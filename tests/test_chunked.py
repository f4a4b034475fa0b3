"""Chunked (bounded-memory) ingest: exactness vs the eager path.

Reference analog: the true-streaming engines (src/streaming.rs:513-616).
"""

import gzip
import io
import os
import random

import numpy as np
import pytest

import krust as kt
from krust.api import _count_path
from krust.io.format import SequenceFormat
from krust.io.reader import stream_input_chunks
from krust.models.engines import BatchEngine
from krust.utils.config import EngineConfig

import oracle


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n")
            # multi-line records exercise the FASTA cut logic
            for j in range(0, len(s), 37):
                f.write(s[j : j + 37] + "\n")


def _write_fastq(path, seqs, qual_char="I"):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{qual_char * len(s)}\n")


@pytest.fixture
def seqs():
    rng = random.Random(11)
    return [oracle.random_dna(rng, rng.randint(0, 400), "ACGTN") for _ in range(60)]


@pytest.mark.parametrize("chunk_bytes", [64, 700, 1 << 20])
def test_fasta_chunked_equals_eager(tmp_path, seqs, chunk_bytes):
    p = tmp_path / "big.fa"
    _write_fasta(p, seqs)
    eager = _count_path(p, 7)
    chunked = _count_path(
        p, 7, config=EngineConfig(ingest_chunk_bytes=chunk_bytes)
    )
    assert np.array_equal(eager.codes, chunked.codes)
    assert np.array_equal(eager.counts, chunked.counts)


@pytest.mark.parametrize("chunk_bytes", [64, 1500])
def test_fastq_chunked_equals_eager(tmp_path, seqs, chunk_bytes):
    p = tmp_path / "big.fq"
    _write_fastq(p, seqs)
    eager = _count_path(p, 9, min_quality=20)
    chunked = _count_path(
        p, 9, min_quality=20, config=EngineConfig(ingest_chunk_bytes=chunk_bytes)
    )
    assert np.array_equal(eager.codes, chunked.codes)
    assert np.array_equal(eager.counts, chunked.counts)


def test_gzip_chunked(tmp_path, seqs):
    p = tmp_path / "big.fa.gz"
    raw = []
    for i, s in enumerate(seqs):
        raw.append(f">r{i}\n{s}\n")
    with gzip.open(p, "wt") as f:
        f.write("".join(raw))
    eager = _count_path(p, 5)
    chunked = _count_path(p, 5, config=EngineConfig(ingest_chunk_bytes=512))
    assert np.array_equal(eager.codes, chunked.codes)
    assert np.array_equal(eager.counts, chunked.counts)


def test_record_longer_than_chunk(tmp_path):
    # one 5 kb record with 64-byte chunks: the carry must grow until EOF
    rng = random.Random(3)
    seq = oracle.random_dna(rng, 5000, "ACGT")
    p = tmp_path / "one.fa"
    _write_fasta(p, [seq, "ACGTACGT"])
    eager = _count_path(p, 11)
    chunked = _count_path(p, 11, config=EngineConfig(ingest_chunk_bytes=64))
    assert np.array_equal(eager.codes, chunked.codes)
    assert np.array_equal(eager.counts, chunked.counts)


def test_chunk_boundaries_are_record_aligned(tmp_path, seqs):
    p = tmp_path / "rec.fa"
    _write_fasta(p, seqs)
    total_records = 0
    total_bases = 0
    for streams in stream_input_chunks(p, SequenceFormat.AUTO, 256):
        total_records += streams.n_records
        total_bases += streams.n_bases
    assert total_records == len(seqs)
    assert total_bases == sum(len(s) for s in seqs)


def test_progress_fires_per_chunk(tmp_path, seqs):
    from krust.utils.progress import ProgressTracker

    p = tmp_path / "prog.fa"
    _write_fasta(p, seqs)
    snaps = []
    chunks = stream_input_chunks(p, SequenceFormat.AUTO, 512)
    BatchEngine(EngineConfig()).count_chunked(
        chunks, 5, progress=snaps.append, tracker=ProgressTracker()
    )
    assert len(snaps) >= 2
    assert snaps[-1].sequences_processed == len(seqs)
    bases = [s.bases_processed for s in snaps]
    assert bases == sorted(bases)


class _ChunkOnlyReader:
    """A stream that REFUSES whole-stream reads: read() must get a size.

    Stands in for an unbounded pipe — if any code path tries to slurp it
    (reader.read() with no/negative size), the test fails immediately.
    """

    def __init__(self, data: bytes):
        self._buf = io.BytesIO(data)
        self.max_request = 0

    def read(self, n: int = -1) -> bytes:
        assert n is not None and n > 0, "unbounded read() on a pipe reader"
        self.max_request = max(self.max_request, n)
        return self._buf.read(n)


class TestFromReaderBounded:
    """count_kmers_from_reader consumes the stream in record-aligned chunks
    (reference's BufRead loop: src/streaming.rs:513-616) — never slurping."""

    def test_reader_never_slurped_and_exact(self, tmp_path, seqs):
        p = tmp_path / "in.fa"
        _write_fasta(p, seqs)
        expected = oracle.count_sequences(seqs, 7)
        data = p.read_bytes()
        # many chunks: chunk size far below the input size
        cfg = EngineConfig(ingest_chunk_bytes=512)
        reader = _ChunkOnlyReader(data)
        got = kt.count_kmers_from_reader(
            reader, 7, SequenceFormat.FASTA, config=cfg
        )
        assert reader.max_request <= 512
        assert got == expected

    def test_default_chunked_matches_eager(self, tmp_path, seqs):
        p = tmp_path / "in.fq"
        _write_fastq(p, [s for s in seqs if s])
        with open(p, "rb") as f:
            got = kt.count_kmers_from_reader(f, 5, SequenceFormat.FASTQ)
        assert got == kt.count_kmers_with_format(str(p), 5, SequenceFormat.FASTQ)

    def test_streaming_api_defaults_to_chunked(self, tmp_path, seqs, monkeypatch):
        """count_kmers_streaming never eager-parses: a file far larger than
        the configured chunk is counted exactly through stream_input_chunks
        (round-4 change: the name is now true — the reference's same-named
        function batches everything, src/streaming.rs:857-899)."""
        import krust.api as api_mod

        p = tmp_path / "big.fa"
        _write_fasta(p, seqs)
        expected = oracle.count_sequences(seqs, 7)

        # the eager path goes through read_input_bytes; poison it so any
        # whole-file parse fails loudly
        def _boom(*a, **kw):
            raise AssertionError("streaming API must not eager-read the file")

        monkeypatch.setattr(api_mod, "read_input_bytes", _boom)
        monkeypatch.setattr(
            api_mod, "DEFAULT_STREAMING_CHUNK_BYTES", 512
        )
        assert kt.count_kmers_streaming(str(p), 7) == expected
        packed = kt.count_kmers_streaming_packed(str(p), 7)
        assert len(packed) == len(expected)
        assert sum(packed.values()) == sum(expected.values())

    def test_builder_count_streaming_chunked(self, tmp_path, seqs, monkeypatch):
        import krust.api as api_mod

        p = tmp_path / "big.fa"
        _write_fasta(p, seqs)
        monkeypatch.setattr(api_mod, "DEFAULT_STREAMING_CHUNK_BYTES", 512)
        got = kt.KmerCounter().k(7).min_count(2).count_streaming(str(p))
        expected = {
            km: c for km, c in oracle.count_sequences(seqs, 7).items() if c >= 2
        }
        assert got == expected

    def test_streaming_api_respects_explicit_eager(self, tmp_path, seqs):
        """An explicit ingest_chunk_bytes=0 keeps the builder eager."""
        p = tmp_path / "in.fa"
        _write_fasta(p, seqs)
        cfg = EngineConfig(ingest_chunk_bytes=0)
        got = (
            kt.KmerCounter().k(7).engine_config(cfg).count_streaming(str(p))
        )
        assert got == oracle.count_sequences(seqs, 7)

    def test_stdin_pipe_larger_than_chunk(self, tmp_path, seqs):
        """CLI stdin: input many times the chunk size, exact counts."""
        import subprocess
        import sys

        p = tmp_path / "in.fa"
        _write_fasta(p, seqs)
        env = dict(os.environ, KRUST_PLATFORM="cpu", KRUST_ENGINE="native")
        out = subprocess.run(
            [sys.executable, "-m", "krust", "7", "-", "-f", "tsv", "-q"],
            stdin=open(p, "rb"),
            capture_output=True,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert out.returncode == 0, out.stderr
        got = {}
        for line in out.stdout.splitlines():
            kmer, cnt = line.split("\t")
            got[kmer] = int(cnt)
        assert got == oracle.count_sequences(seqs, 7)
