"""Library API tests with exact-count oracles (mirrors reference
tests/library_tests.rs + streaming/quality suites)."""

import gzip
import io

import pytest

import krust as kt
from krust.io.format import SequenceFormat

import oracle


def write(tmp_path, name, content: str):
    p = tmp_path / name
    p.write_bytes(content.encode())
    return str(p)


class TestExactCounts:
    def test_acgt_k3(self, tmp_path):
        # reference: library_tests.rs:22-33 — ACGT, k=3 -> {ACG: 2}
        # (ACG canonical; CGT's revcomp is ACG)
        p = write(tmp_path, "x.fa", ">s\nACGT\n")
        assert kt.count_kmers(p, 3) == {"ACG": 2}

    def test_canonical_only_output(self, tmp_path):
        # reference: library_tests.rs:54-64 — TTT -> AAA
        p = write(tmp_path, "x.fa", ">s\nTTT\n")
        assert kt.count_kmers(p, 3) == {"AAA": 1}

    def test_n_gap(self, tmp_path):
        # reference: library_tests.rs:66-80 — ACGNACG k=3 -> {ACG: 2}
        p = write(tmp_path, "x.fa", ">s\nACGNACG\n")
        assert kt.count_kmers(p, 3) == {"ACG": 2}

    def test_k1_complement_folding(self, tmp_path):
        # reference: library_tests.rs:129-140 — ACGT k=1 -> A:2, C:2
        p = write(tmp_path, "x.fa", ">s\nACGT\n")
        assert kt.count_kmers(p, 1) == {"A": 2, "C": 2}

    def test_homopolymer(self, tmp_path):
        # reference: AAAAA k=3 -> AAA:3
        p = write(tmp_path, "x.fa", ">s\nAAAAA\n")
        assert kt.count_kmers(p, 3) == {"AAA": 3}

    def test_k32_max(self, tmp_path):
        seq = "ACGT" * 8
        p = write(tmp_path, "x.fa", f">s\n{seq}\n")
        got = kt.count_kmers(p, 32)
        assert got == {oracle.canonical(seq): 1}

    def test_seq_equals_rc_seq(self, tmp_path):
        # reference: library_tests.rs:219-230
        seq = "GATTACA"
        rc = oracle.revcomp(seq)
        p1 = write(tmp_path, "a.fa", f">s\n{seq}\n")
        p2 = write(tmp_path, "b.fa", f">s\n{rc}\n")
        assert kt.count_kmers(p1, 4) == kt.count_kmers(p2, 4)

    def test_soft_mask(self, fixtures_dir):
        # reference: integration_tests.rs:263-281 — AAAa k=3 -> AAA:2
        assert kt.count_kmers(str(fixtures_dir / "soft_masked.fa"), 3) == {"AAA": 2}

    def test_simple_fixture_all_k(self, simple_fa):
        seqs = ["ACGTACGT", "GATTACA"]
        for k in range(1, 33):
            assert kt.count_kmers(simple_fa, k) == oracle.count_sequences(seqs, k), k

    def test_shorter_than_k(self, tmp_path):
        p = write(tmp_path, "x.fa", ">s\nACG\n")
        assert kt.count_kmers(p, 5) == {}

    def test_invalid_k(self, simple_fa):
        with pytest.raises(kt.KmerLengthError):
            kt.count_kmers(simple_fa, 0)
        with pytest.raises(kt.KmerLengthError):
            kt.count_kmers(simple_fa, 33)

    def test_missing_file(self):
        with pytest.raises(FileNotFoundError):
            kt.count_kmers("/nonexistent/path.fa", 3)


class TestFormatsAndSources:
    def test_fasta_fastq_equal(self, simple_fa, simple_fq):
        assert kt.count_kmers(simple_fa, 3) == kt.count_kmers(simple_fq, 3)

    def test_gzip_equals_plain(self, fixtures_dir):
        plain = kt.count_kmers(str(fixtures_dir / "simple.fa"), 5)
        gz = kt.count_kmers(str(fixtures_dir / "simple.fa.gz"), 5)
        assert plain == gz

    def test_explicit_format(self, tmp_path):
        # FASTQ content with a .txt extension needs explicit format
        p = write(tmp_path, "reads.txt", "@s\nACGT\n+\nIIII\n")
        got = kt.count_kmers_with_format(p, 3, SequenceFormat.FASTQ)
        assert got == {"ACG": 2}

    def test_from_reader(self):
        buf = io.BytesIO(b">s\nACGT\n")
        assert kt.count_kmers_from_reader(buf, 3) == {"ACG": 2}

    def test_from_reader_fastq(self):
        buf = io.BytesIO(b"@s\nACGT\n+\nIIII\n")
        got = kt.count_kmers_from_reader(buf, 3, SequenceFormat.FASTQ)
        assert got == {"ACG": 2}

    def test_from_sequences(self):
        # reference: streaming.rs count_kmers_from_sequences
        assert kt.count_kmers_from_sequences(["ACGT", "ACGT"], 3) == {"ACG": 4}

    def test_mmap_equals_regular(self, simple_fa):
        # reference: tests/mmap_tests.rs
        assert kt.count_kmers_mmap(simple_fa, 5) == kt.count_kmers(simple_fa, 5)

    def test_mmap_handles_with_n(self, fixtures_dir):
        # reference: tests/mmap_tests.rs count_kmers_mmap_handles_with_n
        path = fixtures_dir / "with_n.fa"
        got = kt.count_kmers_mmap(path, 4)
        assert got and got == kt.count_kmers(path, 4)


class TestMmapFasta:
    """Public mmap type surface (reference: src/mmap.rs:29-71,
    tests/mmap_tests.rs)."""

    def test_open_and_read(self, simple_fa):
        # reference: tests/mmap_tests.rs mmap_fasta_open_and_read
        with kt.MmapFasta.open(simple_fa) as m:
            assert not m.is_empty()
            assert bytes(m.as_bytes()[:5]) == b">seq1"

    def test_len(self, tmp_path):
        # reference: tests/mmap_tests.rs mmap_fasta_len
        p = tmp_path / "t.fa"
        p.write_bytes(b"ACGT")
        with kt.MmapFasta.open(p) as m:
            assert m.len() == 4
            assert len(m) == 4

    def test_empty_file(self, tmp_path):
        p = tmp_path / "empty.fa"
        p.write_bytes(b"")
        with kt.MmapFasta.open(p) as m:
            assert m.is_empty() and m.len() == 0
            assert bytes(m.as_bytes()) == b""

    def test_nonexistent_file_error(self, tmp_path):
        # reference: tests/mmap_tests.rs mmap_fasta_nonexistent_file_error
        with pytest.raises(OSError):
            kt.MmapFasta.open(tmp_path / "nonexistent_file.fa")

    def test_close_idempotent_and_repr(self, simple_fa):
        m = kt.MmapFasta.open(simple_fa)
        assert not m.closed and "bytes" in repr(m)
        m.close()
        m.close()
        assert m.closed and "closed" in repr(m)

    def test_zero_copy_parse(self, simple_fa):
        # the mapped view feeds the parser directly (what count_kmers_mmap does)
        from krust.io.reader import parse_to_streams

        with kt.MmapFasta.open(simple_fa) as m:
            streams = parse_to_streams(m.as_bytes(), SequenceFormat.FASTA)
        assert streams.n_records == 2

    def test_streaming_equals_batch(self, simple_fa):
        assert kt.count_kmers_streaming(simple_fa, 5) == kt.count_kmers(simple_fa, 5)

    def test_sequential_equals_batch(self, simple_fa):
        assert kt.count_kmers_sequential(simple_fa, 5) == kt.count_kmers(simple_fa, 5)

    def test_packed_consistent(self, simple_fa):
        packed = kt.count_kmers_packed(simple_fa, 5)
        strings = kt.count_kmers(simple_fa, 5)
        assert len(packed) == len(strings)
        assert {kt.unpack_to_string(c, 5): n for c, n in packed.items()} == strings


class TestQuality:
    def test_q20_filters_low_quality(self, fixtures_dir):
        # reference: tests/quality_tests.rs — low_quality.fq: ACGTACGT with
        # IIII!!!! ('!' = Phred 0) + GATTACA all-I (Phred 40)
        p = str(fixtures_dir / "low_quality.fq")
        unfiltered = kt.count_kmers_with_quality(p, 4, SequenceFormat.FASTQ, None)
        filtered = kt.count_kmers_with_quality(p, 4, SequenceFormat.FASTQ, 20)
        assert sum(filtered.values()) < sum(unfiltered.values())
        # only the first 4 bases of seq1 pass: exactly 1 window (ACGT),
        # plus all 4 windows of GATTACA
        exp = oracle.count_sequences(
            [("ACGTACGT", "IIII!!!!"), ("GATTACA", "IIIIIII")], 4, min_quality=20
        )
        assert filtered == exp

    def test_q0_no_op(self, fixtures_dir):
        p = str(fixtures_dir / "low_quality.fq")
        q0 = kt.count_kmers_with_quality(p, 4, SequenceFormat.FASTQ, 0)
        # '!' = 33 = Phred 0, threshold 0+33=33, so nothing is below it
        none = kt.count_kmers_with_quality(p, 4, SequenceFormat.FASTQ, None)
        assert q0 == none

    def test_high_quality_unaffected(self, simple_fq):
        q = kt.count_kmers_with_quality(simple_fq, 3, SequenceFormat.FASTQ, 30)
        no_q = kt.count_kmers(simple_fq, 3)
        assert q == no_q

    def test_fasta_ignores_quality(self, simple_fa):
        # quality filter is a no-op for FASTA (no quality stream)
        got = kt.count_kmers_with_quality(simple_fa, 3, SequenceFormat.FASTA, 40)
        assert got == kt.count_kmers(simple_fa, 3)


class TestProgress:
    def test_progress_fires_and_matches(self, simple_fa):
        # reference: tests/progress_tests.rs — callback fires; totals exact
        snaps = []
        counts = kt.count_kmers_with_progress(simple_fa, 3, snaps.append)
        assert counts == kt.count_kmers(simple_fa, 3)
        assert len(snaps) >= 1
        assert snaps[-1].sequences_processed == 2
        assert snaps[-1].bases_processed == 15

    def test_progress_exact_cadence(self, simple_fa):
        # reference cadence (src/run.rs:586-654): one callback per record
        # with exact running totals
        snaps = []
        counts = kt.count_kmers_with_progress(
            simple_fa, 3, snaps.append, exact_cadence=True
        )
        assert counts == kt.count_kmers(simple_fa, 3)
        assert [s.sequences_processed for s in snaps] == [1, 2]
        assert snaps[0].bases_processed == 8  # ACGTACGT
        assert snaps[-1].bases_processed == 15


class TestRunApis:
    def test_run_with_options_tsv(self, simple_fa, capsys):
        kt.run_with_options(simple_fa, 3, kt.OutputFormat.TSV)
        out = capsys.readouterr().out
        lines = dict(
            (l.split("\t")[0], int(l.split("\t")[1]))
            for l in out.strip().splitlines()
        )
        assert lines == oracle.count_sequences(["ACGTACGT", "GATTACA"], 3)

    def test_run_with_input(self, simple_fa, capsys):
        kt.run_with_input(kt.Input.from_path(simple_fa), 3, kt.OutputFormat.TSV, 1)
        assert capsys.readouterr().out.strip()


class TestAllKSweep:
    """SURVEY §4: differential coverage for every k in 1..=32 on fixtures."""

    def test_fixture_counts_all_k(self, simple_fa):
        with open(simple_fa) as f:
            seqs = [l.strip() for l in f if not l.startswith(">")]
        for k in range(1, 33):
            got = kt.count_kmers(simple_fa, k)
            assert got == oracle.count_sequences(seqs, k), f"k={k}"

    def test_random_stream_all_k(self):
        import random

        rng = random.Random(99)
        seqs = [oracle.random_dna(rng, rng.randint(0, 80), "ACGTN") for _ in range(8)]
        for k in range(1, 33):
            got = kt.count_kmers_from_sequences(seqs, k)
            assert got == oracle.count_sequences(seqs, k), f"k={k}"


class TestMultiFile:
    """count_kmers_files: several inputs into one exact table (new
    capability; jellyfish-style multi-input)."""

    def test_two_files_sum(self, tmp_path):
        a = tmp_path / "a.fa"
        b = tmp_path / "b.fq"
        a.write_text(">r\nACGTACGT\n")
        b.write_text("@r\nGATTACA\n+\nIIIIIII\n")
        got = kt.count_kmers_files([a, b], 3)
        ca = kt.count_kmers(a, 3)
        cb = kt.count_kmers(b, 3)
        exp = dict(ca)
        for km, c in cb.items():
            exp[km] = exp.get(km, 0) + c
        assert got == exp

    def test_same_file_twice_doubles(self, simple_fa):
        once = kt.count_kmers(simple_fa, 5)
        twice = kt.count_kmers_files([simple_fa, simple_fa], 5)
        assert twice == {km: 2 * c for km, c in once.items()}

    def test_gzip_mixed_and_quality(self, fixtures_dir):
        got = kt.count_kmers_files(
            [fixtures_dir / "simple.fa.gz", fixtures_dir / "low_quality.fq"],
            4,
            min_quality=20,
        )
        a = kt.count_kmers(fixtures_dir / "simple.fa.gz", 4)
        b = kt.count_kmers_with_quality(
            fixtures_dir / "low_quality.fq", 4, min_quality=20
        )
        exp = dict(a)
        for km, c in b.items():
            exp[km] = exp.get(km, 0) + c
        assert got == exp

    def test_empty_list(self):
        assert kt.count_kmers_files([], 5) == {}


class TestInputDispatch:
    """count_kmers_from_input[_packed] (reference: src/streaming.rs:477-509)
    and count_kmers_stdin_packed (src/streaming.rs:349-353)."""

    def test_from_input_file(self, simple_fa):
        from krust.io.input import Input

        got = kt.count_kmers_from_input(Input.from_path(simple_fa), 3)
        assert got == kt.count_kmers(simple_fa, 3)
        packed = kt.count_kmers_from_input_packed(Input.from_path(simple_fa), 3)
        assert len(packed) == len(got)
        assert sum(packed.values()) == sum(got.values())

    def test_from_input_stdin(self, monkeypatch):
        import io as _io

        from krust.io.input import Input

        class _Stdin:
            buffer = _io.BytesIO(b">s\nACGT\n")

        monkeypatch.setattr("sys.stdin", _Stdin())
        got = kt.count_kmers_from_input(Input.from_path(None), 3)
        assert got == {"ACG": 2}
        _Stdin.buffer = _io.BytesIO(b">s\nACGT\n")
        monkeypatch.setattr("sys.stdin", _Stdin())
        packed = kt.count_kmers_from_input_packed(Input.from_path("-"), 3)
        assert list(packed.values()) == [2]


class TestIndexSurface:
    def test_len_and_into_counts(self):
        idx = kt.KmerIndex(3, {5: 2, 9: 7})
        assert idx.len() == len(idx) == 2
        assert idx.into_counts() == {5: 2, 9: 7}
        assert not idx.is_empty()
