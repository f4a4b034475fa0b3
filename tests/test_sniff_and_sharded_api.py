"""Content-sniffing reader mode + user-facing sharded counting API."""

import numpy as np
import pytest

from krust import (
    KmerCounter,
    SequenceFormat,
    count_kmers,
    count_kmers_sharded,
    count_kmers_sharded_result,
    count_kmers_sniffed,
)


class TestFromContent:
    def test_fasta_by_content(self):
        assert SequenceFormat.from_content(b">x\nACGT\n") is SequenceFormat.FASTA

    def test_fastq_by_content(self):
        assert (
            SequenceFormat.from_content(b"@x\nACGT\n+\nIIII\n")
            is SequenceFormat.FASTQ
        )

    def test_leading_newlines_skipped(self):
        # only line terminators may precede the header byte — the parsers
        # require '>'/'@' at line start, so ' >x' must NOT sniff as FASTA
        # (advisor r1 finding)
        assert SequenceFormat.from_content(b"\n\r\n>x\n") is SequenceFormat.FASTA
        with pytest.raises(ValueError):
            SequenceFormat.from_content(b" >x\n")
        with pytest.raises(ValueError):
            SequenceFormat.from_content(b"\t@x\n")

    def test_garbage_rejected(self):
        with pytest.raises(ValueError):
            SequenceFormat.from_content(b"ACGT\n")
        with pytest.raises(ValueError):
            SequenceFormat.from_content(b"")

    def test_resolve_with_content_overrides_extension(self, tmp_path):
        # a FASTQ stream in a .fa-named file: sniffing wins (needletail
        # behavior), extension rules would say FASTA
        assert (
            SequenceFormat.AUTO.resolve_with_content(
                "reads.fa", b"@r\nACGT\n+\nIIII\n"
            )
            is SequenceFormat.FASTQ
        )

    def test_explicit_format_not_overridden(self):
        assert (
            SequenceFormat.FASTA.resolve_with_content("x.fq", b"@r\n")
            is SequenceFormat.FASTA
        )


def test_count_kmers_sniffed_misnamed_fastq(tmp_path):
    p = tmp_path / "reads.fa"  # FASTQ content behind a FASTA extension
    p.write_text("@r1\nACGTACGT\n+\nIIIIIIII\n")
    got = count_kmers_sniffed(p, 3)
    q = tmp_path / "reads.fq"
    q.write_text("@r1\nACGTACGT\n+\nIIIIIIII\n")
    assert got == count_kmers(q, 3)


@pytest.mark.slow
class TestShardedApi:
    def _fasta(self, tmp_path, n=16):
        rng = np.random.default_rng(5)
        seqs = [
            "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=200)])
            for _ in range(n)
        ]
        p = tmp_path / "g.fa"
        p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
        return p

    def test_matches_single_device(self, tmp_path):
        p = self._fasta(tmp_path)
        assert count_kmers_sharded(p, 11) == count_kmers(p, 11)

    def test_result_sorted(self, tmp_path):
        p = self._fasta(tmp_path)
        res = count_kmers_sharded_result(p, 21)
        assert np.all(np.diff(res.codes.astype(np.uint64)) > 0)

    def test_builder_sharded(self, tmp_path):
        p = self._fasta(tmp_path)
        got = KmerCounter.new().k(9).min_count(2).count_sharded(p)
        exp = {s: c for s, c in count_kmers(p, 9).items() if c >= 2}
        assert got == exp


@pytest.mark.slow
def test_sharded_gzip_fastq_quality(tmp_path):
    """BASELINE config 5 composition: gzip FASTQ -> sharded count, with
    quality filtering, equals the single-device engine."""
    import gzip

    from krust import count_kmers_with_quality

    rng = np.random.default_rng(77)
    recs = []
    for i in range(12):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=150)])
        qual = "".join(chr(c) for c in rng.integers(33, 80, size=150))
        recs.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    p = tmp_path / "reads.fq.gz"
    p.write_bytes(gzip.compress("".join(recs).encode()))
    got = count_kmers_sharded(p, 15, min_quality=5)
    exp = count_kmers_with_quality(p, 15, min_quality=5)
    assert got == exp and len(got) > 0
