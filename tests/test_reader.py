"""IO layer tests: format detection, input, FASTA/FASTQ parsing, gzip.

Mirrors reference: src/format.rs:127-226, src/input.rs:103-158 unit tests and
reader semantics.
"""

import gzip

import numpy as np
import pytest

from krust.errors import FormatError
from krust.io.format import SequenceFormat, is_gzip_path
from krust.io.input import Input
from krust.io.reader import (
    parse_records,
    parse_to_streams,
    read_records,
    read_records_with_quality,
    streams_from_sequences,
)


class TestFormat:
    @pytest.mark.parametrize(
        "path,expected",
        [
            ("reads.fq", SequenceFormat.FASTQ),
            ("reads.fastq", SequenceFormat.FASTQ),
            ("reads.FASTQ", SequenceFormat.FASTQ),
            ("reads.fastq.gz", SequenceFormat.FASTQ),
            ("reads.fq.gz", SequenceFormat.FASTQ),
            ("genome.fa", SequenceFormat.FASTA),
            ("genome.fasta", SequenceFormat.FASTA),
            ("genome.fa.gz", SequenceFormat.FASTA),
            ("genome.txt", SequenceFormat.FASTA),
            ("genome", SequenceFormat.FASTA),
            ("weird.gz", SequenceFormat.FASTA),
        ],
    )
    def test_from_extension(self, path, expected):
        assert SequenceFormat.from_extension(path) is expected

    def test_resolve(self):
        assert SequenceFormat.AUTO.resolve("x.fq") is SequenceFormat.FASTQ
        assert SequenceFormat.AUTO.resolve(None) is SequenceFormat.FASTA
        assert SequenceFormat.FASTA.resolve("x.fq") is SequenceFormat.FASTA

    def test_is_gzip(self):
        assert is_gzip_path("a.kmix.gz")
        assert not is_gzip_path("a.kmix")


class TestInput:
    def test_dash_is_stdin(self):
        assert Input.from_path("-").is_stdin
        assert Input.from_path(None).is_stdin
        assert str(Input.from_path("-")) == "<stdin>"

    def test_file(self):
        i = Input.from_path("genome.fa")
        assert i.is_file and not i.is_stdin
        assert str(i) == "genome.fa"


class TestFastaParse:
    def test_simple(self):
        recs = parse_records(b">a\nACGT\n>b\nGGG\n", SequenceFormat.FASTA)
        assert [r.seq for r in recs] == [b"ACGT", b"GGG"]
        assert all(r.qual is None for r in recs)

    def test_multiline_concatenates(self):
        # reference: tests/library_tests.rs:233-241
        recs = parse_records(b">a\nACG\nTAC\nGT\n", SequenceFormat.FASTA)
        assert [r.seq for r in recs] == [b"ACGTACGT"]

    def test_crlf(self):
        recs = parse_records(b">a\r\nACGT\r\n", SequenceFormat.FASTA)
        assert [r.seq for r in recs] == [b"ACGT"]

    def test_no_trailing_newline(self):
        recs = parse_records(b">a\nACGT", SequenceFormat.FASTA)
        assert [r.seq for r in recs] == [b"ACGT"]

    def test_empty(self):
        assert parse_records(b"", SequenceFormat.FASTA) == []

    def test_garbage_before_header(self):
        with pytest.raises(FormatError):
            parse_records(b"ACGT\n>a\nACGT\n", SequenceFormat.FASTA)

    def test_empty_record(self):
        recs = parse_records(b">a\n>b\nACGT\n", SequenceFormat.FASTA)
        assert [r.seq for r in recs] == [b"", b"ACGT"]


class TestFastqParse:
    def test_simple(self):
        recs = parse_records(
            b"@a\nACGT\n+\nIIII\n@b\nGGG\n+\nIII\n", SequenceFormat.FASTQ
        )
        assert [(r.seq, r.qual) for r in recs] == [
            (b"ACGT", b"IIII"),
            (b"GGG", b"III"),
        ]

    def test_bad_line_count(self):
        with pytest.raises(FormatError):
            parse_records(b"@a\nACGT\n+\n", SequenceFormat.FASTQ)

    def test_bad_header(self):
        with pytest.raises(FormatError):
            parse_records(b">a\nACGT\n+\nIIII\n", SequenceFormat.FASTQ)

    def test_qual_length_mismatch(self):
        with pytest.raises(FormatError):
            parse_records(b"@a\nACGT\n+\nIII\n", SequenceFormat.FASTQ)


class TestStreams:
    def test_separator_between_records(self):
        ps = parse_to_streams(b">a\nACGT\n>b\nGG\n", SequenceFormat.FASTA)
        assert ps.codes.tolist() == [0, 1, 2, 3, 4, 2, 2]
        assert ps.n_records == 2
        assert ps.n_bases == 6
        assert ps.qual is None

    def test_fastq_quality_aligned(self):
        ps = parse_to_streams(b"@a\nAC\n+\nI!\n@b\nG\n+\n#\n", SequenceFormat.FASTQ)
        assert ps.codes.tolist() == [0, 1, 4, 2]
        assert ps.qual.tolist() == [ord("I"), ord("!"), 0xFF, ord("#")]

    def test_soft_mask_normalized(self):
        ps = parse_to_streams(b">s\nAAAa\n", SequenceFormat.FASTA)
        assert ps.codes.tolist() == [0, 0, 0, 0]

    def test_n_invalid(self):
        ps = parse_to_streams(b">s\nACGNT\n", SequenceFormat.FASTA)
        assert ps.codes.tolist() == [0, 1, 2, 4, 3]

    def test_from_sequences(self):
        ps = streams_from_sequences(["ACGT", b"GG"])
        assert ps.codes.tolist() == [0, 1, 2, 3, 4, 2, 2]
        assert ps.n_records == 2


class TestFileReading:
    def test_read_records(self, simple_fa):
        assert read_records(simple_fa) == [b"ACGTACGT", b"GATTACA"]

    def test_read_with_quality(self, simple_fq):
        recs = read_records_with_quality(simple_fq)
        assert recs[0].seq == b"ACGTACGT"
        assert recs[0].qual == b"IIIIIIII"

    def test_gzip(self, fixtures_dir):
        plain = read_records(str(fixtures_dir / "simple.fa"))
        gz = read_records(str(fixtures_dir / "simple.fa.gz"))
        assert plain == gz
