"""Vectorized output path: byte-level equivalence with the dict formatter."""

import io
import json

import numpy as np
import pytest

from krust.kmer import pack_many, unpack_many
from krust.models.engines import PackedCounts
from krust.output import (
    OutputFormat,
    format_packed_counts,
    output_counts,
    output_packed,
)


def _random_result(rng, k, n):
    codes = np.unique(
        rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    )
    counts = rng.integers(1, 10_000_000, size=codes.shape[0], dtype=np.uint64)
    return PackedCounts(k, codes, counts)


def _dict_bytes(result, fmt, min_count):
    buf = io.StringIO()
    output_counts(result.to_string_dict(), fmt, min_count, buf)
    return buf.getvalue().encode()


@pytest.mark.parametrize("fmt", list(OutputFormat))
@pytest.mark.parametrize("k", [1, 11, 32])
def test_matches_dict_path_linewise(fmt, k):
    rng = np.random.default_rng(int(k))
    result = _random_result(rng, k, 500)
    got = format_packed_counts(result.codes, result.counts, k, fmt)
    ref = _dict_bytes(result, fmt, 1)
    if fmt is OutputFormat.JSON:
        key = lambda e: (e["kmer"], e["count"])
        assert sorted(json.loads(got), key=key) == sorted(json.loads(ref), key=key)
    else:
        assert sorted(got.splitlines()) == sorted(ref.splitlines())


@pytest.mark.parametrize("fmt", list(OutputFormat))
def test_min_count_filter(fmt):
    rng = np.random.default_rng(7)
    result = _random_result(rng, 9, 300)
    got = format_packed_counts(result.codes, result.counts, 9, fmt, min_count=5000)
    ref = _dict_bytes(result, fmt, 5000)
    if fmt is OutputFormat.JSON:
        key = lambda e: (e["kmer"], e["count"])
        assert sorted(json.loads(got), key=key) == sorted(json.loads(ref), key=key)
    else:
        assert sorted(got.splitlines()) == sorted(ref.splitlines())


@pytest.mark.parametrize("fmt", list(OutputFormat))
def test_empty(fmt):
    empty = PackedCounts.empty(5)
    got = format_packed_counts(empty.codes, empty.counts, 5, fmt)
    assert got == _dict_bytes(empty, fmt, 1)


def test_digit_group_boundaries():
    # counts straddling every digit-width boundary render exactly
    counts = np.array(
        [1, 9, 10, 99, 100, 999, 1000, 10**6, 10**7 - 1, 10**12, 2**63],
        dtype=np.uint64,
    )
    codes = np.arange(counts.shape[0], dtype=np.uint64)
    got = format_packed_counts(codes, counts, 4, OutputFormat.TSV)
    kmers = unpack_many(codes, 4)
    expect = {f"{km}\t{c}" for km, c in zip(kmers, counts.tolist())}
    assert set(got.decode().splitlines()) == expect


def test_output_packed_text_stream():
    result = PackedCounts(
        3, np.array([1, 2], np.uint64), np.array([5, 6], np.uint64)
    )
    buf = io.StringIO()
    output_packed(result, OutputFormat.TSV, out=buf)
    assert buf.getvalue() == "AAC\t5\nAAG\t6\n"


def test_json_exact_bytes_single_order():
    # when entry order coincides (single digit-width group), bytes match
    result = PackedCounts(
        3, np.array([0, 5], np.uint64), np.array([2, 3], np.uint64)
    )
    got = format_packed_counts(result.codes, result.counts, 3, OutputFormat.JSON)
    ref = _dict_bytes(result, OutputFormat.JSON, 1)
    assert got == ref
