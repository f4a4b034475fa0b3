"""Builder + async API tests (mirrors reference: src/builder.rs:553-641,
src/async_api.rs:282-316)."""

import asyncio

import pytest

import krust as kt
from krust.errors import BuilderError
from krust.io.format import SequenceFormat


def test_builder_basic(simple_fa):
    counts = kt.KmerCounter.new().k(3).count(simple_fa)
    assert counts == kt.count_kmers(simple_fa, 3)


def test_builder_requires_k(simple_fa):
    with pytest.raises(BuilderError):
        kt.KmerCounter.new().count(simple_fa)


def test_builder_invalid_k():
    with pytest.raises(kt.KmerLengthError):
        kt.KmerCounter.new().k(0)


def test_builder_min_count(simple_fa):
    all_counts = kt.KmerCounter.new().k(3).count(simple_fa)
    filtered = kt.KmerCounter.new().k(3).min_count(2).count(simple_fa)
    assert filtered == {km: c for km, c in all_counts.items() if c >= 2}


def test_builder_getters():
    b = (
        kt.KmerCounter.new()
        .k(5)
        .min_count(3)
        .format(kt.OutputFormat.TSV)
        .input_format(SequenceFormat.FASTQ)
        .min_quality(20)
    )
    assert b.get_k() == kt.KmerLength(5)
    assert b.get_min_count() == 3
    assert b.get_format() is kt.OutputFormat.TSV
    assert b.get_input_format() is SequenceFormat.FASTQ
    assert b.get_min_quality() == 20


def test_builder_min_quality_validation():
    with pytest.raises(BuilderError):
        kt.KmerCounter.new().min_quality(94)


def test_builder_histogram(simple_fa):
    hist = kt.KmerCounter.new().k(3).histogram(simple_fa)
    assert hist == kt.compute_histogram(kt.count_kmers(simple_fa, 3))


def test_builder_streaming_and_mmap(simple_fa):
    base = kt.KmerCounter.new().k(3).count(simple_fa)
    assert kt.KmerCounter.new().k(3).count_streaming(simple_fa) == base
    assert kt.KmerCounter.new().k(3).count_mmap(simple_fa) == base


def test_builder_progress(simple_fa):
    snaps = []
    counts = kt.KmerCounter.new().k(3).count_with_progress(simple_fa, snaps.append)
    assert counts == kt.count_kmers(simple_fa, 3)
    assert snaps and snaps[-1].sequences_processed == 2


def test_builder_run_to_writer(simple_fa, tmp_path):
    import io

    buf = io.StringIO()
    kt.KmerCounter.new().k(3).format(kt.OutputFormat.TSV).count_to_writer(
        simple_fa, buf
    )
    assert buf.getvalue().strip()


def test_async_count(simple_fa):
    got = asyncio.run(kt.count_kmers_async(simple_fa, 3))
    assert got == kt.count_kmers(simple_fa, 3)


def test_async_packed(simple_fa):
    got = asyncio.run(kt.count_kmers_packed_async(simple_fa, 3))
    assert got == kt.count_kmers_packed(simple_fa, 3)


def test_async_invalid_k(simple_fa):
    with pytest.raises(kt.KmerLengthError):
        asyncio.run(kt.count_kmers_async(simple_fa, 0))


def test_async_builder(simple_fa):
    counter = kt.AsyncKmerCounter.new().k(3).min_count(2)
    got = asyncio.run(counter.count(simple_fa))
    exp = {
        km: c for km, c in kt.count_kmers(simple_fa, 3).items() if c >= 2
    }
    assert got == exp


def test_progress_tracker():
    t = kt.ProgressTracker()
    t.record_sequence(100)
    t.record_sequence(50)
    snap = t.snapshot()
    assert snap.sequences_processed == 2
    assert snap.bases_processed == 150
    t.reset()
    assert t.snapshot().sequences_processed == 0
