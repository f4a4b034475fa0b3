"""Histogram tests (mirrors reference: src/histogram.rs:171-288)."""

import numpy as np

from krust.histogram import (
    compute_histogram,
    compute_histogram_array,
    compute_histogram_packed,
    histogram_stats,
)


def test_compute_histogram():
    counts = {"ACG": 1, "CGT": 1, "GTA": 2, "TAC": 2, "AAA": 5}
    hist = compute_histogram(counts)
    assert hist == {1: 2, 2: 2, 5: 1}
    # ascending key order
    assert list(hist.keys()) == sorted(hist.keys())


def test_packed_and_array_agree():
    counts = {1: 3, 2: 3, 3: 7}
    assert compute_histogram_packed(counts) == {3: 2, 7: 1}
    arr = np.array([3, 3, 7], dtype=np.uint64)
    assert compute_histogram_array(arr) == {3: 2, 7: 1}


def test_empty():
    assert compute_histogram({}) == {}
    assert compute_histogram_array(np.zeros(0, np.uint64)) == {}


def test_stats():
    # reference doc example: {ACG:1, CGT:1, GTA:2, TAC:2}
    hist = compute_histogram({"ACG": 1, "CGT": 1, "GTA": 2, "TAC": 2})
    stats = histogram_stats(hist)
    assert stats.distinct_kmers == 4
    assert stats.total_kmers == 6
    assert stats.mean_count == 1.5
    # tie on frequency 2: max_by_key keeps the last (highest count)
    assert stats.mode_count == 2
    assert stats.mode_frequency == 2


def test_stats_empty():
    stats = histogram_stats({})
    assert stats.total_kmers == 0
    assert stats.distinct_kmers == 0
    assert stats.mode_count == 0
    assert stats.mean_count == 0.0


def test_sum_freq_equals_distinct():
    # histogram invariant (reference: integration_tests.rs:664-706)
    counts = {f"K{i}": (i % 3) + 1 for i in range(30)}
    hist = compute_histogram(counts)
    assert sum(hist.values()) == len(counts)
    assert sum(c * f for c, f in hist.items()) == sum(counts.values())
