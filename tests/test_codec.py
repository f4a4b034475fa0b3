"""Device codec + count op tests: jnp vs numpy vs brute-force oracle.

The three implementations (jax device codec, numpy host codec, python
string oracle) are developed independently and must agree exactly —
the property/differential strategy from reference tests/property_tests.rs.
"""

import random

import numpy as np
import pytest

from krust.io.packer import blockize
from krust.io.reader import streams_from_sequences
from krust.kmer import unpack_many
from krust.models.engines import count_stream_numpy
from krust.ops.codec import combine64, encode_blocks
from krust.ops.count import count_unique

import oracle


def device_count(streams, k, threshold=None):
    """Run the full device path: blockize -> encode -> count -> dict."""
    batch = blockize(streams.codes, streams.qual, k, block_windows=256)
    hi, lo, valid = encode_blocks(
        np.asarray(batch.codes),
        k,
        None if batch.qual is None or threshold is None else np.asarray(batch.qual),
        threshold,
    )
    u_hi, u_lo, u_cnt, n = count_unique(
        np.asarray(hi), np.asarray(lo), np.asarray(valid)
    )
    n = int(n)
    codes64 = combine64(np.asarray(u_hi)[:n], np.asarray(u_lo)[:n])
    counts = np.asarray(u_cnt)[:n]
    return dict(zip(unpack_many(codes64, k), counts.tolist()))


def numpy_count(streams, k, threshold=None):
    uniq, cnt = count_stream_numpy(streams.codes, streams.qual, k, threshold)
    return dict(zip(unpack_many(uniq, k), cnt.tolist()))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 11, 16, 17, 21, 31, 32])
def test_differential_random_dna(k):
    rng = random.Random(42 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 120)) for _ in range(20)]
    expected = oracle.count_sequences(seqs, k)
    streams = streams_from_sequences(seqs)
    assert numpy_count(streams, k) == expected
    assert device_count(streams, k) == expected


@pytest.mark.parametrize("k", [1, 3, 5, 17, 21, 32])
def test_differential_with_n_and_case(k):
    rng = random.Random(77 + k)
    seqs = [
        oracle.random_dna(rng, rng.randint(0, 90), "ACGTacgtNnX")
        for _ in range(20)
    ]
    expected = oracle.count_sequences(seqs, k)
    streams = streams_from_sequences(seqs)
    assert numpy_count(streams, k) == expected
    assert device_count(streams, k) == expected


@pytest.mark.parametrize("k", [3, 5, 21])
def test_differential_quality(k):
    rng = random.Random(99 + k)
    records = []
    for _ in range(15):
        n = rng.randint(0, 80)
        seq = oracle.random_dna(rng, n)
        qual = "".join(chr(rng.randint(33, 73)) for _ in range(n))
        records.append((seq, qual))
    min_q = 20
    threshold = min_q + 33
    expected = oracle.count_sequences(records, k, min_quality=min_q)
    streams = streams_from_sequences(
        [s for s, _ in records], [q.encode() for _, q in records]
    )
    assert numpy_count(streams, k, threshold) == expected
    assert device_count(streams, k, threshold) == expected


def test_sum_counts_bounded_by_windows():
    # reference: tests/property_tests.rs:265-286
    rng = random.Random(5)
    for _ in range(20):
        k = rng.randint(1, 16)
        seqs = [oracle.random_dna(rng, rng.randint(0, 60)) for _ in range(5)]
        streams = streams_from_sequences(seqs)
        got = numpy_count(streams, k)
        windows = sum(max(len(s) - k + 1, 0) for s in seqs)
        assert sum(got.values()) <= windows
        # pure-ACGT input: equality
        assert sum(got.values()) == windows


def test_kmer_plus_rc_counts_two():
    # reference: tests/property_tests.rs:293-330
    rng = random.Random(6)
    for _ in range(20):
        k = rng.randint(1, 32)
        s = oracle.random_dna(rng, k)
        streams = streams_from_sequences([s, oracle.revcomp(s)])
        got = numpy_count(streams, k)
        assert got == {oracle.canonical(s): 2}


def test_empty_and_short_inputs():
    streams = streams_from_sequences([])
    assert numpy_count(streams, 5) == {}
    assert device_count(streams, 5) == {}
    streams = streams_from_sequences(["ACG"])
    assert numpy_count(streams, 5) == {}
    assert device_count(streams, 5) == {}


def test_all_invalid():
    streams = streams_from_sequences(["NNNNNNNN"])
    assert numpy_count(streams, 3) == {}
    assert device_count(streams, 3) == {}


def test_batch_shape_independence():
    """Counts must be identical across block/batch geometries (determinism)."""
    rng = random.Random(11)
    seqs = [oracle.random_dna(rng, 500) for _ in range(4)]
    streams = streams_from_sequences(seqs)
    k = 21
    expected = oracle.count_sequences(seqs, k)
    for w in (64, 128, 1000):
        batch = blockize(streams.codes, None, k, block_windows=w)
        hi, lo, valid = encode_blocks(np.asarray(batch.codes), k)
        u_hi, u_lo, u_cnt, n = count_unique(
            np.asarray(hi), np.asarray(lo), np.asarray(valid)
        )
        n = int(n)
        codes64 = combine64(np.asarray(u_hi)[:n], np.asarray(u_lo)[:n])
        got = dict(
            zip(unpack_many(codes64, k), np.asarray(u_cnt)[:n].tolist())
        )
        assert got == expected, f"mismatch at block_windows={w}"


@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 31, 32])
def test_count_runs_matches_count_unique(k):
    """The scatter-free hot path must agree with the compacted path."""
    import numpy as np
    from krust.ops.count import count_runs, count_unique

    rng = np.random.default_rng(500 + k)
    n = 4096
    max_code = (1 << (2 * k)) - 1
    hi_max = max(max_code >> 32, 0)
    lo_mask = min(max_code, 0xFFFFFFFF)
    hi = rng.integers(0, hi_max + 1, size=n).astype(np.uint32)
    lo = (rng.integers(0, 1 << 32, size=n, dtype=np.uint64) & np.uint64(lo_mask)).astype(np.uint32)
    valid = rng.random(n) < 0.8

    u_hi, u_lo, u_cnt, n_u = count_unique(hi, lo, valid)
    n_u = int(n_u)
    exp = {}
    for h, l, c in zip(
        np.asarray(u_hi)[:n_u], np.asarray(u_lo)[:n_u], np.asarray(u_cnt)[:n_u]
    ):
        exp[(int(h) << 32) | int(l)] = int(c)

    s_hi, s_lo, cnt = count_runs(hi, lo, valid, k)
    s_hi, s_lo, cnt = np.asarray(s_hi), np.asarray(s_lo), np.asarray(cnt)
    got = {}
    for h, l, c in zip(s_hi[cnt > 0], s_lo[cnt > 0], cnt[cnt > 0]):
        got[(int(h) << 32) | int(l)] = int(c)
    assert got == exp


@pytest.mark.parametrize("k", [1, 3, 16, 21, 32])
def test_packed_2bit_path_matches(k):
    """Bit-packed transfer path must equal the raw-code path exactly."""
    from krust.io.packer import pack_buffer_2bit
    from krust.models.engines import _dense_raw_step
    from krust.ops.codec import combine64
    from krust.ops.count import count_runs

    rng = random.Random(900 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 200), "ACGTacgtNn") for _ in range(10)]
    expected = oracle.count_sequences(seqs, k)
    streams = streams_from_sequences(seqs)
    got = {}
    for batch in pack_buffer_2bit(streams.codes, None, k, None, block_windows=128):
        hi, lo, w = _dense_raw_step(batch.packed2, batch.badbits, k, batch.width)
        s_hi, s_lo, cnt = count_runs(hi, lo, w > 0, k)
        s_hi, s_lo, cnt = np.asarray(s_hi), np.asarray(s_lo), np.asarray(cnt)
        live = cnt > 0
        codes64 = combine64(s_hi[live], s_lo[live])
        from krust.kmer import unpack_many

        for km, c in zip(unpack_many(codes64, k), cnt[live].tolist()):
            got[km] = got.get(km, 0) + c
    assert got == expected


def test_packed_2bit_quality():
    from krust.io.packer import pack_buffer_2bit
    from krust.models.engines import _dense_raw_step
    from krust.ops.codec import combine64
    from krust.ops.count import count_runs
    from krust.kmer import unpack_many

    rng = random.Random(33)
    records = []
    for _ in range(10):
        n = rng.randint(0, 100)
        seq = oracle.random_dna(rng, n)
        qual = "".join(chr(rng.randint(33, 73)) for _ in range(n))
        records.append((seq, qual))
    k, min_q = 5, 20
    expected = oracle.count_sequences(records, k, min_quality=min_q)
    streams = streams_from_sequences(
        [s for s, _ in records], [q.encode() for _, q in records]
    )
    got = {}
    for batch in pack_buffer_2bit(
        streams.codes, streams.qual, k, min_q + 33, block_windows=64
    ):
        hi, lo, w = _dense_raw_step(batch.packed2, batch.badbits, k, batch.width)
        s_hi, s_lo, cnt = count_runs(hi, lo, w > 0, k)
        s_hi, s_lo, cnt = np.asarray(s_hi), np.asarray(s_lo), np.asarray(cnt)
        live = cnt > 0
        codes64 = combine64(s_hi[live], s_lo[live])
        for km, c in zip(unpack_many(codes64, k), cnt[live].tolist()):
            got[km] = got.get(km, 0) + c
    assert got == expected
