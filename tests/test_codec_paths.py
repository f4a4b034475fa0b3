"""The device codec and the flat batch step vs numpy, window by window.

``encode_blocks`` (the rolling canonical codec every device path runs) is
checked per window against a direct numpy computation of each window's
forward and reverse-complement codes; the flat transfer step
(``_count_flat_step``: unpack + codec + window masking in one jitted step)
is checked per window and, on dirty streams, against ``NumpyEngine``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from krust.io.packer import blockize, pack2_full
from krust.io.reader import ParsedStreams, streams_from_sequences
from krust.kmer import INVALID_CODE
from krust.models.engines import NumpyEngine, _count_flat_step
from krust.ops.codec import encode_blocks

import oracle


def _windows(row, k, qual=None, thr=None):
    """(hi, lo, valid) of every length-k window of one code row, in u64."""
    row = np.asarray(row)
    w = row.shape[0] - k + 1
    good = row < 4
    if qual is not None:
        good = good & (np.asarray(qual) >= thr)
    b = np.where(good, row, 0).astype(np.uint64)
    comp = np.where(good, 3 - row.astype(np.int64), 0).astype(np.uint64)
    fwd = np.zeros(w, np.uint64)
    rc = np.zeros(w, np.uint64)
    valid = np.ones(w, bool)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | b[j : j + w]
        rc = (rc << np.uint64(2)) | comp[k - 1 - j : k - 1 - j + w]
        valid &= good[j : j + w]
    canon = np.minimum(fwd, rc)
    return (canon >> np.uint64(32)).astype(np.uint32), canon.astype(np.uint32), valid


def _compare(codes, k, qual=None, thr=None):
    hi, lo, valid = encode_blocks(
        jnp.asarray(codes), k, None if qual is None else jnp.asarray(qual), thr
    )
    for r in range(codes.shape[0]):
        e_hi, e_lo, e_valid = _windows(
            codes[r], k, None if qual is None else qual[r], thr
        )
        np.testing.assert_array_equal(np.asarray(hi[r]), e_hi)
        np.testing.assert_array_equal(np.asarray(lo[r]), e_lo)
        np.testing.assert_array_equal(np.asarray(valid[r]), e_valid)


@pytest.mark.parametrize("k", [1, 3, 16, 17, 21, 32])
def test_encode_blocks_matches_numpy(k):
    rng = random.Random(42 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), "ACGTN") for _ in range(10)]
    streams = streams_from_sequences(seqs)
    batch = blockize(streams.codes, None, k, block_windows=128)
    _compare(np.asarray(batch.codes), k)


@pytest.mark.parametrize("w", [128, 256, 1000, 4096])
def test_encode_blocks_widths(w):
    k = 21
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, size=(8, w + k - 1), dtype=np.uint8)
    _compare(codes, k)


def test_encode_blocks_quality_mask():
    """A base below the quality threshold poisons every window over it."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(8, 40), dtype=np.uint8)
    qual = rng.integers(33, 80, size=codes.shape, dtype=np.uint8)
    _compare(codes, 5, qual, 53)


def test_encode_blocks_odd_rows():
    # a row count that is no power of two
    k = 5
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 5, size=(3, 128 + k - 1), dtype=np.uint8)
    _compare(codes, k)


def test_encode_blocks_all_k():
    """Every k, including the hi/lo boundary cases (16, 17, 24, 31, 32)."""
    rng = np.random.default_rng(7)
    for k in range(1, 33):
        codes = rng.integers(0, 5, size=(2, 150 + k - 1), dtype=np.uint8)
        _compare(codes, k)


# --- the flat batch step ----------------------------------------------------


def _flat_batch(stream: np.ndarray, k: int, rows: int, w: int):
    """One FlatBatch-shaped (packed2, invpos, covered), built by hand."""
    seg_bases = rows * w + k - 1
    if stream.shape[0] < seg_bases:
        stream = np.concatenate(
            [stream, np.full(seg_bases - stream.shape[0], 0, np.uint8)]
        )
    t = max(stream.shape[0] - k + 1, 0)
    covered = min(rows * w, t)
    packed2 = pack2_full(stream)
    inv = np.flatnonzero(stream >= INVALID_CODE).astype(np.int32)
    p = max(8, int(2 ** np.ceil(np.log2(max(inv.shape[0], 1)))))
    invpos = np.full(p, seg_bases, np.int32)
    invpos[: inv.shape[0]] = inv
    return packed2, invpos, covered


def _step(stream, k, rows, w, mode, covered=None):
    packed2, invpos, cov = _flat_batch(stream, k, rows, w)
    return _count_flat_step(
        jnp.asarray(packed2), jnp.asarray(invpos),
        np.int32(cov if covered is None else covered), k, rows, w, mode,
    )


@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 21, 24, 32])
def test_flat_step_matches_oracle(k):
    """Window j of the step is stream window j, bit for bit."""
    rows, w = 8, 512
    rng = np.random.default_rng(k)
    stream = rng.integers(0, 4, size=rows * w + k - 1, dtype=np.uint8)
    hi, lo, wgt = _step(stream, k, rows, w, "raw")
    e_hi, e_lo, e_valid = _windows(stream, k)
    np.testing.assert_array_equal(np.asarray(hi).reshape(-1), e_hi)
    np.testing.assert_array_equal(np.asarray(lo).reshape(-1), e_lo)
    np.testing.assert_array_equal(np.asarray(wgt).reshape(-1), e_valid)


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize("mode", ["raw_sent", "raw"])
def test_flat_step_matches_numpy_engine(k, mode):
    """On a dirty stream (Ns + separators) the step's valid windows count
    exactly what NumpyEngine counts, in both output modes."""
    rng = np.random.default_rng(7 + k)
    rows, w = 8, 512
    stream = rng.integers(0, 4, size=rows * w + k - 1, dtype=np.uint8)
    bad = rng.choice(stream.shape[0], size=25, replace=False)
    stream[bad] = INVALID_CODE
    out = _step(stream, k, rows, w, mode)
    if mode == "raw_sent":
        assert (len(out) == 1) == (k <= 16)
        if len(out) == 1:  # lo-only part (k <= 16)
            codes = np.asarray(out[0]).astype(np.uint64)
            codes = codes[codes != 0xFFFFFFFF]
        else:
            hi, lo = (np.asarray(x).astype(np.uint64) for x in out)
            keep = ~((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF))
            codes = (hi[keep] << np.uint64(32)) | lo[keep]
    else:
        hi, lo, wgt = (np.asarray(x).reshape(-1) for x in out)
        keep = wgt != 0
        codes = (hi[keep].astype(np.uint64) << np.uint64(32)) | lo[keep]
    got_codes, got_counts = np.unique(codes, return_counts=True)
    exp = NumpyEngine().count(ParsedStreams(stream, None, 1, stream.shape[0]), k)
    np.testing.assert_array_equal(got_codes, exp.codes)
    np.testing.assert_array_equal(got_counts.astype(np.uint64), exp.counts)


def test_flat_step_covered_mask():
    """Windows at global index >= covered must be sentinel-keyed."""
    k, rows, w = 21, 8, 512
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 4, size=rows * w + k - 1, dtype=np.uint8)
    hi, lo = _step(stream, k, rows, w, "raw_sent", covered=100)
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    n_valid = int(np.sum(~((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF))))
    assert n_valid == 100


def test_flat_step_poisons_k_windows_per_invalid():
    """One interior invalid base must kill exactly k windows."""
    k, rows, w = 7, 8, 512
    stream = np.zeros(rows * w + k - 1, np.uint8)  # poly-A
    stream[1000] = INVALID_CODE
    _, _, covered = _flat_batch(stream, k, rows, w)
    (lo,) = _step(stream, k, rows, w, "raw_sent")
    # k <= 16 parts are lo-only; valid 7-mer codes span 14 bits, so the
    # all-ones sentinel is unambiguous
    sentinels = int(np.sum(np.asarray(lo) == 0xFFFFFFFF))
    assert sentinels == rows * w - covered + k
