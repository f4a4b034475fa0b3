"""Run-length compaction and part merge of the epoch table, vs numpy.

``compact_runs`` turns a key-sorted (SENT, SENT)-padded stream into the
distinct (key, summed count) table at the front; ``_merge_compact`` merges
two compacted parts (concatenate + sort + compaction). Sizes straddle the
powers of two and run lengths cross them, so scans and scatter ranks are
exercised at their edges.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

from krust.ops.count import SENT, compact_runs, merge_runs
from krust.ops.table import _merge_compact


def _split(keys):
    return (
        (keys >> 32).astype(np.uint32),
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def _run(keys, cnt=None, pad=0):
    hi, lo = _split(keys)
    if pad:
        hi = np.concatenate([hi, np.full(pad, SENT, np.uint32)])
        lo = np.concatenate([lo, np.full(pad, SENT, np.uint32)])
        if cnt is not None:
            cnt = np.concatenate([cnt, np.zeros(pad, np.uint32)])
    args = [jnp.asarray(hi), jnp.asarray(lo)]
    if cnt is not None:
        args.append(jnp.asarray(cnt))
    o_hi, o_lo, o_cnt, nu = compact_runs(*args)
    nu = int(nu)
    got_k = (np.asarray(o_hi[:nu]).astype(np.uint64) << np.uint64(32)) | np.asarray(
        o_lo[:nu]
    ).astype(np.uint64)
    return got_k, np.asarray(o_cnt[:nu]), nu, (np.asarray(o_hi), np.asarray(o_cnt))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 5000])
def test_unit_matches_numpy(seed, n):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, max(n // 2, 2), n).astype(np.uint64))
    got_k, got_c, nu, (full_hi, full_c) = _run(keys, pad=int(rng.integers(0, 300)))
    uq, cn = np.unique(keys, return_counts=True)
    assert nu == uq.shape[0]
    assert np.array_equal(got_k, uq)
    assert np.array_equal(got_c, cn.astype(np.uint32))
    # tail contract: sentinel keys, zero counts
    assert np.all(full_hi[nu:] == SENT)
    assert np.all(full_c[nu:] == 0)


@pytest.mark.parametrize("seed", range(3))
def test_weighted_matches_numpy(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 4000))
    keys = np.sort(rng.integers(0, max(n // 3, 2), n).astype(np.uint64))
    cnt = rng.integers(1, 1000, n).astype(np.uint32)
    got_k, got_c, nu, _ = _run(keys, cnt, pad=int(rng.integers(0, 2049)))
    uq = np.unique(keys)
    sums = np.zeros(uq.shape[0], np.uint64)
    np.add.at(sums, np.searchsorted(uq, keys), cnt)
    assert nu == uq.shape[0]
    assert np.array_equal(got_c.astype(np.uint64), sums)
    assert np.array_equal(got_k, uq)


def test_single_run_spanning_many_chunks():
    # one key repeated past several powers of two: the run sum is exact
    n = 5 * 1024 + 17
    keys = np.full(n, 42, np.uint64)
    got_k, got_c, nu, _ = _run(keys)
    assert nu == 1 and got_k[0] == 42 and got_c[0] == n


def test_all_sentinels_and_empty():
    hi = np.full(2048, SENT, np.uint32)
    o = compact_runs(jnp.asarray(hi), jnp.asarray(hi))
    assert int(o[3]) == 0
    assert np.all(np.asarray(o[0]) == SENT) and np.all(np.asarray(o[2]) == 0)
    z = jnp.zeros(0, jnp.uint32)
    o = compact_runs(z, z)
    assert int(o[3]) == 0


def test_run_boundary_at_chunk_edge():
    # runs ending exactly at 1024-multiples
    keys = np.concatenate(
        [
            np.full(1024, 1, np.uint64),
            np.full(1024, 2, np.uint64),
            np.full(100, 3, np.uint64),
        ]
    )
    got_k, got_c, nu, _ = _run(keys)
    assert nu == 3
    assert got_k.tolist() == [1, 2, 3]
    assert got_c.tolist() == [1024, 1024, 100]


def test_all_distinct():
    keys = np.arange(3000, dtype=np.uint64)
    got_k, got_c, nu, _ = _run(keys)
    assert nu == 3000
    assert np.array_equal(got_k, keys)
    assert np.all(got_c == 1)


def test_matches_merge_runs():
    """Sorted input through compact_runs and the unsorted stream through
    DeviceTable's weighted merge both equal numpy's table."""
    rng = np.random.default_rng(7)
    n = 6000
    keys = rng.integers(0, 2000, n).astype(np.uint64)
    w = rng.integers(1, 50, n).astype(np.uint32)
    exp_k, exp_c = _expected(keys, w)
    order = np.argsort(keys, kind="stable")
    hi, lo = _split(keys[order])
    c_hi, c_lo, c_cnt, c_n = compact_runs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w[order])
    )
    u_hi, u_lo = _split(keys)
    m_hi, m_lo, m_cnt, m_n = merge_runs(
        jnp.asarray(u_hi), jnp.asarray(u_lo), jnp.asarray(w), 32
    )
    for o_hi, o_lo, o_cnt, o_n in ((c_hi, c_lo, c_cnt, c_n),
                                   (m_hi, m_lo, m_cnt, m_n)):
        nu = int(o_n)
        got_k = (np.asarray(o_hi[:nu]).astype(np.uint64) << np.uint64(32)) | (
            np.asarray(o_lo[:nu]).astype(np.uint64))
        assert np.array_equal(got_k, exp_k)
        assert np.array_equal(np.asarray(o_cnt[:nu]), exp_c)
    # merge_runs pads with zeros, compact_runs with SENT keys
    assert not np.asarray(m_hi[int(m_n):]).any()
    assert not np.asarray(m_cnt[int(m_n):]).any()


def _run_1key(lo32, cnt=None, pad=0):
    lo = np.asarray(lo32, np.uint32)
    if pad:
        lo = np.concatenate([lo, np.full(pad, SENT, np.uint32)])
        if cnt is not None:
            cnt = np.concatenate([cnt, np.zeros(pad, np.uint32)])
    args = [None, jnp.asarray(lo)]
    if cnt is not None:
        args.append(jnp.asarray(cnt))
    return compact_runs(*args, one_key=True)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [1, 7, 1023, 1025, 5000])
def test_one_key_matches_two_plane(seed, n):
    """one_key (k<=16, no hi plane) must equal the 2-plane form and numpy
    on lo-only keys, sentinel tails included."""
    rng = np.random.default_rng(seed + 50)
    lo = np.sort(rng.integers(0, max(n // 2, 2), n).astype(np.uint32))
    pad = int(rng.integers(0, 300))
    o_hi1, o_lo1, o_cnt1, nu1 = _run_1key(lo, pad=pad)

    hi2 = np.zeros(lo.shape[0] + pad, np.uint32)
    lo2 = np.concatenate([lo, np.full(pad, SENT, np.uint32)])
    hi2[lo.shape[0]:] = SENT
    o_hi2, o_lo2, o_cnt2, nu2 = compact_runs(jnp.asarray(hi2), jnp.asarray(lo2))
    assert int(nu1) == int(nu2)
    assert np.array_equal(np.asarray(o_lo1), np.asarray(o_lo2))
    assert np.array_equal(np.asarray(o_cnt1), np.asarray(o_cnt2))
    assert np.array_equal(np.asarray(o_hi1), np.asarray(o_hi2))
    uq, cn = np.unique(lo, return_counts=True)
    nu = int(nu1)
    assert np.array_equal(np.asarray(o_lo1[:nu]), uq)
    assert np.array_equal(np.asarray(o_cnt1[:nu]), cn.astype(np.uint32))


def test_one_key_weighted():
    rng = np.random.default_rng(99)
    lo = np.sort(rng.integers(0, 40, 3000).astype(np.uint32))
    w = rng.integers(1, 9, 3000).astype(np.uint32)
    o_hi, o_lo, o_cnt, nu = _run_1key(lo, cnt=w, pad=111)
    nu = int(nu)
    uq = np.unique(lo)
    exp = np.array([w[lo == u].sum() for u in uq], np.uint32)
    assert nu == uq.shape[0]
    assert np.array_equal(np.asarray(o_lo[:nu]), uq)
    assert np.array_equal(np.asarray(o_cnt[:nu]), exp)
    assert (np.asarray(o_hi[:nu]) == 0).all()
    assert (np.asarray(o_hi[nu:]) == SENT).all()


def test_one_key_near_sentinel_codes():
    """Real codes adjacent to the sentinel (0xFFFFFFFE etc.) stay distinct
    from the padding — the k=16 collision-freedom contract."""
    lo = np.sort(
        np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFE, 0xFFFFFFFD], np.uint32)
    )
    o_hi, o_lo, o_cnt, nu = _run_1key(lo, pad=200)
    nu = int(nu)
    assert nu == 4
    assert np.asarray(o_lo[:nu]).tolist() == [0, 1, 0xFFFFFFFD, 0xFFFFFFFE]
    assert np.asarray(o_cnt[:nu]).tolist() == [1, 1, 1, 2]


# --- part merge: concatenate + sort + compaction ---------------------------


def _part(keys, cnt, pad=0):
    """Compacted-part planes (hi, lo, cnt) with (SENT, SENT, 0) padding."""
    hi, lo = _split(np.asarray(keys, np.uint64))
    cnt = np.asarray(cnt, np.uint32)
    if pad:
        hi = np.concatenate([hi, np.full(pad, SENT, np.uint32)])
        lo = np.concatenate([lo, np.full(pad, SENT, np.uint32)])
        cnt = np.concatenate([cnt, np.zeros(pad, np.uint32)])
    return tuple(jnp.asarray(x) for x in (hi, lo, cnt))


def _merged(a, b, one_key=False):
    o_hi, o_lo, o_cnt, n = _merge_compact(a, b, 16 if one_key else 32)
    n = int(n)
    keys = (np.asarray(o_hi[:n]).astype(np.uint64) << np.uint64(32)) | np.asarray(
        o_lo[:n]
    ).astype(np.uint64)
    if one_key:
        keys = np.asarray(o_lo[:n]).astype(np.uint64)
    return keys, np.asarray(o_cnt[:n]).astype(np.uint64)


def _expected(keys, cnts):
    keys = np.asarray(keys, np.uint64)
    uq = np.unique(keys)
    sums = np.zeros(uq.shape[0], np.uint64)
    np.add.at(sums, np.searchsorted(uq, keys), np.asarray(cnts, np.uint64))
    return uq, sums


def _check(a_keys, a_cnt, b_keys, b_cnt, one_key=False, a_pad=0, b_pad=0):
    got = _merged(
        _part(a_keys, a_cnt, a_pad), _part(b_keys, b_cnt, b_pad), one_key
    )
    exp = _expected(
        np.concatenate([a_keys, b_keys]), np.concatenate([a_cnt, b_cnt])
    )
    assert np.array_equal(got[0], exp[0])
    assert np.array_equal(got[1], exp[1])


def _distinct_sorted(rng, m, space):
    return np.unique(rng.integers(0, space, m, np.int64).astype(np.uint64))


@pytest.mark.parametrize("m", [2048, 2 * 2048, 3 * 2048 + 64, 10_000])
def test_random_merge(m):
    rng = np.random.default_rng(m)
    a = _distinct_sorted(rng, m, 1 << 32)
    b = _distinct_sorted(rng, m, 1 << 32)
    _check(a, np.ones(a.shape[0]), b, np.ones(b.shape[0]), one_key=True)


def test_skewed_merge():
    """All of a sorts before b, and the reverse."""
    m = 4 * 2048
    a = np.arange(m, dtype=np.uint64)
    b = np.arange(m, dtype=np.uint64) + np.uint64(1 << 20)
    ca = np.full(m, 3)
    cb = np.full(m, 5)
    _check(a, ca, b, cb, one_key=True)
    _check(b, cb, a, ca, one_key=True)


def test_interleaved_and_duplicates():
    rng = np.random.default_rng(7)
    a = _distinct_sorted(rng, 2 * 2048, 50)
    b = _distinct_sorted(rng, 2 * 2048, 50)
    _check(a, rng.integers(1, 9, a.shape[0]), b, rng.integers(1, 9, b.shape[0]),
           one_key=True)


def test_sentinel_padding_tail():
    """SENT-padded tails merge to the back like +inf and drop out."""
    rng = np.random.default_rng(3)
    a = _distinct_sorted(rng, 2048, 1 << 30)
    b = _distinct_sorted(rng, 1024, 1 << 30)
    _check(a, np.ones(a.shape[0]), b, np.ones(b.shape[0]), one_key=True,
           b_pad=1024)


class TestKeyedMerge:
    """(hi, lo, cnt) merge: exact summed counts under any duplication."""

    def _case(self, m, key_space, seed):
        r = np.random.default_rng(seed)
        a = _distinct_sorted(r, m, key_space)
        b = _distinct_sorted(r, m, key_space)
        _check(a, r.integers(1, 100, a.shape[0]), b, r.integers(1, 100, b.shape[0]),
               a_pad=64, b_pad=3)

    def test_sparse_keys(self):
        self._case(2048, 1 << 40, 2)

    def test_dense_duplicates(self):
        self._case(2 * 2048, 50, 3)

    def test_partial_tail(self):
        self._case(3 * 2048 + 64, 1 << 20, 4)

    def test_extreme_duplication(self):
        self._case(4 * 2048, 8, 5)

    def test_single_key(self):
        self._case(2 * 2048, 1, 6)


def test_unequal_shapes_rejected():
    """A part whose planes disagree in length cannot be merged."""
    z = jnp.zeros(256, jnp.uint32)
    with pytest.raises((TypeError, ValueError)):
        _merge_compact((z, z, z), (z, z, jnp.zeros(128, jnp.uint32)), 32)


def test_empty_inputs():
    z = jnp.zeros(0, jnp.uint32)
    for one_key in (False, True):
        o_hi, o_lo, o_cnt, n = _merge_compact((z, z, z), (z, z, z), 16 if one_key else 32)
        assert o_hi.shape == o_lo.shape == o_cnt.shape == (0,)
        assert int(n) == 0


def test_sent_saturated_input():
    """One side entirely padding: the other side comes back unchanged."""
    rng = np.random.default_rng(8)
    a = _distinct_sorted(rng, 2 * 2048, 1 << 30)
    ca = rng.integers(1, 9, a.shape[0])
    empty = np.zeros(0, np.uint64)
    for one_key in (False, True):
        _check(a, ca, empty, np.zeros(0), one_key=one_key, b_pad=2 * 2048)


def test_kv_unequal_lengths():
    """A small compacted part merges into a large one."""
    r = np.random.default_rng(11)
    for ma, mb in [(2048, 7 * 2048), (5 * 2048 + 100, 300), (1, 2 * 2048)]:
        a = _distinct_sorted(r, ma, 1 << 20)
        b = _distinct_sorted(r, mb, 1 << 20)
        _check(a, r.integers(1, 100, a.shape[0]), b, r.integers(1, 100, b.shape[0]))


class TestMergeOneKey:
    """One-key (k<=16) merge: no hi plane. Differential vs the two-plane
    merge with zero hi planes and vs numpy."""

    @pytest.mark.parametrize("seed", range(3))
    def test_random_matches_kv_and_numpy(self, seed):
        rng = np.random.default_rng(seed + 7)
        a = _distinct_sorted(rng, int(rng.integers(1, 4000)), 500)
        b = _distinct_sorted(rng, int(rng.integers(1, 4000)), 500)
        ca = rng.integers(1, 100, a.shape[0])
        cb = rng.integers(1, 100, b.shape[0])
        one = _merged(_part(a, ca), _part(b, cb), one_key=True)
        two = _merged(_part(a, ca), _part(b, cb))
        exp = _expected(np.concatenate([a, b]), np.concatenate([ca, cb]))
        for got in (one, two):
            assert np.array_equal(got[0], exp[0])
            assert np.array_equal(got[1], exp[1])

    def test_sentinel_tail_and_near_sentinel(self):
        a = np.array([1, 5, 0xFFFFFFFE], np.uint64)
        b = np.array([5, 0xFFFFFFFD], np.uint64)
        keys, cnts = _merged(
            _part(a, [2, 3, 4], pad=2), _part(b, [7, 9]), one_key=True
        )
        assert keys.tolist() == [1, 5, 0xFFFFFFFD, 0xFFFFFFFE]
        assert cnts.tolist() == [2, 10, 9, 4]

    def test_empty_sides(self):
        a = np.array([3, 4], np.uint64)
        empty = np.zeros(0, np.uint64)
        for first, second in ((a, empty), (empty, a)):
            keys, cnts = _merged(
                _part(first, np.ones(first.shape[0])),
                _part(second, np.ones(second.shape[0])),
                one_key=True,
            )
            assert keys.tolist() == [3, 4] and cnts.tolist() == [1, 1]


def test_merge_counts_survive_as_multiset():
    """Every input (key, count) lands in exactly one output entry."""
    r = np.random.default_rng(12)
    a = _distinct_sorted(r, 3000, 1 << 12)
    b = _distinct_sorted(r, 3000, 1 << 12)
    ca, cb = r.integers(1, 50, a.shape[0]), r.integers(1, 50, b.shape[0])
    keys, cnts = _merged(_part(a, ca), _part(b, cb))
    total = collections.Counter()
    for k_, c_ in zip(np.concatenate([a, b]).tolist(), np.concatenate([ca, cb]).tolist()):
        total[k_] += c_
    assert dict(zip(keys.tolist(), cnts.tolist())) == dict(total)
