"""DeviceTable (on-device accumulator) tests."""

import numpy as np

from krust.ops.count import count_unique
from krust.ops.table import DeviceTable
from krust.models.engines import _HostAccumulator


def _batch(rng, n, key_space):
    hi = rng.integers(0, 2, size=n, dtype=np.uint32)
    lo = rng.integers(0, key_space, size=n, dtype=np.uint32)
    valid = rng.random(n) < 0.9
    return hi, lo, valid


def test_table_matches_host_merge():
    rng = np.random.default_rng(0)
    table = DeviceTable(max_parts=3)
    expected: dict[int, int] = {}
    for _ in range(10):
        hi, lo, valid = _batch(rng, 1000, 50)
        u_hi, u_lo, u_cnt, _ = count_unique(hi, lo, valid)
        table.add(u_hi, u_lo, u_cnt, 1000)
        for h, l, v in zip(hi.tolist(), lo.tolist(), valid.tolist()):
            if v:
                key = (h << 32) | l
                expected[key] = expected.get(key, 0) + 1
    codes, counts = table.finalize()
    got = dict(zip(codes.tolist(), counts.tolist()))
    assert got == expected


def test_table_empty():
    table = DeviceTable()
    codes, counts = table.finalize()
    assert codes.shape[0] == 0 and counts.shape[0] == 0


def test_table_epoch_flush_merges_in_host_acc():
    """Simulates the engine's epoch flush: two epochs merge exactly."""
    rng = np.random.default_rng(1)
    acc = _HostAccumulator()
    expected: dict[int, int] = {}
    for _epoch in range(2):
        table = DeviceTable(max_parts=2)
        for _ in range(4):
            hi, lo, valid = _batch(rng, 500, 20)
            u_hi, u_lo, u_cnt, _ = count_unique(hi, lo, valid)
            table.add(u_hi, u_lo, u_cnt, 500)
            for h, l, v in zip(hi.tolist(), lo.tolist(), valid.tolist()):
                if v:
                    key = (h << 32) | l
                    expected[key] = expected.get(key, 0) + 1
        acc.add(*table.finalize())
    codes, counts = acc.result()
    got = dict(zip(codes.tolist(), counts.tolist()))
    assert got == expected


def test_table_with_small_k_sentinel_merge():
    """k-aware sentinel merge path must agree with the k=32 fallback."""
    rng = np.random.default_rng(2)
    for k in (5, 15, 16, 21, 31):
        max_code = (1 << (2 * k)) - 1
        expected = {}
        tables = [DeviceTable(k, max_parts=2), DeviceTable(32, max_parts=2)]
        for _ in range(5):
            code = rng.integers(0, min(max_code, 2**50), size=600, dtype=np.uint64)
            hi = (code >> np.uint64(32)).astype(np.uint32)
            lo = code.astype(np.uint32)
            valid = rng.random(600) < 0.9
            u = count_unique(hi, lo, valid)
            for t in tables:
                t.add(u[0], u[1], u[2], 600)
            for c, v in zip(code.tolist(), valid.tolist()):
                if v:
                    expected[c] = expected.get(c, 0) + 1
        results = [t.finalize() for t in tables]
        for codes, counts in results:
            got = dict(zip(codes.tolist(), counts.tolist()))
            assert got == expected, k


def test_table_delta_pull_exception_heavy():
    """Delta pull with huge gaps: most entries are exceptions; still exact."""
    rng = np.random.default_rng(3)
    # k=13 -> space 4^13 = 67M and n*2^22 >> space, so the delta path runs,
    # but mean gap ~1M >> 2^24 so most deltas overflow to exceptions
    table = DeviceTable(k=13, max_parts=2)
    expected = {}
    for _ in range(3):
        code = rng.integers(0, 1 << 26, size=64, dtype=np.uint64)
        valid = rng.random(64) < 0.9
        hi = (code >> np.uint64(32)).astype(np.uint32)
        lo = code.astype(np.uint32)
        table.add(hi, lo, valid.astype(np.uint32), 64)
        for c, v in zip(code.tolist(), valid.tolist()):
            if v:
                expected[c] = expected.get(c, 0) + 1
    codes, counts = table.finalize()
    assert dict(zip(codes.tolist(), counts.tolist())) == expected
    assert np.all(np.diff(codes.astype(np.int64)) > 0)


def test_table_packed_delta_pull_exact():
    """Bit-packed delta pull (16/20/24-bit pairs + 4-bit counts) is exact.

    k picks the bit width via the mean-gap heuristic: k=12 -> 16-bit,
    k=13 -> 20-bit, k=16 -> 24-bit at ~6k distinct codes. Counts include
    values above the 4-bit saturation point (re-gathered exactly).
    """
    rng = np.random.default_rng(4)
    for k, want_bits in ((12, 16), (13, 20), (16, 24)):
        space = 1 << (2 * k)
        codes = np.unique(rng.integers(0, space, size=6500, dtype=np.uint64))
        assert codes.shape[0] >= 4096
        cnts = rng.integers(1, 31, size=codes.shape[0], dtype=np.uint32)
        table = DeviceTable(k=k, max_parts=2)
        seen_bits = []
        orig = DeviceTable._finalize_delta_packed

        def spy(self, t_hi, t_lo, t_cnt, n, cap, bits, _orig=orig):
            seen_bits.append(bits)
            return _orig(self, t_hi, t_lo, t_cnt, n, cap, bits)

        DeviceTable._finalize_delta_packed = spy
        try:
            hi = (codes >> np.uint64(32)).astype(np.uint32)
            lo = codes.astype(np.uint32)
            # weights-as-counts: the window total keeps mean count <= 6
            table.add(hi, lo, cnts, n_windows=codes.shape[0])
            got_codes, got_counts = table.finalize()
        finally:
            DeviceTable._finalize_delta_packed = orig
        assert seen_bits == [want_bits], (k, seen_bits)
        assert np.array_equal(got_codes, codes), k
        assert np.array_equal(got_counts, cnts.astype(np.uint64)), k


def test_table_packed_pull_declined_on_heavy_duplication():
    """Mean count above the 4-bit regime keeps the 3-byte/8-bit pull."""
    rng = np.random.default_rng(5)
    codes = np.unique(rng.integers(0, 1 << 24, size=5000, dtype=np.uint64))
    cnts = np.full(codes.shape[0], 200, np.uint32)
    table = DeviceTable(k=12, max_parts=2)
    called = []
    orig = DeviceTable._finalize_delta_packed
    DeviceTable._finalize_delta_packed = (
        lambda self, *a, **kw: called.append(1) or orig(self, *a, **kw)
    )
    try:
        # window total 200x the distinct count -> mean count 200 >> 6
        table.add(
            (codes >> np.uint64(32)).astype(np.uint32),
            codes.astype(np.uint32),
            cnts,
            n_windows=codes.shape[0] * 200,
        )
        got_codes, got_counts = table.finalize()
    finally:
        DeviceTable._finalize_delta_packed = orig
    assert not called
    assert np.array_equal(got_codes, codes)
    assert np.array_equal(got_counts, cnts.astype(np.uint64))


class TestEpochNarrowHiSort:
    """The narrowed-hi epoch sort (k 17..23) must be exact at every dtype
    boundary, including max-valid-hi keys and sentinel stripping."""

    def test_hi_sort_dtype_gates(self):
        import jax.numpy as jnp

        from krust.ops.table import _hi_sort_dtype

        # round 5: sentinels are the all-ones PAIR (never a canonical
        # k-mer), so the gates are inclusive — k=20 rides u8, k=24 u16
        assert _hi_sort_dtype(17) is jnp.uint8
        assert _hi_sort_dtype(19) is jnp.uint8  # hi_bits=6
        assert _hi_sort_dtype(20) is jnp.uint8  # hi_bits=8: pair-sentinel
        assert _hi_sort_dtype(21) is jnp.uint16  # hi_bits=10
        assert _hi_sort_dtype(23) is jnp.uint16  # hi_bits=14
        assert _hi_sort_dtype(24) is jnp.uint16  # hi_bits=16: pair-sentinel
        assert _hi_sort_dtype(25) is None  # hi_bits=18
        assert _hi_sort_dtype(32) is None

    def test_epoch_table_exact_at_boundaries(self):
        from krust.ops.table import EpochTable

        rng = np.random.default_rng(7)
        sent = np.uint32(0xFFFFFFFF)
        for k in (17, 19, 20, 21, 23, 24, 25):
            hi_bits = 2 * (k - 16)
            hi_max = (1 << hi_bits) - 1
            table = EpochTable(k=k, max_parts=2)
            expected: dict[int, int] = {}
            for _ in range(3):
                n = 4096
                hi = rng.integers(0, hi_max + 1, n).astype(np.uint32)
                lo = rng.integers(0, 1 << 32, n, np.uint64).astype(np.uint32)
                # force boundary keys: max-valid hi (must NOT be taken for
                # a sentinel after the narrow sort) and lo == all-ones —
                # but never the all-ones PAIR, which is reserved for
                # sentinels (it is the all-T k-mer, never canonical)
                hi[:64] = hi_max
                lo[64:96] = sent
                reserved = (hi == hi_max) & (lo == sent)
                lo[reserved] = sent - 1
                invalid = rng.random(n) < 0.1
                hi[invalid] = sent
                lo[invalid] = sent
                table.add(hi, lo, None, n)
                for h, l, inv in zip(hi.tolist(), lo.tolist(), invalid.tolist()):
                    if not inv:
                        key = (h << 32) | l
                        expected[key] = expected.get(key, 0) + 1
            codes, counts = table.finalize()
            got = dict(zip(codes.tolist(), counts.tolist()))
            assert got == expected, f"k={k}"
