"""Flat transfer path + slim table pull: differential and edge-case tests."""

import numpy as np
import pytest

from krust.io.packer import (
    flat_batch_widths,
    flat_batches,
    invalid_positions,
    pack2_full,
)
from krust.io.reader import ParsedStreams
from krust.kmer import INVALID_CODE
from krust.models.engines import BatchEngine, NumpyEngine
from krust.utils.config import EngineConfig


def _random_stream(rng, n, p_invalid=0.0):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    if p_invalid > 0:
        bad = rng.random(n) < p_invalid
        codes[bad] = INVALID_CODE
    return codes


def _counts_equal(a, b):
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.counts, b.counts)


@pytest.mark.parametrize("k", [1, 2, 5, 15, 16, 17, 21, 26, 27, 31, 32])
def test_flat_matches_numpy_across_k(k):
    rng = np.random.default_rng(k)
    codes = _random_stream(rng, 5000, p_invalid=0.01)
    streams = ParsedStreams(codes, None, 1, 5000)
    cfg = EngineConfig(block_windows=256, batch_rows=8)
    flat = BatchEngine(cfg).count(streams, k)
    oracle = NumpyEngine(cfg).count(streams, k)
    _counts_equal(flat, oracle)


@pytest.mark.parametrize("k", [3, 21])
def test_dense_fallback_matches_numpy(k):
    """>1/32 invalid bases routes to the dense badbits path."""
    rng = np.random.default_rng(7)
    codes = _random_stream(rng, 4000, p_invalid=0.2)
    streams = ParsedStreams(codes, None, 1, 4000)
    cfg = EngineConfig(block_windows=256, batch_rows=8)
    assert flat_batches(codes, None, k, None, 256, 8) is None
    dense = BatchEngine(cfg).count(streams, k)
    oracle = NumpyEngine(cfg).count(streams, k)
    _counts_equal(dense, oracle)


def test_flat_vs_dense_same_result():
    rng = np.random.default_rng(3)
    codes = _random_stream(rng, 3000, p_invalid=0.005)
    streams = ParsedStreams(codes, None, 1, 3000)
    flat = BatchEngine(EngineConfig(block_windows=256, batch_rows=8)).count(
        streams, 9
    )
    dense = BatchEngine(
        EngineConfig(block_windows=256, batch_rows=8, use_flat=False)
    ).count(streams, 9)
    _counts_equal(flat, dense)


@pytest.mark.parametrize(
    "n", [0, 1, 4, 7, 20, 255, 256, 257, 275, 276, 277, 1000]
)
def test_flat_tail_sizes(n):
    """Tails around block/byte boundaries (k=21, W=256: t=n-20)."""
    rng = np.random.default_rng(n)
    codes = _random_stream(rng, n) if n else np.zeros(0, np.uint8)
    streams = ParsedStreams(codes, None, 1, n)
    cfg = EngineConfig(block_windows=256, batch_rows=8)
    flat = BatchEngine(cfg).count(streams, 21)
    oracle = NumpyEngine(cfg).count(streams, 21)
    _counts_equal(flat, oracle)


def test_flat_quality_folded_into_positions():
    rng = np.random.default_rng(11)
    n = 2000
    codes = _random_stream(rng, n)
    qual = rng.integers(33, 90, size=n, dtype=np.uint8)
    streams = ParsedStreams(codes, qual, 1, n)
    cfg = EngineConfig(block_windows=256, batch_rows=8)
    # threshold passes most bases -> sparse path eligible
    flat = BatchEngine(cfg).count(streams, 7, min_quality=2)
    oracle = NumpyEngine(cfg).count(streams, 7, min_quality=2)
    _counts_equal(flat, oracle)


def test_pack2_full_roundtrip():
    rng = np.random.default_rng(5)
    for n in (0, 1, 3, 4, 5, 8, 1023):
        codes = rng.integers(0, 5, size=n, dtype=np.uint8)
        packed = pack2_full(codes)
        assert packed.shape[0] == -(-n // 4)
        shifts = np.array([6, 4, 2, 0], np.uint8)
        unpacked = ((packed[:, None] >> shifts) & 3).reshape(-1)[:n]
        assert np.array_equal(unpacked, codes & 3)


def test_invalid_positions_with_quality():
    codes = np.array([0, 1, 4, 2, 3], np.uint8)
    qual = np.array([70, 33, 0xFF, 70, 70], np.uint8)
    pos = invalid_positions(codes, qual, 53)
    assert pos.tolist() == [1, 2]


def test_count_saturation_uint8_exception_path():
    """A count above 0xFF survives the uint8 slim pull exactly."""
    n = 70_000
    codes = np.zeros(n, np.uint8)  # poly-A: one k-mer, count n-k+1 >> 255
    streams = ParsedStreams(codes, None, 1, n)
    cfg = EngineConfig(block_windows=256, batch_rows=32)
    res = BatchEngine(cfg).count(streams, 5)
    assert res.distinct == 1
    assert int(res.counts[0]) == n - 5 + 1


def test_epoch_flush_merges_exactly(monkeypatch):
    """Force tiny epochs; multi-epoch merge must equal single-epoch counts."""
    import krust.ops.table as table_mod

    rng = np.random.default_rng(19)
    codes = _random_stream(rng, 6000, p_invalid=0.01)
    streams = ParsedStreams(codes, None, 1, 6000)
    cfg = EngineConfig(block_windows=256, batch_rows=8)
    oracle = NumpyEngine(cfg).count(streams, 11)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 4096)
    import krust.models.engines as eng_mod

    monkeypatch.setattr(eng_mod, "EPOCH_WINDOW_LIMIT", 4096, raising=False)
    res = BatchEngine(cfg).count(streams, 11)
    _counts_equal(res, oracle)


def test_finalize_codes_sorted():
    rng = np.random.default_rng(23)
    codes = _random_stream(rng, 4000)
    streams = ParsedStreams(codes, None, 1, 4000)
    for k in (8, 21, 29):
        res = BatchEngine(EngineConfig(block_windows=256, batch_rows=8)).count(
            streams, k
        )
        assert np.all(np.diff(res.codes.astype(np.uint64)) > 0)


def test_flat_halo_wider_than_block_falls_back():
    """block_windows < k-1 routes to the dense path (halo cannot fit)."""
    rng = np.random.default_rng(29)
    codes = _random_stream(rng, 500)
    assert flat_batches(codes, None, 31, None, 24, 8) is None
    streams = ParsedStreams(codes, None, 1, 500)
    cfg = EngineConfig(block_windows=24, batch_rows=8)
    res = BatchEngine(cfg).count(streams, 31)
    oracle = NumpyEngine(cfg).count(streams, 31)
    _counts_equal(res, oracle)


class TestProgressCadence:
    """Per-batch progress (reference fires per sequence: src/run.rs:586-654).

    The device engine must report >= 2 monotonic snapshots on a multi-batch
    input — not one 0%->100% jump after all batches (round-1 regression)."""

    def _run(self, use_flat):
        from krust.utils.progress import ProgressTracker

        rng = np.random.default_rng(3)
        codes = _random_stream(rng, 40_000, p_invalid=0.0 if use_flat else 0.2)
        streams = ParsedStreams(codes, None, 10, 40_000)
        cfg = EngineConfig(block_windows=1024, batch_rows=8, use_flat=use_flat)
        snaps = []
        tracker = ProgressTracker()
        BatchEngine(cfg).count(streams, 9, progress=snaps.append, tracker=tracker)
        return snaps

    @pytest.mark.parametrize("use_flat", [True, False])
    def test_multiple_monotonic_snapshots(self, use_flat):
        snaps = self._run(use_flat)
        assert len(snaps) >= 3  # several batches + the true-up
        bases = [s.bases_processed for s in snaps]
        assert bases == sorted(bases)
        assert 0 < bases[0] < 40_000  # first snapshot is a real partial
        assert snaps[-1].bases_processed == 40_000
        assert snaps[-1].sequences_processed == 10

    def test_sharded_progress_cadence(self):
        from krust.parallel.mesh import make_mesh
        from krust.parallel.sharded import count_sharded
        from krust.utils.progress import ProgressTracker

        rng = np.random.default_rng(4)
        codes = _random_stream(rng, 40_000)
        streams = ParsedStreams(codes, None, 10, 40_000)
        cfg = EngineConfig(block_windows=1024, batch_rows=8)
        snaps = []
        count_sharded(
            streams, 9, mesh=make_mesh(), config=cfg,
            progress=snaps.append, tracker=ProgressTracker(),
        )
        assert len(snaps) >= 2
        bases = [s.bases_processed for s in snaps]
        assert bases == sorted(bases)
        assert snaps[-1].bases_processed == 40_000
        assert snaps[-1].sequences_processed == 10


class TestFlatBatchWidths:
    """flat_batch_widths is the cheap metadata twin of flat_batches: same
    per-batch padded invpos widths, same flat-vs-dense decision, no pack."""

    @pytest.mark.parametrize("n,k,ninv", [(0, 5, 0), (3, 5, 0), (2000, 5, 20),
                                          (5000, 21, 100), (777, 31, 3)])
    def test_widths_match_actual(self, n, k, ninv):
        rng = np.random.default_rng(n + k)
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        if ninv and n:
            codes[rng.choice(n, size=min(ninv, n), replace=False)] = 4
        w, rows = 128, 4
        widths = flat_batch_widths(codes, None, k, None, w, rows)
        flat = flat_batches(codes, None, k, None, w, rows)
        assert widths is not None and flat is not None
        actual = [b.invpos.shape[0] for b in flat]
        assert widths == actual

    def test_dirty_decision_matches(self):
        rng = np.random.default_rng(9)
        codes = rng.integers(0, 4, 1000, dtype=np.uint8)
        codes[rng.choice(1000, size=100, replace=False)] = 4  # > 1/32 dirty
        assert flat_batch_widths(codes, None, 5, None, 128, 4) is None
        assert flat_batches(codes, None, 5, None, 128, 4) is None

    def test_quality_threshold_included(self):
        rng = np.random.default_rng(11)
        codes = rng.integers(0, 4, 3000, dtype=np.uint8)
        qual = np.full(3000, 70, np.uint8)
        qual[rng.choice(3000, size=40, replace=False)] = 35
        widths = flat_batch_widths(codes, qual, 7, 53, 128, 4)
        flat = flat_batches(codes, qual, 7, 53, 128, 4)
        assert widths == [b.invpos.shape[0] for b in flat]


class TestPrefetchFeed:
    """Double-buffered feed (round 5): identical results, clean teardown."""

    def test_depth_invariance(self):
        rng = np.random.default_rng(21)
        codes = rng.integers(0, 4, 9000, dtype=np.uint8)
        codes[rng.choice(9000, size=40, replace=False)] = INVALID_CODE
        streams = ParsedStreams(codes, None, 1, codes.shape[0])
        outs = []
        for depth in (0, 2, 5):
            cfg = EngineConfig(
                block_windows=256, batch_rows=4, feed_depth=depth
            )
            outs.append(BatchEngine(cfg).count(streams, 13))
        for o in outs[1:]:
            assert np.array_equal(o.codes, outs[0].codes)
            assert np.array_equal(o.counts, outs[0].counts)

    def test_error_propagates(self):
        from krust.models.engines import _prefetch_staged

        def gen():
            yield 1
            raise RuntimeError("reader exploded")

        it = _prefetch_staged(gen(), lambda x: x * 2, depth=2)
        assert next(it) == 2
        with pytest.raises(RuntimeError, match="reader exploded"):
            list(it)

    def test_early_abandon_no_deadlock(self):
        import threading

        from krust.models.engines import _prefetch_staged

        n_live = threading.active_count()
        it = _prefetch_staged(iter(range(1000)), lambda x: x, depth=1)
        assert next(it) == 0
        it.close()  # GeneratorExit -> finally -> stop.set()
        for _ in range(100):
            if threading.active_count() <= n_live:
                break
            import time

            time.sleep(0.05)
        assert threading.active_count() <= n_live + 1

    def test_stage_runs_on_worker(self):
        import threading

        from krust.models.engines import _prefetch_staged

        main = threading.current_thread().name
        seen = []

        def stage(x):
            seen.append(threading.current_thread().name)
            return x

        assert list(_prefetch_staged(iter([1, 2]), stage, depth=2)) == [1, 2]
        assert all(name != main for name in seen)
