"""Epoch-sort table (use_epoch_sort): differential vs oracle and DeviceTable."""

import numpy as np
import pytest

from krust.io.reader import ParsedStreams
from krust.kmer import INVALID_CODE
from krust.models.engines import BatchEngine, NumpyEngine
from krust.utils.config import EngineConfig


def _stream(rng, n, p_invalid=0.0):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    if p_invalid:
        codes[rng.random(n) < p_invalid] = INVALID_CODE
    return codes


def _cfg(batch_rows=8):
    return EngineConfig(block_windows=256, batch_rows=batch_rows, use_epoch_sort=True)


@pytest.mark.parametrize("k", [1, 5, 15, 16, 17, 21, 31, 32])
def test_epoch_table_matches_oracle(k):
    rng = np.random.default_rng(k + 100)
    codes = _stream(rng, 6000, p_invalid=0.01)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    got = BatchEngine(_cfg()).count(streams, k)
    exp = NumpyEngine(EngineConfig()).count(streams, k)
    assert np.array_equal(got.codes, exp.codes)
    assert np.array_equal(got.counts, exp.counts)


def test_epoch_table_dense_path():
    rng = np.random.default_rng(9)
    codes = _stream(rng, 4000, p_invalid=0.2)  # routes to dense badbits path
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    got = BatchEngine(_cfg()).count(streams, 11)
    exp = NumpyEngine(EngineConfig()).count(streams, 11)
    assert np.array_equal(got.codes, exp.codes)
    assert np.array_equal(got.counts, exp.counts)


def test_epoch_table_homopolymer_counts():
    codes = np.zeros(70_000, np.uint8)  # one k-mer, count >> 255
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    res = BatchEngine(_cfg(batch_rows=32)).count(streams, 5)
    assert res.distinct == 1 and int(res.counts[0]) == 70_000 - 4


def test_epoch_table_window_limit_flush(monkeypatch):
    import krust.ops.table as table_mod

    rng = np.random.default_rng(19)
    codes = _stream(rng, 6000, p_invalid=0.01)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    exp = NumpyEngine(EngineConfig()).count(streams, 11)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 4096)
    got = BatchEngine(_cfg()).count(streams, 11)
    assert np.array_equal(got.codes, exp.codes)
    assert np.array_equal(got.counts, exp.counts)


def test_epoch_table_vs_device_table():
    """The retired-default DeviceTable remains the on-device oracle: both
    table designs must agree bit-for-bit."""
    rng = np.random.default_rng(77)
    codes = _stream(rng, 9000, p_invalid=0.02)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    a = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, use_epoch_sort=True)).count(streams, 17)
    b = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, use_epoch_sort=False)).count(streams, 17)
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.counts, b.counts)


@pytest.mark.slow
def test_epoch_table_raw_epoch_entry_flush(monkeypatch):
    """Force the raw-entry epoch limit so multiple sort+rle flushes and the
    compacted-part merge path execute."""
    import krust.ops.table as table_mod

    monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", 2048)
    rng = np.random.default_rng(5)
    codes = _stream(rng, 20_000, p_invalid=0.01)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    got = BatchEngine(_cfg()).count(streams, 13)
    exp = NumpyEngine(EngineConfig()).count(streams, 13)
    assert np.array_equal(got.codes, exp.codes)
    assert np.array_equal(got.counts, exp.counts)


def test_k16_one_op_sentinel_safety():
    """k=16 rides the 1-operand epoch sort (round 4): codes span all 32
    bits, so the invalid-window sentinel 0xFFFFFFFF is only safe because
    the all-T k-mer is never canonical (its RC is all-A == 0). Feed
    poly-T runs abutting Ns — codes adjacent to the sentinel — and require
    exact equality with the oracle."""
    t = np.full(600, 3, np.uint8)  # poly-T: fwd code all-ones
    n = np.full(3, INVALID_CODE, np.uint8)
    rng = np.random.default_rng(16)
    codes = np.concatenate([t, n, _stream(rng, 3000), n, t])
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    got = BatchEngine(_cfg()).count(streams, 16)
    exp = NumpyEngine(EngineConfig()).count(streams, 16)
    assert np.array_equal(got.codes, exp.codes)
    assert np.array_equal(got.counts, exp.counts)
    # the all-A canonical code (poly-T folded) dominates
    assert got.codes[0] == 0 and got.counts[0] >= 2 * (600 - 15)


class TestAdaptiveAndScaledLimits:
    """Memory-derived entry limits + duplication-adaptive epoch sizing."""

    def test_env_override_pins_limits(self, monkeypatch):
        import krust.ops.table as table_mod

        monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "12345")
        monkeypatch.setenv("KRUST_PENDING_ENTRIES", "6789")
        assert table_mod.epoch_entry_limit() == 12345
        t = table_mod.EpochTable(k=11)
        assert t._epoch_limit == 12345
        assert t._pending_limit == 6789
        assert t._adaptive is False  # explicit pin disables adaptation

    def test_hbm_scaling(self, monkeypatch):
        """The budget is a share of the device's bytes_limit over the
        measured peak bytes per epoch entry."""
        import krust.ops.table as table_mod

        monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
        bpe = table_mod.EPOCH_BYTES_PER_ENTRY
        limit = 80 << 30
        monkeypatch.setattr(table_mod, "_MEM_CACHE", limit)
        assert table_mod.epoch_entry_limit() == int(
            limit * table_mod._MEMORY_SHARE
        ) // bpe
        # twice the memory, twice the budget
        monkeypatch.setattr(table_mod, "_MEM_CACHE", 2 * limit)
        assert table_mod.epoch_entry_limit() == int(
            2 * limit * table_mod._MEMORY_SHARE
        ) // bpe
        # simulate a tiny device: the 1M floor holds
        monkeypatch.setattr(table_mod, "_MEM_CACHE", 1 << 20)
        assert table_mod.epoch_entry_limit() == 1 << 20
        # no memory limit reported (XLA on the CPU): the fixed budget
        monkeypatch.setattr(table_mod, "_MEM_CACHE", None)
        assert table_mod.epoch_entry_limit() == table_mod.EPOCH_ENTRY_LIMIT

    def test_pending_limit_follows_memory(self, monkeypatch):
        import krust.ops.table as table_mod

        monkeypatch.delenv("KRUST_PENDING_ENTRIES", raising=False)
        monkeypatch.setattr(table_mod, "_MEM_CACHE", 64 << 30)
        t = table_mod.DeviceTable(k=21)
        assert t._pending_limit == int(
            (64 << 30) * table_mod._MEMORY_SHARE
        ) // table_mod.DeviceTable.MERGE_BYTES_PER_ENTRY

    def test_adaptive_epoch_shrinks_on_duplication(self, monkeypatch):
        """High-duplication input retunes the epoch limit after epoch 1
        (to ADAPT_DUP_TARGET * distinct) and stays exact vs the oracle."""
        import krust.ops.table as table_mod

        monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
        monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", 4096)
        monkeypatch.setattr(table_mod.EpochTable, "ADAPT_MIN", 64)
        rng = np.random.default_rng(55)
        # ~30 distinct 9-mers duplicated heavily: dup ratio >> ADAPT target
        motif = _stream(rng, 40, 0.0)
        codes = np.concatenate([motif for _ in range(600)])
        streams = ParsedStreams(codes, None, 1, codes.shape[0])
        engine = BatchEngine(_cfg())
        mode, table = engine._make_table(9)

        epochs = []
        engine._feed_streams(streams, 9, None, table, mode, epochs, lambda w: None)
        assert table._adaptive is False
        assert table._epoch_limit < 4096  # shrunk from the big limit
        got_codes, got_counts = table.finalize()
        for e_codes, e_counts in epochs:
            # fold any early-epoch results (uint32 headroom flushes)
            merged = {}
            for c, n in zip(got_codes.tolist(), got_counts.tolist()):
                merged[c] = merged.get(c, 0) + n
            for c, n in zip(e_codes.tolist(), e_counts.tolist()):
                merged[c] = merged.get(c, 0) + n
            got_codes = np.array(sorted(merged), np.uint64)
            got_counts = np.array([merged[c] for c in sorted(merged)], np.uint64)
        exp = NumpyEngine(EngineConfig()).count(streams, 9)
        assert np.array_equal(got_codes, exp.codes)
        assert np.array_equal(got_counts, exp.counts)

    def test_adaptive_epoch_keeps_large_on_low_duplication(self, monkeypatch):
        import krust.ops.table as table_mod

        monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
        monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", 2048)
        monkeypatch.setattr(table_mod.EpochTable, "ADAPT_MIN", 64)
        rng = np.random.default_rng(56)
        codes = _stream(rng, 12_000, 0.0)  # random: low duplication
        streams = ParsedStreams(codes, None, 1, codes.shape[0])
        engine = BatchEngine(_cfg())
        mode, table = engine._make_table(15)
        epochs = []
        engine._feed_streams(streams, 15, None, table, mode, epochs, lambda w: None)
        table.finalize()
        # distinct ~= windows: target 64 * n exceeds the limit -> unchanged
        assert table._epoch_limit == 2048


class TestPartSpill:
    """Parts whose device merge would not fit the merge budget are pulled
    and merged on the host, exactly."""

    @pytest.mark.parametrize("k", [13, 21])
    def test_spilled_count_matches_oracle(self, monkeypatch, k):
        import krust.ops.table as table_mod
        from krust.utils import tracing

        monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "2048")
        monkeypatch.setenv("KRUST_PENDING_ENTRIES", "3000")
        rng = np.random.default_rng(31 + k)
        codes = _stream(rng, 20_000, p_invalid=0.01)
        streams = ParsedStreams(codes, None, 1, codes.shape[0])
        spills = []
        collect = lambda kind, name, f: name == "part_spill" and spills.append(f)
        tracing.add_collector(collect)
        try:
            got = BatchEngine(_cfg()).count(streams, k)
        finally:
            tracing.remove_collector(collect)
        assert spills and all(f["entries"] > 3000 for f in spills)
        exp = NumpyEngine(EngineConfig()).count(streams, k)
        assert np.array_equal(got.codes, exp.codes)
        assert np.array_equal(got.counts, exp.counts)
        assert table_mod.EpochTable(k)._host_parts == []

    def test_parts_within_budget_merge_on_device(self, monkeypatch):
        from krust.utils import tracing

        monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "2048")
        monkeypatch.setenv("KRUST_PENDING_ENTRIES", str(1 << 30))
        rng = np.random.default_rng(32)
        codes = _stream(rng, 20_000, p_invalid=0.01)
        streams = ParsedStreams(codes, None, 1, codes.shape[0])
        names = []
        collect = lambda kind, name, f: names.append(name)
        tracing.add_collector(collect)
        try:
            BatchEngine(_cfg()).count(streams, 13)
        finally:
            tracing.remove_collector(collect)
        assert "part_merge" in names and "part_spill" not in names


def _table(rng, n, space):
    codes = np.unique(rng.integers(0, space, n).astype(np.uint64))
    return codes, rng.integers(1, 1000, codes.shape[0]).astype(np.uint64)


@pytest.mark.parametrize(
    "sizes,space",
    [
        ([1000, 1000], 1 << 40),  # nearly disjoint
        ([3000, 2000, 500], 4000),  # heavy overlap, three parts
        ([0, 700], 1 << 20),  # empty first part
        ([700, 0], 1 << 20),  # empty later part
        ([1, 1], 1),  # one shared key
    ],
)
def test_host_merge_of_tables_matches_numpy(sizes, space):
    """The host merge behind spilled parts and multi-table counts."""
    from krust.models.engines import _merge_partials

    rng = np.random.default_rng(sum(sizes))
    parts = [_table(rng, n, space) for n in sizes]
    exp = {}
    for codes, counts in parts:
        for c, n in zip(codes.tolist(), counts.tolist()):
            exp[c] = exp.get(c, 0) + n
    codes, counts = _merge_partials([c for c, _ in parts], [n for _, n in parts])
    assert codes.tolist() == sorted(exp)
    assert counts.tolist() == [exp[c] for c in sorted(exp)]
