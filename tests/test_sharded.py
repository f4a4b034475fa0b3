"""Multi-chip sharded counting tests on the 8-device virtual CPU mesh.

The SURVEY.md §4 implication: shard-merge results must exactly equal
single-device counts, across mesh shapes.
"""

import random

import jax
import numpy as np
import pytest

from krust.io.reader import streams_from_sequences
from krust.kmer import unpack_many
from krust.models.engines import NumpyEngine
from krust.parallel.mesh import make_mesh
from krust.parallel.sharded import count_sharded
from krust.utils.config import EngineConfig

import oracle


def small_cfg():
    return EngineConfig(block_windows=128, batch_rows=16)


def to_dict(pc):
    return dict(zip(unpack_many(pc.codes, pc.k), pc.counts.tolist()))


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


@pytest.mark.parametrize("k", [3, 5, 17, 21, 31])
def test_sharded_equals_oracle(eight_devices, k):
    rng = random.Random(123 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), "ACGTN") for _ in range(30)]
    expected = oracle.count_sequences(seqs, k)
    streams = streams_from_sequences(seqs)
    mesh = make_mesh(8)
    got = count_sharded(streams, k, mesh=mesh, config=small_cfg())
    assert to_dict(got) == expected


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_mesh_shape_independence(eight_devices, n_dev):
    """Counts are bit-identical across mesh shapes (determinism contract)."""
    rng = random.Random(55)
    seqs = [oracle.random_dna(rng, 400) for _ in range(8)]
    streams = streams_from_sequences(seqs)
    k = 21
    single = NumpyEngine().count(streams, k)
    mesh = make_mesh(n_dev)
    sharded = count_sharded(streams, k, mesh=mesh, config=small_cfg())
    assert np.array_equal(sharded.codes, single.codes)
    assert np.array_equal(sharded.counts, single.counts)


def test_sharded_quality(eight_devices):
    rng = random.Random(77)
    records = []
    for _ in range(12):
        n = rng.randint(0, 150)
        seq = oracle.random_dna(rng, n)
        qual = "".join(chr(rng.randint(33, 73)) for _ in range(n))
        records.append((seq, qual))
    k, min_q = 7, 20
    expected = oracle.count_sequences(records, k, min_quality=min_q)
    streams = streams_from_sequences(
        [s for s, _ in records], [q.encode() for _, q in records]
    )
    got = count_sharded(
        streams, k, min_quality=min_q, mesh=make_mesh(8), config=small_cfg()
    )
    assert to_dict(got) == expected


def test_sharded_empty(eight_devices):
    streams = streams_from_sequences([])
    got = count_sharded(streams, 5, mesh=make_mesh(8), config=small_cfg())
    assert got.distinct == 0


def test_sharded_skew_homopolymer(eight_devices):
    """All windows identical — maximal hash skew; must still be exact."""
    streams = streams_from_sequences(["A" * 2000])
    got = count_sharded(streams, 21, mesh=make_mesh(8), config=small_cfg())
    assert to_dict(got) == {"A" * 21: 2000 - 21 + 1}


def test_multibatch_sharded(eight_devices):
    """Input spanning many batches merges exactly."""
    rng = random.Random(99)
    seqs = [oracle.random_dna(rng, 600) for _ in range(10)]
    streams = streams_from_sequences(seqs)
    k = 11
    expected = oracle.count_sequences(seqs, k)
    cfg = EngineConfig(block_windows=64, batch_rows=8)
    got = count_sharded(streams, k, mesh=make_mesh(8), config=cfg)
    assert to_dict(got) == expected


class TestExchangeOverflow:
    """Both branches of the exchange retry ladder (parallel/sharded.py).

    A hash-skewed key set (every key owned by destination 0) overflows the
    first-pass per-destination capacity; the escalated retry must succeed
    with exact results, and an insufficient ladder must raise
    CapacityOverflow naming its final factor.
    """

    def _skewed_entries(self, n_dev, per_chip, want):
        """Random (hi, lo) uint32 pairs all hashing to owner 0."""
        from krust.parallel import sharded as sh

        rng = np.random.default_rng(9)
        out_hi, out_lo = [], []
        need = n_dev * per_chip
        while need > 0:
            hi = rng.integers(0, 1 << 10, 200_000, np.uint32)
            lo = rng.integers(0, 1 << 32, 200_000, np.uint64).astype(np.uint32)
            h = (hi * sh._MIX1) ^ (lo * sh._MIX2)
            h = h ^ (h >> np.uint32(16))
            h = h * sh._MIX1
            h = h ^ (h >> np.uint32(13))
            keep = (h % np.uint32(n_dev)) == want
            out_hi.append(hi[keep])
            out_lo.append(lo[keep])
            need -= int(keep.sum())
        hi = np.concatenate(out_hi)[: n_dev * per_chip]
        lo = np.concatenate(out_lo)[: n_dev * per_chip]
        # unique within each chip row so entries are table-like (dedup'd)
        return hi.reshape(n_dev, per_chip), lo.reshape(n_dev, per_chip)

    def _make_table(self, mesh, n_dev, per_chip):
        import jax.numpy as jnp

        from krust.parallel.sharded import ShardedTable

        hi, lo = self._skewed_entries(n_dev, per_chip, want=0)
        cnt = np.ones((n_dev, per_chip), np.uint32)
        table = ShardedTable(21, mesh)
        table.add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cnt), per_chip)
        expected = {}
        for h, l in zip(hi.reshape(-1).tolist(), lo.reshape(-1).tolist()):
            expected[(h << 32) | l] = expected.get((h << 32) | l, 0) + 1
        return table, expected

    def test_retry_succeeds_after_first_pass_overflow(self, eight_devices, monkeypatch):
        from krust.parallel import sharded as sh

        mesh = make_mesh(8)
        # 768 skewed entries/chip: first-pass cap ~ ceil(L/8)*4 < entries to
        # dest 0, escalated cap clamps to the full row and succeeds
        table, expected = self._make_table(mesh, 8, 768)

        calls = []
        real = sh._exchange_sharded

        def spy(*args, **kw):
            calls.append(args[-1])  # cap is the last positional (static) arg
            return real(*args, **kw)

        monkeypatch.setattr(sh, "_exchange_sharded", spy)
        m_hi, m_lo, m_cnt, n_m = table.exchange(capacity_factor=4)
        assert len(calls) == 2, "first pass must overflow, retry must run"
        assert calls[1] > calls[0]

        got = {}
        n_m = np.asarray(n_m)
        m_hi, m_lo, m_cnt = map(np.asarray, (m_hi, m_lo, m_cnt))
        for d in range(8):
            nd = int(n_m[d])
            for h, l, c in zip(
                m_hi[d, :nd].tolist(), m_lo[d, :nd].tolist(), m_cnt[d, :nd].tolist()
            ):
                got[(h << 32) | l] = got.get((h << 32) | l, 0) + c
        assert got == expected

    def test_capacity_overflow_raises_with_final_factor(self, eight_devices):
        from krust.parallel.sharded import CapacityOverflow

        mesh = make_mesh(8)
        table, _ = self._make_table(mesh, 8, 768)
        # ladder (1, 4): final cap = ceil(L/8)*4 = L/2 < skewed load -> raise
        with pytest.raises(CapacityOverflow, match="4x"):
            table.exchange(capacity_factor=1)


@pytest.mark.slow
def test_epoch_flush_defers_sync(eight_devices):
    """The sharded epoch flush must NOT sync the n scalar at dispatch time:
    the sort result stays an unresolved _pending_epoch so queued batches
    overlap the per-chip epoch sorts (ops/table.EpochTable's pipelining,
    VERDICT r2 weakness #3). The deferred resolve happens at the next
    flush/exchange and results stay exact."""
    import jax.numpy as jnp

    from krust.parallel.sharded import EpochShardedTable

    mesh = make_mesh(8)
    table = EpochShardedTable(21, mesh)

    rng = np.random.default_rng(3)
    expected = {}
    for i in range(3):
        hi = rng.integers(0, 1 << 10, (8, 128), dtype=np.uint32)
        lo = rng.integers(0, 1 << 31, (8, 128), dtype=np.uint32)
        cnt = np.ones((8, 128), np.uint32)
        for h, l in zip(hi.reshape(-1).tolist(), lo.reshape(-1).tolist()):
            key = (h << 32) | l
            expected[key] = expected.get(key, 0) + 1
        table.add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cnt), 128)
        table._flush_raw()  # what the epoch-limit trigger calls
        # the epoch just dispatched stays unresolved (no scalar sync); only
        # the PREVIOUS flushes' epochs have been resolved into parts
        assert table._pending_epoch is not None
        assert len(table._compacted) == i
        assert table._raw == []

    m_hi, m_lo, m_cnt, n_m = table.exchange()
    got = {}
    n_m = np.asarray(n_m)
    m_hi, m_lo, m_cnt = map(np.asarray, (m_hi, m_lo, m_cnt))
    for d in range(8):
        for h, l, c in zip(
            m_hi[d, : n_m[d]].tolist(),
            m_lo[d, : n_m[d]].tolist(),
            m_cnt[d, : n_m[d]].tolist(),
        ):
            got[(h << 32) | l] = got.get((h << 32) | l, 0) + c
    assert got == expected


@pytest.mark.slow
def test_sharded_all_k_sweep(eight_devices):
    """Exhaustive k=1..=32 differential on the sharded epoch engine: the
    sentinel/key-regime boundaries (15/16, 31/32) and everything between
    (SURVEY §4 all-k coverage extended to the multi-chip path)."""
    rng = random.Random(7)
    seqs = [oracle.random_dna(rng, rng.randint(0, 120), "ACGTN") for _ in range(6)]
    streams = streams_from_sequences(seqs)
    mesh = make_mesh(8)
    for k in range(1, 33):
        got = count_sharded(streams, k, mesh=mesh, config=small_cfg())
        assert to_dict(got) == oracle.count_sequences(seqs, k), f"k={k}"
