"""Multi-chip counting: data-parallel encode + hash-sharded all-to-all merge.

The distributed design (new — the reference has no distributed layer; see
SURVEY.md §5 "Distributed communication backend"):

1. **Data-parallel encode.** Block rows shard across the ``data`` mesh axis;
   each chip runs the rolling codec on its shard, producing raw per-window
   (hi, lo, weight) entries that feed a *device-resident per-chip table*.
2. **Per-chip LSM tables.** Each chip accumulates and periodically
   sort-merges its own partial table locally (:class:`ShardedTable`, the
   shard_map twin of ops/table.DeviceTable) — zero communication while
   batches stream, and the same deferred-sync pipelining so scalar
   readbacks overlap queued work.
3. **One hash-sharded all-to-all at finalize.** Each chip's deduplicated
   table entries are bucketed by owner ``hash(code) % n`` and exchanged with
   ``jax.lax.all_to_all`` over the interconnect, so the wire carries distinct
   (code, count) pairs — a fraction of the raw window count — exactly once.
   After a weighted segment-merge every chip holds the final counts for a
   disjoint hash range.

Capacity handling: per-destination bucket sizes are data-dependent, but the
exchanged entries are deduplicated and the hash mixes well, so load
concentrates at mean ``n_unique / n``. The kernel uses a safety factor and
reports an overflow flag; on overflow (pathological skew) the caller retries
the exchange with a larger factor — tables are still device-resident, and
exactness is never silently compromised.

Determinism: sort-based dedup/merge is order-insensitive, so results are
bit-identical across mesh shapes (tested in tests/test_sharded.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.packer import flat_batches, pack_buffer
from ..io.reader import ParsedStreams
from ..kmer import INVALID_CODE
from ..models.engines import (
    PackedCounts,
    _HostAccumulator,
    _ProgressPacer,
    _quality_threshold,
)
from ..ops.codec import encode_blocks
from ..ops.count import merge_runs
from ..ops.table import EPOCH_WINDOW_LIMIT, DeviceTable
from ..utils.config import EngineConfig
from ..utils.numutil import round_pow2
from ..utils.tracing import span, trace_event
from .mesh import DATA_AXIS, make_mesh

# multiplicative mixing constants (odd, high-entropy)
_MIX1 = np.uint32(0x9E3779B1)
_MIX2 = np.uint32(0x85EBCA77)


def _owner_of(hi: jax.Array, lo: jax.Array, n: int) -> jax.Array:
    """Owner chip of a 64-bit key: a multiplicative hash mod n (int32)."""
    h = (hi * _MIX1) ^ (lo * _MIX2)
    h = h ^ (h >> 16)
    h = h * _MIX1
    h = h ^ (h >> 13)
    return (h % jnp.uint32(n)).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("k", "quality_threshold", "mesh")
)
def _encode_sharded(codes, qual, k, quality_threshold, mesh):
    """Rolling codec over row-sharded blocks -> raw sharded (hi, lo, weight).

    Pure data-parallel (no collectives): outputs stay sharded on the same
    axis, one flat [n_dev * rows_local * w] lane per chip.
    """
    n_dev = mesh.shape[DATA_AXIS]

    def local_fn(codes_l, qual_l=None):
        hi, lo, valid = encode_blocks(codes_l, k, qual_l, quality_threshold)
        return (
            hi.reshape(1, -1),
            lo.reshape(1, -1),
            valid.astype(jnp.uint32).reshape(1, -1),
        )

    out_spec = (P(DATA_AXIS, None),) * 3
    row_spec = P(DATA_AXIS, None)
    if qual is None:
        return jax.shard_map(
            local_fn, mesh=mesh, in_specs=(row_spec,), out_specs=out_spec,
            check_vma=False,
        )(codes)
    return jax.shard_map(
        local_fn, mesh=mesh, in_specs=(row_spec, row_spec), out_specs=out_spec,
        check_vma=False,
    )(codes, qual)


@functools.partial(
    jax.jit, static_argnames=("k", "rows", "block_windows", "mesh")
)
def _encode_flat_sharded(packed2, invpos, covered, k, rows, block_windows, mesh):
    """Flat minimal-byte sharded step: per-chip 2-bit slices -> raw windows.

    The sharded twin of engines._count_flat_step: each chip receives its own
    contiguous 2-bit stream slice (0.25 B/base) plus sparse invalid
    positions, unpacks/blockizes on device, runs the codec, and masks
    windows at local index >= its ``covered`` scalar.
    """
    from ..models.engines import _count_flat_step

    def local_fn(p_l, iv_l, cov_l):
        hi, lo, valid = _count_flat_step(
            p_l[0], iv_l[0], cov_l[0], k, rows, block_windows
        )
        return hi.reshape(1, -1), lo.reshape(1, -1), valid.reshape(1, -1)

    spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec, spec, P(DATA_AXIS)),
        out_specs=(spec,) * 3,
        check_vma=False,
    )(packed2, invpos, covered)


@functools.partial(jax.jit, static_argnames=("k", "mesh"))
def _merge_sharded(hi, lo, cnt, k, mesh):
    """Per-chip local merge of concatenated sharded parts (no collectives).

    Inputs are [n_dev, L]; each chip merge-compacts its own row. Returns
    ([n_dev, L] hi/lo/cnt front-compacted, [n_dev] n_unique).
    """

    def local_fn(hi_l, lo_l, cnt_l):
        m_hi, m_lo, m_cnt, n_m = merge_runs(
            hi_l.reshape(-1), lo_l.reshape(-1), cnt_l.reshape(-1), k
        )
        # replicated max: multi-process hosts can read it without owning
        # every shard (np.asarray on a partially-addressable array raises)
        n_max = jax.lax.pmax(n_m, DATA_AXIS)
        return m_hi[None], m_lo[None], m_cnt[None], n_max

    spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec,) * 3,
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )(hi, lo, cnt)


def _exchange_and_merge(u_hi, u_lo, u_cnt, *, k: int, axis: str, n_dev: int, cap: int):
    """Bucket local uniques by owner, all-to-all, merge received partials.

    Runs inside shard_map. Inputs hold live entries wherever ``u_cnt > 0``
    (zero count = padding). ``cap`` is the per-destination entry capacity.
    Returns (m_hi, m_lo, m_cnt, n_m, overflowed) where the m_* arrays hold
    this chip's final hash-range table compacted to the front.
    """
    n_loc = u_hi.shape[0]
    pos = jnp.arange(n_loc, dtype=jnp.int32)
    live = u_cnt > 0

    owner = jnp.where(live, _owner_of(u_hi, u_lo, n_dev), n_dev)
    # sort by owner so each destination's entries are contiguous
    s_owner, s_hi, s_lo, s_cnt = jax.lax.sort(
        (owner, u_hi, u_lo, u_cnt), num_keys=1, is_stable=False
    )
    is_start = (s_owner != jnp.roll(s_owner, 1)).at[0].set(True)
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    rank = pos - run_start  # position within its destination bucket

    overflowed = jnp.any((rank >= cap) & (s_owner < n_dev))

    dest = jnp.where(
        (s_owner < n_dev) & (rank < cap), s_owner * cap + rank, n_dev * cap
    )
    send_hi = jnp.zeros(n_dev * cap, jnp.uint32).at[dest].set(s_hi, mode="drop")
    send_lo = jnp.zeros(n_dev * cap, jnp.uint32).at[dest].set(s_lo, mode="drop")
    send_cnt = jnp.zeros(n_dev * cap, jnp.uint32).at[dest].set(s_cnt, mode="drop")

    recv_hi = jax.lax.all_to_all(send_hi, axis, 0, 0, tiled=True)
    recv_lo = jax.lax.all_to_all(send_lo, axis, 0, 0, tiled=True)
    recv_cnt = jax.lax.all_to_all(send_cnt, axis, 0, 0, tiled=True)

    m_hi, m_lo, m_cnt, n_m = merge_runs(recv_hi, recv_lo, recv_cnt, k)
    return m_hi, m_lo, m_cnt, n_m, overflowed


@functools.partial(jax.jit, static_argnames=("k", "mesh", "cap"))
def _exchange_sharded(hi, lo, cnt, k, mesh, cap):
    """Finalize collective: hash-shard per-chip tables, merge per hash range."""
    n_dev = mesh.shape[DATA_AXIS]

    def local_fn(hi_l, lo_l, cnt_l):
        m_hi, m_lo, m_cnt, n_m, ovf = _exchange_and_merge(
            hi_l.reshape(-1),
            lo_l.reshape(-1),
            cnt_l.reshape(-1),
            k=k,
            axis=DATA_AXIS,
            n_dev=n_dev,
            cap=cap,
        )
        ovf_any = jax.lax.pmax(ovf.astype(jnp.int32), DATA_AXIS)
        return m_hi[None], m_lo[None], m_cnt[None], n_m[None], ovf_any

    spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec,) * 3,
        out_specs=(spec, spec, spec, P(DATA_AXIS), P()),
        check_vma=False,
    )(hi, lo, cnt)


@jax.jit
def _sentinelize(hi, lo, cnt):
    """Weight-1/0 encode output -> raw sentinel-keyed windows."""
    sent = jnp.uint32(0xFFFFFFFF)
    live = cnt > 0
    return jnp.where(live, hi, sent), jnp.where(live, lo, sent)


@functools.partial(jax.jit, static_argnames=("k", "mesh"))
def _epoch_sort_rle_sharded(hi, lo, k, mesh):
    """Per-chip epoch flush inside shard_map: local sort + RLE/compaction.

    Inputs are [n_dev, L] raw sentinel-keyed windows; every chip sorts and
    compacts its own shard with the same programs as the single-device
    EpochTable (no collectives). Returns ([n_dev, L] hi/lo/cnt compacted,
    replicated max n).
    """
    from ..ops.table import _epoch_sort_rle

    def local_fn(hi_l, lo_l):
        o_hi, o_lo, o_cnt, n = _epoch_sort_rle(
            hi_l.reshape(-1), lo_l.reshape(-1), k
        )
        return o_hi[None], o_lo[None], o_cnt[None], jax.lax.pmax(n, DATA_AXIS)

    spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )(hi, lo)


@functools.partial(jax.jit, static_argnames=("k", "mesh"))
def _merge_compact_sharded(a, b, k, mesh):
    """Per-chip merge of two compacted parts + re-compaction (no collectives)."""
    from ..ops.table import _merge_compact

    def local_fn(ah, al, ac, bh, bl, bc):
        o_hi, o_lo, o_cnt, n = _merge_compact(
            (ah.reshape(-1), al.reshape(-1), ac.reshape(-1)),
            (bh.reshape(-1), bl.reshape(-1), bc.reshape(-1)),
            k,
        )
        return o_hi[None], o_lo[None], o_cnt[None], jax.lax.pmax(n, DATA_AXIS)

    spec = P(DATA_AXIS, None)
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )(*a, *b)


def _empty_dense(r_local: int, width: int, w: int, has_qual: bool):
    """Fully-masked dummy dense batch (multi-process lockstep filler)."""
    from ..io.packer import PackedBatch

    return PackedBatch(
        np.full((r_local, width), INVALID_CODE, np.uint8),
        np.full((r_local, width), 0xFF, np.uint8) if has_qual else None,
        0,
        w,
    )


class CapacityOverflow(RuntimeError):
    """Hash-shard destination capacity exceeded; retry with a larger factor."""


class ShardedTable(DeviceTable):
    """Per-chip device-resident LSM count tables (the sharded DeviceTable).

    Reuses DeviceTable's deferred-sync add/resolve/compact state machine
    verbatim; parts carry a leading chip axis ([n_dev, L] arrays), the merge
    runs per chip inside shard_map, and the resolve sync reads the max of
    the [n_dev] n_unique vector. No collectives until :meth:`exchange`.
    """

    AXIS = 1  # entries sit behind the chip axis

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8):
        super().__init__(k, max_parts)
        self._mesh = mesh

    def _prepare_part(self, hi, lo, cnt):
        return hi, lo, cnt  # already [n_dev, L]

    def _do_merge(self, hi, lo, cnt):
        return _merge_sharded(hi, lo, cnt, self._k, self._mesh)

    def _read_n(self, n_dev) -> int:
        # _merge_sharded returns the replicated per-chip max directly
        return int(np.asarray(n_dev))

    def finalize(self):  # pragma: no cover - guard against misuse
        raise NotImplementedError("use exchange() + host gather for sharded tables")

    def exchange(self, capacity_factor: int = 4):
        """All-to-all the per-chip tables into disjoint hash-range shards.

        Returns (m_hi, m_lo, m_cnt, n_m) per-chip-stacked final tables.
        Raises :class:`CapacityOverflow` after escalating retries.
        """
        self._compact()
        self._resolve()
        if self._table is None:
            return None
        t_hi, t_lo, t_cnt = self._table
        n_dev = self._mesh.shape[DATA_AXIS]
        n_loc = t_hi.shape[1]
        final_factor = capacity_factor * 4
        for factor in (capacity_factor, final_factor, 0):
            if factor == 0:
                raise CapacityOverflow(
                    f"hash-shard capacity exceeded even at {final_factor}x "
                    "uniform load"
                )
            cap = min(max(64, -(-n_loc // n_dev) * factor), n_loc)
            # gross collective volume: every chip all-to-alls 3 u32 planes
            # of n_dev*cap entries (scaling harnesses collect this field)
            with span(
                "sharded_exchange",
                devices=n_dev,
                cap=cap,
                wire_bytes=12 * cap * n_dev * n_dev,
            ):
                m_hi, m_lo, m_cnt, n_m, ovf = _exchange_sharded(
                    t_hi, t_lo, t_cnt, self._k, self._mesh, cap
                )
            if not bool(np.asarray(ovf)):
                break
        self._table = None
        self._table_entries = 0
        self.windows_this_epoch = 0
        return m_hi, m_lo, m_cnt, n_m


class EpochShardedTable(ShardedTable):
    """Per-chip epoch-sort tables (the sharded twin of ops/table.EpochTable).

    Batches append RAW sentinel-keyed [n_dev, L] windows; per epoch, every
    chip flat-sorts + RLE-compacts its shard locally (shard_map, zero
    collectives), and compacted parts merge per chip (concatenate + sort +
    compaction). Only :meth:`exchange` communicates — one hash-sharded
    all-to-all on the deduplicated tables, unchanged from ShardedTable.
    """

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8):
        super().__init__(k, mesh, max_parts)
        self._raw: list[tuple[jax.Array, jax.Array]] = []
        self._raw_pending = 0  # per-chip entries
        self._compacted: list[tuple] = []
        # unresolved epoch: full-length sort+rle output + device-side n.
        # The n sync is DEFERRED until the next flush/exchange needs it, so
        # the host keeps feeding batches while the epoch sorts run on every
        # chip (same pipelining as ops/table.EpochTable._pending_epoch).
        self._pending_epoch = None

    def add(self, u_hi, u_lo, u_cnt, n_windows: int):
        from ..ops.table import epoch_entry_limit

        u_hi, u_lo = _sentinelize(u_hi, u_lo, u_cnt)
        self._raw.append((u_hi, u_lo))
        self._raw_pending += u_hi.shape[1]
        self.windows_this_epoch += n_windows
        # per-chip entries against the per-device budget: every chip holds
        # and sorts only its own shard
        if self._raw_pending >= epoch_entry_limit():
            self._flush_raw()

    def _resolve_epoch(self) -> None:
        """Sync the in-flight epoch's n and slice it into a compacted part."""
        if self._pending_epoch is None:
            return
        o_hi, o_lo, o_cnt, n_dev_max = self._pending_epoch
        self._pending_epoch = None
        n = int(np.asarray(n_dev_max))
        keep = min(round_pow2(max(n, 1)), o_hi.shape[1])
        self._compacted.append(
            (o_hi[:, :keep], o_lo[:, :keep], o_cnt[:, :keep])
        )
        if len(self._compacted) > self._max_parts:
            self._merge_compacted()

    def _flush_raw(self) -> None:
        self._resolve_epoch()  # sync overlaps the batches queued since
        if not self._raw:
            return
        with span("epoch_flush", pending=self._raw_pending):
            hi = jnp.concatenate([p[0] for p in self._raw], axis=1)
            lo = jnp.concatenate([p[1] for p in self._raw], axis=1)
            self._raw = []
            self._raw_pending = 0
            self._pending_epoch = _epoch_sort_rle_sharded(
                hi, lo, self._k, self._mesh
            )

    def _merge_compacted(self) -> None:
        runs = self._compacted
        while len(runs) > 1:
            nxt = []
            for i in range(0, len(runs) - 1, 2):
                o_hi, o_lo, o_cnt, n_dev_max = _merge_compact_sharded(
                    runs[i], runs[i + 1], self._k, self._mesh
                )
                n = int(np.asarray(n_dev_max))
                keep = min(round_pow2(max(n, 1)), o_hi.shape[1])
                nxt.append((o_hi[:, :keep], o_lo[:, :keep], o_cnt[:, :keep]))
            if len(runs) % 2:
                nxt.append(runs[-1])
            runs = nxt
        self._compacted = runs

    def exchange(self, capacity_factor: int = 4):
        self._flush_raw()
        self._resolve_epoch()
        self._merge_compacted()
        if not self._compacted:
            return None
        self._table = self._compacted[0]
        self._compacted = []
        # delegate to ShardedTable.exchange's retry ladder on the resolved
        # table (its _compact/_resolve see empty parts and keep _table)
        return super().exchange(capacity_factor)

    def _reset(self) -> None:
        super()._reset()
        self._raw = []
        self._raw_pending = 0
        self._compacted = []
        self._pending_epoch = None



def count_sharded(
    streams: ParsedStreams,
    k: int,
    min_quality: int | None = None,
    mesh: Mesh | None = None,
    config: EngineConfig | None = None,
    progress=None,
    tracker=None,
) -> PackedCounts:
    """Count a parsed input across all mesh devices; exact result.

    Streams block batches data-parallel into per-chip device-resident
    tables, exchanges the deduplicated tables once per epoch via
    hash-sharded all-to-all, gathers the per-chip hash-range shards, and
    concatenates on host (shards are disjoint by construction).
    """
    cfg = config or EngineConfig()
    mesh = mesh or make_mesh()
    n_dev = mesh.shape[DATA_AXIS]
    thr = _quality_threshold(min_quality) if streams.qual is not None else None
    qual_stream = streams.qual if thr is not None else None

    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    acc = _HostAccumulator(cfg.host_compact_threshold)
    if cfg.use_epoch_sort:
        table = EpochShardedTable(k, mesh)
    else:
        table = ShardedTable(k, mesh)
    total_windows = max(streams.codes.shape[0] - k + 1, 0)
    pacer = _ProgressPacer(
        tracker, progress, streams.n_records, streams.n_bases, total_windows
    )

    def flush_epoch():
        result = table.exchange()
        if result is None:
            return
        m_hi, m_lo, m_cnt, n_m = result
        # per-process extraction: read only the shards this process owns
        # (single-host: all of them). Hash ranges are disjoint, so every
        # process accumulates exactly its devices' final table rows.
        n_by_dev = {
            s.index[0].start or 0: int(np.asarray(s.data)[0])
            for s in n_m.addressable_shards
        }
        # per-device final-shard sizes: the skew signal a scaling run needs
        # to diagnose a hash-range imbalance (collected by benches/scaling.py)
        trace_event("shard_sizes", sizes=sorted(n_by_dev.values()))
        rows = {}
        for name, arr in (("hi", m_hi), ("lo", m_lo), ("cnt", m_cnt)):
            for s in arr.addressable_shards:
                rows.setdefault(s.index[0].start or 0, {})[name] = np.asarray(
                    s.data
                )[0]
        for d, r in rows.items():
            nd = n_by_dev[d]
            if nd:
                acc.add(
                    (r["hi"][:nd].astype(np.uint64) << np.uint64(32))
                    | r["lo"][:nd],
                    r["cnt"][:nd].astype(np.uint64),
                )

    procs = jax.process_count()
    if n_dev % max(procs, 1):
        raise ValueError(
            f"mesh devices ({n_dev}) must divide evenly across "
            f"{procs} processes"
        )
    n_group = n_dev // procs  # chips fed by THIS process

    def put_rows(local, global_rows):
        """Place process-local rows into the globally row-sharded array."""
        if procs == 1:
            return jax.device_put(local, sharding)
        shape = (global_rows,) + local.shape[1:]
        return jax.make_array_from_process_local_data(sharding, local, shape)

    def put_vec(local):
        s = NamedSharding(mesh, P(DATA_AXIS))
        if procs == 1:
            return jax.device_put(local, s)
        return jax.make_array_from_process_local_data(s, local, (n_dev,))

    def sync_max(value: int) -> int:
        """Max of an int across processes (no-op single-process)."""
        if procs == 1:
            return value
        from jax.experimental import multihost_utils

        return int(
            multihost_utils.process_allgather(np.array([value])).max()
        )

    # per-chip rows per super-batch: largest power of two keeping the total
    # around cfg.batch_rows
    r_chip = 8
    while r_chip * 2 <= max(cfg.batch_rows // n_dev, 8):
        r_chip *= 2

    w_ = cfg.block_windows
    # multi-process: the lockstep metadata pass (widths below) and the
    # feeding pass both need the stream scan — run it ONCE and share
    prescanned = None
    prescan_done = False
    if cfg.use_flat and procs > 1:
        from ..io.packer import _flat_eligible, flat_scan

        if _flat_eligible(k, w_, r_chip):
            prescanned = flat_scan(
                streams.codes, qual_stream, thr, streams.codes.shape[0] // 32
            )
            prescan_done = True

    def flat_factory():
        if not cfg.use_flat or (prescan_done and prescanned is None):
            return None  # flat disabled, or prescan says too dirty
        fl = flat_batches(
            streams.codes, qual_stream, k, thr, w_, r_chip,
            prescanned=prescanned,
        )
        return (
            None if fl is None else _flat_groups(fl, n_group, r_chip, w_, k)
        )

    flat = flat_factory()
    if procs > 1 and sync_max(1 if flat is None else 0):
        # flat-vs-dense is data-dependent (dirty-input threshold); if ANY
        # process needs the dense path, all must take it or the collective
        # sequences diverge and the pod hangs
        flat = None
    # multi-process: every process must drive the SAME collective sequence
    # (lockstep), so group counts sync to the global max and short processes
    # feed zero-covered dummy groups. Window accounting uses the GLOBAL
    # per-super-batch count so epoch flushes trigger identically everywhere.
    # Lockstep metadata (count + invpos widths) and the feeding pass share
    # the ONE prescanned stream scan above — no second pass of any kind
    # over the input.
    if flat is not None:
        w = cfg.block_windows
        seg_bases = r_chip * w + k - 1
        seg_bytes = -(-seg_bases // 4)
        groups = flat
        if procs > 1:
            from jax.experimental import multihost_utils

            from ..io.packer import flat_batch_widths

            batch_widths = flat_batch_widths(
                streams.codes, qual_stream, k, thr, w, r_chip,
                invpos=None if prescanned is None else prescanned[1],
            )
            assert batch_widths is not None  # agreed flat above
            # group consecutive per-chip batches exactly as _flat_groups
            # does: the super-batch width is the max member width (members
            # are already powers of two >= 8)
            widths = [
                max(batch_widths[i : i + n_group])
                for i in range(0, len(batch_widths), n_group)
            ]
            n_groups = sync_max(len(widths))
            pc = np.full(n_groups, 8, np.int64)
            pc[: len(widths)] = widths
            pcaps = multihost_utils.process_allgather(pc)
            pcaps = pcaps.reshape(procs, n_groups).max(axis=0)

            def mp_groups():
                it = flat  # the one feeding pass
                for gi in range(n_groups):
                    g = next(it, None)
                    if g is not None:
                        p2, iv, cov, _ = g
                        if iv.shape[1] > int(pcaps[gi]):
                            raise AssertionError(
                                "flat metadata narrower than actual invpos"
                            )
                        if iv.shape[1] != int(pcaps[gi]):
                            pad = np.full(
                                (n_group, int(pcaps[gi]) - iv.shape[1]),
                                seg_bases,
                                np.int32,
                            )
                            iv = np.concatenate([iv, pad], axis=1)
                    else:  # dummy lockstep group: fully masked
                        p2 = np.zeros((n_group, seg_bytes), np.uint8)
                        iv = np.full(
                            (n_group, int(pcaps[gi])), seg_bases, np.int32
                        )
                        cov = np.zeros(n_group, np.int32)
                    yield p2, iv, cov, 0

            groups = mp_groups()
        batch_windows = n_dev * r_chip * w  # global, identical on all hosts
        for p2, iv, cov, _ in groups:
            if table.windows_this_epoch + batch_windows >= EPOCH_WINDOW_LIMIT:
                flush_epoch()  # uint32 count headroom exhausted
            p2_d = put_rows(p2, n_dev)
            iv_d = put_rows(iv, n_dev)
            cov_d = put_vec(cov)
            with span("sharded_encode", rows=n_dev * r_chip, devices=n_dev):
                hi, lo, cnt = _encode_flat_sharded(
                    p2_d, iv_d, cov_d, k, r_chip, w, mesh
                )
            table.add(hi, lo, cnt, batch_windows)
            pacer.step(int(cov.sum()))
    else:  # dense fallback: dirty input or flat-ineligible config
        w = cfg.block_windows
        width = w + k - 1
        r_local = -(-cfg.batch_rows // n_group) * n_group
        has_qual = qual_stream is not None

        def dense_factory():
            return pack_buffer(streams.codes, qual_stream, k, w, r_local)

        batches = dense_factory()
        if procs > 1:
            # batch count is pure geometry (mirrors pack_buffer's loop) —
            # no materializing pass needed
            t = max(streams.codes.shape[0] - k + 1, 0)
            n_blocks = -(-t // w) if t > 0 else 0
            n_local_batches = 1 if n_blocks <= r_local else -(-n_blocks // r_local)
            n_batches = sync_max(n_local_batches)

            def mp_batches():
                it = dense_factory()
                for _ in range(n_batches):
                    b = next(it, None)
                    # dummy lockstep batch when this process runs dry
                    yield b if b is not None else _empty_dense(
                        r_local, width, w, has_qual
                    )

            batches = mp_batches()
        batch_windows = procs * r_local * w
        for batch in batches:
            codes, qual = batch.codes, batch.qual
            covered = batch.n_windows
            if codes.shape[0] > r_local:
                raise AssertionError("pack_buffer exceeded batch rows")
            if codes.shape[0] != r_local:  # fixed shape across processes
                pad = r_local - codes.shape[0]
                codes = np.vstack(
                    [codes, np.full((pad, width), INVALID_CODE, np.uint8)]
                )
                if qual is not None:
                    qual = np.vstack(
                        [qual, np.full((pad, width), 0xFF, np.uint8)]
                    )
            if table.windows_this_epoch + batch_windows >= EPOCH_WINDOW_LIMIT:
                flush_epoch()
            codes_d = put_rows(codes, procs * r_local)
            qual_d = put_rows(qual, procs * r_local) if qual is not None else None
            with span("sharded_encode", rows=codes.shape[0], devices=n_dev):
                hi, lo, cnt = _encode_sharded(codes_d, qual_d, k, thr, mesh)
            table.add(hi, lo, cnt, batch_windows)
            pacer.step(covered)

    pacer.finish()
    flush_epoch()
    codes64, counts64 = acc.result()
    return PackedCounts(k, codes64, counts64)


def _flat_groups(flat_iter, n_dev: int, rows: int, w: int, k: int):
    """Group per-chip FlatBatches into stacked sharded super-batches.

    Each yield is (packed2 [n_dev, B], invpos [n_dev, P], covered [n_dev],
    window_count): chip d's row holds its contiguous 2-bit stream slice.
    Missing chips in the final group get zero-covered dummy rows, and every
    member pads to the common full-rows segment size (padding bases decode
    as 'A' but only reach windows masked by ``covered``).
    """
    seg_bases = rows * w + k - 1
    seg_bytes = -(-seg_bases // 4)

    def emit(group):
        p_cap = round_pow2(max(max(g.invpos.shape[0] for g in group), 8))
        p2 = np.zeros((n_dev, seg_bytes), np.uint8)
        iv = np.full((n_dev, p_cap), seg_bases, np.int32)  # sentinel: masked
        cov = np.zeros(n_dev, np.int32)
        for d, g in enumerate(group):
            p2[d, : g.packed2.shape[0]] = g.packed2
            iv[d, : g.invpos.shape[0]] = g.invpos
            cov[d] = g.covered
        return p2, iv, cov, n_dev * rows * w

    group = []
    for fb in flat_iter:
        group.append(fb)
        if len(group) == n_dev:
            yield emit(group)
            group = []
    if group:
        yield emit(group)
