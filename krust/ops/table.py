"""Device-resident count table with amortized, pipeline-friendly compaction.

Keeps per-batch results on the device instead of pulling them to the host
after every batch: per-batch run-length results append to a device-side
part list; when pending parts outgrow the compacted table, everything
concatenates and re-merges on device (LSM-style doubling, amortized
O(n log n) total).

Two properties keep the host from stalling the device:

- **Deferred syncs.** A compaction's ``n_unique`` scalar is not read back
  when the merge is dispatched; the full-length merge output is retained and
  only sliced (one scalar sync) when the *next* compaction needs the table —
  by which point several more batches are queued on the device, so the sync
  overlaps useful work instead of stalling the feed pipeline.
- **Slim finalize.** The distinct table leaves the device exactly once, in a
  minimal-byte encoding: lo as uint32, counts as uint8 saturating at 0xFF
  (exact values for saturated entries re-gathered by the host — cheap while
  high-count k-mers are a small fraction, with a full-width fallback when
  they are not), and hi (zero for k<=16) reconstructed from a
  device-computed histogram whenever that is smaller than raw hi bytes.
  ~5.25 bytes/entry instead of 12.

Count-width: parts carry uint32 counts. A single table epoch therefore must
see < 2^31 windows; :class:`DeviceTable` tracks this and the engine flushes
to the host u64 accumulator before overflow — exactness is preserved for
arbitrarily large inputs (reference saturation contract: src/run.rs:569).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .count import SENT, compact_runs, merge_runs
from ..utils.numutil import round_pow2 as _round_pow2, round_up as _round_up
from ..utils.tracing import span, trace_event

#: windows per epoch bound, with headroom below 2^32 (counts are uint32)
EPOCH_WINDOW_LIMIT = 1 << 31

#: share of the device's memory that one table's working set may take: the
#: next epoch's raw parts accumulate while a flush runs, and compacted parts
#: and staged batches stay resident beside it
_MEMORY_SHARE = 0.5


def _device_memory_bytes() -> int | None:
    """``bytes_limit`` of device 0, or None where the backend reports none
    (XLA on the CPU). Cached: the backend doesn't change mid-run."""
    global _MEM_CACHE
    if _MEM_CACHE is _MEM_UNSET:
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        _MEM_CACHE = int(limit) if limit else None
    return _MEM_CACHE


_MEM_UNSET = object()
_MEM_CACHE: int | None = _MEM_UNSET  # type: ignore[assignment]


def _entry_budget(env: str, bytes_per_entry: int, fallback: int) -> int:
    """Entries a table may gather before it must sort them.

    ``env`` overrides everything; otherwise :data:`_MEMORY_SHARE` of the
    device's ``bytes_limit`` over the measured peak bytes per entry
    (floored at 1M entries), or ``fallback`` where the backend reports no
    memory limit.
    """
    v = os.environ.get(env)
    if v:
        return max(int(v), 1)
    limit = _device_memory_bytes()
    if limit is None:
        return fallback
    return max(int(limit * _MEMORY_SHARE) // bytes_per_entry, 1 << 20)


#: finalize pull granularity: slices round up to this, bounding both the
#: over-pull (<1.6MB) and the number of distinct pull shapes compiled
_PULL_QUANTUM = 1 << 18


def _pull_size(n: int, limit: int) -> int:
    cap = _round_pow2(n) if n < _PULL_QUANTUM else _round_up(n, _PULL_QUANTUM)
    return min(cap, limit)


@functools.partial(jax.jit, static_argnames=("cap", "hi_space", "raw_hi"))
def _pull_fused(
    hi: jax.Array,
    lo: jax.Array,
    cnt: jax.Array,
    n: jax.Array,
    cap: int,
    hi_space: int,
    raw_hi: bool,
):
    """Everything the host needs, as ONE uint8 buffer (one sync round-trip).

    Layout: lo bytes [4*cap] | saturated uint8 counts [cap] | hi plane —
    either a histogram of hi over the first n entries (hi is sorted;
    ``hi_space`` int32 buckets) or, for large hi spaces, raw hi bytes
    [4*cap]. Exact counts for saturated entries are re-gathered by the host.
    """
    lo_b = jax.lax.bitcast_convert_type(lo[:cap], jnp.uint8).reshape(-1)
    cnt8 = jnp.minimum(cnt[:cap], 0xFF).astype(jnp.uint8)
    if hi_space == 0:  # k <= 16: hi identically zero
        hi_b = jnp.zeros(0, jnp.uint8)
    elif raw_hi:
        hi_b = jax.lax.bitcast_convert_type(hi[:cap], jnp.uint8).reshape(-1)
    else:
        hi_m = jnp.where(jnp.arange(cap) < n, hi[:cap], jnp.uint32(hi_space))
        starts = jnp.searchsorted(hi_m, jnp.arange(hi_space, dtype=jnp.uint32))
        hist = jnp.diff(jnp.append(starts.astype(jnp.int32), n.astype(jnp.int32)))
        hi_b = jax.lax.bitcast_convert_type(hist, jnp.uint8).reshape(-1)
    return jnp.concatenate([lo_b, cnt8, hi_b])


#: delta-plane sentinel: a 24-bit delta of 0xFFFFFF means "exception —
#: re-gather this entry's absolute code" (also used for deltas >= 2^24 - 1)
_DELTA_EXC = 0xFFFFFF


@functools.partial(jax.jit, static_argnames=("cap",))
def _pull_delta(hi: jax.Array, lo: jax.Array, cnt: jax.Array, cap: int):
    """Delta-coded pull: 3-byte code deltas + uint8 counts (4B/entry total).

    The table's codes are sorted and unique, so consecutive 64-bit deltas
    are small (mean = key-space / n). Each delta is emitted as 3 little-
    endian bytes; deltas >= 2^24 - 1 (and entry 0, whose "delta" is the
    absolute code) emit the exception sentinel and are re-gathered exactly
    by the host. Works identically for every k — no hi plane at all.
    """
    d = _delta_stream(hi, lo, cap, _DELTA_EXC)
    b0 = (d & 0xFF).astype(jnp.uint8)
    b1 = ((d >> 8) & 0xFF).astype(jnp.uint8)
    b2 = ((d >> 16) & 0xFF).astype(jnp.uint8)
    delta_b = jnp.stack([b0, b1, b2], axis=1).reshape(-1)
    cnt8 = jnp.minimum(cnt[:cap], 0xFF).astype(jnp.uint8)
    return jnp.concatenate([delta_b, cnt8])


def _delta_stream(hi: jax.Array, lo: jax.Array, cap: int, exc: int):
    """Consecutive-code deltas over the first ``cap`` entries, with ``exc``
    standing in for entry 0 and any delta >= exc (shared by the 3-byte and
    bit-packed pull variants)."""
    hi_c = hi[:cap]
    lo_c = lo[:cap]
    p_hi = jnp.roll(hi_c, 1).at[0].set(0)
    p_lo = jnp.roll(lo_c, 1).at[0].set(0)
    d_lo = lo_c - p_lo  # wrapping u32
    borrow = (lo_c < p_lo).astype(jnp.uint32)
    d_hi = hi_c - p_hi - borrow
    small = (d_hi == 0) & (d_lo < exc)
    return jnp.where(small, d_lo, exc).at[0].set(exc)


@functools.partial(jax.jit, static_argnames=("cap", "bits"))
def _pull_delta_packed(
    hi: jax.Array, lo: jax.Array, cnt: jax.Array, cap: int, bits: int
):
    """Entropy-coded pull: paired ``bits``-wide deltas + 4-bit counts.

    The 3-byte delta plane of :func:`_pull_delta` spends 24 bits on deltas
    whose mean is key-space / n — far less on dense tables. Packing delta
    PAIRS at 16/20/24 bits each (4/5/6 bytes per pair) plus one shared
    count byte per pair (two 4-bit saturating counts, 0xF = re-gather)
    brings the pull to 2.5/3.0/3.5 bytes/entry. The all-ones ``bits``-wide
    sentinel marks exceptions (entry 0, oversized deltas) whose absolute
    codes the host re-gathers; counts >= 15 re-gather through the same
    machinery as the 8-bit saturations. ``cap`` must be even.
    """
    # evenness currently holds because _pull_size yields pow2 / 2^18-quantum
    # sizes; fail loudly (not with an opaque jit stack-shape error) if a
    # future _pull_size or table-capacity change breaks that
    assert cap % 2 == 0, f"_pull_delta_packed requires an even cap, got {cap}"
    exc = (1 << bits) - 1
    d = _delta_stream(hi, lo, cap, exc)
    d0 = d[0::2]
    d1 = d[1::2]
    planes = [(d0 & 0xFF), (d0 >> 8) & 0xFF]
    if bits == 16:
        planes += [(d1 & 0xFF), (d1 >> 8) & 0xFF]
    elif bits == 20:
        planes += [((d0 >> 16) & 0xF) | ((d1 & 0xF) << 4),
                   (d1 >> 4) & 0xFF, (d1 >> 12) & 0xFF]
    else:  # 24
        planes += [(d0 >> 16) & 0xFF, d1 & 0xFF,
                   (d1 >> 8) & 0xFF, (d1 >> 16) & 0xFF]
    delta_b = jnp.stack(
        [p.astype(jnp.uint8) for p in planes], axis=1
    ).reshape(-1)
    c4 = jnp.minimum(cnt[:cap], 0xF).astype(jnp.uint8)
    cnt_b = c4[0::2] | (c4[1::2] << 4)
    return jnp.concatenate([delta_b, cnt_b])


@functools.partial(jax.jit, static_argnames=())
def _gather_u32(arr: jax.Array, idx: jax.Array):
    return jnp.take(arr, idx, mode="clip")


class DeviceTable:
    """Accumulates (hi, lo, count) uniques on device across batches.

    The single-device LSM accumulator. :class:`~krust.parallel.sharded.
    ShardedTable` reuses the identical add/resolve/compact state machine by
    overriding the ``AXIS`` / ``_do_merge`` / ``_read_n`` hooks (its arrays
    carry a leading per-chip axis and merge inside shard_map).
    """

    #: max merge-input entries (pending parts + compacted table) before a
    #: forced merge, where the device reports no memory limit; otherwise
    #: the budget comes from ``bytes_limit`` and MERGE_BYTES_PER_ENTRY
    #: (KRUST_PENDING_ENTRIES overrides)
    PENDING_ENTRY_LIMIT = 280_000_000

    #: peak device bytes per merge-input entry of :func:`merge_runs`
    #: (12-byte parts, the sort, the compacted output), from
    #: ``peak_bytes_in_use`` over a merge of two all-distinct k=31 parts of
    #: 2^27 entries on an H100 (benches/phases.py --budget)
    MERGE_BYTES_PER_ENTRY = 45

    #: entry axis of part arrays (ShardedTable: 1, behind the chip axis)
    AXIS = 0

    def __init__(self, k: int = 32, max_parts: int = 8):
        self._pending_limit = _entry_budget(
            "KRUST_PENDING_ENTRIES",
            type(self).MERGE_BYTES_PER_ENTRY,
            type(self).PENDING_ENTRY_LIMIT,
        )
        self._k = k  # enables sentinel-key merges (fewer sort operands)
        self._parts: list[tuple[jax.Array, jax.Array, jax.Array]] = []
        self._pending = 0
        # resolved table: full-length merge output + known entry count
        self._table: tuple[jax.Array, jax.Array, jax.Array] | None = None
        self._table_entries = 0
        # unresolved merge: full-length output + device-side entry count
        self._merge: tuple[jax.Array, jax.Array, jax.Array] | None = None
        self._merge_n: jax.Array | None = None
        self._max_parts = max_parts
        self.windows_this_epoch = 0
        self._windows_total = 0  # informs the finalize pull's count width

    # --- hooks ------------------------------------------------------------

    def _prepare_part(self, hi, lo, cnt):
        return hi.reshape(-1), lo.reshape(-1), cnt.reshape(-1)

    def _do_merge(self, hi, lo, cnt):
        return merge_runs(hi, lo, cnt, self._k)

    def _read_n(self, n_dev) -> int:
        return int(n_dev)

    # --- LSM state machine (shared with ShardedTable) ---------------------

    def add(self, u_hi: jax.Array, u_lo: jax.Array, u_cnt: jax.Array, n_windows: int):
        """Append one batch's (hi, lo, weight) entries (zero weight = padding)."""
        part = self._prepare_part(u_hi, u_lo, u_cnt)
        self._parts.append(part)
        self._pending += part[0].shape[self.AXIS]
        self.windows_this_epoch += n_windows
        self._windows_total += n_windows
        # batch up parts before merging: each window is sorted exactly once
        # regardless, so fewer merges = less per-merge overhead and fewer
        # resolve syncs; max_parts / the entry limit bound HBM held by
        # pending raw parts and the merge working set. The merge input is
        # parts PLUS the compacted table, so the trigger accounts for the
        # table's length too (with a floor of LIMIT/8 pending so a huge
        # table cannot force a quadratic merge-per-batch regime).
        table_len = 0
        if self._table is not None:
            table_len = self._table[0].shape[self.AXIS]
        elif self._merge is not None:
            table_len = self._merge[0].shape[self.AXIS]
        pending_cap = max(
            self._pending_limit - table_len, self._pending_limit // 8
        )
        if len(self._parts) >= self._max_parts or self._pending >= pending_cap:
            self._compact()

    def _slice_keep(self, arrays, keep: int):
        idx = (slice(None),) * self.AXIS + (slice(0, keep),)
        return tuple(a[idx] for a in arrays)

    def _resolve(self) -> None:
        """Turn the in-flight merge into a sliced table (one scalar sync)."""
        if self._merge is None:
            return
        n = self._read_n(self._merge_n)
        keep = min(_round_pow2(max(n, 1)), self._merge[0].shape[self.AXIS])
        self._table = self._slice_keep(self._merge, keep)
        self._table_entries = n
        self._merge = None
        self._merge_n = None

    def _concat(self):
        arrays = list(self._parts)
        if self._table is not None:
            arrays.append(self._table)
        out = [
            jnp.concatenate([a[i] for a in arrays], axis=self.AXIS)
            for i in range(3)
        ]
        # pad to a 4M-entry bucket: bounds jit recompiles without the up-to-2x
        # work a power-of-two bucket would add to the big final merge
        n = out[0].shape[self.AXIS]
        target = _round_up(n, 1 << 22) if n > (1 << 22) else _round_pow2(n)
        if target != n:
            shape = list(out[0].shape)
            shape[self.AXIS] = target - n
            out = [
                jnp.concatenate(
                    [a, jnp.zeros(shape, jnp.uint32)], axis=self.AXIS
                )
                for a in out
            ]
        return out

    def _compact(self):
        self._resolve()  # syncs the previous merge; overlaps queued batches
        if not self._parts:
            return
        hi, lo, cnt = self._concat()
        m_hi, m_lo, m_cnt, n_m = self._do_merge(hi, lo, cnt)
        self._merge = (m_hi, m_lo, m_cnt)
        self._merge_n = n_m
        self._parts = []
        self._pending = 0
        self._table = None
        self._table_entries = 0

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Compact and pull the distinct table to host: (codes u64, counts u64).

        Codes come back sorted ascending (merge compaction is key-ordered).
        The pull is slim: uint32 lo + uint8 saturated counts (exact values
        for saturated entries re-gathered individually) + hi via histogram
        or raw uint32, whichever is smaller.
        """
        self._compact()
        self._resolve()
        return self._pull_table()

    def _pull_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Slim-pull the resolved table (shared with EpochTable.finalize)."""
        if self._table is None:
            self._reset()
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        codes, counts = self._pull_part(*self._table, self._table_entries)
        self._reset()
        return codes, counts

    def _pull_part(self, t_hi, t_lo, t_cnt, n: int):
        """One compacted part (its first ``n`` entries) -> host (codes,
        counts), key-sorted."""
        if n == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        cap = _pull_size(n, t_hi.shape[0])

        # dense tables: code deltas (mean gap = key-space / n, so exceptions
        # are vanishing when the space is < ~n * 2^22); sparse tables: plane
        # pull with the hi histogram trick. Dense tables with low expected
        # duplication further bit-pack the deltas and ride 4-bit counts
        # (2.5-3.5 B/entry vs 4).
        if (1 << (2 * self._k)) < (max(n, 1) << 22):
            mean_gap = max((1 << (2 * self._k)) // max(n, 1), 1)
            mean_cnt = self._windows_total / max(n, 1)
            if n >= 4096 and (self._windows_total == 0 or mean_cnt <= 6.0):
                bits = next(
                    (b for b in (16, 20, 24) if mean_gap * 8 <= (1 << b)), 24
                )
                codes, counts = self._finalize_delta_packed(
                    t_hi, t_lo, t_cnt, n, cap, bits
                )
            else:
                codes, counts = self._finalize_delta(t_hi, t_lo, t_cnt, n, cap)
        else:
            codes, counts = self._finalize_planes(t_hi, t_lo, t_cnt, n, cap)
        return codes, counts

    def _resolve_saturated(self, t_cnt, cnt8, n, sat_val=0xFF) -> np.ndarray:
        """Saturating count plane -> exact u64 counts (re-gather saturations)."""
        counts = cnt8.astype(np.uint64)
        sat = np.flatnonzero(cnt8 == sat_val)
        if sat.shape[0] > max(n // 8, 64):
            # saturation-heavy table (tiny k / extreme duplication): one
            # full-width count pull beats per-entry gathers
            cap = _pull_size(n, t_cnt.shape[0])
            return np.asarray(t_cnt[:cap])[:n].astype(np.uint64)
        if sat.shape[0]:
            exact = self._gather(t_cnt, sat)
            counts[sat] = exact
        return counts

    @staticmethod
    def _gather(arr, idx: np.ndarray) -> np.ndarray:
        p = _round_pow2(max(idx.shape[0], 8))
        full = np.zeros(p, np.int32)
        full[: idx.shape[0]] = idx
        return np.asarray(_gather_u32(arr, jnp.asarray(full)))[: idx.shape[0]]

    def _codes_from_deltas(self, deltas, exc_val, t_hi, t_lo, n):
        """Delta plane -> absolute sorted u64 codes (host side).

        ``exc_val`` entries (entry 0 and oversized deltas) contribute 0 to
        the running sum; their absolute codes are re-gathered and every
        entry inherits the offset fixed by the last exception at or before
        it (entry 0 is always an exception, so every entry is covered).
        """
        exc = np.flatnonzero(deltas == exc_val)
        prelim = np.cumsum(
            np.where(deltas == exc_val, 0, deltas).astype(np.uint64)
        )
        abs_codes = (self._gather(t_hi, exc).astype(np.uint64) << np.uint64(32)) | (
            self._gather(t_lo, exc).astype(np.uint64)
        )
        adj_at = np.zeros(n, np.uint64)
        adj_at[exc] = abs_codes - prelim[exc]
        is_exc = np.zeros(n, bool)
        is_exc[exc] = True
        last_exc = np.maximum.accumulate(np.where(is_exc, np.arange(n), 0))
        return prelim + adj_at[last_exc]

    def _finalize_delta(self, t_hi, t_lo, t_cnt, n, cap):
        buf = np.asarray(_pull_delta(t_hi, t_lo, t_cnt, cap))
        db = buf[: 3 * cap].reshape(cap, 3)[:n].astype(np.uint32)
        cnt8 = buf[3 * cap : 4 * cap][:n]
        deltas = db[:, 0] | (db[:, 1] << 8) | (db[:, 2] << 16)
        codes = self._codes_from_deltas(deltas, _DELTA_EXC, t_hi, t_lo, n)
        return codes, self._resolve_saturated(t_cnt, cnt8, n)

    def _finalize_delta_packed(self, t_hi, t_lo, t_cnt, n, cap, bits):
        """Decode the bit-packed pull of :func:`_pull_delta_packed`."""
        pair_bytes = {16: 4, 20: 5, 24: 6}[bits]
        half = cap // 2
        buf = np.asarray(_pull_delta_packed(t_hi, t_lo, t_cnt, cap, bits))
        db = buf[: pair_bytes * half].reshape(half, pair_bytes).astype(np.uint32)
        cb = buf[pair_bytes * half :]
        if bits == 16:
            d0 = db[:, 0] | (db[:, 1] << 8)
            d1 = db[:, 2] | (db[:, 3] << 8)
        elif bits == 20:
            d0 = db[:, 0] | (db[:, 1] << 8) | ((db[:, 2] & 0xF) << 16)
            d1 = (db[:, 2] >> 4) | (db[:, 3] << 4) | (db[:, 4] << 12)
        else:
            d0 = db[:, 0] | (db[:, 1] << 8) | (db[:, 2] << 16)
            d1 = db[:, 3] | (db[:, 4] << 8) | (db[:, 5] << 16)
        deltas = np.empty(cap, np.uint32)
        deltas[0::2] = d0
        deltas[1::2] = d1
        deltas = deltas[:n]
        codes = self._codes_from_deltas(deltas, (1 << bits) - 1, t_hi, t_lo, n)
        c4 = np.empty(cap, np.uint8)
        c4[0::2] = cb & 0xF
        c4[1::2] = cb >> 4
        counts = self._resolve_saturated(t_cnt, c4[:n], n, sat_val=0xF)
        return codes, counts

    def _finalize_planes(self, t_hi, t_lo, t_cnt, n, cap):
        k = self._k
        if k <= 16:
            hi_space, raw_hi = 0, False
        else:
            hi_space = 1 << (2 * k - 32)
            # histogram costs 4*hi_space bytes, raw hi costs 4*cap: pick the
            # smaller pull (both ints are static at trace time)
            raw_hi = hi_space > cap

        buf = np.asarray(
            _pull_fused(t_hi, t_lo, t_cnt, jnp.int32(n), cap, hi_space, raw_hi)
        )
        lo = buf[: 4 * cap].view(np.uint32)[:n].astype(np.uint64)
        cnt8 = buf[4 * cap : 5 * cap][:n]
        hi_plane = buf[5 * cap :]

        counts = self._resolve_saturated(t_cnt, cnt8, n)

        if hi_space == 0:
            codes = lo
        elif raw_hi:
            hi = hi_plane.view(np.uint32)[:n].astype(np.uint64)
            codes = (hi << np.uint64(32)) | lo
        else:
            hist = hi_plane.view(np.int32)
            hi = np.repeat(np.arange(hi_space, dtype=np.uint64), hist)
            codes = (hi << np.uint64(32)) | lo
        return codes, counts

    def _reset(self) -> None:
        self._table = None
        self._table_entries = 0
        self._merge = None
        self._merge_n = None
        self._parts = []
        self._pending = 0
        self.windows_this_epoch = 0
        # per-table-lifetime: a later finalize's mean-count gate must see
        # only the windows feeding the CURRENT contents, not all history
        self._windows_total = 0


#: raw (hi, lo) entries accumulated before an epoch sort where the device
#: reports no memory limit (XLA on the CPU); otherwise the budget comes
#: from ``bytes_limit`` and EPOCH_BYTES_PER_ENTRY via
#: :func:`epoch_entry_limit` (KRUST_EPOCH_ENTRIES overrides)
EPOCH_ENTRY_LIMIT = 240_000_000

#: peak device bytes per raw entry of one epoch (raw parts, the
#: concatenated sort operands, sort output and compaction), from
#: ``peak_bytes_in_use`` over a one-epoch count of 520M windows on an H100
#: (benches/phases.py): 25.5 at k=16, 30.25 at k=21, 34.25 at k=31
EPOCH_BYTES_PER_ENTRY = 35


def epoch_entry_limit() -> int:
    """Raw-entry epoch budget for THIS process's device (env > memory).

    Reads the module attrs (not a closure) so tests monkeypatching
    ``EPOCH_ENTRY_LIMIT`` still steer it.
    """
    return _entry_budget(
        "KRUST_EPOCH_ENTRIES", EPOCH_BYTES_PER_ENTRY, EPOCH_ENTRY_LIMIT
    )


def _hi_sort_dtype(k: int):
    """Narrowest unsigned dtype for the epoch sort's hi operand at this k.

    hi carries 2*(k-16) significant bits for k > 16; a narrower operand
    means fewer bytes through every pass of the sort.

    Sentinels are the all-ones PAIR: a canonical k-mer can populate
    hi == all-ones alone (TTT...AAA forms are their own-rc minima), but the
    full (all-ones hi, all-ones lo) pair is the all-T k-mer, whose reverse
    complement is all-A == 0 — never canonical, for any k (the same
    invariant the k <= 16 one-key sentinel and engines._sentinel_part
    already rely on). The sort orders sentinel pairs last within the narrow
    all-ones hi block, and the upcast in :func:`_epoch_sort_rle` restores
    the exact u32 sentinel by pair equality, so the gates are inclusive:
    hi_bits <= 8 (k <= 20) rides u8, hi_bits <= 16 (k <= 24) rides u16.
    """
    hi_bits = 2 * (k - 16)
    if hi_bits <= 8:
        return jnp.uint8
    if hi_bits <= 16:
        return jnp.uint16
    return None


@functools.partial(jax.jit, static_argnames=("k",))
def _epoch_sort_rle(hi, lo, k):
    """One epoch flush: flat sort of raw sentinel-keyed windows + run-length
    compaction -> (hi, lo, cnt, n) distinct table part."""
    # a bool would silently ride the k<=16 path (bool is an int subclass)
    assert isinstance(k, int) and not isinstance(k, bool) and 1 <= k <= 32, (
        f"_epoch_sort_rle: k must be an int in 1..=32, got {k!r}"
    )

    if k <= 16:
        # k <= 16: hi is identically zero, lo alone orders the keys and
        # lo == SENT safely marks invalid windows — even at k == 16, where
        # codes span all 32 bits, the all-ones code (the all-T k-mer) is
        # never canonical because its reverse complement is all-A == 0.
        # The hi plane never materializes.
        (s_lo,) = jax.lax.sort((lo,), num_keys=1, is_stable=False)
        return compact_runs(None, s_lo, one_key=True)
    dt = _hi_sort_dtype(k)
    if dt is not None:
        # 17 <= k <= 24: sort with a narrowed hi operand. astype on
        # unsigned ints is modular, so the 0xFFFFFFFF sentinel becomes the
        # narrow all-ones (still the maximum, still sorts last). Valid
        # entries CAN carry hi == narrow all-ones (e.g. k=20/24 boundary
        # k-mers), but never the all-ones PAIR (the all-T k-mer is never
        # canonical — see _hi_sort_dtype), so the upcast restores the
        # exact u32 sentinel by PAIR equality; within the all-ones hi
        # block the sentinels' lo == all-ones sorts them last, so the
        # upcast preserves sorted order.
        narrow_max = jnp.uint32((1 << (8 * dt(0).itemsize)) - 1)
        s_hi_n, s_lo = jax.lax.sort(
            (hi.astype(dt), lo), num_keys=2, is_stable=False
        )
        s_hi32 = s_hi_n.astype(jnp.uint32)
        s_hi = jnp.where(
            (s_hi32 == narrow_max) & (s_lo == jnp.uint32(SENT)),
            jnp.uint32(SENT),
            s_hi32,
        )
        return compact_runs(s_hi, s_lo)
    s_hi, s_lo = jax.lax.sort((hi, lo), num_keys=2, is_stable=False)
    return compact_runs(s_hi, s_lo)


@functools.partial(jax.jit, static_argnames=("k",))
def _epoch_concat_sort_rle(his, los, k):
    """Concatenate raw parts and epoch-sort them in ONE XLA program, so the
    concatenated operand is written straight into the sort's input instead
    of being materialized by a separate dispatch. ``his`` is None on the
    lo-only (k <= 16) path."""
    hi = None if his is None else jnp.concatenate(his)
    lo = jnp.concatenate(los)
    return _epoch_sort_rle(hi, lo, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_compact(a, b, k):
    """Merge two compacted (hi, lo, cnt) parts and re-compact (weighted):
    concatenate, then :func:`~krust.ops.count.merge_runs` (one sort with
    the counts as payload, run-length compaction). Zero counts are
    padding."""
    return merge_runs(*(jnp.concatenate([x, y]) for x, y in zip(a, b)), k)


class EpochTable(DeviceTable):
    """Epoch-sort accumulator: the counting core.

    Batches append RAW sentinel-keyed windows (no per-batch sort, no
    weights); once the epoch budget (:func:`epoch_entry_limit`) is pending,
    ONE flat XLA sort plus the run-length compaction
    (:func:`~krust.ops.count.compact_runs`) turn them into a compacted
    distinct part. Past ``max_parts`` parts, parts merge pairwise
    (concatenate + sort + compaction) on the compacted volume, a fraction
    of the raw one. Each window is sorted exactly once.

    Adaptive epoch sizing: splitting an epoch into slices shortens each
    sort but pays the weighted merge chain on the compacted volume, which
    only pays off on highly duplicated input. After the first epoch
    resolves, its distinct count retunes the limit to
    clamp(ADAPT_DUP_TARGET * distinct, ADAPT_MIN, device budget). An
    explicit KRUST_EPOCH_ENTRIES pins the size and disables adaptation.

    Reference analog: the whole dashmap engine (reference: src/run.rs:489-583).
    """

    #: adaptive size target: epochs aim for this duplication per slice.
    #: Untuned on the GPU (ROADMAP Speed 8).
    ADAPT_DUP_TARGET = 16
    ADAPT_MIN = 1 << 25

    def __init__(self, k: int = 32, max_parts: int = 8):
        super().__init__(k, max_parts)
        self._epoch_limit = epoch_entry_limit()
        # explicit env pin wins over measurement; otherwise adapt after
        # the first epoch's duplication ratio is known
        self._adaptive = not os.environ.get("KRUST_EPOCH_ENTRIES")
        self._raw: list[tuple[jax.Array, jax.Array]] = []
        self._raw_pending = 0
        self._compacted: list[tuple[jax.Array, jax.Array, jax.Array]] = []
        # unresolved epoch: full-length sort+rle output + device-side n.
        # The n sync is DEFERRED until the next flush/finalize needs it, so
        # the host keeps feeding batches while the epoch sort runs (same
        # pipelining trick as DeviceTable._resolve).
        self._pending_epoch = None
        self._pending_epoch_raw = 0
        # parts whose merge would not fit on the device, pulled to the host
        self._host_parts: list[tuple[np.ndarray, np.ndarray]] = []

    def add(self, u_hi, u_lo, u_cnt, n_windows: int):
        """Append one batch's raw sentinel-keyed windows (u_cnt ignored).

        ``u_hi`` may be None for k <= 16 (hi is identically zero and the
        epoch sort is lo-only): the hi plane then never materializes."""
        self._raw.append(
            (None if u_hi is None else u_hi.reshape(-1), u_lo.reshape(-1))
        )
        self._raw_pending += self._raw[-1][1].shape[0]
        self.windows_this_epoch += n_windows
        # feeds the finalize pull's mean-count gate (the epoch path was
        # leaving this at 0, unconditionally choosing the 4-bit packed pull
        # even for high-duplication tables where exceptions dominate)
        self._windows_total += n_windows
        if self._raw_pending >= self._epoch_limit:
            self._flush_raw()

    def _resolve_epoch(self) -> None:
        """Sync the in-flight epoch's n and slice it into a compacted part."""
        if self._pending_epoch is None:
            return
        o_hi, o_lo, o_cnt, n_dev = self._pending_epoch
        epoch_raw = self._pending_epoch_raw
        self._pending_epoch = None
        n = int(n_dev)
        trace_event("epoch_flushed", unique_kmers=n)
        if self._adaptive and epoch_raw:
            # retune from this epoch's measured duplication: high-dup data
            # prefers slices of ~ADAPT_DUP_TARGET * distinct (merges on the
            # compacted volume stay cheaper than the saved sort stages);
            # low-dup data keeps the device-budget maximum
            self._adaptive = False  # one measurement is enough
            target = max(n, 1) * self.ADAPT_DUP_TARGET
            new_limit = min(self._epoch_limit, max(target, self.ADAPT_MIN))
            if new_limit < self._epoch_limit:
                trace_event(
                    "epoch_limit_adapted", new=new_limit, distinct=n,
                    raw=epoch_raw,
                )
                self._epoch_limit = new_limit
        keep = min(_round_pow2(max(n, 1)), o_hi.shape[0])
        self._compacted.append((o_hi[:keep], o_lo[:keep], o_cnt[:keep], n))
        if len(self._compacted) > self._max_parts:
            self._merge_compacted()

    def _flush_raw(self) -> None:
        self._resolve_epoch()  # sync overlaps the batches queued since
        if not self._raw:
            return
        with span("epoch_flush", pending=self._raw_pending):
            his = (
                None
                if any(p[0] is None for p in self._raw)
                else [p[0] for p in self._raw]
            )
            los = [p[1] for p in self._raw]
            self._pending_epoch_raw = self._raw_pending
            self._raw = []
            self._raw_pending = 0
            self._pending_epoch = _epoch_concat_sort_rle(his, los, self._k)

    def _merge_compacted(self) -> None:
        runs = self._compacted
        entries = sum(r[0].shape[0] for r in runs)
        if len(runs) > 1 and entries > self._pending_limit:
            # their merge would not fit beside them on the device
            # (MERGE_BYTES_PER_ENTRY): the host merges them at finalize
            with span("part_spill", entries=entries):
                self._host_parts.extend(self._pull_part(*r) for r in runs)
            self._compacted = []
            return
        while len(runs) > 1:
            nxt = []
            for i in range(0, len(runs) - 1, 2):
                with span("part_merge", entries=runs[i][3] + runs[i + 1][3]):
                    o_hi, o_lo, o_cnt, n_dev = _merge_compact(
                        runs[i][:3], runs[i + 1][:3], self._k
                    )
                    n = int(n_dev)
                keep = min(_round_pow2(max(n, 1)), o_hi.shape[0])
                nxt.append((o_hi[:keep], o_lo[:keep], o_cnt[:keep], n))
            if len(runs) % 2:
                nxt.append(runs[-1])
            runs = nxt
        self._compacted = runs

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        self._flush_raw()
        self._resolve_epoch()
        self._merge_compacted()
        if self._host_parts:
            from ..models.engines import _merge_partials

            parts = self._host_parts + [self._pull_part(*r) for r in self._compacted]
            self._reset()
            return _merge_partials([p[0] for p in parts], [p[1] for p in parts])
        if not self._compacted:
            self._reset()
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        t_hi, t_lo, t_cnt, n = self._compacted[0]
        self._table = (t_hi, t_lo, t_cnt)
        self._table_entries = n
        self._compacted = []
        return self._pull_table()

    def _reset(self) -> None:
        super()._reset()
        self._raw = []
        self._raw_pending = 0
        self._compacted = []
        self._pending_epoch = None
        self._pending_epoch_raw = 0
        self._host_parts = []
