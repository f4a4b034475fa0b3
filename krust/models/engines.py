"""Counting engines.

Three interchangeable engines produce identical results (a determinism
contract tested in tests/test_flat.py and tests/test_sharded.py):

- :class:`BatchEngine` — the GPU path. 2-bit stream slices transfer in
  fixed-shape batches; a jitted step runs the rolling codec
  (:mod:`krust.ops.codec`) and emits raw sentinel-keyed windows into the
  epoch-sort table (:class:`krust.ops.table.EpochTable`: one flat XLA
  sort per epoch + the run-length compaction
  :func:`krust.ops.count.compact_runs`). Replaces the reference's
  rayon + dashmap engine (reference: src/run.rs:489-583).
- :class:`NumpyEngine` — the same algorithm in pure numpy uint64 on host.
  Fallback when no accelerator is usable, and the differential oracle.
- :class:`SequentialEngine` — record-at-a-time counting (numpy per record),
  mirroring the reference's single-threaded paths
  (reference: src/streaming.rs:665-830).

All engines consume :class:`~krust.io.reader.ParsedStreams` and return
:class:`PackedCounts`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable

import jax
import numpy as np

from ..io.packer import PackedBatch
from ..io.reader import ParsedStreams
from ..kmer import INVALID_CODE, unpack_many
from ..utils.config import EngineConfig
from ..utils.progress import Progress, ProgressTracker
from ..utils.tracing import span, trace_event

ProgressCallback = Callable[[Progress], None]


@dataclass
class PackedCounts:
    """Final counting result: sorted distinct canonical codes and counts.

    ``codes``/``counts`` are uint64 numpy arrays sorted by code. Counts use
    u64 accumulation; saturation at u64::MAX matches the reference contract
    (reference: src/run.rs:569) though it is unreachable for physical inputs.
    """

    k: int
    codes: np.ndarray
    counts: np.ndarray

    @property
    def distinct(self) -> int:
        return int(self.codes.shape[0])

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def to_packed_dict(self) -> dict[int, int]:
        return dict(zip(self.codes.tolist(), self.counts.tolist()))

    def to_string_dict(self) -> dict[str, int]:
        strings = unpack_many(self.codes, self.k)
        return dict(zip(strings, self.counts.tolist()))

    def get(self, packed: int) -> int:
        i = np.searchsorted(self.codes, np.uint64(packed))
        if i < self.codes.shape[0] and self.codes[i] == np.uint64(packed):
            return int(self.counts[i])
        return 0

    @classmethod
    def empty(cls, k: int) -> "PackedCounts":
        return cls(k, np.zeros(0, np.uint64), np.zeros(0, np.uint64))


class _HostAccumulator:
    """Merges per-batch (codes, counts) partials into one sorted table.

    Compacts lazily: partials concatenate until ``threshold`` entries, then a
    sort-merge collapses duplicates — amortized O(n log n) host work that
    overlaps with device compute of subsequent batches.
    """

    def __init__(self, threshold: int = 64_000_000):
        self._codes: list[np.ndarray] = []
        self._counts: list[np.ndarray] = []
        self._pending = 0
        self._threshold = threshold

    def add(self, codes: np.ndarray, counts: np.ndarray) -> None:
        if codes.shape[0] == 0:
            return
        self._codes.append(np.asarray(codes, np.uint64))
        self._counts.append(np.asarray(counts, np.uint64))
        self._pending += codes.shape[0]
        if self._pending > self._threshold:
            self._compact()

    def _compact(self) -> None:
        merged = _merge_partials(self._codes, self._counts)
        self._codes = [merged[0]]
        self._counts = [merged[1]]
        self._pending = merged[0].shape[0]

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        self._compact()
        return self._codes[0], self._counts[0]


def _merge_partials(
    codes_list: list[np.ndarray], counts_list: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    if not codes_list:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    codes = np.concatenate(codes_list)
    counts = np.concatenate(counts_list)
    uniq, inverse = np.unique(codes, return_inverse=True)
    sums = np.zeros(uniq.shape[0], dtype=np.uint64)
    np.add.at(sums, inverse, counts)
    return uniq, sums


def _quality_threshold(min_quality: int | None) -> int | None:
    """Phred threshold -> ASCII threshold, saturating (reference: src/run.rs:538)."""
    if min_quality is None:
        return None
    return min(min_quality + 33, 255)


class _ProgressPacer:
    """Apportions stream-level progress across device batches.

    The reference fires its callback after every sequence from worker
    threads (reference: src/run.rs:586-654); the device engine's unit of
    work is a window batch, so the callback fires once per batch with
    record/base totals apportioned by window fraction, then trued up to the
    exact totals when the stream is done. Same Progress payload, monotonic,
    batch cadence.
    """

    def __init__(
        self,
        tracker: ProgressTracker | None,
        callback: ProgressCallback | None,
        n_records: int,
        n_bases: int,
        total_windows: int,
    ):
        self._tracker = tracker
        self._callback = callback
        self._n_records = n_records
        self._n_bases = n_bases
        self._total = max(total_windows, 1)
        self._done_windows = 0
        self._rec_sent = 0
        self._base_sent = 0

    def step(self, windows: int) -> None:
        """Record one processed batch covering ``windows`` real windows."""
        if self._tracker is None:
            return
        self._done_windows = min(self._done_windows + windows, self._total)
        frac = self._done_windows / self._total
        rec = min(int(frac * self._n_records), self._n_records)
        base = min(int(frac * self._n_bases), self._n_bases)
        self._tracker.record_batch(rec - self._rec_sent, base - self._base_sent)
        self._rec_sent, self._base_sent = rec, base
        if self._callback is not None:
            self._callback(self._tracker.snapshot())

    def finish(self) -> None:
        """True up to the exact stream totals (always fires once)."""
        if self._tracker is None:
            return
        self._tracker.record_batch(
            self._n_records - self._rec_sent, self._n_bases - self._base_sent
        )
        self._rec_sent = self._n_records
        self._base_sent = self._n_bases
        if self._callback is not None:
            self._callback(self._tracker.snapshot())


# --- numpy host engine -----------------------------------------------------------


def count_stream_numpy(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Rolling canonical encode + count on host in uint64.

    Same semantics as the device codec (see ops/codec.py docstring); numpy
    has native 64-bit lanes so no hi/lo split is needed.
    """
    t = codes.shape[0] - k + 1
    if t <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    good = codes < INVALID_CODE
    if qual is not None and quality_threshold is not None:
        good = good & (qual >= quality_threshold)
    b = np.where(good, codes, 0).astype(np.uint64)
    comp = np.where(good, 3 - codes.astype(np.int64), 0).astype(np.uint64)

    fwd = np.zeros(t, np.uint64)
    rc = np.zeros(t, np.uint64)
    valid = np.ones(t, bool)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | b[j : j + t]
        rc = (rc << np.uint64(2)) | comp[k - 1 - j : k - 1 - j + t]
        valid &= good[j : j + t]
    canon = np.minimum(fwd, rc)
    return np.unique(canon[valid], return_counts=True)


def count_stream_host(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Best host path: native C++ rolling+sort core, numpy fallback.

    The native core (io/native/krust_native.cpp krust_count_stream) is the
    sort-based host twin of the device engine — ~50x the pure-numpy path on a
    single core — used when no accelerator is available.
    """
    from ..io import native as _native

    res = _native.count_stream_native(codes, qual, quality_threshold, k)
    if res is not None:
        return res
    return count_stream_numpy(codes, qual, k, quality_threshold)


class NumpyEngine:
    """Pure-host engine; exact, no accelerator required.

    Stays pure numpy on purpose: it is the mid-level oracle of the 3-way
    differential (device / numpy / brute-force, SURVEY.md §4). The fast
    host path for production fallback is :class:`NativeEngine`.
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        with span("process_sequences", engine="numpy", k=k):
            uniq, cnt = count_stream_numpy(streams.codes, streams.qual, k, thr)
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
        counts = cnt.astype(np.uint64)
        return PackedCounts(k, uniq, counts)


class NativeEngine:
    """Host engine on the native C++ counting core (numpy fallback).

    The no-accelerator production engine: rolling canonical encode + sort +
    RLE in one native call — the same sort-based design as the device
    engine, not the reference's hash map (reference: src/run.rs:489-583).
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        with span("process_sequences", engine="native", k=k):
            uniq, cnt = count_stream_host(streams.codes, streams.qual, k, thr)
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
        return PackedCounts(k, uniq, np.asarray(cnt, dtype=np.uint64))


# --- device batch engine ----------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("k", "rows", "block_windows", "mode")
)
def _count_flat_step(packed2, invpos, covered, k, rows, block_windows, mode="raw"):
    """Flat-transfer batch step: the minimum-byte device pipeline.

    Unpacks a contiguous 2-bit stream slice, scatters invalid positions,
    blockizes with reshape/slice on device, runs the rolling codec, and masks
    windows at global index >= ``covered``. Unpack, codec and mask are
    shifts, ORs and compares that XLA fuses into a few loop fusions. Output
    by ``mode``:

    - ``"raw"``: per-window (hi, lo, weight) with weight 1 for valid windows
      (DeviceTable: dedup happens in the LSM merge sorts).
    - ``"raw_sent"``: UNSORTED (hi, lo) with invalid windows as the
      (SENT, SENT) key — the EpochTable path; the epoch sort orders
      everything at once, so the batch step stays codec-only.
    """
    from ..ops.codec import encode_blocks, unpack_flat_blocks

    jnp = jax.numpy
    blocks = unpack_flat_blocks(packed2, invpos, k, rows, block_windows)
    hi, lo, valid = encode_blocks(blocks, k)
    idx = jnp.arange(rows * block_windows, dtype=jnp.int32)
    valid = valid & (idx.reshape(rows, block_windows) < covered)
    if mode == "raw_sent":
        return _sentinel_part(hi, lo, valid, k)
    return hi, lo, valid.astype(jnp.uint32)


def _sentinel_part(hi, lo, valid, k=32):
    """Unsorted (hi, lo) with invalid windows keyed (SENT, SENT) — never a
    canonical code for any k (the all-ones k-mer's RC is all-zeros).

    k <= 16: hi is identically zero and the epoch sort is lo-only, so the
    part is a 1-tuple (lo,) — the hi plane never materializes."""
    jnp = jax.numpy
    sent = jnp.uint32(0xFFFFFFFF)
    valid = valid.reshape(-1)
    s_lo = jnp.where(valid, lo.reshape(-1), sent)
    if k <= 16:
        return (s_lo,)
    return (jnp.where(valid, hi.reshape(-1), sent), s_lo)


@functools.partial(jax.jit, static_argnames=("k", "width", "mode"))
def _dense_raw_step(packed2, badbits, k, width, mode="raw"):
    """Dense-mask batch step: unpack -> codec -> per-window output (see
    :func:`_count_flat_step` for the mode contract)."""
    from ..ops.codec import encode_blocks, unpack_2bit

    hi, lo, valid = encode_blocks(unpack_2bit(packed2, badbits, width), k)
    if mode == "raw_sent":
        return _sentinel_part(hi, lo, valid, k)
    return hi, lo, valid.astype(jax.numpy.uint32)


def _prefetch_staged(gen, stage_fn, depth: int):
    """Run ``stage_fn`` over ``gen`` in a background thread, ``depth`` deep.

    The double-buffered host->device feed (SURVEY §7 L3; VERDICT r4 weak
    #3): ``stage_fn`` does the per-batch host glue + ``device_put``
    dispatch off the main thread, so transfers overlap the device compute
    the main loop keeps dispatching. A bounded queue caps in-flight
    batches (device memory: ~8MB packed bytes each). FIFO order is
    preserved — results are bit-identical to the synchronous loop, pinned
    by tests/test_flat.py. ``depth <= 0`` degrades to the synchronous
    map (used by tests and single-batch inputs).

    Reference analog: rayon's read/compute overlap (src/reader.rs:58-79).
    """
    if depth <= 0:
        for b in gen:
            yield stage_fn(b)
        return
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker():
        try:
            for b in gen:
                if stop.is_set() or not put(stage_fn(b)):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=worker, name="krust-feed", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()  # consumer abandoned early: unblock the worker


class BatchEngine:
    """Device engine: stream fixed-shape batches through a fused jitted step.

    Batches are padded to power-of-two row buckets so at most
    ``log2(batch_rows)`` distinct shapes are ever compiled.
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def _bucket_rows(self, rows: int) -> int:
        cap = self.config.batch_rows
        b = 8
        while b < rows and b < cap:
            b *= 2
        return max(b, rows) if rows > cap else b

    def _pad_batch(self, batch: PackedBatch) -> PackedBatch:
        rows = batch.codes.shape[0]
        target = self._bucket_rows(rows)
        if target == rows:
            return batch
        pad = target - rows
        codes = np.vstack(
            [batch.codes, np.full((pad, batch.codes.shape[1]), INVALID_CODE, np.uint8)]
        )
        qual = None
        if batch.qual is not None:
            qual = np.vstack(
                [batch.qual, np.full((pad, batch.qual.shape[1]), 0xFF, np.uint8)]
            )
        return PackedBatch(codes, qual, batch.n_windows, batch.block_windows)

    def _pad_batch2(self, batch):
        from ..io.packer import PackedBatch2

        rows = batch.packed2.shape[0]
        target = self._bucket_rows(rows)
        if target == rows:
            return batch
        pad = target - rows
        packed2 = np.vstack(
            [batch.packed2, np.zeros((pad, batch.packed2.shape[1]), np.uint8)]
        )
        badbits = np.vstack(
            [batch.badbits, np.full((pad, batch.badbits.shape[1]), 0xFF, np.uint8)]
        )
        return PackedBatch2(
            packed2, badbits, batch.n_windows, batch.block_windows, batch.width
        )

    def _make_table(self, k: int):
        from ..ops.table import DeviceTable, EpochTable

        cfg = self.config
        if cfg.use_epoch_sort:
            return "raw_sent", EpochTable(k)
        return "raw", DeviceTable(k)

    def _feed_streams(
        self, streams, k, min_quality, table, mode, epochs, on_windows
    ) -> None:
        """Feed one parsed stream's batches into ``table`` (shared by the
        eager and chunked ingest paths)."""
        from ..io.packer import flat_batches, pack_buffer_2bit
        from ..ops.table import EPOCH_WINDOW_LIMIT

        cfg = self.config
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        qual_stream = streams.qual if thr is not None else None
        flat = (
            flat_batches(
                streams.codes, qual_stream, k, thr,
                cfg.block_windows, cfg.batch_rows,
            )
            if cfg.use_flat
            else None
        )
        depth = cfg.feed_depth
        if flat is not None:
            # stage (host glue + device_put dispatch) runs on the feeder
            # thread so transfers overlap the compute dispatched below
            staged = _prefetch_staged(
                flat,
                lambda b: (
                    jax.numpy.asarray(b.packed2),
                    jax.numpy.asarray(b.invpos),
                    b,
                ),
                depth,
            )
            for p2, iv, batch in staged:
                batch_windows = batch.rows * batch.block_windows
                if table.windows_this_epoch + batch_windows >= EPOCH_WINDOW_LIMIT:
                    epochs.append(table.finalize())  # uint32 headroom exhausted
                with span("encode_count_batch", rows=batch.rows, path="flat"):
                    out = _count_flat_step(
                        p2,
                        iv,
                        np.int32(batch.covered),
                        k,
                        batch.rows,
                        batch.block_windows,
                        mode,
                    )
                    if len(out) == 1:  # lo-only sentinel part (k <= 16)
                        table.add(None, out[0], None, batch_windows)
                    elif len(out) == 2:
                        table.add(out[0], out[1], None, batch_windows)
                    else:
                        table.add(out[0], out[1], out[2], batch_windows)
                on_windows(batch.covered)
        else:  # dense path: invalid/quality-masked bases too numerous
            batches = pack_buffer_2bit(
                streams.codes, qual_stream, k, thr, cfg.block_windows, cfg.batch_rows
            )

            def _stage_dense(batch):
                batch = self._pad_batch2(batch)
                return (
                    jax.numpy.asarray(batch.packed2),
                    jax.numpy.asarray(batch.badbits),
                    batch,
                )

            for p2, bb, batch in _prefetch_staged(batches, _stage_dense, depth):
                batch_windows = batch.packed2.shape[0] * batch.block_windows
                if table.windows_this_epoch + batch_windows >= EPOCH_WINDOW_LIMIT:
                    epochs.append(table.finalize())
                with span(
                    "encode_count_batch", rows=batch.packed2.shape[0], path="dense"
                ):
                    out = _dense_raw_step(p2, bb, k, batch.width, mode)
                    if len(out) == 1:  # lo-only sentinel part (k <= 16)
                        table.add(None, out[0], None, batch_windows)
                    elif len(out) == 2:
                        table.add(out[0], out[1], None, batch_windows)
                    else:
                        table.add(out[0], out[1], out[2], batch_windows)
                on_windows(batch.n_windows)

    @staticmethod
    def _merge_epochs(epochs, k) -> PackedCounts:
        if len(epochs) == 1:
            codes64, counts64 = epochs[0]  # already sorted and distinct
        else:
            codes64, counts64 = _merge_partials(
                [e[0] for e in epochs], [e[1] for e in epochs]
            )
        trace_event("unpack_kmers", unique_kmers=int(codes64.shape[0]))
        return PackedCounts(k, codes64, counts64)

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        mode, table = self._make_table(k)
        epochs: list[tuple[np.ndarray, np.ndarray]] = []
        total_windows = max(streams.codes.shape[0] - k + 1, 0)
        pacer = _ProgressPacer(
            tracker, progress, streams.n_records, streams.n_bases, total_windows
        )
        self._feed_streams(
            streams, k, min_quality, table, mode, epochs, pacer.step
        )
        pacer.finish()
        epochs.append(table.finalize())
        return self._merge_epochs(epochs, k)

    def count_chunked(
        self,
        chunks,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        """Count an iterator of :class:`ParsedStreams` chunks as one input.

        The bounded-host-memory ingest path (reference's true-streaming
        engines: src/streaming.rs:513-616): each chunk is parsed, fed, and
        released before the next is read, so host RSS stays at
        O(chunk + device tables) regardless of input size. Exact: chunks cut
        at record boundaries, and the table accumulates across chunks.
        """
        mode, table = self._make_table(k)
        epochs: list[tuple[np.ndarray, np.ndarray]] = []
        for streams in chunks:
            self._feed_streams(
                streams, k, min_quality, table, mode, epochs, lambda w: None
            )
            if tracker is not None:
                tracker.record_batch(streams.n_records, streams.n_bases)
                if progress is not None:
                    progress(tracker.snapshot())
        epochs.append(table.finalize())
        return self._merge_epochs(epochs, k)


# --- sequential engine -------------------------------------------------------------


class SequentialEngine:
    """Record-at-a-time engine (reference: src/streaming.rs:665-830).

    Processes each record independently and merges — useful for bounded-memory
    pipes and as a third differential implementation.
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count_records(
        self,
        records,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        from ..kmer import BASE_LUT

        acc = _HostAccumulator()
        for rec in records:
            seq = rec.seq if hasattr(rec, "seq") else rec
            qual = rec.qual if hasattr(rec, "qual") else None
            codes = BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]
            qarr = (
                np.frombuffer(qual, dtype=np.uint8) if qual is not None else None
            )
            thr = _quality_threshold(min_quality) if qarr is not None else None
            uniq, cnt = count_stream_numpy(codes, qarr, k, thr)
            acc.add(uniq, np.asarray(cnt, dtype=np.uint64))
            if tracker is not None:
                tracker.record_sequence(len(seq))
                if progress is not None:
                    progress(tracker.snapshot())
        codes64, counts64 = acc.result()
        return PackedCounts(k, codes64, counts64)


# --- engine selection ---------------------------------------------------------------


def select_engine(cfg: EngineConfig):
    """The engine for this config and this process's JAX backend.

    Dispatch order: an explicit numpy request (config beats environment —
    it is the documented differential-testing knob) -> the KRUST_ENGINE
    override (``native`` / ``numpy`` / ``device``) -> the backend: ``gpu``
    runs the device engine; any other backend runs the native C++ host
    core (numpy when ``use_native_host`` is off), the product mode for a
    machine with no accelerator. ``KRUST_ENGINE=device`` without a GPU
    backend is an error, not a silent XLA-CPU run.
    """
    if cfg.use_numpy_backend:
        return NumpyEngine(cfg)  # explicit request: the pure-numpy oracle
    forced = os.environ.get("KRUST_ENGINE", "").lower()
    if forced == "numpy":
        return NumpyEngine(cfg)
    if forced == "native":
        return NativeEngine(cfg)
    if forced and forced not in ("device", "jax", "batch"):
        raise ValueError(
            f"KRUST_ENGINE={forced!r}: expected 'native', 'numpy' or 'device'"
        )
    backend = jax.default_backend()
    if backend == "gpu":
        return BatchEngine(cfg)
    if forced:
        raise RuntimeError(
            f"KRUST_ENGINE={forced} needs a GPU backend; JAX has {backend!r}"
        )
    return NativeEngine(cfg) if cfg.use_native_host else NumpyEngine(cfg)


def count_streams(
    streams: ParsedStreams,
    k: int,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
    tracker: ProgressTracker | None = None,
) -> PackedCounts:
    """Count with the best available engine (see :func:`select_engine`)."""
    cfg = config or EngineConfig()
    engine = select_engine(cfg)
    return engine.count(streams, k, min_quality, progress, tracker)


def count_chunked_streams(
    chunks,
    k: int,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
    tracker: ProgressTracker | None = None,
) -> PackedCounts:
    """Count an iterator of :class:`ParsedStreams` chunks as one input.

    The bounded-host-memory twin of :func:`count_streams` (reference's
    true-streaming engines: src/streaming.rs:513-616): chunks are consumed
    and released one at a time on whichever engine is available, so host RSS
    stays at O(chunk + tables) for arbitrarily large pipes.
    """
    cfg = config or EngineConfig()
    engine = select_engine(cfg)
    if isinstance(engine, BatchEngine):
        return engine.count_chunked(chunks, k, min_quality, progress, tracker)
    count_fn = (
        count_stream_host
        if isinstance(engine, NativeEngine)
        else count_stream_numpy
    )
    acc = _HostAccumulator(cfg.host_compact_threshold)
    for streams in chunks:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        uniq, cnt = count_fn(streams.codes, streams.qual, k, thr)
        acc.add(uniq, np.asarray(cnt, dtype=np.uint64))
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
    codes64, counts64 = acc.result()
    return PackedCounts(k, codes64, counts64)
