"""Runtime engine configuration.

Replaces the reference's compile-time cargo feature matrix
(reference: Cargo.toml:47-64) with one runtime dataclass: gzip/mmap/tracing
are always available; knobs that were features become fields here.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EngineConfig:
    """Tunables for the device counting pipeline."""

    #: windows per block row (last-dim extent is block_windows + k - 1)
    block_windows: int = 4096

    #: max rows per device batch; bounds HBM footprint for huge inputs.
    #: 8192 rows x 4096 windows = 33.6M windows/batch (~1GB working set) —
    #: large batches amortize sort cost and minimize table compactions.
    batch_rows: int = 8192

    #: host-side partial-results compaction threshold (entries)
    host_compact_threshold: int = 64_000_000

    #: force the numpy host backend (no jax) — used on machines without a
    #: usable accelerator and for differential testing
    use_numpy_backend: bool = False

    #: when no accelerator is usable, count on the native C++ host core
    #: (rolling canonical + sort + RLE) instead of pure numpy; numpy remains
    #: the automatic fallback when the native lib can't build
    use_native_host: bool = True

    #: use the epoch-sort table: batches append raw sentinel-keyed windows;
    #: one flat XLA sort plus a run-length compaction per epoch (sized from
    #: the device's memory, ops/table.py) replaces the per-compaction merge
    #: sorts of DeviceTable. Exact; differentially tested.
    use_epoch_sort: bool = True

    #: use the flat minimal-byte transfer path (2-bit stream slices + sparse
    #: invalid positions) when invalid bases are sparse; falls back to the
    #: dense badbits path automatically for dirty inputs
    use_flat: bool = True

    #: when set, file/stdin inputs stream through record-aligned chunks of
    #: this many bytes instead of one eager whole-file parse — bounded host
    #: memory for inputs larger than RAM (None = eager, the default)
    ingest_chunk_bytes: int | None = None

    #: double-buffered feed depth: a background thread stages (host glue +
    #: device_put) up to this many batches ahead so host->device transfers
    #: overlap device compute (SURVEY §7 L3). 0 = synchronous feed.
    #: Results are bit-identical either way (FIFO order preserved).
    feed_depth: int = 2
