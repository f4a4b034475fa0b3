"""Device mesh construction.

The reference is single-process shared-memory (SURVEY.md §2, "Parallelism
strategies"); the distributed layer here is new. The mesh has one ``data``
axis over all chips: read blocks shard data-parallel along it, and the merge
phase hash-shards the count table along the same axis (an expert-parallel-like
all-to-all), so the interconnect carries the (much smaller) deduplicated
partial tables.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """Build a 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def init_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Initialize multi-host JAX (jax.distributed) when running on a pod slice.

    Single-host runs need not call this. Safe to call once per process before
    any collective work.
    """
    jax.distributed.initialize(coordinator_address=coordinator, **kwargs)
