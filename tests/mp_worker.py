"""Worker for the 2-process jax.distributed test (spawned by test_multihost).

Each process parses ONLY its half of the records (per-host input sharding),
counts over the global 2x4-device CPU mesh, and writes the hash-range table
shards its devices own. The parent asserts the union equals the oracle.
"""

import os
import random
import sys

import numpy as np


def main():
    proc_id = int(sys.argv[1])
    n_procs = int(sys.argv[2])
    coordinator = sys.argv[3]
    outdir = sys.argv[4]
    k = int(sys.argv[5])
    alphabet = sys.argv[6] if len(sys.argv) > 6 else "ACGTN"

    import jax

    # force CPU before any backend/distributed initialization: the test
    # drives processes of a virtual CPU cluster, whatever the host has
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=n_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == n_procs
    assert len(jax.devices()) == n_procs * jax.local_device_count()

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))  # repo root: krust import
    import oracle

    from krust.io.reader import streams_from_sequences
    from krust.parallel.mesh import make_mesh
    from krust.parallel.sharded import count_sharded
    from krust.utils.config import EngineConfig

    rng = random.Random(1234)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), alphabet) for _ in range(40)]
    # per-host input sharding: this process parses only its own records
    local = seqs[proc_id::n_procs]
    streams = streams_from_sequences(local)

    # double-parse regression spy: the whole input must be native-scanned
    # (parsed + 2-bit packed) AT MOST once per process, by the feeding pass
    from krust.io import native as _native

    scan_calls = {"n": 0}
    _real_scan = _native.scan_stream_native

    def _spy(*a, **kw):
        scan_calls["n"] += 1
        return _real_scan(*a, **kw)

    _native.scan_stream_native = _spy

    mesh = make_mesh()
    cfg = EngineConfig(block_windows=128, batch_rows=16)
    result = count_sharded(streams, k, mesh=mesh, config=cfg)
    assert scan_calls["n"] <= 1, f"input scanned {scan_calls['n']} times"

    np.savez(
        os.path.join(outdir, f"shard_{proc_id}.npz"),
        codes=result.codes,
        counts=result.counts,
    )
    print(f"proc {proc_id}: {result.distinct} distinct", flush=True)


if __name__ == "__main__":
    main()
