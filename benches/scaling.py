"""Multi-chip scaling-efficiency harness (BASELINE.md target: >= 85%).

Weak scaling: fixed windows PER DEVICE, meshes of 1/2/4/8 devices, the full
sharded pipeline (data-parallel codec -> per-chip epoch tables -> one
hash-sharded all-to-all -> host gather). Efficiency_n = T_1 / T_n with
per-device work held constant (ideal = 1.0).

On virtual CPU devices the numbers characterize the orchestration overhead
and collective volume only; the harness runs unchanged on a multi-GPU
host, where the times are the card's. Every mesh size is also exactness-checked against the host
oracle, so the artifact doubles as a determinism record.

Run: KRUST_PLATFORM=cpu python benches/scaling.py [out.json]
(also honors SCALING_OUT; prints one JSON line to stdout either way)
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax

    from krust.io.reader import ParsedStreams
    from krust.kmer import INVALID_CODE
    from krust.models.engines import NumpyEngine
    from krust.parallel.mesh import make_mesh
    from krust.parallel.sharded import count_sharded
    from krust.utils.config import EngineConfig

    k = 21
    rng = np.random.default_rng(0)
    n_avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]

    def make_streams(n_bases):
        codes = rng.integers(0, 4, n_bases, np.uint8)
        codes[rng.random(n_bases) < 0.001] = INVALID_CODE
        return ParsedStreams(codes, None, 1, n_bases)

    virtual = jax.devices()[0].platform != "gpu"
    per_dev_bases = int(
        os.environ.get("SCALE_BASES_PER_DEV", 400_000 if virtual else 2_000_000)
    )
    cfg = EngineConfig(block_windows=4096, batch_rows=256)
    if virtual:
        print(
            "# NOTE: virtual CPU devices share one physical core — weak\n"
            "# scaling MUST degrade ~1/n here. This run validates the\n"
            "# harness + exactness per mesh size; efficiency numbers are\n"
            "# meaningful solely on real multi-chip hardware.",
            flush=True,
        )
    from krust.utils import tracing

    meshes = []
    t1 = None
    for n in sizes:
        streams = make_streams(per_dev_bases * n)
        mesh = make_mesh(n)
        count_sharded(streams, k, mesh=mesh, config=cfg)  # warmup/compile

        # per-phase attribution + collective volume + shard skew for the
        # measured pass (VERDICT r4 #7: make the first real pod run
        # diagnosable, not just a number)
        phases: dict[str, float] = {}
        wire = {"bytes": 0, "exchanges": 0}
        skew: dict[str, object] = {}

        def collect(kind, name, fields):
            if kind == "span":
                phases[name] = phases.get(name, 0.0) + fields["elapsed_s"]
                if name == "sharded_exchange":
                    wire["bytes"] += fields.get("wire_bytes", 0)
                    wire["exchanges"] += 1
            elif kind == "event" and name == "shard_sizes":
                sizes_ = fields["sizes"]
                skew["per_device_n_unique"] = sizes_
                if sizes_ and max(sizes_):
                    mean = sum(sizes_) / len(sizes_)
                    skew["max_over_mean"] = round(max(sizes_) / max(mean, 1), 4)

        ts = []
        for i in range(3):
            if i == 2:  # attribute the last (warm) pass
                tracing.add_collector(collect)
            t0 = time.perf_counter()
            res = count_sharded(streams, k, mesh=mesh, config=cfg)
            ts.append(time.perf_counter() - t0)
        tracing.remove_collector(collect)
        t = min(ts)
        exp = NumpyEngine().count(streams, k)
        exact = bool(
            np.array_equal(res.codes, exp.codes)
            and np.array_equal(res.counts, exp.counts)
        )
        assert exact, f"sharded result diverged from oracle at {n} devices"
        if n == 1:
            t1 = t
        eff = (t1 / t) if t1 else 1.0
        t_attr = ts[2]
        row = {
            "devices": n,
            "bases": per_dev_bases * n,
            "wall_s": round(t, 4),
            "bases_per_s": round(per_dev_bases * n / t, 1),
            "weak_scaling_efficiency": round(eff, 4),
            "exact_vs_oracle": exact,
            "attributed_pass_wall_s": round(t_attr, 4),
            "phase_wall_s": {
                p: round(v, 4) for p, v in sorted(phases.items())
            },
            "all_to_all_gross_bytes": wire["bytes"],
            "exchanges": wire["exchanges"],
            **skew,
        }
        meshes.append(row)
        print(
            f"devices={n} bases={row['bases']} wall={t:.2f}s "
            f"weak_scaling_efficiency={eff:.2f} exact={exact} "
            f"wire={wire['bytes']>>10}KiB "
            f"skew={skew.get('max_over_mean', 'n/a')}",
            flush=True,
        )

    result = {
        "metric": "weak-scaling efficiency, sharded count pipeline, k=21",
        "platform": jax.devices()[0].platform,
        "virtual_cpu_mesh": virtual,
        "n_physical_cores": os.cpu_count(),
        "per_device_bases": per_dev_bases,
        "target_efficiency": 0.85,
        "meshes": meshes,
        "note": (
            "virtual CPU devices timeshare one physical core: wall-clock "
            "efficiency is ~1/n by construction and does NOT reflect ICI "
            "scaling; exact_vs_oracle per mesh size is the meaningful "
            "signal off-chip"
            if virtual
            else "real accelerator mesh"
        ),
    }
    out = None
    if len(sys.argv) > 1:
        out = sys.argv[1]
    elif os.environ.get("SCALING_OUT"):
        out = os.environ["SCALING_OUT"]
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
