"""Randomized exactness soak on the GPU: device engine vs the native C++ core.

chip_smoke.py fixes its read distributions and sweeps k; this soak
randomizes the CONTENT — coverage, read length, N density, quality
filtering, stream size — at production batch geometry, with k drawn from
1..=32, and asserts full-table equality between the device engine on the
card and the native host core per trial.

Geometry stays fixed at the production defaults so compiled executables
are reused across trials (random shapes would turn the soak into a
compile benchmark).

Run: SOAK_SECONDS=1800 python benches/soak_device.py
Exit 0 = no divergence found. One line per trial; a divergent input is
saved to chiprun_out/soak_divergence.npz.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def main() -> int:
    import jax

    from krust.io.reader import ParsedStreams
    from krust.kmer import INVALID_CODE
    from krust.models.engines import BatchEngine, NativeEngine
    from krust.utils.config import EngineConfig
    from krust.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    budget = float(
        sys.argv[1] if len(sys.argv) > 1
        else os.environ.get("SOAK_SECONDS", "1800")
    )
    print(f"devices: {jax.devices()}  budget={budget:.0f}s", flush=True)
    if jax.devices()[0].platform != "gpu":
        print("soak_device: needs a GPU (benches/soak.py runs on the CPU)",
              file=sys.stderr)
        return 1

    rng = np.random.default_rng(int(os.environ.get("SOAK_SEED", "1")))
    dev = BatchEngine(EngineConfig())
    nat = NativeEngine(EngineConfig())
    t_end = time.monotonic() + budget
    trials = 0
    while time.monotonic() < t_end:
        trials += 1
        k = int(rng.integers(1, 33))
        n_bases = int(rng.integers(4, 33)) * 1_000_000
        coverage = int(rng.choice([1, 8, 32, 200]))
        read_len = int(rng.choice([80, 250, 1000]))
        p_inv = float(rng.choice([0.0, 0.0005, 0.01]))
        use_qual = bool(rng.integers(0, 2))

        genome_len = max(n_bases // coverage, read_len + 1)
        genome = rng.integers(0, 4, genome_len, np.uint8)
        n_reads = max(n_bases // read_len, 1)
        starts = rng.integers(0, genome_len - read_len, n_reads, np.int64)
        reads = genome[
            starts[:, None] + np.arange(read_len, dtype=np.int64)[None, :]
        ]
        stream = np.empty((n_reads, read_len + 1), np.uint8)
        stream[:, :read_len] = reads
        stream[:, read_len] = INVALID_CODE
        stream = stream.reshape(-1)[:-1].copy()
        if p_inv:
            bad = rng.random(stream.shape[0]) < p_inv
            stream[bad] = INVALID_CODE
        qual = thr = None
        if use_qual:
            qual = rng.integers(33, 75, stream.shape[0]).astype(np.uint8)
            thr = int(rng.integers(0, 41))
        streams = ParsedStreams(stream, qual, n_reads, stream.shape[0])

        t0 = time.perf_counter()
        got = dev.count(streams, k, min_quality=thr)
        t_dev = time.perf_counter() - t0
        exp = nat.count(streams, k, min_quality=thr)
        ok = np.array_equal(got.codes, exp.codes) and np.array_equal(
            got.counts, exp.counts
        )
        print(
            f"trial {trials}: k={k} bases={n_bases//1_000_000}M cov={coverage} "
            f"rl={read_len} p_inv={p_inv} q={thr} distinct={got.distinct} "
            f"{'OK' if ok else 'DIVERGED'} ({t_dev:.1f}s dev)",
            flush=True,
        )
        if not ok:
            os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
            np.savez(
                os.path.join(REPO, "chiprun_out", "soak_divergence.npz"),
                stream=stream,
                qual=qual if qual is not None else np.zeros(0, np.uint8),
                k=k,
                thr=-1 if thr is None else thr,
            )
            return 1
    print(f"device soak passed: {trials} randomized trials", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
