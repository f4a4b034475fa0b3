"""Randomized cross-engine soak differential.

Long-running (bounded by SOAK_SECONDS, default 600) randomized campaign:
for random (k, input shape, N density, soft-masking, quality filtering,
ingest chunking), assert BatchEngine (XLA pipeline, epoch tables) ==
NumpyEngine == NativeEngine ==
brute-force string oracle. Exercises boundary regimes the fixed suites
sample sparsely: one-key paths (k <= 16), wide codes (k >= 17), epoch
flush limits, part-merge trees, dense/dirty inputs.

Run: KRUST_PLATFORM=cpu python benches/soak.py [seconds]
Exit code 0 = no divergence found.

Long runs are supervised: the campaign executes in fresh subprocesses of
SOAK_BATCH_SECONDS (default 300) each, because XLA-CPU retains one
compiled executable per distinct jit shape for the process lifetime —
a randomized-shape soak in a single process grows without bound
(measured ~3 MB/s RSS here) and eventually OOMs inside LLVM.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np


def main() -> int:
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else float(
        os.environ.get("SOAK_SECONDS", "600")
    )
    import oracle
    from krust.io.reader import ParsedStreams
    from krust.kmer import INVALID_CODE, unpack_many
    from krust.models.engines import (
        BatchEngine,
        NativeEngine,
        NumpyEngine,
    )
    from krust.utils.config import EngineConfig

    rng = np.random.default_rng(int(os.environ.get("SOAK_SEED", "0")))
    t_end = time.monotonic() + budget
    trials = 0
    while time.monotonic() < t_end:
        trials += 1
        k = int(rng.integers(1, 33))
        n = int(rng.integers(0, 20_000))
        p_inv = float(rng.choice([0.0, 0.001, 0.02, 0.25]))
        use_qual = bool(rng.integers(0, 2))
        codes = rng.integers(0, 4, n, np.uint8)
        if p_inv:
            codes[rng.random(n) < p_inv] = INVALID_CODE
        qual = None
        thr = None
        if use_qual:
            qual = rng.integers(33, 75, n).astype(np.uint8)
            thr = int(rng.integers(0, 41))
        streams = ParsedStreams(codes, qual, 1, n)

        bw = int(rng.choice([64, 256, 1024]))
        br = int(rng.choice([8, 32, 256]))
        cfg = EngineConfig(block_windows=bw, batch_rows=br)
        got_b = BatchEngine(cfg).count(streams, k, min_quality=thr)
        got_np = NumpyEngine(EngineConfig()).count(streams, k, min_quality=thr)
        got_nat = NativeEngine(EngineConfig()).count(streams, k, min_quality=thr)

        ok = (
            np.array_equal(got_b.codes, got_np.codes)
            and np.array_equal(got_b.counts, got_np.counts)
            and np.array_equal(got_nat.codes, got_np.codes)
            and np.array_equal(got_nat.counts, got_np.counts)
        )
        if not ok:
            print(
                f"DIVERGENCE trial={trials} k={k} n={n} p_inv={p_inv} "
                f"thr={thr} bw={bw} br={br} seed={os.environ.get('SOAK_SEED','0')}",
                flush=True,
            )
            os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
            np.savez(
                os.path.join(REPO, "chiprun_out", "soak_divergence.npz"),
                codes=codes,
                qual=qual if qual is not None else np.zeros(0, np.uint8),
                k=k,
                thr=-1 if thr is None else thr,
                bw=bw,
                br=br,
            )
            return 1
        # spot-check vs the brute-force string oracle on small inputs
        if n <= 2000 and trials % 5 == 0:
            s = "".join("ACGTN"[c] for c in codes)
            q = "".join(chr(c) for c in qual) if qual is not None else None
            exp = oracle.count_sequences(
                [(s, q)] if q is not None else [s], k,
                min_quality=thr if q is not None else None,
            )
            got = dict(
                zip(unpack_many(got_np.codes, k), got_np.counts.tolist())
            )
            if got != exp:
                print(f"ORACLE DIVERGENCE trial={trials} k={k} n={n}", flush=True)
                return 1
        if trials % 25 == 0:
            print(
                f"  soak: {trials} trials, "
                f"{t_end - time.monotonic():.0f}s left", flush=True
            )
    print(f"soak passed: {trials} randomized cross-engine trials", flush=True)
    return 0


def supervise(budget: float) -> int:
    """Run the campaign in fresh subprocess batches (see module docstring)."""
    import subprocess

    batch = float(os.environ.get("SOAK_BATCH_SECONDS", "300"))
    base_seed = int(os.environ.get("SOAK_SEED", "0"))
    t_end = time.monotonic() + budget
    n_batches = 0
    while time.monotonic() < t_end:
        left = t_end - time.monotonic()
        this = min(batch, max(left, 30.0))
        env = dict(
            os.environ,
            SOAK_SECONDS=str(this),
            SOAK_SEED=str(base_seed + n_batches + 1),
            SOAK_CHILD="1",
        )
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env, timeout=this + 300
        )
        if r.returncode != 0:
            print(f"soak batch {n_batches + 1} FAILED rc={r.returncode}", flush=True)
            return r.returncode
        n_batches += 1
    print(f"soak supervisor done: {n_batches} clean batches", flush=True)
    return 0


if __name__ == "__main__":
    _budget = float(sys.argv[1]) if len(sys.argv) > 1 else float(
        os.environ.get("SOAK_SECONDS", "600")
    )
    if os.environ.get("SOAK_CHILD") or _budget <= float(
        os.environ.get("SOAK_BATCH_SECONDS", "300")
    ):
        sys.exit(main())
    sys.exit(supervise(_budget))
