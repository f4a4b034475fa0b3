"""Minimal reproducer for the XLA-CPU JIT segfault that shapes conftest.py.

Observation (round 2): running the full pytest suite in ONE process, the
XLA CPU backend segfaults inside a fresh compile after several hundred
distinct executables have been JIT-compiled and kept live. The crash is
deterministic at the same test in a full run, yet that test passes in any
smaller run — implicating accumulated live-executable state, not the test.
The suite works around it by calling ``jax.clear_caches()`` after
heavy-compile modules (tests/conftest.py), which bounds the live population.

This script reproduces the shape of that workload without pytest: it
compiles a stream of DISTINCT tiny executables (unique shapes force unique
compilations) while keeping every compiled executable alive in jax's
C++ pjit cache, printing progress so the crash point is visible. Run:

    KRUST_PLATFORM=cpu python benches/repro_xla_cpu_crash.py [max_compiles]

Exit 0 with "no crash" means this jax/jaxlib build survives `max_compiles`
(default 2000) live executables — evidence the workaround can be relaxed.
A segfault (rc -11) before that reproduces the suite's crash. Findings per
jaxlib version belong in a comment here:

- jaxlib in this image (0.8.x, CPU): full suite crashed past ~450 tests
  (~hundreds of live executables) without per-module clearing; with
  clearing scoped to heavy-compile modules the full suite passes.
- Negative results (this image, round 3): 1200 live tiny executables
  (unique-shape cumsum programs) do NOT crash; neither do 800 live
  heavy executables (3-operand sort + cumsum + cummax per program,
  growing shapes). Executable COUNT and plain sort/scan code size are
  therefore not the trigger; the suite's mix adds (until their removal)
  interpreted kernel bodies, shard_map programs over 8 virtual devices, and donated
  buffers — one of those interactions is implicated. The scoped
  per-module clear (tests/conftest.py) remains the workaround; re-run
  this falsifier, then the full suite without clearing, on jaxlib
  upgrades.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("KRUST_PLATFORM", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    max_compiles = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    keep = []  # hold jitted callables so their executables stay live
    for i in range(max_compiles):
        n = 8 + i  # unique shape -> unique executable
        f = jax.jit(lambda x: jnp.cumsum(x * 2 + 1) + x.sum())
        y = f(np.arange(n, dtype=np.float32))
        y.block_until_ready()
        keep.append((f, y))
        if (i + 1) % 100 == 0:
            print(f"{i + 1} live executables, ok", flush=True)
    print(f"no crash after {max_compiles} live executables", flush=True)


if __name__ == "__main__":
    main()
