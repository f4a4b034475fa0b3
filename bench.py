"""Benchmark: end-to-end canonical k-mer counting throughput at k=21 on a GPU.

Workload (BASELINE.json config 2's shape): synthetic sequencing reads at
32x coverage — by default 512 Mbases of 250 bp reads over a 16 Mbase genome,
~16M distinct canonical 21-mers — counted end to end (pack -> transfer ->
device rolling codec -> epoch-sort counting core -> full table pull to
host), excluding compilation (one warm-up pass) and output formatting, the
scope of the reference's criterion macro-bench
(reference: benches/kmer_benchmark.rs:127-188).

One process, one card. The first timed pass is phase-instrumented: host
pack, host->device feed, device compute (codec + epoch sort + compaction
and merges, ending in a device sync) and the finalize pull; two clean
end-to-end passes follow. Exits non-zero when JAX's device is not a GPU:
this measures the card, never a CPU stand-in.

Baseline: the reference publishes no numbers (BASELINE.md), so
`benches/baseline_cpp/kmerust_like.cpp` reproduces the reference's hot-loop
shape (per-window allocation + validate + pack + canonical + FxHash map
update; reference: src/run.rs:526-571, src/kmer.rs:266-398), measured
single-thread on a CPU host at k=21: 2.26 Mbases/s/thread. The ratio
``vs_baseline`` divides by that x 64 threads with ideal scaling =
144.6 Mbases/s.

Prints ONE JSON line: metric, value, unit, vs_baseline, phases, pass times,
platform, device_kind, device count, and the card's name and power limit.
KRUST_BENCH_BASES overrides the workload size, KRUST_BENCH_K the k.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: faithful C++ reference-shape proxy, 2.26 Mbases/s/thread x 64 threads
BASELINE_BASES_PER_S = 144.6e6
K = int(os.environ.get("KRUST_BENCH_K", "21"))
COVERAGE = 32
READ_LEN = 250
DEFAULT_BASES = 512_000_000


def make_reads(
    rng: np.random.Generator, n_bases: int, read_len: int = READ_LEN
) -> np.ndarray:
    """Synthetic reads: COVERAGE x random substrings of one random genome."""
    genome_len = max(n_bases // COVERAGE, read_len + 1)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    n_reads = n_bases // read_len
    starts = rng.integers(0, genome_len - read_len, size=n_reads, dtype=np.int64)
    idx = starts[:, None] + np.arange(read_len, dtype=np.int64)[None, :]
    return genome[idx]  # [n_reads, read_len] of 2-bit codes


def reads_to_stream(reads: np.ndarray) -> np.ndarray:
    """Code rows -> flat separator-delimited stream (reader output format)."""
    from krust.kmer import INVALID_CODE

    n, length = reads.shape
    out = np.empty((n, length + 1), dtype=np.uint8)
    out[:, :length] = reads
    out[:, length] = INVALID_CODE
    return out.reshape(-1)[:-1]  # one separator between reads, none trailing


def _staged_pass(engine, streams) -> dict:
    """Phase-instrumented pass: pack / feed / compute / finalize separated.

    All batches stage onto the device first (feed), then the compute steps
    run on device-resident inputs and end in one device sync, so
    ``compute`` is the codec + epoch sort + compaction core alone. The
    phase sum is an end-to-end pass time (same total work as a clean pass).
    """
    import jax

    from krust.io.packer import flat_batches
    from krust.models.engines import _count_flat_step
    from krust.ops.table import EPOCH_WINDOW_LIMIT

    cfg = engine.config
    t0 = time.perf_counter()
    batches = list(
        flat_batches(streams.codes, None, K, None, cfg.block_windows, cfg.batch_rows)
    )
    t_pack = time.perf_counter() - t0

    t0 = time.perf_counter()
    staged = [
        (jax.device_put(b.packed2), jax.device_put(b.invpos), b) for b in batches
    ]
    jax.block_until_ready([s[:2] for s in staged])
    t_feed = time.perf_counter() - t0

    mode, table = engine._make_table(K)
    epochs = []
    t0 = time.perf_counter()
    for p2, iv, b in staged:
        bw = b.rows * b.block_windows
        if table.windows_this_epoch + bw >= EPOCH_WINDOW_LIMIT:
            epochs.append(table.finalize())
        out = _count_flat_step(
            p2, iv, np.int32(b.covered), K, b.rows, b.block_windows, mode
        )
        if len(out) == 1:  # lo-only sentinel part (k <= 16)
            table.add(None, out[0], None, bw)
        else:
            table.add(out[0], out[1], None, bw)
    table._flush_raw()
    table._resolve_epoch()
    jax.block_until_ready(table._compacted)
    t_compute = time.perf_counter() - t0

    t0 = time.perf_counter()
    epochs.append(table.finalize())
    engine._merge_epochs(epochs, K)
    t_final = time.perf_counter() - t0
    return {
        "pack": t_pack,
        "feed": t_feed,
        "compute": t_compute,
        "finalize": t_final,
    }


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from krust.io.reader import ParsedStreams
    from krust.models.engines import BatchEngine
    from krust.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX's device is {dev.platform!r}, not a GPU", file=sys.stderr)
        return 1
    card = _card()

    bases = int(os.environ.get("KRUST_BENCH_BASES", DEFAULT_BASES))
    reads = make_reads(np.random.default_rng(7), bases)
    n_bases = int(reads.size)
    streams = ParsedStreams(reads_to_stream(reads), None, reads.shape[0], n_bases)
    del reads

    engine = BatchEngine()
    t0 = time.perf_counter()
    engine.count(streams, K)  # warm-up: compiles every shape of the pass
    warmup = time.perf_counter() - t0

    phases = _staged_pass(engine, streams)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        result = engine.count(streams, K)
        times.append(time.perf_counter() - t0)
    value = n_bases / min(times)
    name, _, power = card.partition(",")
    print(json.dumps({
        "metric": f"bases_per_second_k{K}",
        "value": value,
        "unit": "bases/s",
        "vs_baseline": value / BASELINE_BASES_PER_S,
        "compute_only_bases_per_s": n_bases / phases["compute"],
        "phases": phases,
        "times": times,
        "warmup_s": warmup,
        "bases": n_bases,
        "distinct": result.distinct,
        "total": result.total,
        "peak_bytes_in_use": (dev.memory_stats() or {}).get("peak_bytes_in_use"),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": name.strip(),
        "power_limit": power.strip(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
