"""Per-phase device times of the counting core, on the card.

    python benches/phases.py            # everything below, one card
    python benches/phases.py --peak 21  # one peak-memory child (internal)
    python benches/phases.py --budget   # the default epoch budget at scale

``--budget`` runs three children, one at a time: peak bytes per entry of a
part merge; all-distinct k=31 entries through EpochTable at the default
budget (compacted parts as large as their epochs, the worst case for a
merge, which the host takes); and a 2.2 Gbase k=31 count through
BatchEngine at the default budget, checked against the native core.

Workload: bench.py's 512 Mbase of 250 bp reads at 32x (k=21 unless noted).
Each time ends in ``block_until_ready`` and is the minimum of 3 runs after
a warm-up run:

- codec: the flat batch step (unpack + rolling codec + sentinel keying)
  summed over the input's batches, and its share of the device phases;
- epoch sort, compaction (the scatter form the tables use, and the older
  second-sort form for comparison) and the whole flush, on one epoch
  holding the whole input and on a 2^25-entry epoch;
- part merge of two compacted 2^25-entry epochs;
- finalize pull of the compacted table, one transfer against 8 MB slices.

Also, from the compiled HLO: which sort XLA emits for each epoch-sort form
(a CUB radix sort custom call or its own comparison sort) and the fusions
of the codec step; and peak device bytes per raw epoch entry at k=16, 21
and 31, each from ``peak_bytes_in_use`` in a child process of its own (run
before this process touches the card, one process at a time).

Prints one JSON object per line; the last line holds everything.
Exits non-zero when JAX's device is not a GPU.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASES = 512_000_000
PINNED = 1 << 25
K = 21
#: --budget: 1.94G k=31 windows, two full default epochs and a third
#: (a table ends at 2^31 windows)
BUDGET_BASES = 2_200_000_000
#: one full default epoch and a second, all distinct: 1.0G entries, more
#: than a device merge may take on an 80 GB card
DISTINCT_STEP = 1 << 25
DISTINCT_TOTAL = 30 * DISTINCT_STEP
MERGE_PART = 1 << 27


def _streams():
    from bench import make_reads, reads_to_stream
    from krust.io.reader import ParsedStreams

    reads = make_reads(np.random.default_rng(7), BASES)
    return ParsedStreams(reads_to_stream(reads), None, reads.shape[0], reads.size)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def _need_gpu(jax) -> None:
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"phases: JAX's device is {jax.devices()[0].platform!r}, not a GPU")


def peak_child(k: int) -> None:
    """One full-input epoch at k through BatchEngine; peak bytes / entry."""
    os.environ["KRUST_EPOCH_ENTRIES"] = str((1 << 31) - 1)  # one epoch
    import jax

    from krust.models.engines import BatchEngine
    from krust.utils import tracing

    _need_gpu(jax)
    streams = _streams()
    dev = jax.devices()[0]
    base = dev.memory_stats()["bytes_in_use"]
    flushes = []
    tracing.add_collector(
        lambda kind, name, f: name == "epoch_flush" and flushes.append(f["pending"])
    )
    res = BatchEngine().count(streams, k)
    stats = dev.memory_stats()
    raw = max(flushes)
    print(json.dumps({
        "k": k,
        "epochs": len(flushes),
        "raw_entries": raw,
        "distinct": res.distinct,
        "peak_bytes": stats["peak_bytes_in_use"],
        "base_bytes": base,
        "bytes_per_entry": (stats["peak_bytes_in_use"] - base) / raw,
    }))


def _epoch_log():
    """Collector of epoch_flush / part_merge / part_spill span fields,
    installed."""
    from krust.utils import tracing

    log: dict = {"epoch_flush": [], "part_merge": [], "part_spill": []}
    tracing.add_collector(
        lambda kind, name, f: name in log and log[name].append(f)
    )
    return log


def budget_engine() -> None:
    """k=31 count of BUDGET_BASES at the default epoch budget through
    BatchEngine (several full epochs and part merges), against the native
    core; peak device bytes."""
    import jax

    from bench import make_reads, reads_to_stream
    from krust.io.reader import ParsedStreams
    from krust.models.engines import BatchEngine, NativeEngine
    from krust.ops.table import epoch_entry_limit

    _need_gpu(jax)
    reads = make_reads(np.random.default_rng(11), BUDGET_BASES)
    streams = ParsedStreams(reads_to_stream(reads), None, reads.shape[0], reads.size)
    del reads
    log = _epoch_log()
    t0 = time.perf_counter()
    got = BatchEngine().count(streams, 31)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats()
    exp = NativeEngine().count(streams, 31)
    print(json.dumps({
        "bases": BUDGET_BASES, "k": 31, "epoch_limit": epoch_entry_limit(),
        "epoch_raw": [f["pending"] for f in log["epoch_flush"]],
        "part_merges": len(log["part_merge"]), "distinct": got.distinct,
        "exact": bool(np.array_equal(got.codes, exp.codes)
                      and np.array_equal(got.counts, exp.counts)),
        "wall_s": wall, "peak_bytes": stats["peak_bytes_in_use"],
    }))


def _distinct_batch(jnp, start, n: int):
    """n raw k=31 entries, all distinct: lo is the running index, hi a
    30-bit hash of it (so the sort sees random order)."""
    i = start + jnp.arange(n, dtype=jnp.uint32)
    h = i * jnp.uint32(0x9E3779B1)
    h = (h ^ (h >> 15)) * jnp.uint32(0x85EBCA77)
    return (h ^ (h >> 13)) & jnp.uint32((1 << 30) - 1), i


def merge_peak() -> None:
    """Peak device bytes per input entry of one part merge: two sorted,
    compacted, all-distinct k=31 parts of MERGE_PART entries each."""
    import jax
    import jax.numpy as jnp

    from krust.ops import table as table_mod

    _need_gpu(jax)
    dev = jax.devices()[0]
    base = dev.memory_stats()["bytes_in_use"]

    @jax.jit
    def part(start):
        hi, lo = _distinct_batch(jnp, start, MERGE_PART)
        s_hi, s_lo = jax.lax.sort((hi, lo), num_keys=2)
        return s_hi, s_lo, jnp.ones(MERGE_PART, jnp.uint32)

    a = jax.block_until_ready(part(jnp.uint32(0)))
    b = jax.block_until_ready(part(jnp.uint32(MERGE_PART)))
    peak_before = dev.memory_stats()["peak_bytes_in_use"]
    o = jax.block_until_ready(table_mod._merge_compact(a, b, 31))
    peak = dev.memory_stats()["peak_bytes_in_use"]
    print(json.dumps({
        "entries": 2 * MERGE_PART, "distinct": int(o[3]),
        "peak_bytes": peak, "peak_before_merge": peak_before,
        "base_bytes": base,
        "bytes_per_entry": (peak - base) / (2 * MERGE_PART),
    }))


def budget_distinct() -> None:
    """Worst case for the default budget: DISTINCT_TOTAL all-distinct k=31
    raw entries through EpochTable (a full-size epoch whose compacted part
    is as large as its raw input), then finalize: the parts are too large
    to merge on the device, so they are pulled and merged on the host.
    Prints the peak device bytes, or the allocation failure."""
    import jax
    import jax.numpy as jnp

    from krust.ops.table import EpochTable, epoch_entry_limit

    _need_gpu(jax)
    step = DISTINCT_STEP
    gen = jax.jit(lambda s: _distinct_batch(jnp, s, step))
    log = _epoch_log()
    row: dict = {"entries": DISTINCT_TOTAL, "epoch_limit": epoch_entry_limit()}
    t0 = time.perf_counter()
    try:
        table = EpochTable(31)
        row["merge_limit"] = table._pending_limit
        for s in range(0, DISTINCT_TOTAL, step):
            hi, lo = gen(jnp.uint32(s))
            table.add(hi, lo, None, step)
        codes, counts = table.finalize()
        row["distinct"] = int(codes.shape[0])
        row["ok"] = bool(
            codes.shape[0] == DISTINCT_TOTAL
            and np.all(counts == 1)
            and np.all(codes[1:] > codes[:-1])
        )
    except Exception as e:  # an allocation failure is the finding
        row["ok"] = False
        row["error"] = f"{type(e).__name__}: {str(e)[:400]}"
    row["wall_s"] = time.perf_counter() - t0
    row["epoch_raw"] = [f["pending"] for f in log["epoch_flush"]]
    row["merges"] = [(f["entries"], f["elapsed_s"]) for f in log["part_merge"]]
    row["spills"] = [(f["entries"], f["elapsed_s"]) for f in log["part_spill"]]
    row["peak_bytes"] = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(json.dumps(row))


def budget() -> None:
    """The default-budget checks, each in a child process of its own."""
    report = {"card": _card()}
    for mode in ("--merge-peak", "--budget-distinct", "--budget-engine"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), mode],
            capture_output=True, text=True,
        )
        lines = out.stdout.strip().splitlines()
        report[mode[2:]] = (json.loads(lines[-1]) if out.returncode == 0
                            else {"rc": out.returncode, "stderr": out.stderr[-2000:]})
        print(json.dumps({mode[2:]: report[mode[2:]]}), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "budget.json"), "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    print(json.dumps(report))


def _time(fn, reps: int = 3):
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def _sort_kinds(hlo: str) -> list[str]:
    """Sort implementations in an optimized HLO module: custom-call
    targets (CUB's radix sort) and XLA's own ``sort`` ops."""
    kinds = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    if re.search(r"\bsort\(", hlo):
        kinds.append("xla_sort")
    return kinds


def _entry_ops(hlo: str) -> list[str]:
    """Opcodes of the ENTRY computation of an optimized HLO module."""
    body = hlo[hlo.index("ENTRY"):]
    body = body[: body.index("\n}")]
    ops = re.findall(r"= \S+ ([a-z\-]+)\(", body)
    return [o for o in ops if o not in ("parameter", "tuple", "get-tuple-element",
                                        "constant", "bitcast")]


def main() -> None:
    children = []
    for k in (16, 21, 31):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--peak", str(k)],
            capture_output=True, text=True, check=True,
        )
        children.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({"peak": children[-1]}), flush=True)

    import jax
    import jax.numpy as jnp

    from krust.io.packer import flat_batches
    from krust.models.engines import _count_flat_step
    from krust.ops import count as count_mod
    from krust.ops import table as table_mod
    from krust.utils.config import EngineConfig

    _need_gpu(jax)
    card = _card()
    dev = jax.devices()[0]
    report: dict = {"card": card, "device_kind": dev.device_kind,
                    "bytes_per_entry": children}

    cfg = EngineConfig()
    streams = _streams()
    batches = list(flat_batches(streams.codes, None, K, None,
                                cfg.block_windows, cfg.batch_rows))
    staged = [(jnp.asarray(b.packed2), jnp.asarray(b.invpos), b) for b in batches]
    jax.block_until_ready([s[:2] for s in staged])

    def codec_all():
        return [
            _count_flat_step(p2, iv, np.int32(b.covered), K, b.rows,
                             b.block_windows, "raw_sent")
            for p2, iv, b in staged
        ]

    t_codec, ts = _time(codec_all)
    report["codec_s"] = t_codec
    parts = codec_all()
    his = [p[0] for p in parts]
    los = [p[1] for p in parts]
    p0 = staged[0]
    codec_hlo = _count_flat_step.lower(
        p0[0], p0[1], np.int32(p0[2].covered), K, p0[2].rows,
        p0[2].block_windows, "raw_sent",
    ).compile().as_text()
    report["codec_entry_ops"] = _entry_ops(codec_hlo)
    print(json.dumps({"codec_s": t_codec, "runs": ts,
                      "entry_ops": report["codec_entry_ops"]}), flush=True)

    hi = jnp.concatenate(his)
    lo = jnp.concatenate(los)
    del parts, his, los
    dt = table_mod._hi_sort_dtype(K)

    @jax.jit
    def sort21(h, l):
        return jax.lax.sort((h.astype(dt), l), num_keys=2, is_stable=False)

    @jax.jit
    def sort_u32(h, l):
        return jax.lax.sort((h, l), num_keys=2, is_stable=False)

    @jax.jit
    def sort_one(l):
        return jax.lax.sort((l,), num_keys=1, is_stable=False)

    @jax.jit
    def sort_kv(l, c):
        return jax.lax.sort((l, c), num_keys=1, is_stable=False)

    @jax.jit
    def sort_kkv(h, l, c):
        return jax.lax.sort((h, l, c), num_keys=2, is_stable=False)

    @jax.jit
    def compact_by_sort(s_hi, s_lo):
        """The second-sort compaction form: run sums as in compact_runs,
        then a 2-key sort moves the emitted entries to the front."""
        sent = jnp.uint32(0xFFFFFFFF)
        n = s_lo.shape[0]
        differs = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
        edge = jnp.ones(1, jnp.bool_)
        is_start = jnp.concatenate([edge, differs])
        is_end = jnp.concatenate([differs, edge])
        pos = jnp.arange(n, dtype=jnp.int32)
        run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
        run = (pos - run_start + 1).astype(jnp.uint32)
        emit = is_end & ~((s_hi == sent) & (s_lo == sent))
        c_hi, c_lo, c_cnt = jax.lax.sort(
            (jnp.where(emit, s_hi, sent), jnp.where(emit, s_lo, sent),
             jnp.where(emit, run, 0)),
            num_keys=2, is_stable=False,
        )
        return c_hi, c_lo, c_cnt, jnp.sum(emit, dtype=jnp.int32)

    hlo_kinds = {}
    small = jnp.zeros(1 << 20, jnp.uint32)
    for name, fn, args in (
        ("k<=16 one key u32", sort_one, (small,)),
        ("k17-24 narrowed hi + u32", sort21, (small, small)),
        ("k25-32 u32 + u32", sort_u32, (small, small)),
        ("merge k<=16 key + count", sort_kv, (small, small)),
        ("merge k>16 2 keys + count", sort_kkv, (small, small, small)),
    ):
        hlo_kinds[name] = _sort_kinds(fn.lower(*args).compile().as_text())
    report["sort_hlo"] = hlo_kinds
    print(json.dumps({"sort_hlo": hlo_kinds}), flush=True)

    @jax.jit
    def upcast(s):
        sent = jnp.uint32(0xFFFFFFFF)
        s_hi32 = s[0].astype(jnp.uint32)
        narrow_max = jnp.uint32((1 << (8 * dt(0).itemsize)) - 1)
        return jnp.where((s_hi32 == narrow_max) & (s[1] == sent), sent, s_hi32), s[1]

    for label, n in (("full_epoch", hi.shape[0]), ("pinned_epoch", PINNED)):
        h, l = hi[:n], lo[:n]
        row: dict = {"entries": int(n)}
        row["sort_s"], _ = _time(lambda: sort21(h, l))
        s_hi, s_lo = upcast(sort21(h, l))
        row["compact_scatter_s"], _ = _time(
            lambda: count_mod.compact_runs(s_hi, s_lo))
        row["compact_sort_s"], _ = _time(lambda: compact_by_sort(s_hi, s_lo))
        row["flush_s"], _ = _time(lambda: table_mod._epoch_sort_rle(h, l, K))
        row["distinct"] = int(count_mod.compact_runs(s_hi, s_lo)[3])
        del s_hi, s_lo
        report[label] = row
        print(json.dumps({label: row}), flush=True)

    def compacted(a, b):
        o = table_mod._epoch_sort_rle(hi[a:b], lo[a:b], K)
        n = int(o[3])
        keep = 1 << (n - 1).bit_length()
        return tuple(x[:keep] for x in o[:3]), n

    pa, na = compacted(0, PINNED)
    pb, nb = compacted(PINNED, 2 * PINNED)
    t_merge, _ = _time(lambda: table_mod._merge_compact(pa, pb, K))
    report["part_merge"] = {"entries": na + nb, "padded": pa[0].shape[0] * 2,
                            "merge_s": t_merge}
    print(json.dumps({"part_merge": report["part_merge"]}), flush=True)
    del pa, pb

    o = table_mod._epoch_sort_rle(hi, lo, K)
    n = int(o[3])
    del hi, lo
    keep = 1 << (n - 1).bit_length()
    t = table_mod.EpochTable(K)

    def finalize():
        t._table = tuple(x[:keep] for x in o[:3])
        t._table_entries = n
        t._windows_total = BASES
        return t._pull_table()

    t_final, _ = _time(finalize)
    buf = table_mod._pull_fused(o[0], o[1], o[2], jnp.int32(n),
                                keep, 1 << 10, False)
    step = 8 << 20

    def pull(sliced: bool) -> float:
        """Best of 3 pulls of fresh device copies (a jax.Array caches its
        host copy, so each pull needs an array never pulled before)."""
        ts = []
        for _ in range(4):
            fresh = jax.block_until_ready(buf + jnp.uint8(0))
            t0 = time.perf_counter()
            if sliced:
                np.concatenate([np.asarray(fresh[i:i + step])
                                for i in range(0, fresh.shape[0], step)])
            else:
                np.asarray(fresh)
            ts.append(time.perf_counter() - t0)
        return min(ts[1:])

    t_one, t_sliced = pull(False), pull(True)
    report["finalize"] = {"distinct": n, "finalize_s": t_final,
                          "pull_bytes": int(buf.shape[0]),
                          "pull_one_transfer_s": t_one,
                          "pull_8mb_slices_s": t_sliced}
    print(json.dumps({"finalize": report["finalize"]}), flush=True)

    dev_phases = (t_codec + report["full_epoch"]["flush_s"] + t_final)
    report["codec_share_of_device_phases"] = t_codec / dev_phases
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phases.json"), "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    with open(os.path.join(REPO, "chiprun_out", "codec_hlo.txt"), "w") as f:
        f.write(codec_hlo)
    print(json.dumps(report))


_CHILDREN = {
    "--budget": budget,
    "--budget-engine": budget_engine,
    "--budget-distinct": budget_distinct,
    "--merge-peak": merge_peak,
}


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--peak":
        peak_child(int(sys.argv[2]))
    elif len(sys.argv) > 1 and sys.argv[1] in _CHILDREN:
        _CHILDREN[sys.argv[1]]()
    else:
        main()
