"""Smoke run of the counting path on the GPU, checked bit for bit.

    python chip_smoke.py               # one card: every default phase
    python chip_smoke.py --four-cards  # four cards: only the sharded path

One process drives the card(s) through the entry points a user calls:

1. Device: the card's name and power limit (``nvidia-smi``), JAX's
   ``device_kind``, the device count and ``bytes_limit``.
2. Main path at full size: a 512 Mbase FASTA (250 bp reads at 32x over a
   16 Mbase genome from ``--seed``, the shape of BASELINE.json config 2)
   counted at k=21 by ``krust.cli.main`` in this process, with histogram
   output and ``--save`` to a ``.kmix`` index, then one ``query``. The
   histogram and the full table (``api.count_kmers_packed``) must equal the
   native C++ core's, which shares no code with the device path.
3. Exactness over the sort regimes: a 64 Mbase FASTQ with N runs and a
   Phred profile at k in {1, 16, 20, 24, 31, 32}, once as is (flat feed
   path) and once with ``-Q 20`` (dense feed path), each equal to the
   native core; then k=21 on the 512 Mbase input with the epoch budget
   pinned low, which must flush at least 4 epochs and merge parts.

``--four-cards`` runs only ``count_sharded`` over a 4-device mesh on an
input large enough for two exchanges, and ``api.count_kmers_sharded`` on a
file, both against the native core.

Exits non-zero, printing no result, when JAX's device is not a GPU or the
device engine is not selected. The last line of a passing run is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: scratch inputs live inside the checkout (listed in .gitignore)
DATA_DIR = os.path.join(REPO, ".smoke_data")

MAIN_BASES = 512_000_000
FASTQ_BASES = 64_000_000
FASTQ_READ_LEN = 150
SWEEP_K = (1, 16, 20, 24, 31, 32)
PINNED_EPOCH_ENTRIES = 33_554_432
#: 2^31 windows end an exchange epoch; 72 super-batches of 2^25 windows
#: on 4 cards make two exchanges
FOUR_CARD_BASES = 2_400_000_000

_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def card_line() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return "; ".join(lines)


def write_fasta(path: str, reads: np.ndarray) -> None:
    """One ``>r`` record per read row of 2-bit codes."""
    n, length = reads.shape
    rows = np.empty((n, length + 4), np.uint8)
    rows[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rows[:, 3:-1] = _LETTERS[reads]
    rows[:, -1] = ord("\n")
    rows.tofile(path)


def write_fastq(path: str, rng: np.random.Generator, n_bases: int) -> None:
    """Reads with runs of N (~1% of bases) and a Phred profile that falls
    along the read (mean Q40 to Q20, sd 6): ``-Q 20`` masks about a tenth
    of the bases, enough to send the stream down the dense feed path."""
    from bench import make_reads

    reads = make_reads(rng, n_bases, FASTQ_READ_LEN)
    n, length = reads.shape
    flat = reads.reshape(-1)
    n_runs = flat.shape[0] // 650
    starts = rng.integers(0, flat.shape[0] - 12, n_runs)
    for off in range(12):  # run lengths 1..12
        hit = starts[rng.integers(1, 13, n_runs) > off] + off
        flat[hit] = 4
    mean = 40.0 - 20.0 * np.arange(length) / length
    q = np.clip(mean + rng.normal(0.0, 6.0, (n, length)), 2, 41).astype(np.uint8)
    rows = np.empty((n, 2 * length + 7), np.uint8)
    rows[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rows[:, 3 : 3 + length] = _LETTERS[reads]
    rows[:, 3 + length : 6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rows[:, 6 + length : 6 + 2 * length] = q + 33
    rows[:, -1] = ord("\n")
    rows.tofile(path)


def run_cli(argv: list[str]) -> bytes:
    """``krust.cli.main`` in this process (it already holds the card),
    returning what it wrote to stdout."""
    from krust import cli

    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="ascii", write_through=True)
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    out.flush()
    if rc != 0:
        raise RuntimeError(f"kmix {' '.join(argv)} exited {rc}")
    return buf.getvalue()


class SpanLog:
    """Collects the engine's trace spans and events while active."""

    def __init__(self):
        self.records: list[tuple[str, str, dict]] = []

    def __call__(self, kind, name, fields):
        self.records.append((kind, name, fields))

    def __enter__(self):
        from krust.utils import tracing

        tracing.add_collector(self)
        return self

    def __exit__(self, *exc):
        from krust.utils import tracing

        tracing.remove_collector(self)

    def count(self, name: str) -> int:
        return sum(1 for _, n, _ in self.records if n == name)

    def paths(self) -> set:
        return {
            f["path"] for _, n, f in self.records if n == "encode_count_batch"
        }


def same(got, exp, what: str) -> None:
    if not (
        np.array_equal(got.codes, exp.codes)
        and np.array_equal(got.counts, exp.counts)
    ):
        raise AssertionError(
            f"{what}: device table differs from the native core "
            f"({got.distinct} vs {exp.distinct} distinct)"
        )


def phase_device(jax) -> str:
    card = card_line()
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    print(f"card: {card}")
    print(
        f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} bytes_limit={stats.get('bytes_limit')}"
    )
    return card


def phase_main(jax, rng, card: str):
    from krust import api
    from krust.io.reader import parse_to_streams, read_input_bytes
    from krust.io.format import SequenceFormat
    from krust.kmer import unpack_many
    from krust.models.engines import NativeEngine
    from krust.output import OutputFormat, format_packed_counts
    from bench import make_reads

    fasta = os.path.join(DATA_DIR, "reads_512M.fa")
    kmix = os.path.join(DATA_DIR, "reads_512M.kmix")
    reads = make_reads(rng, MAIN_BASES)
    write_fasta(fasta, reads)
    n_bases = int(reads.size)
    del reads

    t0 = time.perf_counter()
    hist = run_cli(["21", fasta, "-f", "histogram", "--save", kmix, "-q"])
    wall = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(
        f"main path: kmix 21 ({n_bases / 1e6:.0f} Mbase FASTA, histogram, --save) "
        f"wall {wall:.3f} s, {n_bases / wall / 1e6:.1f} Mbases/s, "
        f"peak device bytes {peak} [{card}; compile included]"
    )

    streams = parse_to_streams(read_input_bytes(fasta), SequenceFormat.FASTA)
    t0 = time.perf_counter()
    native = NativeEngine().count(streams, 21)
    print(
        f"native core: {native.distinct} distinct, "
        f"{time.perf_counter() - t0:.3f} s"
    )
    del streams
    want = format_packed_counts(
        native.codes, native.counts, 21, OutputFormat.HISTOGRAM
    )
    if hist != want:
        raise AssertionError("histogram differs from the native core")

    table = api.count_kmers_packed(fasta, 21)
    codes = np.fromiter(table.keys(), np.uint64, len(table))
    counts = np.fromiter(table.values(), np.uint64, len(table))
    del table
    if not (
        np.array_equal(codes, native.codes)
        and np.array_equal(counts, native.counts)
    ):
        raise AssertionError("api.count_kmers_packed differs from the native core")

    top = int(np.argmax(native.counts))
    kmer = unpack_many(native.codes[top : top + 1], 21)[0]
    got = int(run_cli(["query", kmix, kmer]).decode().strip())
    if got != int(native.counts[top]):
        raise AssertionError(f"query {kmer}: {got} != {int(native.counts[top])}")
    print(
        f"main path exact: histogram, full table ({native.distinct} distinct) "
        f"and query {kmer}={got} equal the native core"
    )
    return fasta, native


def phase_exactness(fasta: str, native21, rng) -> None:
    from krust import api
    from krust.io.format import SequenceFormat
    from krust.io.input import Input
    from krust.io.reader import parse_to_streams, read_input_bytes
    from krust.models.engines import NativeEngine

    fastq = os.path.join(DATA_DIR, "reads_64M.fq")
    write_fastq(fastq, rng, FASTQ_BASES)
    streams = parse_to_streams(read_input_bytes(fastq), SequenceFormat.FASTQ)
    for k in SWEEP_K:
        for q in (None, 20):
            with SpanLog() as log:
                got = api.count_with_input(
                    Input.from_path(fastq), k, SequenceFormat.FASTQ, q
                )
            exp = NativeEngine().count(streams, k, q)
            same(got, exp, f"k={k} -Q {q}")
            print(
                f"exact: k={k} -Q {q}: {got.distinct} distinct, "
                f"path={'/'.join(sorted(log.paths()))}"
            )

    os.environ["KRUST_EPOCH_ENTRIES"] = str(PINNED_EPOCH_ENTRIES)
    try:
        with SpanLog() as log:
            got = api.count_with_input(
                Input.from_path(fasta), 21, SequenceFormat.FASTA
            )
    finally:
        del os.environ["KRUST_EPOCH_ENTRIES"]
    same(got, native21, "pinned epoch budget")
    flushes, merges = log.count("epoch_flush"), log.count("part_merge")
    print(
        f"exact: k=21 with KRUST_EPOCH_ENTRIES={PINNED_EPOCH_ENTRIES}: "
        f"{flushes} epoch flushes, {merges} part merges"
    )
    if flushes < 4 or merges < 1:
        raise AssertionError("pinned run did not flush 4 epochs and merge parts")


def four_card_streams(rng, n_bases: int):
    """Reads at 32x over one genome, as a separator-delimited stream,
    generated in chunks to keep host memory near the stream's size."""
    from bench import COVERAGE, READ_LEN
    from krust.io.reader import ParsedStreams
    from krust.kmer import INVALID_CODE

    genome = rng.integers(0, 4, n_bases // COVERAGE, dtype=np.uint8)
    n_reads = n_bases // READ_LEN
    rows = np.empty((n_reads, READ_LEN + 1), np.uint8)
    rows[:, READ_LEN] = INVALID_CODE
    step = 1 << 20
    span_ = np.arange(READ_LEN, dtype=np.int64)
    for i in range(0, n_reads, step):
        m = min(step, n_reads - i)
        starts = rng.integers(0, genome.shape[0] - READ_LEN, m)
        rows[i : i + m, :READ_LEN] = genome[starts[:, None] + span_]
    codes = rows.reshape(-1)[:-1]
    return ParsedStreams(codes, None, n_reads, n_reads * READ_LEN)


def phase_four_cards(jax, rng, card: str) -> None:
    from bench import make_reads
    from krust import api
    from krust.io.format import SequenceFormat
    from krust.io.reader import parse_to_streams, read_input_bytes
    from krust.models.engines import NativeEngine
    from krust.parallel.mesh import make_mesh
    from krust.parallel.sharded import count_sharded

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {len(jax.devices())}")
    mesh = make_mesh(4)
    streams = four_card_streams(rng, FOUR_CARD_BASES)
    t0 = time.perf_counter()
    with SpanLog() as log:
        got = count_sharded(streams, 21, mesh=mesh)
    wall = time.perf_counter() - t0
    exchanges = log.count("sharded_exchange")
    sizes = [f["sizes"] for _, n, f in log.records if n == "shard_sizes"]
    peaks = [
        (d.memory_stats() or {}).get("peak_bytes_in_use")
        for d in jax.devices()[:4]
    ]
    print(
        f"count_sharded: {streams.n_bases} bases on 4 cards, wall {wall:.3f} s "
        f"[{card}; compile included], {exchanges} exchanges, "
        f"shard_sizes {sizes}, per-device peak bytes {peaks}"
    )
    t0 = time.perf_counter()
    exp = NativeEngine().count(streams, 21)
    print(f"native core: {exp.distinct} distinct, {time.perf_counter() - t0:.3f} s")
    same(got, exp, "count_sharded")
    if exchanges < 2 or any(not s or min(s) == 0 for s in sizes):
        raise AssertionError("need 2 exchanges with data on every device")
    del streams, got, exp

    fasta = os.path.join(DATA_DIR, "reads_64M.fa")
    write_fasta(fasta, make_reads(rng, FASTQ_BASES))
    got = api.count_kmers_sharded(fasta, 21, mesh=mesh)
    streams = parse_to_streams(read_input_bytes(fasta), SequenceFormat.FASTA)
    if got != NativeEngine().count(streams, 21).to_string_dict():
        raise AssertionError("api.count_kmers_sharded differs from the native core")
    print(f"api.count_kmers_sharded: {len(got)} distinct, exact")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only count_sharded over 4 cards and its comparison",
    )
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from krust.models.engines import BatchEngine, select_engine
    from krust.utils.config import EngineConfig
    from krust.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    engine = select_engine(EngineConfig())
    if not isinstance(engine, BatchEngine):
        print(f"chip_smoke: select_engine chose {type(engine).__name__}",
              file=sys.stderr)
        return 1

    card = phase_device(jax)
    rng = np.random.default_rng(args.seed)
    os.makedirs(DATA_DIR, exist_ok=True)
    try:
        if args.four_cards:
            phase_four_cards(jax, rng, card)
        else:
            fasta, native21 = phase_main(jax, rng, card)
            phase_exactness(fasta, native21, rng)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
