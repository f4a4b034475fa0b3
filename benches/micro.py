"""Micro/macro benchmarks (reference: benches/kmer_benchmark.rs).

Micro: scalar from_sub/pack/canonical/unpack at k in {5, 11, 21, 31}, plus
the vectorized and device codec equivalents.
Macro: count_kmers / count_kmers_streaming / count_kmers_from_sequences over
100 sequences x 320 bp at k in {5, 11, 21} (the reference's workload).

Usage: python benches/micro.py [--device]
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Force the CPU platform BEFORE importing krust: the package reads
# KRUST_PLATFORM at import time. --device keeps the default backend.
if "--device" not in sys.argv:
    os.environ.setdefault("KRUST_PLATFORM", "cpu")

import numpy as np  # noqa: E402

import krust as kt  # noqa: E402
from krust.io.reader import streams_from_sequences  # noqa: E402
from krust.models.engines import count_stream_numpy  # noqa: E402


def timeit(label: str, fn, n_iter: int = 100, per: int = 1) -> None:
    fn()  # warmup
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    dt = (time.perf_counter() - t0) / n_iter
    rate = per / dt if dt > 0 else float("inf")
    print(f"{label:48s} {dt * 1e6:10.2f} us/iter  {rate / 1e6:10.2f} M/s")


def random_dna(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("ACGT") for _ in range(n))


def micro() -> None:
    rng = random.Random(42)
    print("== micro: scalar codec ==")
    for k in (5, 11, 21, 31):
        s = random_dna(rng, k)
        kmer_obj = kt.Kmer.from_sub(s)
        packed = kmer_obj.pack()
        bits = packed.packed_bits
        timeit(f"Kmer.from_sub k={k}", lambda s=s: kt.Kmer.from_sub(s))
        timeit(f"pack k={k}", lambda s=s: kt.pack(s))
        timeit(f"canonical k={k}", lambda b=bits, k=k: kt.canonical_packed(b, k))
        timeit(f"unpack k={k}", lambda b=bits, k=k: kt.unpack_to_string(b, k))

    print("== micro: bulk host codec (1M windows) ==")
    seq = random_dna(rng, 1_000_000 + 31)
    streams = streams_from_sequences([seq])
    for k in (5, 11, 21, 31):
        timeit(
            f"count_stream_numpy k={k}",
            lambda k=k: count_stream_numpy(streams.codes, None, k),
            n_iter=3,
            per=1_000_000,
        )


def macro() -> None:
    rng = random.Random(7)
    seqs = [random_dna(rng, 320) for _ in range(100)]
    print("== macro: 100 seqs x 320bp (reference workload) ==")
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        for i, s in enumerate(seqs):
            f.write(f">seq{i}\n{s}\n")
        path = f.name
    try:
        per = sum(len(s) for s in seqs)
        for k in (5, 11, 21):
            timeit(
                f"count_kmers k={k}",
                lambda k=k: kt.count_kmers(path, k),
                n_iter=5,
                per=per,
            )
            timeit(
                f"count_kmers_from_sequences k={k}",
                lambda k=k: kt.count_kmers_from_sequences(seqs, k),
                n_iter=5,
                per=per,
            )
    finally:
        os.unlink(path)


def output_path() -> None:
    """Output formatting throughput (VERDICT r1 #6): bytes straight from
    (codes, counts) arrays, timed at 4M distinct entries."""
    from krust.output import OutputFormat, format_packed_counts

    rng = np.random.default_rng(0)
    codes = np.unique(rng.integers(0, 1 << 42, size=4_000_000, dtype=np.uint64))
    counts = rng.integers(1, 100, size=codes.shape[0], dtype=np.uint64)
    n = codes.shape[0]
    print(f"== output path: {n} distinct entries ==")
    for fmt in (OutputFormat.TSV, OutputFormat.FASTA, OutputFormat.HISTOGRAM):
        timeit(
            f"format_packed_counts {fmt.value}",
            lambda fmt=fmt: format_packed_counts(codes, counts, 21, fmt),
            n_iter=3,
            per=n,
        )


if __name__ == "__main__":
    micro()
    macro()
    output_path()
