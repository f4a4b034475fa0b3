"""krust — a GPU k-mer counting engine in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of the
reference Rust tool ``kmerust`` (suchapalaver/krust): canonical k-mer
counting (k = 1-32, 2-bit packed) over FASTA/FASTQ (plain/gzip, file/stdin)
with N-base skipping, soft-mask normalization, and Phred quality filtering;
FASTA/TSV/JSON/histogram output with min-count filtering; a byte-compatible
binary ``.kmix`` index plus query; library, builder, streaming, progress and
async APIs; and a CLI with the same UX.

Architecture (accelerator-first, not a port — see SURVEY.md §7):
  host reader/packer  ->  dense haloed [B, W+k-1] uint8 code tensors
  device rolling codec -> canonical (hi, lo) uint32 code pairs + validity
  device sort-count    -> compacted distinct (code, count) per batch
  host/device merge    -> u64 totals; multi-chip via hash-sharded all-to-all
"""

__version__ = "0.8.0"

import os as _os

# KRUST_PLATFORM picks the JAX platform (e.g. KRUST_PLATFORM=cpu runs the
# device pipeline on XLA-CPU for tests and the virtual-device mesh). Must
# happen before any backend initialization.
if _os.environ.get("KRUST_PLATFORM"):
    try:
        import jax as _jax

        _jax.config.update("jax_platforms", _os.environ["KRUST_PLATFORM"])
    except Exception:
        pass

from .api import (
    count_kmers,
    count_kmers_files,
    count_kmers_from_input,
    count_kmers_from_input_packed,
    count_kmers_with_format,
    count_kmers_with_quality,
    count_kmers_with_progress,
    count_kmers_mmap,
    count_kmers_streaming,
    count_kmers_streaming_packed,
    count_kmers_packed,
    count_kmers_sequential,
    count_kmers_from_reader,
    count_kmers_from_reader_packed,
    count_kmers_stdin,
    count_kmers_stdin_packed,
    count_kmers_stdin_with_format,
    count_kmers_from_sequences,
    count_kmers_from_sequences_packed,
    count_kmers_sniffed,
    count_kmers_sharded,
    count_kmers_sharded_result,
    count_with_input,
    run,
    run_with_options,
    run_with_input,
    run_with_input_format,
    run_with_quality,
)
from .async_api import AsyncKmerCounter, count_kmers_async, count_kmers_packed_async
from .builder import KmerCounter
from .errors import (
    BuilderError,
    FormatError,
    InvalidBaseError,
    InvalidIndexError,
    IndexReadError,
    IndexWriteError,
    KmerLengthError,
    KrustError,
    ReadError,
)
from .histogram import (
    HistogramStats,
    compute_histogram,
    compute_histogram_packed,
    histogram_stats,
)
from .index import KmerIndex, load_index, save_index
from .io.format import SequenceFormat
from .io.input import Input
from .io.mmapfile import MmapFasta
from .kmer import (
    Kmer,
    KmerBase,
    KmerLength,
    canonical_packed,
    canonical_string,
    pack,
    unpack_to_bytes,
    unpack_to_string,
)
from .models.engines import PackedCounts
from .output import OutputFormat, format_packed_counts, output_counts, output_packed
from .utils.progress import Progress, ProgressTracker

__all__ = [
    "__version__",
    # counting
    "count_kmers",
    "count_kmers_with_format",
    "count_kmers_with_quality",
    "count_kmers_with_progress",
    "count_kmers_files",
    "count_kmers_from_input",
    "count_kmers_from_input_packed",
    "count_kmers_mmap",
    "count_kmers_streaming",
    "count_kmers_streaming_packed",
    "count_kmers_packed",
    "count_kmers_sequential",
    "count_kmers_from_reader",
    "count_kmers_from_reader_packed",
    "count_kmers_stdin",
    "count_kmers_stdin_packed",
    "count_kmers_stdin_with_format",
    "count_kmers_sniffed",
    "count_kmers_sharded",
    "count_kmers_sharded_result",
    "count_kmers_from_sequences",
    "count_kmers_from_sequences_packed",
    "count_with_input",
    "run",
    "run_with_options",
    "run_with_input",
    "run_with_input_format",
    "run_with_quality",
    # async
    "AsyncKmerCounter",
    "count_kmers_async",
    "count_kmers_packed_async",
    # builder
    "KmerCounter",
    # kmer core
    "Kmer",
    "KmerBase",
    "KmerLength",
    "pack",
    "unpack_to_bytes",
    "unpack_to_string",
    "canonical_packed",
    "canonical_string",
    # io
    "Input",
    "MmapFasta",
    "SequenceFormat",
    # output / histogram
    "OutputFormat",
    "output_counts",
    "output_packed",
    "format_packed_counts",
    "compute_histogram",
    "compute_histogram_packed",
    "histogram_stats",
    "HistogramStats",
    # index
    "KmerIndex",
    "save_index",
    "load_index",
    # progress
    "Progress",
    "ProgressTracker",
    "PackedCounts",
    # errors
    "KrustError",
    "KmerLengthError",
    "InvalidBaseError",
    "BuilderError",
    "FormatError",
    "ReadError",
    "IndexReadError",
    "IndexWriteError",
    "InvalidIndexError",
]
