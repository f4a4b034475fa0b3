"""Independent brute-force k-mer counting oracle.

A deliberately naive pure-Python implementation of the reference semantics
(reference: src/run.rs:526-571), written without reusing any krust
codec code, for differential testing. Slow; use on small inputs only.
"""

from __future__ import annotations

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_VALID = set("ACGT")


def revcomp(s: str) -> str:
    return "".join(_COMP[c] for c in reversed(s))


def canonical(s: str) -> str:
    rc = revcomp(s)
    return min(s, rc)


def count_sequence(
    seq: str, k: int, qual: str | None = None, min_quality: int | None = None
) -> dict[str, int]:
    """Window scan with the reference's skip-ahead semantics."""
    counts: dict[str, int] = {}
    if len(seq) < k:
        return counts
    threshold = None if min_quality is None else min(min_quality + 33, 255)
    i = 0
    while i <= len(seq) - k:
        if qual is not None and threshold is not None:
            bad = next(
                (j for j in range(k) if ord(qual[i + j]) < threshold), None
            )
            if bad is not None:
                i += bad + 1
                continue
        window = seq[i : i + k].upper()
        bad = next((j for j in range(k) if window[j] not in _VALID), None)
        if bad is not None:
            i += bad + 1
            continue
        c = canonical(window)
        counts[c] = counts.get(c, 0) + 1
        i += 1
    return counts


def count_sequences(
    records, k: int, min_quality: int | None = None
) -> dict[str, int]:
    """records: iterable of str or (seq, qual) tuples."""
    total: dict[str, int] = {}
    for rec in records:
        if isinstance(rec, tuple):
            seq, qual = rec
        else:
            seq, qual = rec, None
        for km, c in count_sequence(seq, k, qual, min_quality).items():
            total[km] = total.get(km, 0) + c
    return total


def random_dna(rng, n: int, alphabet: str = "ACGT") -> str:
    return "".join(rng.choice(alphabet) for _ in range(n))
