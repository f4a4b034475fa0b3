"""Device counting: sort-based unique+count with front compaction.

The device replacement for the reference's concurrent hash map
(reference: src/run.rs:489-583). A shared mutable dashmap has no good analog
under XLA's functional model; instead each batch of canonical codes is sorted
(`lax.sort` on the (hi, lo) uint32 pair), runs are length-encoded with
prefix-scan arithmetic, and the distinct (code, count) pairs are scattered to
the front of fixed-shape output buffers. Only ``n_unique`` leading entries are
meaningful, so the host (or the cross-chip merge) moves a fraction of the raw
window count.

Determinism: sorting is order-insensitive, so counts are bit-identical across
batch sizes and mesh shapes — the determinism-by-construction that replaces
the reference's data-race tooling (SURVEY.md §5).

Count dtype: uint32 per merge call. Per-batch window counts are < 2^32 by
construction; cross-batch totals are accumulated in uint64 on the host (or
chunked on device). Saturation at the u64 limit (reference: src/run.rs:569)
is unreachable in any physical input but preserved in the host accumulator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: padding key: the (SENT, SENT) pair is the all-T k-mer, whose reverse
#: complement is all-A == 0, so it is never canonical for any k in 1..=32
SENT = 0xFFFFFFFF


@jax.jit
def merge_weighted(hi: jax.Array, lo: jax.Array, weight: jax.Array, valid: jax.Array):
    """Sum weights per distinct (hi, lo) key, compacting results to the front.

    Args:
      hi, lo: uint32 arrays (any shape; flattened) forming 64-bit keys; no
        valid key is the (SENT, SENT) pair, which no canonical k-mer is.
      weight: uint32 weights (counts) per entry.
      valid: bool; invalid entries (and entries of weight 0) are dropped.

    Returns:
      (u_hi, u_lo, u_cnt, n_unique): flat arrays of the input's total length
      with the distinct keys/counts in the first ``n_unique`` slots, key
      sorted (the rest zero), plus the scalar count of distinct valid keys.
    """
    weight = weight.reshape(-1).astype(jnp.uint32)
    return merge_runs(hi, lo, jnp.where(valid.reshape(-1), weight, 0), 32)


@jax.jit
def count_unique(hi: jax.Array, lo: jax.Array, valid: jax.Array):
    """Count occurrences of each distinct valid (hi, lo) key.

    Equivalent to :func:`merge_weighted` with unit weights.
    """
    ones = jnp.ones(hi.size, jnp.uint32)
    return merge_weighted(hi, lo, ones, valid)


@functools.partial(jax.jit, static_argnames=("k",))
def merge_runs(hi: jax.Array, lo: jax.Array, weight: jax.Array, k: int):
    """k-aware weighted merge with front compaction — the table-merge path.

    Entries of weight 0 are padding. Padding is keyed to the (SENT, SENT)
    pair, which sorts last and which no canonical k-mer is; one sort with
    the weights as payload (the key in ``lo`` alone for k <= 16), then
    :func:`compact_runs`. Output padding past ``n_unique`` is zero.
    """
    lo = lo.reshape(-1)
    weight = weight.reshape(-1).astype(jnp.uint32)
    if lo.shape[0] == 0:
        z = jnp.zeros(0, jnp.uint32)
        return z, z, z, jnp.int32(0)
    live = weight > 0
    sent = jnp.uint32(SENT)
    key_lo = jnp.where(live, lo, sent)
    if k <= 16:
        s_lo, s_w = jax.lax.sort((key_lo, weight), num_keys=1, is_stable=False)
        o_hi, o_lo, o_cnt, n = compact_runs(None, s_lo, s_w, one_key=True)
    else:
        key_hi = jnp.where(live, hi.reshape(-1), sent)
        s_hi, s_lo, s_w = jax.lax.sort(
            (key_hi, key_lo, weight), num_keys=2, is_stable=False
        )
        o_hi, o_lo, o_cnt, n = compact_runs(s_hi, s_lo, s_w)
    live = o_cnt > 0
    return jnp.where(live, o_hi, 0), jnp.where(live, o_lo, 0), o_cnt, n


@functools.partial(jax.jit, static_argnames=("one_key",))
def compact_runs(hi, lo, cnt=None, one_key=False):
    """Distinct (key, count) table from a key-sorted sentinel-padded stream.

    The run-length + stream-compaction pass behind every epoch flush and
    part merge: a run-boundary mask, run sums from a prefix scan (a
    masked ``cummax``), then each run's last entry scattered to its rank
    among emitted entries. All of it is
    memory-bound elementwise work and one scatter with unique indices.

    Args:
      hi, lo: uint32 [n] key halves, sorted ascending as 64-bit (hi, lo)
        pairs with (SENT, SENT) padding at the back.
      cnt: optional uint32 weights (None = every entry counts 1). Weight
        sums must stay below 2^32 (the tables cap an epoch's windows).
      one_key: k <= 16 — keys live entirely in ``lo`` (pass ``hi=None``);
        output hi is 0 for real entries and SENT for padding.

    Returns:
      (o_hi, o_lo, o_cnt, n_unique): distinct keys with summed counts at
      the front, SENT keys and zero counts past ``n_unique``.
    """
    n = lo.shape[0]
    if n == 0:
        z = jnp.zeros(0, jnp.uint32)
        return z, z, z, jnp.int32(0)
    sent = jnp.uint32(SENT)
    if one_key:
        is_sent = lo == sent
        differs = lo[1:] != lo[:-1]
    else:
        is_sent = (hi == sent) & (lo == sent)
        differs = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    edge = jnp.ones(1, jnp.bool_)
    is_start = jnp.concatenate([edge, differs])
    is_end = jnp.concatenate([differs, edge])
    pos = jnp.arange(n, dtype=jnp.int32)
    if cnt is None:
        run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
        run_sum = (pos - run_start + 1).astype(jnp.uint32)
    else:
        prefix = jnp.cumsum(cnt, dtype=jnp.uint32)
        before = jax.lax.cummax(jnp.where(is_start, prefix - cnt, 0))
        run_sum = prefix - before
    emit = is_end & ~is_sent
    rank = jnp.cumsum(emit, dtype=jnp.int32)
    n_unique = rank[-1]
    dest = jnp.where(emit, rank - 1, n)  # slot n is out of range: dropped

    def scatter(fill, vals):
        return jnp.full(n, fill, jnp.uint32).at[dest].set(vals, mode="drop")

    o_lo = scatter(SENT, lo)
    o_cnt = scatter(0, run_sum)
    if one_key:
        o_hi = jnp.where(pos < n_unique, jnp.uint32(0), sent)
    else:
        o_hi = scatter(SENT, hi)
    return o_hi, o_lo, o_cnt, n_unique


@functools.partial(jax.jit, static_argnames=("k",))
def count_runs(hi: jax.Array, lo: jax.Array, valid: jax.Array, k: int):
    """Per-batch counting without compaction — the hot path.

    Returns (s_hi, s_lo, cnt) of the input's total length: keys sorted
    ascending with each run's total count at its last position and zeros
    elsewhere (zero-count entries are padding for downstream merges). Skips
    the compaction scatters of :func:`count_unique` and sorts the minimum
    number of operands for the given k:

    - k <= 16: codes fit 32 bits with hi identically zero, and 0xFFFFFFFF is
      a safe invalid sentinel even at k == 16 — the all-T k-mer is never
      canonical (its reverse complement is all-A == 0) — so one sort operand
      suffices;
    - k <= 31: hi <= 4^(k-16)-1 < 0xFFFFFFFF, so the sentinel pair is safe
      with two operands;
    - k == 32: T^32 == all-ones, sentinel unsafe; carry an invalid flag key.
    """
    lo = lo.reshape(-1)
    valid = valid.reshape(-1).astype(jnp.bool_)
    n = lo.shape[0]
    if n == 0:
        z = jnp.zeros(0, jnp.uint32)
        return z, z, z

    sentinel = jnp.uint32(0xFFFFFFFF)
    if k <= 16:
        key = jnp.where(valid, lo, sentinel)
        (s_lo,) = jax.lax.sort((key,), num_keys=1)
        s_hi = jnp.zeros_like(s_lo)
        sorted_valid = s_lo != sentinel
        prev_differs = s_lo != jnp.roll(s_lo, 1)
        next_differs = s_lo != jnp.roll(s_lo, -1)
    elif k <= 31:
        hi = hi.reshape(-1)
        key_hi = jnp.where(valid, hi, sentinel)
        key_lo = jnp.where(valid, lo, sentinel)
        s_hi, s_lo = jax.lax.sort((key_hi, key_lo), num_keys=2)
        sorted_valid = s_hi != sentinel
        prev_differs = (s_hi != jnp.roll(s_hi, 1)) | (s_lo != jnp.roll(s_lo, 1))
        next_differs = (s_hi != jnp.roll(s_hi, -1)) | (s_lo != jnp.roll(s_lo, -1))
    else:
        hi = hi.reshape(-1)
        inv = (~valid).astype(jnp.uint32)
        s_inv, s_hi, s_lo = jax.lax.sort((inv, hi, lo), num_keys=3)
        sorted_valid = s_inv == 0
        prev_differs = (
            (s_hi != jnp.roll(s_hi, 1))
            | (s_lo != jnp.roll(s_lo, 1))
            | (s_inv != jnp.roll(s_inv, 1))
        )
        next_differs = (
            (s_hi != jnp.roll(s_hi, -1))
            | (s_lo != jnp.roll(s_lo, -1))
            | (s_inv != jnp.roll(s_inv, -1))
        )

    pos = jnp.arange(n, dtype=jnp.int32)
    is_start = prev_differs.at[0].set(True)
    is_end = next_differs.at[n - 1].set(True)
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    cnt = jnp.where(
        is_end & sorted_valid, (pos - run_start + 1).astype(jnp.uint32), 0
    )
    # scrub sentinel keys so padding entries are (0, 0, 0)
    s_hi = jnp.where(cnt > 0, s_hi, 0)
    s_lo = jnp.where(cnt > 0, s_lo, 0)
    return s_hi, s_lo, cnt
