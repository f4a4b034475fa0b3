"""Device codec: rolling canonical k-mer encoding over haloed blocks.

This is the device replacement for the reference's per-window scalar loop
(reference: src/run.rs:526-571, src/kmer.rs:266-390). Instead of walking each
sequence byte-by-byte, the whole input lives in a dense [B, W + k - 1] uint8
tensor and every window's forward code, reverse-complement code, canonical
minimum, and validity are computed with k unrolled vector steps — no
data-dependent control flow, fully fusable by XLA.

64-bit representation: JAX runs without x64 by default, so a packed k-mer
(up to 64 bits for k=32) is carried as a (hi, lo) pair of uint32 tensors. For k <= 16
the hi half is identically zero and the comparisons collapse; for k > 16 a
left-shift-by-2 across the pair is ``hi = hi<<2 | lo>>30; lo = lo<<2 | base``.

Semantics reproduced exactly:
- forward pack: first base most significant (reference: src/kmer.rs:467-471);
- reverse complement: complement code is ``3 - c``; base at window offset j
  contributes at bit offset 2j (reference: src/kmer.rs:348-390);
- canonical = numeric min of (fwd, rc); ties keep forward;
- a window is valid iff all k bases are ACGT *and* (when quality filtering)
  all k quality bytes >= threshold (reference: src/run.rs:538-563 — the
  skip-ahead scan is equivalent to "count every clean window").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k", "quality_threshold"))
def encode_blocks(
    codes: jax.Array,
    k: int,
    qual: jax.Array | None = None,
    quality_threshold: int | None = None,
):
    """Encode haloed blocks into canonical k-mer codes.

    Args:
      codes: [B, W + k - 1] uint8 base codes (0..3 valid, >=4 invalid).
      k: static k-mer length, 1..32.
      qual: optional [B, W + k - 1] uint8 Phred+33 quality bytes.
      quality_threshold: static ASCII threshold; a base with
        ``qual < threshold`` poisons every window containing it.

    Returns:
      (hi, lo, valid): uint32 [B, W], uint32 [B, W], bool [B, W].
    """
    w = codes.shape[-1] - (k - 1)
    good = codes < 4
    if qual is not None and quality_threshold is not None:
        good = good & (qual >= jnp.uint8(quality_threshold))
    b = jnp.where(good, codes, 0).astype(jnp.uint32)
    comp = jnp.where(good, 3 - codes.astype(jnp.int32), 0).astype(jnp.uint32)

    wide = k > 16
    fwd_lo = jnp.zeros(b.shape[:-1] + (w,), jnp.uint32)
    fwd_hi = jnp.zeros_like(fwd_lo) if wide else None
    rc_lo = jnp.zeros_like(fwd_lo)
    rc_hi = jnp.zeros_like(fwd_lo) if wide else None
    valid = jnp.ones(b.shape[:-1] + (w,), jnp.bool_)

    for j in range(k):
        bj = jax.lax.dynamic_slice_in_dim(b, j, w, axis=-1)
        # rc is built scanning window offsets in reverse (offset j contributes
        # complement at bit 2j, so feed offsets k-1, k-2, ..., 0)
        cj = jax.lax.dynamic_slice_in_dim(comp, k - 1 - j, w, axis=-1)
        gj = jax.lax.dynamic_slice_in_dim(good, j, w, axis=-1)
        if wide:
            fwd_hi = (fwd_hi << 2) | (fwd_lo >> 30)
            rc_hi = (rc_hi << 2) | (rc_lo >> 30)
        fwd_lo = (fwd_lo << 2) | bj
        rc_lo = (rc_lo << 2) | cj
        valid = valid & gj

    if wide:
        use_rc = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
        hi = jnp.where(use_rc, rc_hi, fwd_hi)
    else:
        use_rc = rc_lo < fwd_lo
        hi = jnp.zeros_like(fwd_lo)
    lo = jnp.where(use_rc, rc_lo, fwd_lo)
    return hi, lo, valid


@functools.partial(jax.jit, static_argnames=("width",))
def unpack_2bit(packed2: jax.Array, badbits: jax.Array, width: int) -> jax.Array:
    """Device-side unpack of (packed2, badbits) rows to uint8 codes [B, width].

    Invalid positions (set bits in badbits) come out as INVALID_CODE (4), so
    the result feeds :func:`encode_blocks` directly. Unpacking is a handful
    of shift/mask ops against device memory bandwidth — roughly free
    compared to the host->device transfer it shrinks 2.7x.
    """
    b = packed2.shape[0]
    shifts4 = jnp.array([6, 4, 2, 0], jnp.uint8)
    c = (packed2[:, :, None] >> shifts4[None, None, :]) & 3
    c = c.reshape(b, -1)[:, :width]
    shifts8 = jnp.array([7, 6, 5, 4, 3, 2, 1, 0], jnp.uint8)
    bad = (badbits[:, :, None] >> shifts8[None, None, :]) & 1
    bad = bad.reshape(b, -1)[:, :width]
    return jnp.where(bad != 0, jnp.uint8(4), c.astype(jnp.uint8))


@functools.partial(jax.jit, static_argnames=("k", "rows", "block_windows"))
def unpack_flat_blocks(
    packed2: jax.Array,
    invpos: jax.Array,
    k: int,
    rows: int,
    block_windows: int,
) -> jax.Array:
    """Flat 2-bit slice + sparse invalid positions -> haloed code blocks.

    The device half of the flat transfer path (io/packer.py FlatBatch):
    unpacks 4 bases/byte, scatters INVALID at ``invpos`` (sentinel entries
    >= stream length are dropped), and builds the [rows, W + k - 1] haloed
    block tensor with reshape/slice only — no gathers. Row i covers stream
    positions [i*W, (i+1)*W + k - 1).
    """
    w = block_windows
    shifts4 = jnp.array([6, 4, 2, 0], jnp.uint8)
    flat = ((packed2[:, None] >> shifts4[None, :]) & 3).reshape(-1)
    flat = flat.astype(jnp.uint8).at[invpos].set(jnp.uint8(4), mode="drop")
    # row i's main span is flat[i*w : (i+1)*w]; its halo is the k-1 codes
    # after, i.e. the head of row i+1's span — one extra row's worth of
    # padding makes the shifted reshape in-bounds
    target = (rows + 1) * w
    n = flat.shape[0]
    if n < target:
        flat = jnp.concatenate([flat, jnp.full(target - n, 4, jnp.uint8)])
    else:
        flat = flat[:target]
    ext = flat.reshape(rows + 1, w)
    return jnp.concatenate([ext[:-1], ext[1:, : k - 1]], axis=1)


def split64(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: uint64 codes -> (hi, lo) uint32 pair."""
    codes = np.asarray(codes, dtype=np.uint64)
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)


def combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host helper: (hi, lo) uint32 pair -> uint64 codes."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
