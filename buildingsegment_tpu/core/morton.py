"""On-device Morton (Z-order) encoding and sorting — int32-native.

The reference carries a dead LUT-based Morton encoder from TMC13
(tmc3/PCCMath.h:621-642 — its lookup tables were never shipped, so it
cannot even link).  Spatial locality matters much more for the
data-parallel rebuild: Morton-sorting the cloud makes neighbor
candidates contiguous in memory, which is what lets windowed kNN and
range sharding work.

JAX defaults to x64-disabled (no int64 arrays), so
instead of one 63-bit code we interleave 10 bits per axis into 30-bit
int32 words and sort LSD-radix style: a stable argsort by the low word
followed by a stable argsort by the high word yields the exact order of
the full 60-bit (20 bits/axis, ~1 km at mm resolution) code.  Encoding
is vectorized magic-number bit spreading — no tables, elementwise ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

#: bits per axis captured by one 30-bit int32 word
WORD_BITS = 10
#: total bits per axis across the two-word code
TOTAL_BITS = 2 * WORD_BITS


def _spread_bits_10(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of ``x`` so bit i moves to bit 3*i (int32)."""
    x = x.astype(jnp.int32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(positions: jax.Array, shift: int = 0) -> jax.Array:
    """30-bit Morton code int32[N] of bits [shift, shift+10) of each axis.

    Axis interleave: bit k of x lands at 3k, y at 3k+1, z at 3k+2.
    Positions must be non-negative (the pipeline shifts the bbox to the
    origin first).
    """
    p = positions >> shift if shift else positions
    x = _spread_bits_10(p[..., 0])
    y = _spread_bits_10(p[..., 1])
    z = _spread_bits_10(p[..., 2])
    return x | (y << 1) | (z << 2)


def morton_argsort(positions: jax.Array, mask: jax.Array) -> jax.Array:
    """Stable argsort by the 60-bit Morton code; padded rows sort last.

    Two-pass LSD radix: stable sort by the low 30-bit word, then by the
    high word.  Coordinates are clamped to 20 bits per axis (~1048 m at
    mm scale) — beyond that, points still sort into coarse cells.
    """
    pos = jnp.clip(positions, 0, (1 << TOTAL_BITS) - 1)
    lo = morton_encode(pos, shift=0)
    hi = morton_encode(pos, shift=WORD_BITS)
    return _two_word_argsort(lo, hi, mask)


def _two_word_argsort(lo: jax.Array, hi: jax.Array, mask: jax.Array) -> jax.Array:
    big = jnp.int32(0x7FFFFFFF)
    hi = jnp.where(mask, hi, big)  # padding → after every real point
    order = jnp.argsort(lo, stable=True)
    order = order[jnp.argsort(hi[order], stable=True)]
    return order


def _unspread_bits_10(x: jax.Array) -> jax.Array:
    """Inverse of :func:`_spread_bits_10`: collect bits 3i → bit i."""
    x = x.astype(jnp.int32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton_decode(code: jax.Array) -> jax.Array:
    """Recover the three 10-bit axis words from a 30-bit Morton code."""
    return jnp.stack(
        [
            _unspread_bits_10(code),
            _unspread_bits_10(code >> 1),
            _unspread_bits_10(code >> 2),
        ],
        axis=-1,
    )


def morton_sort(positions: jax.Array, mask: jax.Array,
                small_extent: bool = False):
    """Sort positions+mask by the 60-bit Morton code via ONE
    multi-operand ``lax.sort`` — no argsort-then-gather.

    XLA sort cost scales with the number of carried columns, so the
    coordinates are NOT carried: the two Morton words already hold bits
    0-19 of every axis (decoded after the sort with the inverse bit
    spread), and a residual word packs bits 20-29 of each axis so
    geometry is exact for any int32 coordinate.  Ordering uses bits
    0-19 per axis (~1 km at mm resolution) exactly as before — beyond
    that points still sort into coarse cells.  4 sort operands instead
    of 7.

    ``small_extent=True`` (static) declares every UNMASKED coordinate
    < 2^20 (1048 m at mm scale — every building scan; the host drivers
    check the bbox at read time).  The residual word is then
    identically zero and is dropped from the sort: 3 operands / 2 keys
    instead of 4 / 3, with the padding marker folded into the high
    word.  Bit-identical to the general path on in-range clouds
    (tests/test_morton.py::test_small_extent_matches_general).

    Returns (sorted_positions int32[N,3], sorted_mask bool[N],
    order int32[N]) where ``order`` maps sorted row → original row
    (for the final unsort).
    """
    n = positions.shape[0]
    big = jnp.int32(0x7FFFFFFF)
    if small_extent:
        p = jnp.maximum(positions, 0)
        lo = morton_encode(p, shift=0)
        hi = morton_encode(p, shift=WORD_BITS)
        # padding sorts last via the high word (real hi < 2^30 < big);
        # stability makes ties keep original order, exactly like the
        # general path's stable 3-key sort with resid ≡ 0
        hi = jnp.where(mask, hi, big)
        iota = jnp.arange(n, dtype=jnp.int32)
        s_hi, s_lo, order = lax.sort(
            (hi, lo, iota), num_keys=2, is_stable=True
        )
        m = s_hi < big
        spos = morton_decode(s_lo) | (morton_decode(s_hi) << WORD_BITS)
        spos = jnp.where(m[:, None], spos, jnp.int32(1 << 24))
        return spos, m, order
    # low 20 bits per axis, WRAPPED not saturated (decode must be
    # exact); negatives clamp to 0 (the pipeline shifts to the origin
    # first — negatives only occur in padding, which the mask kills)
    p = jnp.maximum(positions, 0)
    lo = morton_encode(p & ((1 << TOTAL_BITS) - 1), shift=0)
    hi = morton_encode(p & ((1 << TOTAL_BITS) - 1), shift=WORD_BITS)
    # bits ≥ 20 per axis, packed 10+10+10, as the LEADING key: points
    # beyond the 1 km Morton range order by coarse cell first (x-major)
    resid = (
        (p[:, 0] >> TOTAL_BITS)
        | ((p[:, 1] >> TOTAL_BITS) << WORD_BITS)
        | ((p[:, 2] >> TOTAL_BITS) << (2 * WORD_BITS))
    )
    big = jnp.int32(0x7FFFFFFF)
    # padding → after every real point (real resid ≤ 0x3FFFFFFF < big,
    # so the sorted resid word doubles as the mask)
    resid = jnp.where(mask, resid, big)
    iota = jnp.arange(n, dtype=jnp.int32)
    s_res, s_hi, s_lo, order = lax.sort(
        (resid, hi, lo, iota), num_keys=3, is_stable=True
    )
    m = s_res < big
    lo_axes = morton_decode(s_lo)
    hi_axes = morton_decode(s_hi)
    res_axes = jnp.stack(
        [
            s_res & 0x3FF,
            (s_res >> WORD_BITS) & 0x3FF,
            (s_res >> (2 * WORD_BITS)) & 0x3FF,
        ],
        axis=-1,
    )
    spos = (
        lo_axes
        | (hi_axes << WORD_BITS)
        | (res_axes << TOTAL_BITS)
    )
    # padded rows: reproduce the old carried sentinel exactly is not
    # needed — downstream only reads masked rows; give them a large
    # positive coordinate so window sweeps' distance gates also kill
    # them (mirrors the 2^24 host padding convention)
    spos = jnp.where(m[:, None], spos, jnp.int32(1 << 24))
    return spos, m, order


def unsort_by(order: jax.Array, *payloads: jax.Array):
    """Invert the sort permutation gather/scatter-free.

    ``order`` (as returned by :func:`morton_sort`) maps sorted row →
    original row; sorting the payload columns by it restores the
    original frame through the same multi-operand sorting network
    instead of a ``zeros.at[order].set(v)`` scatter (random-access
    writes; not measured against it on the H100 yet).

    Returns the unsorted payload (or tuple of payloads).
    """
    out = lax.sort((order,) + payloads, num_keys=1, is_stable=False)
    return out[1:] if len(payloads) > 1 else out[1]


def unsort_labels(order: jax.Array, labels: jax.Array,
                  max_label: int = 1024) -> jax.Array:
    """Invert the sort permutation for ONE small-range int payload.

    XLA sort cost scales with carried bytes, so (statically, by n and
    ``max_label``):

    1. **Packed**: ``(order << L) | (label + 1)`` in ONE int32 word when
       ``ceil(log2 n) + L <= 32`` — biased by 2^31 (wraparound add) so
       signed ordering matches the unsigned packing; order values are
       unique, hence an unstable single-key sort is exact.  Roughly
       halves :func:`unsort_by`'s time.
    2. **i16 payload**: labels ride as int16 next to the int32 key
       (25% fewer bytes) when they fit int16 but not the pack.
    3. Fallback to :func:`unsort_by` otherwise.
    """
    n = order.shape[0]
    label_bits = max(1, (max_label + 2 - 1).bit_length())  # for label+1
    order_bits = max(1, (n - 1).bit_length())
    if order_bits + label_bits <= 32:
        shift = 32 - order_bits  # give the label every spare bit
        bias = jnp.int32(-(2**31))
        packed = ((order << shift) | (labels + 1)) + bias
        s = lax.sort((packed,), num_keys=1, is_stable=False)[0]
        return (s & ((1 << shift) - 1)) - 1
    if max_label <= 32766:
        _, s = lax.sort(
            (order, (labels + 1).astype(jnp.int16)),
            num_keys=1, is_stable=False,
        )
        return s.astype(jnp.int32) - 1
    return unsort_by(order, labels)


def hilbert_transpose(positions: jax.Array, bits: int = TOTAL_BITS) -> jax.Array:
    """Skilling's axes→transpose transform, vectorized (int32 per axis).

    Returns X int32[..., 3] such that interleaving the bits of
    X[...,0] (most significant), X[...,1], X[...,2] yields the Hilbert
    index.  The Hilbert curve visits every cell through face-adjacent
    steps — unlike the Z-order curve it has no long jumps, which is
    exactly what window-based neighbor search wants.
    """
    x = jnp.clip(positions[..., 0], 0, (1 << bits) - 1)
    y = jnp.clip(positions[..., 1], 0, (1 << bits) - 1)
    z = jnp.clip(positions[..., 2], 0, (1 << bits) - 1)
    X = [x, y, z]

    # inverse undo (static loop over bit planes, vectorized over points)
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            has = (X[i] & q) != 0
            # invert X[0] low bits where has; else swap low bits X[0]<->X[i]
            t = (X[0] ^ X[i]) & p
            X0_inv = X[0] ^ p
            X0_swp = X[0] ^ t
            Xi_swp = X[i] ^ t
            X0_new = jnp.where(has, X0_inv, X0_swp)
            Xi_new = jnp.where(has | (i == 0), X[i], Xi_swp)
            if i == 0:
                X[0] = jnp.where(has, X0_inv, X[0])
            else:
                X[0] = X0_new
                X[i] = Xi_new
        q >>= 1

    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = jnp.zeros_like(X[0])
    q = 1 << (bits - 1)
    while q > 1:
        cond = (X[2] & q) != 0
        t = jnp.where(cond, t ^ (q - 1), t)
        q >>= 1
    return jnp.stack([X[0] ^ t, X[1] ^ t, X[2] ^ t], axis=-1)


def hilbert_argsort(positions: jax.Array, mask: jax.Array) -> jax.Array:
    """Stable argsort by the 60-bit Hilbert index; padded rows sort last.

    Same two-word LSD-radix scheme as :func:`morton_argsort`, with the
    transpose-form axes interleaved so X[...,0] is the most significant
    axis per bit triple (our interleave puts the ``z`` slot at bit
    3k+2, so the transpose axes map to (z,y,x) slots reversed).
    """
    pos = jnp.clip(positions, 0, (1 << TOTAL_BITS) - 1)
    xt = hilbert_transpose(pos)
    # slot order: morton_encode puts axis 2 (z) most significant —
    # feed X0 there, X2 least significant
    perm = jnp.stack([xt[..., 2], xt[..., 1], xt[..., 0]], axis=-1)
    lo = morton_encode(perm, shift=0)
    hi = morton_encode(perm, shift=WORD_BITS)
    return _two_word_argsort(lo, hi, mask)
