"""Quantization and bounding-box normalization.

Reproduces the reference's two coordinate transforms:

1. PLY read scales raw float positions by ``positionScale`` (1000 → mm)
   and truncates toward zero into int32 (tmc3/ply.cpp:407-409 ascii,
   437-465 binary; assignment of a double into ``Vec3<int32_t>`` is a C++
   truncating conversion).
2. The ``buildingSeg`` constructor computes the integer bounding box and
   translates the cloud so the minimum corner is the origin
   (tmc3/TMC3.cpp:58-72, comment "shift to positive").

Both are masked reductions / elementwise ops here, fully fused by XLA.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def quantize_positions(raw: jax.Array, scale: float) -> jax.Array:
    """float[N,3] × scale, truncated toward zero → int32[N,3].

    Matches C++ double→int32 conversion semantics (truncation toward
    zero, tmc3/ply.cpp:407-409): ``jnp.trunc`` then cast.
    """
    scaled = raw.astype(jnp.float64 if raw.dtype == jnp.float64 else jnp.float32) * scale
    return jnp.trunc(scaled).astype(jnp.int32)


def dedup_quantized(
    positions: jax.Array, mask: jax.Array, drop_bits: int = 0
) -> jax.Array:
    """Mask out duplicate points after dropping ``drop_bits`` low bits.

    The container-level dedup of the reference
    (``removeDuplicatePointInQuantizedPoint``, tmc3/PCCPointSet.h:457-472:
    mask low bits, sort, keep first of each run).  Returns an updated
    validity mask with later duplicates cleared; order is preserved and
    the FIRST occurrence in index order survives, like the reference's
    stable pass.  Data-parallel: sort by (key, index), compare runs,
    scatter the keep flags back.
    """
    from buildingsegment_tpu.core.morton import morton_encode

    q = jnp.where(mask[:, None], positions >> drop_bits, -1)
    # 60-bit key via the two-word Morton encode (collision-free for
    # coords < 2^20 per axis after shift-to-origin)
    lo = morton_encode(jnp.maximum(q, 0), shift=0)
    hi = morton_encode(jnp.maximum(q, 0), shift=10)
    n = positions.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # stable two-pass sort by (hi, lo); invalid rows last
    big = jnp.int32(0x7FFFFFFF)
    hi = jnp.where(mask, hi, big)
    order = jnp.argsort(lo, stable=True)
    order = order[jnp.argsort(hi[order], stable=True)]
    s_lo, s_hi, s_mask = lo[order], hi[order], mask[order]
    same_as_prev = (
        (s_lo == jnp.roll(s_lo, 1)) & (s_hi == jnp.roll(s_hi, 1)) & s_mask
    )
    same_as_prev = same_as_prev.at[0].set(False)
    keep_sorted = s_mask & ~same_as_prev
    return jnp.zeros((n,), jnp.bool_).at[order].set(keep_sorted)


def dedup_keep_mask(positions: np.ndarray, drop_bits: int = 0) -> np.ndarray:
    """Host-side keep mask for quantized-duplicate removal.

    Numpy twin of :func:`dedup_quantized` for the CLI/pipeline entry
    (the reference's ``removeDuplicatePointInQuantizedPoint``,
    tmc3/PCCPointSet.h:457-472): compare positions after masking
    ``drop_bits`` low bits; the FIRST occurrence in index order
    survives.  Runs before upload so the padded batch only carries
    surviving points (the reference resizes its container the same way).
    """
    n = len(positions)
    if n == 0:
        return np.zeros(0, bool)
    q = positions.astype(np.int64) >> drop_bits
    q = q - q.min(axis=0, keepdims=True)
    if int(q.max()) < (1 << 21):
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        _, first = np.unique(key, return_index=True)
    else:  # pragma: no cover — >2 km extent at mm scale
        _, first = np.unique(q, axis=0, return_index=True)
    keep = np.zeros(n, bool)
    keep[first] = True
    return keep


def estimate_spacing_mm(positions: np.ndarray, cell_mm: int = 512) -> float:
    """Host-side point-spacing estimate for a surface scan (mm).

    Occupancy method: count occupied ``cell_mm`` voxels; for surface
    data, points-per-occupied-cell ≈ (cell/spacing)², so
    spacing ≈ cell / sqrt(points_per_cell).  One ``np.unique`` over
    packed int64 keys — ~10 ms at 1M points.  Used by the drivers to
    prove a STATIC density hint (the ``morton_small`` pattern) that
    the multigrid edge gates scale with; see seg/coarse.py.
    """
    n = len(positions)
    if n == 0:
        return float(cell_mm)
    q = positions.astype(np.int64)
    q = (q - q.min(axis=0, keepdims=True)) // cell_mm
    if int(q.max(initial=0)) < (1 << 21):
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        occupied = len(np.unique(key))
    else:  # pragma: no cover — >~1000 km extent at cell=512
        occupied = len(np.unique(q, axis=0))
    per = n / max(occupied, 1)
    return float(cell_mm) / max(per, 1.0) ** 0.5


def spacing_bucket_mm(est_mm: float) -> float:
    """Round a spacing estimate to the NEAREST power of two (mm),
    clamped to [16, 2048] — one jit variant per bucket.  Nearest (not
    up): the edge-gate factor (3× per coarse-row spacing,
    seg/coarse.py) absorbs the ≤√2 underestimate, while rounding UP
    would widen every gate by up to 2× and reintroduce the coplanar
    cross-building bridging the hint exists to prevent."""
    import math

    return float(min(max(2 ** round(math.log2(max(est_mm, 16.0))),
                         16), 2048))


def compute_bbox(positions: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Masked integer bounding box (min, max), each int32[3].

    Mirrors the scan at tmc3/TMC3.cpp:58-68 (init max=int32 max,
    min=int32 lowest).
    """
    imax = jnp.int32(np.iinfo(np.int32).max)
    imin = jnp.int32(np.iinfo(np.int32).min)
    m = mask[:, None]
    lo = jnp.min(jnp.where(m, positions, imax), axis=0)
    hi = jnp.max(jnp.where(m, positions, imin), axis=0)
    return lo, hi


def shift_to_origin(
    positions: jax.Array, mask: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Translate so bbox min is the origin (tmc3/TMC3.cpp:70-72).

    Returns (shifted_positions, bbox_min, bbox_max) — the bbox of the
    ORIGINAL cloud, as the reference keeps it for raster sizing
    (tmc3/TMC3.cpp:75-77).  Padded rows are left untouched.
    """
    lo, hi = compute_bbox(positions, mask)
    shifted = jnp.where(mask[:, None], positions - lo[None, :], positions)
    return shifted, lo, hi
