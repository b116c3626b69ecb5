"""Per-point normal and curvature estimation — covariance PCA on device.

Data-parallel replacement for Open3D's ``EstimateNormals(
KDTreeSearchParamHybrid(radius=100, max_nn=50))`` +
``OrientNormalsToAlignWithDirection(+Z)`` (tmc3/my_function.h:63-64).

Open3D's hybrid neighborhood is "the max_nn nearest neighbors, keeping
only those within radius"; we reproduce it from an already-built kNN
graph (k ≥ max_nn) by masking slots whose distance exceeds the radius.
The neighborhood covariance's smallest eigenvector is the normal — an
embarrassingly parallel batch of 3×3 symmetric eigenproblems, solved in
closed form (trigonometric eigenvalues + cross-product eigenvectors)
elementwise: no iteration, no data-dependent control flow.

Curvature is the standard surface-variation score λ0/(λ0+λ1+λ2), used
by the segmentation stage to gate seeds.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "estimate_normals",
    "estimate_normals_window",
    "eigh3x3_smallest",
    "canonicalize_normals",
]


@functools.partial(
    jax.jit, static_argnames=("window", "radius", "orient_z", "impl")
)
def estimate_normals_window(
    spos: jax.Array,
    smask: jax.Array,
    *,
    radius: float = 100.0,
    window: int = 64,
    orient_z: bool = True,
    impl: str = None,
):
    """Normals + curvature from radius-masked Morton-window moments.

    The gather-free fast path for Morton-sorted clouds: instead of
    gathering the kNN neighborhood per point, accumulate the first and
    second moments of all window candidates within ``radius`` via 2W+1
    contiguous shifted slices — streaming reads + elementwise FMAs.
    The neighborhood is
    "window ∩ radius ball" rather than Open3D's "50 nearest ∩ radius"
    (tmc3/my_function.h:63); on dense scans the radius cap dominates
    both, and the resulting covariances agree to noise level.

    Args:
        spos: float32[N, 3] Morton-sorted positions.
        smask: bool[N].
        radius: neighborhood radius (same units as positions).
        impl: ``"triton"`` (the stats kernel in radius-only mode: no
            order statistics, no bisection, one pass) or ``"xla"`` (the
            shifted-slice form below); None asks
            :func:`ops.stats_sweep.stats_impl`.

    Returns:
        (normals float32[N, 3] unit, +Z oriented; curvature float32[N]).
    """
    n = spos.shape[0]
    w = window

    from buildingsegment_tpu.ops.fused import finish_normals
    from buildingsegment_tpu.ops.stats_sweep import (
        stats_impl, stats_sweep_triton,
    )

    if stats_impl(impl) == "triton":
        _, s0, s1, s2 = stats_sweep_triton(
            spos, smask, k=1, window=w, radius=float(radius),
        )
        return finish_normals(s0, s1, s2, orient_z=orient_z)

    pad_val = jnp.float32(-3e7)
    ppos = jnp.concatenate(
        [
            jnp.full((w, 3), pad_val, jnp.float32),
            spos.astype(jnp.float32),
            jnp.full((w, 3), pad_val, jnp.float32),
        ]
    )
    pmask = jnp.concatenate([jnp.zeros(w, bool), smask, jnp.zeros(w, bool)])
    base = spos.astype(jnp.float32)
    r2 = jnp.float32(radius) * jnp.float32(radius)

    # fully unrolled static slices (fori+dynamic_slice is kernel-launch
    # bound — see ops/fused.py sweep comment); 2w+1 offsets incl. self
    s0 = jnp.zeros((n,), jnp.float32)
    s1 = jnp.zeros((n, 3), jnp.float32)
    s2 = jnp.zeros((n, 6), jnp.float32)
    for slot in range(2 * w + 1):
        cand = lax.slice(ppos, (slot, 0), (slot + n, 3))
        cmask = lax.slice(pmask, (slot,), (slot + n,))
        d = cand - base  # centered on the query point
        dist2 = jnp.sum(d * d, axis=-1)
        use = cmask & smask & (dist2 <= r2)
        uw = use.astype(jnp.float32)
        s0 = s0 + uw
        s1 = s1 + d * uw[:, None]
        # symmetric second moment, 6 unique entries
        s2 = s2 + jnp.stack(
            [
                d[:, 0] * d[:, 0],
                d[:, 1] * d[:, 1],
                d[:, 2] * d[:, 2],
                d[:, 0] * d[:, 1],
                d[:, 0] * d[:, 2],
                d[:, 1] * d[:, 2],
            ],
            axis=-1,
        ) * uw[:, None]

    safe = jnp.maximum(s0, 1.0)
    mean = s1 / safe[:, None]
    m = s2 / safe[:, None]
    cov = jnp.empty((n, 3, 3), jnp.float32)
    c00 = m[:, 0] - mean[:, 0] * mean[:, 0]
    c11 = m[:, 1] - mean[:, 1] * mean[:, 1]
    c22 = m[:, 2] - mean[:, 2] * mean[:, 2]
    c01 = m[:, 3] - mean[:, 0] * mean[:, 1]
    c02 = m[:, 4] - mean[:, 0] * mean[:, 2]
    c12 = m[:, 5] - mean[:, 1] * mean[:, 2]
    cov = jnp.stack(
        [
            jnp.stack([c00, c01, c02], -1),
            jnp.stack([c01, c11, c12], -1),
            jnp.stack([c02, c12, c22], -1),
        ],
        axis=-2,
    )
    v, eigvals = eigh3x3_smallest(cov)
    z = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where((s0 < 3.0)[:, None], z, v)
    if orient_z:
        v = jnp.where((v[..., 2] < 0.0)[..., None], -v, v)
    total = jnp.sum(eigvals, axis=-1)
    curvature = jnp.where(
        total > 0, eigvals[..., 0] / jnp.where(total > 0, total, 1.0), 0.0
    )
    curvature = jnp.where(s0 < 3.0, 0.0, curvature)
    return v, curvature


def canonicalize_normals(normals: jax.Array) -> jax.Array:
    """Flip each normal into a deterministic hemisphere.

    Sign convention: the component of largest magnitude (ties broken
    z > y > x) is made non-negative.  Nearby points on the same plane
    get consistent signs regardless of how the estimator's ±Z
    orientation landed — vertical walls are where
    ``OrientNormalsToAlignWithDirection(+Z)`` (tmc3/my_function.h:64)
    assigns random signs (n_z ≈ ±noise), which breaks signed normal
    averaging and signed cos thresholds.
    """
    # priority z > y > x on exact ties.  Elementwise select chain — 3
    # compares instead of argmax + take_along_axis (a per-row gather);
    # semantics identical to argmax's first-max-index tie rule on the
    # biased keys.
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    keyx = jnp.abs(nx)
    keyy = jnp.abs(ny) + jnp.asarray(1e-7, normals.dtype)
    keyz = jnp.abs(nz) + jnp.asarray(2e-7, normals.dtype)
    dom = jnp.where(
        keyx >= jnp.maximum(keyy, keyz),
        nx,
        jnp.where(keyy >= keyz, ny, nz),
    )
    sign = jnp.sign(dom)
    sign = jnp.where(sign == 0, 1.0, sign)
    return normals * sign[..., None]


def eigh3x3_smallest(cov: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Smallest eigenvector + all eigenvalues of symmetric 3×3 batches.

    Args:
        cov: float32[..., 3, 3] symmetric.

    Returns:
        (v float32[..., 3] unit eigenvector of the smallest eigenvalue,
         eigvals float32[..., 3] ascending).

    Closed-form: eigenvalues via the trigonometric solution of the
    characteristic cubic; eigenvector via the largest cross product of
    rows of (A − λI), which is robust to one-dimensional null spaces.
    Degenerate (isotropic / zero) neighborhoods return v = (0, 0, 1).
    """
    a00 = cov[..., 0, 0]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a11 = cov[..., 1, 1]
    a12 = cov[..., 1, 2]
    a22 = cov[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    safe_p = jnp.where(p > 0, p, 1.0)

    # det(B) / 2 where B = (A - qI) / p
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detb / (2.0 * safe_p**3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    lam_hi = q + 2.0 * p * jnp.cos(phi)
    lam_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    eigvals = jnp.stack([lam_lo, lam_mid, lam_hi], axis=-1)

    # rows of (A - lam_lo I)
    r0 = jnp.stack([a00 - lam_lo, a01, a02], axis=-1)
    r1 = jnp.stack([a01, a11 - lam_lo, a12], axis=-1)
    r2 = jnp.stack([a02, a12, a22 - lam_lo], axis=-1)
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where(
        (n01 >= n02)[..., None] & (n01 >= n12)[..., None],
        c01,
        jnp.where((n02 >= n12)[..., None], c02, c12),
    )
    best_norm = jnp.sqrt(jnp.maximum(jnp.sum(best * best, axis=-1), 0.0))

    # Degenerate: isotropic (p≈0) or null cross products → +Z like
    # Open3D's fallback for unestimable normals.
    scale = jnp.maximum(jnp.abs(q), 1.0)
    degenerate = (p <= 1e-7 * scale) | (best_norm <= 1e-12)
    z = jnp.zeros_like(best).at[..., 2].set(1.0)
    v = jnp.where(
        degenerate[..., None],
        z,
        best / jnp.where(degenerate, 1.0, best_norm)[..., None],
    )
    return v, eigvals


@functools.partial(jax.jit, static_argnames=("max_nn",))
def estimate_normals(
    positions: jax.Array,
    mask: jax.Array,
    neigh_idx: jax.Array,
    neigh_sq_dist: jax.Array,
    *,
    radius: float = 100.0,
    max_nn: int = 50,
    orient_z: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Estimate unit normals + curvature from a kNN graph.

    Args:
        positions: int/float [N, 3].
        mask: bool[N].
        neigh_idx: int32[N, K] with self at slot 0 (K ≥ max_nn ideally).
        neigh_sq_dist: float32[N, K] squared distances.
        radius: hybrid-neighborhood radius (same units as positions).
        max_nn: cap on neighbors used (slots ≥ max_nn ignored).
        orient_z: flip normals so n·(0,0,1) ≥ 0
            (tmc3/my_function.h:64).

    Returns:
        (normals float32[N, 3], curvature float32[N] = λ0/Σλ).
    """
    n, k = neigh_idx.shape
    pos = positions.astype(jnp.float32)

    use = neigh_sq_dist <= jnp.float32(radius) * jnp.float32(radius)
    if max_nn < k:
        slot = jax.lax.broadcasted_iota(jnp.int32, (n, k), 1)
        use = use & (slot < max_nn)
    use = use & mask[neigh_idx] & mask[:, None]
    w = use.astype(jnp.float32)
    cnt = jnp.sum(w, axis=1)
    safe_cnt = jnp.maximum(cnt, 1.0)

    nb = pos[neigh_idx]  # [N, K, 3]
    # center on the query point first: keeps moments small in float32
    nb = (nb - pos[:, None, :]) * w[:, :, None]
    mean = jnp.sum(nb, axis=1) / safe_cnt[:, None]
    # covariance = E[p pᵀ] − mean meanᵀ (over the centered coords)
    sec = jnp.einsum(
        "nkd,nke->nde", nb, nb * w[:, :, None],
        precision=lax.Precision.HIGHEST,
    ) / safe_cnt[:, None, None]
    cov = sec - mean[:, None, :] * mean[:, :, None]

    v, eigvals = eigh3x3_smallest(cov)

    # fewer than 3 usable neighbors → plane undefined → +Z
    z = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where((cnt < 3.0)[:, None], z, v)

    if orient_z:
        v = jnp.where((v[..., 2] < 0.0)[..., None], -v, v)

    total = jnp.sum(eigvals, axis=-1)
    curvature = jnp.where(
        total > 0, eigvals[..., 0] / jnp.where(total > 0, total, 1.0), 0.0
    )
    curvature = jnp.where(cnt < 3.0, 0.0, curvature)
    return v, curvature
