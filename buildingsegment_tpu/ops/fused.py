"""Fused window sweep: kNN distances + normal moments in one pass.

The window kNN and the window-moment normal estimation sweep the same
±W contiguous slices of the Morton-sorted cloud; running them
separately reads every slice twice.  This op accumulates both in one
loop: per offset it computes the candidate distance row (for the top-k
ranking) AND the radius-masked first/second moments (for the
covariance normals), then finishes with one ``top_k`` and the
closed-form eigensolve.

Numerically identical to running :func:`knn_window_sorted` and
:func:`estimate_normals_window` separately with the same window.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from buildingsegment_tpu.ops.normals import eigh3x3_smallest

__all__ = ["knn_normals_window_sorted", "finish_normals"]

_INF = float("inf")  # plain float: a device constant here would force backend init at import


def finish_normals(s0, s1, s2, *, orient_z=True):
    """Moment sums → (unit normals, curvature).

    s0 f32[N] neighborhood count (incl. self), s1 f32[N, 3] offset sum,
    s2 f32[N, 6] second moments (xx, yy, zz, xy, xz, yz) about the
    point.  The covariance eigensolve half of the fused sweep, shared
    with the Pallas stats sweep (ops/stats_sweep.py).
    """
    safe = jnp.maximum(s0, 1.0)
    mean = s1 / safe[:, None]
    m = s2 / safe[:, None]
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


@functools.partial(
    jax.jit,
    static_argnames=("k", "window", "axis_name", "max_nn", "orient_z"),
)
def knn_normals_window_sorted(
    spos: jax.Array,
    smask: jax.Array,
    k: int,
    *,
    window: int = 64,
    radius: float = 100.0,
    orient_z: bool = True,
    axis_name: str = None,
    max_nn: int = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One fused sweep → (neigh_idx, neigh_sq_dist, normals, curvature).

    Args:
        spos: float32[N, 3] Morton-sorted positions.
        smask: bool[N].
        k: neighbors INCLUDING self at slot 0 (2·window ≥ k−1).
        window: half-width of the candidate window.
        radius: normal-estimation neighborhood radius.
        axis_name: when running inside ``shard_map`` over Morton-range
            shards, the mesh axis — window padding comes from a
            ppermute halo exchange instead of constant sentinels, and
            neighbor indices are returned in the GLOBAL sorted frame.
        max_nn: Open3D-hybrid cap — normal moments use the ``max_nn``
            nearest candidates (incl. self) within ``radius``, not all
            in-radius candidates (tmc3/my_function.h:63:
            KDTreeSearchParamHybrid(radius=100, max_nn=50)).  None (or a
            cap wider than the window) keeps the all-in-radius behavior.

    Returns sorted-frame neighbor indices/distances (slot 0 = self) and
    unit normals (+Z oriented) with curvature.
    """
    n = spos.shape[0]
    if 2 * window < k - 1:
        raise ValueError(f"window {window} too small for k={k}")
    w2 = 2 * window

    if axis_name is not None:
        from buildingsegment_tpu.dist.halo import halo_pad

        ppos = halo_pad(spos.astype(jnp.float32), window, axis_name)
        pmask = halo_pad(smask, window, axis_name)
        row_base = lax.axis_index(axis_name).astype(jnp.int32) * n
    else:
        pad_val = jnp.float32(-3e7)
        ppos = jnp.concatenate(
            [
                jnp.full((window, 3), pad_val, jnp.float32),
                spos.astype(jnp.float32),
                jnp.full((window, 3), pad_val, jnp.float32),
            ]
        )
        pmask = jnp.concatenate(
            [jnp.zeros(window, bool), smask, jnp.zeros(window, bool)]
        )
        row_base = jnp.int32(0)
    r2 = jnp.float32(radius) * jnp.float32(radius)
    # the Open3D-hybrid cap binds only when it is tighter than the
    # window itself (max_nn includes self; the window candidates don't)
    cap_active = max_nn is not None and (max_nn - 1) < w2
    kk = max(k - 1, max_nn - 1) if cap_active else k - 1

    # Point-tiled sweep: process T rows at a time so the [2W, T]
    # distance block, its top_k, the hybrid cap and the moment
    # accumulation all stay tile-resident — the [2W, N] block is never
    # materialized in HBM (at 1M points it alone is 0.5 GB, and the
    # XLA layouts of its skinny row updates padded it 128×: OOM).
    # Within a tile the offset loop is FULLY unrolled with STATIC
    # slices: a fori_loop + dynamic_slice version pays a thunk launch
    # and a slice copy per offset (kernel-launch-bound).
    tile = min(n, 32768)
    while n % tile:
        tile //= 2
    ntiles = n // tile

    def tile_fn(ti):
        s = ti * tile  # padded arrays lead with `window` halo rows
        tpos = lax.dynamic_slice(ppos, (s, 0), (tile + w2, 3))
        tmask = lax.dynamic_slice(pmask, (s,), (tile + w2,))
        tbase = lax.slice(tpos, (window, 0), (window + tile, 3))
        tsmask = lax.slice(tmask, (window,), (window + tile,))

        def offset_rows():
            # 1-D concat then reshape: jnp.stack of [T] rows would go
            # through [1, T] intermediates, which some layouts pad along
            # the unit dimension; 1-D concatenation is layout-safe
            rows = []
            for slot in range(w2):
                start = slot if slot < window else slot + 1
                cand = lax.slice(tpos, (start, 0), (start + tile, 3))
                cmask = lax.slice(tmask, (start,), (start + tile,))
                diff = cand - tbase
                d = jnp.sum(diff * diff, axis=-1)
                rows.append(jnp.where(cmask & tsmask, d, _INF))
            return jnp.concatenate(rows).reshape(w2, tile)

        d_block = offset_rows()
        neg_all, arg_all = lax.top_k(-d_block.T, kk)
        if cap_active:
            # hybrid cap: the (max_nn-1)-th nearest other (inf when
            # fewer candidates exist)
            r_eff2 = jnp.minimum(r2, -neg_all[:, max_nn - 2])
        else:
            r_eff2 = r2

        # moment pass over the same tile-resident slices
        s0 = tsmask.astype(jnp.float32)  # self: weight 1, distance 0
        s1 = jnp.zeros((tile, 3), jnp.float32)
        s2 = jnp.zeros((tile, 6), jnp.float32)
        for slot in range(w2):
            start = slot if slot < window else slot + 1
            cand = lax.slice(tpos, (start, 0), (start + tile, 3))
            cmask = lax.slice(tmask, (start,), (start + tile,))
            diff = cand - tbase
            d = jnp.sum(diff * diff, axis=-1)
            use = cmask & tsmask & (d <= r_eff2)
            uw = use.astype(jnp.float32)
            s0 = s0 + uw
            s1 = s1 + diff * uw[:, None]
            s2 = s2 + jnp.stack(
                [
                    diff[:, 0] * diff[:, 0],
                    diff[:, 1] * diff[:, 1],
                    diff[:, 2] * diff[:, 2],
                    diff[:, 0] * diff[:, 1],
                    diff[:, 0] * diff[:, 2],
                    diff[:, 1] * diff[:, 2],
                ],
                axis=-1,
            ) * uw[:, None]
        return neg_all[:, : k - 1], arg_all[:, : k - 1], s0, s1, s2

    neg_top, arg, s0, s1, s2 = lax.map(tile_fn, jnp.arange(ntiles))
    neg_top = neg_top.reshape(n, k - 1)
    arg = arg.reshape(n, k - 1)
    s0 = s0.reshape(n)
    s1 = s1.reshape(n, 3)
    s2 = s2.reshape(n, 6)

    # ---- kNN finish (identical to knn_window_sorted) ----
    nb_d = -neg_top
    off = jnp.where(arg < window, arg - window, arg - window + 1)
    rows = lax.broadcasted_iota(jnp.int32, (n, 1), 0) + row_base
    nb_i = rows + off
    invalid = jnp.isinf(nb_d)
    nb_i = jnp.where(invalid, rows, nb_i)
    nb_d = jnp.where(invalid, 0.0, nb_d)
    nb_i = jnp.concatenate([rows, nb_i], axis=1)
    nb_d = jnp.concatenate([jnp.zeros((n, 1), jnp.float32), nb_d], axis=1)
    nb_i = jnp.where(smask[:, None], nb_i, rows)
    nb_d = jnp.where(smask[:, None], nb_d, 0.0)

    # ---- normals finish (identical to estimate_normals_window) ----
    v, curvature = finish_normals(s0, s1, s2, orient_z=orient_z)
    return nb_i, nb_d, v, curvature
