"""Stats-only window sweep: k-th-NN distance + normal moments, no top-k.

The windowized pipeline never consumes sorted kNN index lists:
segmentation needs only

  (a) the squared k-th-NN distance per point — the seed ball of the
      depth-0 strictness rule (tmc3/my_function.cpp:238 re-expressed in
      ``seg.region_grow.window_seeds``), and
  (b) the Open3D-hybrid moment cap — the distance of the ``max_nn``-th
      nearest candidate, which truncates the normal-estimation
      neighborhood (tmc3/my_function.h:63,
      KDTreeSearchParamHybrid(radius=100, max_nn=50)).

Both are ORDER STATISTICS of the ±W candidate distance row.  The XLA
form (:func:`ops.fused.knn_normals_window_sorted`) ranks every row with
``lax.top_k`` and keeps one column.  The GPU kernel here (Pallas through
Triton) finds the two order statistics without sorting: one program
owns ``block_rows`` consecutive sorted rows, gathers their
``[block_rows, 2W]`` candidate tile (padded to a power of two), and
runs a 31-step bisection on the float32 bit patterns — non-negative
floats order exactly like their int32 bit patterns — for the
rank-(k−1) and rank-(max_nn−1) values at once.  The radius ∩ cap
masked moments are accumulated from the same tile, so no ``[N, 2W]``
array ever reaches device memory.  Distances stay in diff form on the
CUDA cores (no tensor cores): exact, like the XLA form.

Exactness: the bisection returns the exact bit pattern of the r-th
smallest entry (the smallest t with count(d ≤ t) ≥ r), i.e. exactly
``lax.top_k``'s value; ties are immaterial because only the VALUE is
consumed.  Fewer than r finite candidates → +inf, mapped to the XLA
conventions (k-th distance → 0.0, cap → no-op).  The moment sums are
the same terms added in another order, so normals and curvature agree
to float32 rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from buildingsegment_tpu.ops.fused import (
    finish_normals,
    knn_normals_window_sorted,
)
from buildingsegment_tpu.utils.platform import op_impl

__all__ = ["knn_normals_window_stats", "stats_impl", "stats_sweep_triton"]

_INF_BITS = 0x7F800000
_FAR = -3e7  # sentinel coordinate of padding rows (mask 0 as well)
_N_OUT = 11  # dk, s0, s1 (3), s2 (6)


def stats_impl(impl: str = None) -> str:
    """The stats sweep's implementation, ``"triton"`` or ``"xla"``:
    ``impl`` when given, else :func:`utils.platform.op_impl`'s choice.
    Every caller with a Triton and an XLA route resolves it here."""
    if impl is None:
        impl = op_impl("stats_sweep")
    if impl not in ("triton", "xla"):
        raise ValueError(f"unknown stats sweep implementation {impl!r}")
    return impl


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _stats_kernel(x_ref, y_ref, z_ref, m_ref, *out_refs, block_rows, cw,
                  w, r_k, r_cap, r2):
    """One program: rows [i·B, (i+1)·B) of the sorted cloud.

    The refs are the padded component rows (``w`` fill rows in front);
    candidate column c ∈ [0, 2w) is offset c − w (c < w) or c − w + 1
    (c ≥ w), so the self row is never a candidate, and columns ≥ 2w are
    the power-of-two padding of the tile.
    """
    base = pl.program_id(0) * block_rows
    shape = (block_rows, cw)
    q = lax.broadcasted_iota(jnp.int32, shape, 0)
    c = lax.broadcasted_iota(jnp.int32, shape, 1)
    cidx = base + q + c + (c >= w).astype(jnp.int32)
    qsl = pl.ds(base + w, block_rows)
    qx, qy, qz, qm = x_ref[qsl], y_ref[qsl], z_ref[qsl], m_ref[qsl]

    def offsets():
        return (x_ref[cidx] - qx[:, None], y_ref[cidx] - qy[:, None],
                z_ref[cidx] - qz[:, None])

    dx, dy, dz = offsets()
    valid = (c < 2 * w) & (m_ref[cidx] > 0.5) & (qm[:, None] > 0.5)
    d2 = jnp.where(valid, dx * dx + dy * dy + dz * dz, jnp.inf)

    if r_k or r_cap:
        bits = lax.bitcast_convert_type(d2, jnp.int32)

        def step(lo, hi, r):
            mid = lo + ((hi - lo) >> 1)
            cnt = jnp.sum((bits <= mid[:, None]).astype(jnp.int32), axis=1)
            ge = cnt >= r
            return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

        def bisect(_, st):
            lo1, hi1, lo2, hi2 = st
            lo1, hi1 = step(lo1, hi1, r_k)
            if r_cap:
                lo2, hi2 = step(lo2, hi2, r_cap)
            return lo1, hi1, lo2, hi2

        zeros = jnp.zeros((block_rows,), jnp.int32)
        tops = jnp.full((block_rows,), _INF_BITS, jnp.int32)
        dk_bits, _, cap_bits, _ = lax.fori_loop(
            0, 31, bisect, (zeros, tops, zeros, tops)
        )
        dk = lax.bitcast_convert_type(dk_bits, jnp.float32)
        dk = jnp.where(dk_bits >= _INF_BITS, 0.0, dk)
        r_eff2 = jnp.float32(r2)
        if r_cap:
            r_eff2 = jnp.minimum(
                r_eff2, lax.bitcast_convert_type(cap_bits, jnp.float32)
            )
    else:
        # radius-only moments (estimate_normals_window): no order
        # statistics, the bisection is skipped entirely
        dk = jnp.zeros((block_rows,), jnp.float32)
        r_eff2 = jnp.float32(r2)

    # invalid candidates carry +inf and fail the finite radius/cap test
    uw = jnp.where(d2 <= jnp.broadcast_to(r_eff2, (block_rows,))[:, None],
                   1.0, 0.0)
    wx, wy, wz = dx * uw, dy * uw, dz * uw
    sums = (
        dk,
        qm + jnp.sum(uw, axis=1),  # self: weight 1, offset 0
        jnp.sum(wx, axis=1), jnp.sum(wy, axis=1), jnp.sum(wz, axis=1),
        jnp.sum(wx * dx, axis=1), jnp.sum(wy * dy, axis=1),
        jnp.sum(wz * dz, axis=1), jnp.sum(wx * dy, axis=1),
        jnp.sum(wx * dz, axis=1), jnp.sum(wy * dz, axis=1),
    )
    for ref, val in zip(out_refs, sums):
        ref[...] = val


def _padded_rows(spos, smask, w, tail, axis_name):
    """Component rows with ``w`` leading fill rows and ``tail`` trailing
    ones; under ``shard_map`` the ±w rows next to the shard come from
    the halo exchange instead of fill."""
    cols = [spos[:, 0], spos[:, 1], spos[:, 2], smask.astype(jnp.float32)]
    fills = [_FAR, _FAR, _FAR, 0.0]
    if axis_name is not None:
        from buildingsegment_tpu.dist.halo import halo_pad

        return [
            jnp.concatenate([halo_pad(a, w, axis_name),
                             jnp.full((tail - w,), f, jnp.float32)])
            for a, f in zip(cols, fills)
        ]
    return [
        jnp.concatenate([jnp.full((w,), f, jnp.float32), a,
                         jnp.full((tail,), f, jnp.float32)])
        for a, f in zip(cols, fills)
    ]


@functools.partial(
    jax.jit,
    static_argnames=("k", "window", "radius", "max_nn", "axis_name",
                     "block_rows", "num_warps", "interpret"),
)
def stats_sweep_triton(
    spos, smask, *, k, window, radius, max_nn=None, axis_name=None,
    block_rows=32, num_warps=4, interpret=False,
):
    """The Triton stats kernel on Morton-sorted rows.

    Returns (kth_sq_dist f32[n], s0 f32[n], s1 f32[n, 3], s2 f32[n, 6]):
    ``kth_sq_dist`` is 0.0 where fewer than k−1 candidates exist; the
    moments are about each point itself, s2 columns (xx, yy, zz, xy,
    xz, yz) — the accumulation of ops/fused.py's sweep.
    """
    n = spos.shape[0]
    w = window
    if 2 * w < k - 1:
        raise ValueError(f"window {w} too small for k={k}")
    cw = _pow2_at_least(2 * w)
    n_pad = -(-n // block_rows) * block_rows
    # the last program reads padded rows up to n_pad - 1 + cw
    rows = _padded_rows(
        spos.astype(jnp.float32), smask, w, n_pad - n + cw, axis_name
    )
    cap_active = max_nn is not None and (max_nn - 1) < 2 * w
    kernel = functools.partial(
        _stats_kernel, block_rows=block_rows, cw=cw, w=w, r_k=k - 1,
        r_cap=(max_nn - 1) if cap_active else 0,
        r2=float(radius) * float(radius),
    )
    out = pl.pallas_call(
        kernel,
        grid=(n_pad // block_rows,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 4,
        out_specs=[pl.BlockSpec((block_rows,), lambda i: (i,))] * _N_OUT,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * _N_OUT,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="stats_sweep",
    )(*rows)
    out = [o[:n] for o in out]
    return out[0], out[1], jnp.stack(out[2:5], 1), jnp.stack(out[5:11], 1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "window", "radius", "max_nn", "orient_z",
                     "axis_name", "impl", "interpret"),
)
def knn_normals_window_stats(
    spos: jax.Array,
    smask: jax.Array,
    k: int,
    *,
    window: int = 64,
    radius: float = 100.0,
    orient_z: bool = True,
    axis_name: str = None,
    max_nn: int = None,
    impl: str = None,
    interpret: bool = False,
):
    """Stats-only sweep → (kth_sq_dist, normals, curvature).

    ``kth_sq_dist[i]`` equals :func:`ops.fused.knn_normals_window_sorted`'s
    ``neigh_sq_dist[i, k-1]`` and normals/curvature match its outputs.
    ``impl`` is ``"triton"`` (the GPU kernel) or ``"xla"`` (the fused
    XLA op); None asks :func:`stats_impl`.
    """
    if stats_impl(impl) == "xla":
        _, nb_d, normals, curv = knn_normals_window_sorted(
            spos, smask, k, window=window, radius=radius,
            orient_z=orient_z, axis_name=axis_name, max_nn=max_nn,
        )
        return nb_d[:, k - 1], normals, curv
    dk, s0, s1, s2 = stats_sweep_triton(
        spos, smask, k=k, window=window, radius=radius, max_nn=max_nn,
        axis_name=axis_name, interpret=interpret,
    )
    normals, curvature = finish_normals(s0, s1, s2, orient_z=orient_z)
    # masked points: mirror the fused op (zero ball, +Z normal)
    dk = jnp.where(smask, dk, 0.0)
    return dk, normals, curvature
