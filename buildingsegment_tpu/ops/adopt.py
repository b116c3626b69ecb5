"""Hole fill of the multigrid finalize: adjacency-free plane adoption.

An unlabeled point ("hole") tests itself directly against the K
largest merged planes of the finalize table: plane band |p·n − b| ≤ th,
normal agreement, and in-plane proximity to the plane's extent
(reach² per plane).  It adopts the accepting plane with the smallest
|p·n − b| (first lane on ties), and its payload row is added to that
plane's sums.  Every test is an ``[N, K]`` product at
``Precision.HIGHEST``: the mm-scale expansion |p|² − 2p·c + |c|² cancels
catastrophically at lower precision (TF32 would drop ~10 mantissa bits).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from buildingsegment_tpu.ops.segsum import plane_sums

__all__ = ["plane_adopt"]


def plane_adopt(payload, holes, nk, ck, bk, ccdk, reach2, lane_ok, rows,
                *, table_cap, th_thickness, th_cos, signed=False):
    """Adopt holes into the K candidate planes.

    Args:
        payload: f32[n, 8] rows [1, n̂ (canonical normal), p, |p|²].
        holes: bool[n] rows allowed to adopt.
        nk, ck: f32[K, 3] unit normals and centers of the candidates.
        bk, ccdk: f32[K] plane offsets n·c and |c|².
        reach2: f32[K] squared in-plane reach of each candidate.
        lane_ok: f32[K] > 0 where the candidate may adopt at all.
        rows: int32[K] table row of each candidate.
        table_cap: rows of the returned sums table.

    Returns (adopted bool[n], adopt_row int32[n] — the chosen
    candidate's table row, meaningful where adopted — and the adopted
    rows' payload sums f32[table_cap, 8] by table row).
    """
    hi = lax.Precision.HIGHEST
    cmag = (lambda x: x) if signed else jnp.abs
    cn, pos, sq = payload[:, 1:4], payload[:, 4:7], payload[:, 7:8]
    offk = jnp.dot(pos, nk.T, preferred_element_type=jnp.float32,
                   precision=hi) - bk[None, :]
    cosk = cmag(jnp.dot(cn, nk.T, preferred_element_type=jnp.float32,
                        precision=hi))
    d2k = sq + ccdk[None, :] - 2.0 * jnp.dot(
        pos, ck.T, preferred_element_type=jnp.float32, precision=hi
    )
    inpl2 = jnp.maximum(d2k - offk * offk, 0.0)
    okk = (
        (jnp.abs(offk) <= th_thickness)
        & (cosk >= th_cos)
        & (inpl2 <= reach2[None, :])
        & (lane_ok > 0)[None, :]
        & holes[:, None]
    )
    arg = jnp.argmin(jnp.where(okk, jnp.abs(offk), jnp.inf), axis=1)
    adopted = jnp.any(okk, axis=1)
    adopt_row = rows.astype(jnp.int32)[arg]  # a K-entry table lookup
    acc = plane_sums(
        jnp.where(adopted, adopt_row, table_cap), payload, table_cap,
        table_cap=table_cap,
    )
    return adopted, adopt_row, acc
