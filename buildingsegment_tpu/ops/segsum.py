"""Segment reductions and lookups over a SMALL id table (plain XLA).

The finalize of the multigrid solver (``seg/coarse.py``) and the ortho
ground histogram (``raster/ortho.py``) reduce N rows into a table of a
few thousand ids, and read per-id values back.  On the GPU a
scatter-add into such a table is an atomic add per row, and a lookup is
a gather from a table that stays in cache; both are single XLA ops.
Float sums arrive in a different order from run to run on the GPU
(atomics), so callers compare float table entries with a tolerance and
integer-valued columns (counts below 2^24) exactly.

Ids outside ``[0, min(n_live, table_cap))`` are dropped (sums) or read
as 0.0 (lookups).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "plane_sums", "plane_payload_moment_sums", "table_lookup",
    "table_lookup_cols",
]


def _live_ids(ids, n_live, cap):
    """ids with every id outside [0, min(n_live, cap)) mapped to cap."""
    bound = jnp.minimum(jnp.asarray(n_live, jnp.int32), cap)
    return jnp.where((ids >= 0) & (ids < bound), ids, cap)


def plane_sums(ids, payload, n_live, *, table_cap):
    """Segment-sum ``payload`` rows by integer id.

    Args:
        ids: int32[n].
        payload: f32[n, cols].
        n_live: int32 scalar (may be traced) — ids ≥ n_live are dropped.
        table_cap: static table size.

    Returns f32[table_cap, cols]; row t = Σ over rows with ids == t.
    """
    rows = _live_ids(ids, n_live, table_cap)
    return (
        jnp.zeros((table_cap + 1, payload.shape[1]), jnp.float32)
        .at[rows]
        .add(payload.astype(jnp.float32))
    )[:table_cap]


def plane_payload_moment_sums(ids, payload, q, n_live, *, table_cap):
    """Payload sums AND second moments about per-id reference centers.

    Args:
        ids: int32[n]; ids ≥ n_live are dropped.
        payload: f32[n, 8] rows [cnt, n̂, p, |p|²] (p in cols 4:7).
        q: f32[table_cap, 3] per-id reference centers.

    Returns (sums f32[table_cap, 8], moments f32[table_cap, 6]), moment
    columns (xx, yy, zz, xy, xz, yz) of p − q[id].  Centering about a
    per-id center keeps the f32 sums of mm-scale coordinates from
    cancelling; a parallel-axis shift moves them to any other center.
    """
    rows = _live_ids(ids, n_live, table_cap)
    qp = jnp.concatenate([q.astype(jnp.float32),
                          jnp.zeros((1, 3), jnp.float32)])
    d = payload[:, 4:7].astype(jnp.float32) - qp[rows]
    mom = jnp.stack(
        [d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
         d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], axis=1
    )
    return (plane_sums(rows, payload, table_cap, table_cap=table_cap),
            plane_sums(rows, mom, table_cap, table_cap=table_cap))


def table_lookup(ids, lut, n_live):
    """``lut[ids]`` as f32[n]; ids outside [0, n_live) read 0.0."""
    cap = lut.shape[0]
    rows = _live_ids(ids, n_live, cap)
    return jnp.concatenate(
        [lut.astype(jnp.float32), jnp.zeros((1,), jnp.float32)]
    )[rows]


def table_lookup_cols(ids, lut, n_live):
    """``lut[ids, :]`` for a multi-column table, returned COLUMN-major
    as f32[cols, n]; ids outside [0, n_live) read 0.0."""
    cap, cols = lut.shape
    rows = _live_ids(ids, n_live, cap)
    padded = jnp.concatenate(
        [lut.astype(jnp.float32), jnp.zeros((1, cols), jnp.float32)]
    )
    return padded[rows].T
