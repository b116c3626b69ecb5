"""Halo exchange for Morton-range point shards (SURVEY.md §2.5).

The cloud is Morton-sorted globally and sharded into contiguous ranges
over the 1-D ``points`` mesh axis, so every windowized op (±W slice
sweeps for kNN, normal moments, label propagation) only ever needs the
last/first W rows of the ring neighbors — exchanged here with
``lax.ppermute`` between neighbouring devices.  This is the point-cloud
analog of context-
parallel halo exchange; the reference has no equivalent (it is a
single-thread CPU binary, tmc3/TMC3.cpp:202-229).

All helpers run INSIDE ``jax.shard_map`` (they issue collectives over
``axis_name``).  Outermost shards receive zero-filled halos; callers
gate halo rows with the exchanged mask, exactly like the single-device
code gates its constant sentinel padding.

When the halo width exceeds the local shard extent (small coarse
multigrid levels: e.g. 4096 points / 8 shards / two 8× coarsenings →
8 rows per shard against window 16), the exchange walks the ring for
``ceil(w/S)`` hops so each side still returns EXACTLY ``w`` rows —
a single-hop version silently returned short halos and the static
window slices then walked off the padded array (tests/test_dist.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_pad", "ring_halo"]


def _tail(x: jax.Array, w: int, axis: int) -> jax.Array:
    """Last ``w`` rows along ``axis``, zero-padded on the far side if
    the array is shorter than ``w`` (window wider than the whole ring's
    content — degenerate but must stay shape-stable)."""
    s = x.shape[axis]
    if s >= w:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(s - w, s)
        return x[tuple(idx)]
    cfg = [(0, 0, 0)] * x.ndim
    cfg[axis] = (w - s, 0, 0)
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


def _head(x: jax.Array, w: int, axis: int) -> jax.Array:
    """First ``w`` rows along ``axis`` (zero-padded like :func:`_tail`)."""
    s = x.shape[axis]
    if s >= w:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, w)
        return x[tuple(idx)]
    cfg = [(0, 0, 0)] * x.ndim
    cfg[axis] = (0, w - s, 0)
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


def ring_halo(
    x: jax.Array, w: int, axis_name: str, axis: int = 0
) -> tuple[jax.Array, jax.Array]:
    """(left, right): exactly ``w`` halo rows per side along ``axis``.

    left = the ``w`` rows immediately preceding this shard's rows in
    global order; right = the ``w`` rows immediately following.  Rows
    past the global edges are zeros.  Single ppermute pair when the
    local extent covers ``w``; otherwise ``ceil(w/S)`` full-shard hops
    (each hop shifts the buffer one shard along the ring, so after h
    hops shard i holds shard i∓h's rows — zeros ride along past the
    edge, which is exactly the edge fill the callers gate on).
    """
    d = lax.axis_size(axis_name)
    s = x.shape[axis]
    fwd = [(i, i + 1) for i in range(d - 1)]
    bwd = [(i + 1, i) for i in range(d - 1)]
    hops = min(-(-w // s), d)
    if hops == 1:
        # cheap path: move only the needed w rows
        left = lax.ppermute(_tail(x, w, axis), axis_name, perm=fwd)
        right = lax.ppermute(_head(x, w, axis), axis_name, perm=bwd)
        return left, right
    lparts, rparts = [], []
    lbuf = rbuf = x
    for _ in range(hops):
        lbuf = lax.ppermute(lbuf, axis_name, perm=fwd)
        rbuf = lax.ppermute(rbuf, axis_name, perm=bwd)
        # lbuf after h hops = shard i-h's rows → oldest goes first
        lparts.insert(0, lbuf)
        rparts.append(rbuf)
    left = _tail(jnp.concatenate(lparts, axis=axis), w, axis)
    right = _head(jnp.concatenate(rparts, axis=axis), w, axis)
    return left, right


def halo_pad(x: jax.Array, w: int, axis_name: str) -> jax.Array:
    """Pad local rows with ``w`` halo rows from the ring neighbors.

    Args:
        x: local shard array [S, ...] (leading axis = Morton-contiguous
            point rows).
        w: halo width (rows).
        axis_name: shard_map mesh axis.

    Returns:
        [S + 2w, ...]: previous shards' last w rows, then x, then next
        shards' first w rows.  Global-edge shards get zeros (gate with
        the halo-padded mask).
    """
    left, right = ring_halo(x, w, axis_name, axis=0)
    return jnp.concatenate([left, x, right], axis=0)
