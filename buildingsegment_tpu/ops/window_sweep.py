"""The ±W window sweeps of region growing, in plain XLA.

Every sweep reads the same pattern: for each offset o ∈ [−W, W] \\ {0}
of a Morton-sorted cloud, row i meets row i+o.  The rows are padded by
W sentinel rows on both sides (or, under ``shard_map``, by W halo rows
from the ring neighbours), so each offset is one static 1-D slice and
the whole unrolled loop fuses into a few elementwise kernels.  Arrays
are kept as 1-D components: slicing an ``[n, 3]`` array pads its
3-wide minor axis in some layouts.

Sweeps here:

* :func:`label_sweep` — one label-propagation step of the windowized
  solver (``seg/region_grow.py``): the hop-min (a neighbour's region
  model accepts this point) and the merge hook (the two regions'
  models accept each other, smaller label wins).
* :func:`refine_clean` and :func:`refine_sweep` — the multigrid
  refinement (``seg/coarse.py``): drop points whose plane rejects them,
  then adopt the smallest accepting plane id of nearby rows.

The depth-0 seed sweep is ``seg.region_grow.window_seeds``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "pad_rows", "pad_positions", "window_starts",
    "label_sweep", "refine_clean", "refine_sweep",
]

FAR = -3e7  # sentinel coordinate of padding rows


def pad_rows(a, fill, w, axis_name=None):
    """``a`` with ``w`` rows of ``fill`` on both sides — or, inside
    ``shard_map`` over ``axis_name``, ``w`` halo rows from the ring
    neighbours (zeros at the global edges, gated by the padded mask
    exactly like the sentinel fill)."""
    if axis_name is not None:
        from buildingsegment_tpu.dist.halo import halo_pad

        return halo_pad(a, w, axis_name)
    f = jnp.full((w,) + a.shape[1:], fill, a.dtype)
    return jnp.concatenate([f, a, f])


def pad_positions(pos, mask, w, axis_name=None):
    """Padded (x, y, z, mask) rows of a solve, built once and shared by
    all of its sweeps."""
    px, py, pz = pos
    return (
        pad_rows(px, FAR, w, axis_name),
        pad_rows(py, FAR, w, axis_name),
        pad_rows(pz, FAR, w, axis_name),
        pad_rows(mask, False, w, axis_name),
    )


def window_starts(w):
    """Slice starts of the 2w offsets −w..−1, 1..w in a w-padded row."""
    return [slot if slot < w else slot + 1 for slot in range(2 * w)]


def _cmag(signed):
    return (lambda x: x) if signed else jnp.abs


def label_sweep(pos, nrm, mask, label, model, padded, *, window,
                th_thickness, th_normal_cos, edge_gate2, inf_label,
                signed=False, axis_name=None):
    """One windowized label-propagation sweep.

    Args:
        pos, nrm: (x, y, z) component rows, f32[n] each.
        mask: bool[n].
        label: int32[n] current label (``inf_label`` = none).
        model: f32[n, 6] unit normal and center of each row's label
            model (zeros where the row has no label).
        padded: :func:`pad_positions` of ``pos``/``mask``.
        edge_gate2: squared Euclidean edge gate.

    Returns (new, best): ``new`` = min(label, smallest neighbour label
    whose model accepts the row); ``best`` = smallest smaller neighbour
    label whose model and this row's model accept each other
    (``inf_label`` where none).
    """
    n = label.shape[0]
    ws = window
    cmag = _cmag(signed)
    px, py, pz = pos
    nx_, ny_, nz_ = nrm
    ppx, ppy, ppz, pmask = padded
    mnx, mny, mnz = model[:, 0], model[:, 1], model[:, 2]
    mcx, mcy, mcz = model[:, 3], model[:, 4], model[:, 5]
    has = label < inf_label

    def pad(a, fill):
        return pad_rows(a, fill, ws, axis_name)

    plab = pad(label, inf_label)
    pmnx, pmny, pmnz = pad(mnx, 0.0), pad(mny, 0.0), pad(mnz, 0.0)
    pmcx, pmcy, pmcz = pad(mcx, 0.0), pad(mcy, 0.0), pad(mcz, 0.0)
    new = label
    best = jnp.full((n,), inf_label, jnp.int32)
    for start in window_starts(ws):
        sl = lambda a: lax.slice(a, (start,), (start + n,))  # noqa: E731
        clab = sl(plab)
        dx = px - sl(ppx)
        dy = py - sl(ppy)
        dz = pz - sl(ppz)
        near = (dx * dx + dy * dy + dz * dz <= edge_gate2) & sl(pmask) & mask
        cmnx, cmny, cmnz = sl(pmnx), sl(pmny), sl(pmnz)
        cmcx, cmcy, cmcz = sl(pmcx), sl(pmcy), sl(pmcz)
        # hop: does the neighbour's region model accept this point?
        d = jnp.abs(
            (px - cmcx) * cmnx + (py - cmcy) * cmny + (pz - cmcz) * cmnz
        )
        c = cmag(nx_ * cmnx + ny_ * cmny + nz_ * cmnz)
        hop_ok = ((clab < inf_label) & near & (d <= th_thickness)
                  & (c >= th_normal_cos))
        new = jnp.minimum(new, jnp.where(hop_ok, clab, inf_label))
        # merge hook: mutual model acceptance between the regions
        dcx = cmcx - mcx
        dcy = cmcy - mcy
        dcz = cmcz - mcz
        mutual = (
            (jnp.abs(dcx * mnx + dcy * mny + dcz * mnz) <= th_thickness)
            & (jnp.abs(dcx * cmnx + dcy * cmny + dcz * cmnz) <= th_thickness)
            & (cmag(mnx * cmnx + mny * cmny + mnz * cmnz) >= th_normal_cos)
        )
        mrg_ok = has & (clab < label) & near & mutual
        best = jnp.minimum(best, jnp.where(mrg_ok, clab, inf_label))
    return new, best


def _plane_model(pid, mask, pn, b_tab, max_planes):
    """(normal f32[n, 3], offset b = n·c f32[n]) of each row's plane id
    (zeros where the id is 0 or the row is masked)."""
    t = jnp.clip(pid - 1, 0, max_planes - 1)
    has = (pid > 0) & mask
    return (jnp.where(has[:, None], pn[t], 0.0),
            jnp.where(has, b_tab[t], 0.0))


def refine_clean(pid, pos, nrm, mask, pn, b_tab, *, max_planes,
                 th_thickness, th_normal_cos, signed=False):
    """Keep a row's plane id (1..P, 0 = none) only where that plane
    still accepts it.  The plane test is in offset form,
    |p·n_t − b_t| ≤ th with b_t = n_t·c_t (``b_tab``)."""
    cmag = _cmag(signed)
    px, py, pz = pos
    nx_, ny_, nz_ = nrm
    mnp, mb = _plane_model(pid, mask, pn, b_tab, max_planes)
    ok = (
        (pid > 0)
        & mask
        & (jnp.abs(px * mnp[:, 0] + py * mnp[:, 1] + pz * mnp[:, 2] - mb)
           <= th_thickness)
        & (cmag(nx_ * mnp[:, 0] + ny_ * mnp[:, 1] + nz_ * mnp[:, 2])
           >= th_normal_cos)
    )
    return jnp.where(ok, pid, 0)


def refine_sweep(pid, pos, nrm, mask, pn, b_tab, padded, *, window,
                 max_planes, th_thickness, th_normal_cos, edge_gate2,
                 signed=False, axis_name=None):
    """One refinement sweep: a row without a plane id adopts the
    smallest id of a row within ±window and the edge gate whose plane
    accepts it; rows with an id keep it."""
    n = pid.shape[0]
    ws = window
    cmag = _cmag(signed)
    px, py, pz = pos
    nx_, ny_, nz_ = nrm
    ppx, ppy, ppz, pmask = padded
    mnp, mb = _plane_model(pid, mask, pn, b_tab, max_planes)

    def pad(a, fill):
        return pad_rows(a, fill, ws, axis_name)

    ppid = pad(pid, 0)
    pmnx, pmny, pmnz = pad(mnp[:, 0], 0.0), pad(mnp[:, 1], 0.0), pad(
        mnp[:, 2], 0.0)
    pmb = pad(mb, 0.0)
    big_pid = jnp.int32(max_planes + 1)
    best = jnp.full((n,), big_pid, jnp.int32)
    for start in window_starts(ws):
        sl = lambda a: lax.slice(a, (start,), (start + n,))  # noqa: E731
        cpid = sl(ppid)
        dx = px - sl(ppx)
        dy = py - sl(ppy)
        dz = pz - sl(ppz)
        near = dx * dx + dy * dy + dz * dz <= edge_gate2
        cmnx, cmny, cmnz = sl(pmnx), sl(pmny), sl(pmnz)
        d = jnp.abs(px * cmnx + py * cmny + pz * cmnz - sl(pmb))
        c = cmag(nx_ * cmnx + ny_ * cmny + nz_ * cmnz)
        ok = ((cpid > 0) & near & sl(pmask) & mask
              & (d <= th_thickness) & (c >= th_normal_cos))
        best = jnp.minimum(best, jnp.where(ok, cpid, big_pid))
    return jnp.where(pid > 0, pid, jnp.where(best < big_pid, best, 0))
