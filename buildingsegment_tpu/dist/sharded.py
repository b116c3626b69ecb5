"""Sharded end-to-end pipeline over a device mesh — explicit shard_map.

Point-shard data parallelism per SURVEY.md §2.5, written as explicit
SPMD rather than GSPMD pass-through (the auto-partitioner resolves the
windowized pipeline's global data dependencies by all-gathering, i.e.
8 devices ≈ 1× speedup):

  * the cloud is Morton-sorted globally, then split into contiguous
    ranges over the 1-D ``points`` mesh axis — shards are spatially
    coherent boxes of the scan;
  * every windowized op (fused kNN+normals sweep, seed rule, label
    propagation, refinement) runs shard-locally, reading ±W halo rows
    exchanged with ``lax.ppermute`` ring steps between neighbouring
    devices (:mod:`buildingsegment_tpu.dist.halo`);
  * label resolution is collective: per-label statistics are psum'd
    compact tables, the merge parent table is pmin'd, and the plane
    table / renumbering work on replicated tables
    (:func:`buildingsegment_tpu.seg.region_grow.segment_planes` with
    ``axis_name``).

Per-sweep communication is O(N_labels) table reductions + O(W) halo
rows — never a full-[N] all-gather (tests/test_dist.py asserts this on
the compiled HLO).  The global Morton sort at the top is the one
remaining all-gather-shaped step; it runs once per scan, outside the
iteration, and is O(N log N) on bytes (not the bottleneck — the sweep
loop is).

The reference has no parallelism of any kind (single-thread CPU binary,
tmc3/TMC3.cpp:202-229); this layer is the multi-device scaling story.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from buildingsegment_tpu.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu.core.morton import (
    morton_sort,
    unsort_by,
    unsort_labels,
)
from buildingsegment_tpu.core.quantize import shift_to_origin
from buildingsegment_tpu.dist.mesh import POINTS_AXIS, point_sharding
from buildingsegment_tpu.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu.seg.coarse import segment_planes_multigrid
from buildingsegment_tpu.seg.region_grow import (
    SegmentationResult,
    segment_planes,
    window_seeds,
)

__all__ = [
    "sharded_pipeline",
    "sharded_seg_body",
    "sharded_stats_body",
    "sharded_grow_body",
]


def _mg_path(config: PipelineConfig, s: int) -> bool:
    """Production multigrid path applies when the local shard rows
    divide evenly into the coarsening hierarchy."""
    return config.seg_group > 1 and s % (
        config.seg_group ** config.seg_levels
    ) == 0


def sharded_stats_body(mesh: Mesh, config: PipelineConfig):
    """shard_map'd neighborhood stage: sorted positions → per-point
    neighborhood data (halo-exchanged windows, all outputs sharded).

    Multigrid path: ``(kth_sq_dist, normals, curvature)`` via the
    stats sweep (no top_k).  Fallback path: the fused kNN+normals
    sweep's ``(neigh_idx, neigh_d, normals, curvature)``.
    """
    ax = POINTS_AXIS
    knn_k = config.knn_k
    k_q = max(knn_k, 16)

    def local_stats(spos, smask):
        s = spos.shape[0]
        if _mg_path(config, s):
            from buildingsegment_tpu.ops.stats_sweep import (
                knn_normals_window_stats,
            )

            return knn_normals_window_stats(
                spos, smask, k=knn_k, window=config.knn_window,
                radius=config.normal_radius,
                max_nn=config.normal_max_nn, axis_name=ax,
            )
        return knn_normals_window_sorted(
            spos, smask, k=k_q, window=config.knn_window,
            radius=config.normal_radius, max_nn=config.normal_max_nn,
            axis_name=ax,
        )

    def body(spos, smask):
        s = spos.shape[0] // mesh.size
        n_out = 3 if _mg_path(config, s) else 4
        out_specs = tuple(P(ax) for _ in range(n_out))
        return jax.shard_map(
            local_stats,
            mesh=mesh,
            in_specs=(P(ax, None), P(ax)),
            out_specs=out_specs,
            check_vma=False,
        )(spos, smask)

    return body


def sharded_grow_body(mesh: Mesh, config: PipelineConfig, *,
                      signed_normals: bool = False):
    """shard_map'd segmentation stage: sorted positions + stats →
    :class:`SegmentationResult` (labels sharded, tables replicated).
    """
    ax = POINTS_AXIS
    knn_k = config.knn_k

    def local_grow(spos, smask, *stats):
        # fine edge gate widens with the proven density hint, exactly
        # like pipeline._window_stage2 (must match or 8-shard ≢ 1-shard)
        edge0 = 2.0 * config.th_thickness
        if config.spacing_hint_mm is not None:
            edge0 = max(edge0, 3.0 * config.spacing_hint_mm)
        seg_kwargs = dict(
            max_edge_dist=edge0,
            th_seed_curvature=config.th_seed_curvature,
            th_thickness=config.th_thickness,
            th_normal_cos=config.th_normal_cos,
            th_point_count=config.th_point_count,
            max_planes=config.max_planes,
            max_sweeps=config.max_sweeps,
            convergence_tol=config.seg_convergence_tol,
            signed_normals=signed_normals,
        )
        # None → the solver's own default (multigrid 0.0, single-level
        # 0.95) — MUST match pipeline._window_stage2's treatment or
        # 8-shard ≢ 1-shard (tests/test_dist.py pins this)
        if config.seg_anchor_cos is not None:
            seg_kwargs["th_anchor_cos"] = config.seg_anchor_cos
        s = spos.shape[0]
        if _mg_path(config, s):
            dk, normals, curv = stats
            rows_i = jnp.arange(s, dtype=jnp.int32)
            g_idx = jnp.stack([rows_i, rows_i], axis=1)
            return segment_planes_multigrid(
                spos, normals, g_idx, smask,
                kth_sq_dist=dk, curvature=curv,
                group=config.seg_group, levels=config.seg_levels,
                refine_sweeps=config.seg_refine_sweeps,
                seed_source=config.seg_seed_source,
                spacing_hint_mm=config.spacing_hint_mm,
                axis_name=ax, **seg_kwargs,
            )
        neigh_idx, neigh_d, normals, curv = stats
        seeds = window_seeds(
            spos, normals, smask, neigh_d[:, knn_k - 1],
            window=config.knn_window,
            th_thickness=config.th_thickness,
            th_normal_cos=config.th_normal_cos,
            signed_normals=signed_normals,
            axis_name=ax,
        )
        return segment_planes(
            spos, normals, neigh_idx[:, :knn_k], smask,
            neigh_sq_dist=neigh_d[:, :knn_k], curvature=curv,
            seed_override=seeds, propagation="window",
            axis_name=ax, **seg_kwargs,
        )

    out_specs = SegmentationResult(
        plane_idx=P(ax),
        num_planes=P(),
        plane_normal=P(),
        plane_center=P(),
        plane_count=P(),
        num_sweeps=P(),
        # counters derive from psum'd tables / psum'd change counts —
        # replicated by construction
        diagnostics=P(),
    )

    # check_vma=False: the varying-manual-axes checker rejects loop
    # carries initialized from constants (jnp.full inits meeting
    # shard-varying updates) all over the sweep loops.  Replication of
    # the P() outputs holds by construction — every replicated output
    # derives from a psum/pmin'd table.
    def body(spos, smask, *stats):
        in_specs = (P(ax, None), P(ax)) + tuple(
            P(ax) if a.ndim == 1 else P(ax, None) for a in stats
        )
        return jax.shard_map(
            local_grow,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )(spos, smask, *stats)

    return body


def sharded_seg_body(mesh: Mesh, config: PipelineConfig, *,
                     signed_normals: bool = False):
    """The full shard_map'd core: Morton-sorted positions → labels.

    Composes :func:`sharded_stats_body` and :func:`sharded_grow_body`
    (tests compile this composition and assert the HLO contains no
    all-gather; production dispatches the two stages as separate
    programs — see :func:`sharded_pipeline`).
    """
    stats = sharded_stats_body(mesh, config)
    grow = sharded_grow_body(mesh, config, signed_normals=signed_normals)

    def body(spos, smask):
        return grow(spos, smask, *stats(spos, smask))

    return body


def sharded_pipeline(
    mesh: Mesh,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    signed_normals: bool = False,
    capacity_hint: Optional[int] = None,
):
    """Build the sharded pipeline function for ``mesh``.

    Returns ``fn(positions int32[N,3], mask bool[N])`` →
    ``(shifted_positions, bbox_min, SegmentationResult)`` with inputs
    sharded over the points axis.  N must be divisible by the mesh size
    (pad capacity accordingly).  Always runs the production window +
    multigrid path — the only one whose work scales with shards.

    ``fn`` dispatches TWO jitted stages (sort+stats | segmentation)
    back to back, split like the single-device pipeline
    (``pipeline._window_stage2``); every buffer at the boundary is
    [N]-sized.  Both stages stay fully sharded; the boundary does not
    gather.
    """
    del capacity_hint  # kept for API compatibility
    in_shardings = (point_sharding(mesh, 2), point_sharding(mesh, 1))
    stats = sharded_stats_body(mesh, config)
    grow = sharded_grow_body(mesh, config, signed_normals=signed_normals)

    @functools.partial(jax.jit, in_shardings=in_shardings)
    def stage1(positions, mask):
        shifted, lo, _hi = shift_to_origin(positions, mask)
        # global Morton sort (once per scan, outside the sweep loop);
        # coordinates decode from the carried code words — no gather
        sorted_pos, smask, order = morton_sort(
            shifted, mask, config.morton_small
        )
        spos = sorted_pos.astype(jnp.float32)
        return (shifted, lo, spos, smask, order) + tuple(
            stats(spos, smask)
        )

    @jax.jit
    def stage2(spos, smask, order, *stat):
        seg = grow(spos, smask, *stat)
        plane_idx = unsort_labels(order, seg.plane_idx, config.max_planes)
        return dataclasses.replace(seg, plane_idx=plane_idx)

    def fn(positions, mask):
        shifted, lo, spos, smask, order, *stat = stage1(positions, mask)
        return shifted, lo, stage2(spos, smask, order, *stat)

    return fn
