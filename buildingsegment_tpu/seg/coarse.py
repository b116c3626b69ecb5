"""Multigrid region growing — coarse label propagation + fine refinement.

The fixed-point label propagation dominates the pipeline (every sweep
touches several [N]-sized arrays through scatters/gathers).  Building
scans are Morton-sorted before segmentation, so G consecutive points are
almost always samples of the same plane — which makes a classic
multigrid scheme natural:

1. **Coarsen**: group the sorted cloud into super-points of G
   consecutive rows; each carries the masked mean position, the
   normalized mean (canonicalized) normal, and a coherence flag
   (normals aligned + spatially tight).  Incoherent groups (plane
   boundaries, corners, clutter) are excluded from the coarse problem.
2. **Coarse solve**: run the full windowized region growing
   (:func:`segment_planes`) on the ~N/G super-points — identical
   machinery at 1/G the cost per sweep, and each window hop covers G×
   more space, so it also converges in fewer sweeps.
3. **Refine**: expand each group's plane id to its points, then test
   every point against its plane's model (the coarse plane table —
   [P]-sized, so lookups are cheap); points that fail, plus points of
   incoherent groups, try the plane ids of nearby rows through a few
   windowized slice sweeps.
4. **Finalize**: recount plane membership at full resolution, cull
   (> th_point_count, the reference's strict rule), renumber densely,
   and rebuild the plane table from the final membership.

Quality guard: tests compare the multigrid result against the
single-level solver's ground-truth agreement on synthetic houses.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from buildingsegment_tpu.ops.adopt import plane_adopt
from buildingsegment_tpu.ops.normals import canonicalize_normals
from buildingsegment_tpu.ops.prefix import prefix_sum_i32
from buildingsegment_tpu.ops.segsum import plane_sums, table_lookup
from buildingsegment_tpu.ops.window_sweep import (
    pad_positions,
    refine_clean,
    refine_sweep,
)
from buildingsegment_tpu.seg.region_grow import (
    SegmentationResult,
    segment_planes,
    window_seeds,
)

__all__ = ["segment_planes_multigrid"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "group",
        "th_point_count",
        "max_planes",
        "max_sweeps",
        "signed_normals",
        "window",
        "refine_sweeps",
        "convergence_tol",
        "levels",
        "axis_name",
        "th_thickness", "th_normal_cos", "max_edge_dist",
        "th_anchor_cos", "seed_source", "spacing_hint_mm", "heal",
    ),
)
def segment_planes_multigrid(
    positions: jax.Array,
    normals: jax.Array,
    neigh_idx: jax.Array,
    mask: jax.Array,
    *,
    neigh_sq_dist: Optional[jax.Array] = None,
    kth_sq_dist: Optional[jax.Array] = None,
    max_edge_dist: Optional[float] = None,
    curvature: Optional[jax.Array] = None,
    th_seed_curvature: Optional[float] = None,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    th_point_count: int = 400,
    max_planes: int = 4096,
    max_sweeps: int = 64,
    convergence_tol: float = 0.0,
    signed_normals: bool = False,
    window: int = 16,
    group: int = 8,
    refine_sweeps: int = 2,
    levels: int = 1,
    # anchor-pure models ON by default — tools/anchor_sweep.py through
    # the PRODUCTION pipeline: 0.95 separates shallow-dihedral ridges
    # (shallow6 0.9945/3 planes vs 0.876/2 merged at every value below
    # 0.95) and is equal-or-better everywhere else (house40s 0.9856 vs
    # 0.9833, house80 0.9551 vs 0.9513, block identical).  The earlier
    # claim that the anchor over-fragments the coarse level was an
    # artifact of the old quality sweep's radius-300 proxy normals.
    th_anchor_cos: float = 0.95,
    seed_override=None,
    axis_name: str = None,
    seed_source: Optional[str] = None,
    spacing_hint_mm: Optional[float] = None,
    # finalize healing: True = coplanar merge + flat-plane hole
    # adoption; "merge" = merge only; False = neither.  Full heal runs
    # at EVERY level — measured necessity on the 80 mm block scene
    # (bij, floor 0.92): 0.96 full everywhere, 0.894 with inner levels
    # merge-only, 0.83 with inner levels off.  Inner adoption matters
    # because adopted coarse rows participate in the next level's
    # band-tested refinement and window propagation; the one-shot
    # outer band test cannot replicate that.  The knob exists for
    # perf attribution (tools/perf_heal_lab.py), not production use.
    heal=True,  # True | "merge" | False
) -> SegmentationResult:
    """Multigrid windowized plane segmentation (Morton-sorted input).

    Same contract as :func:`segment_planes` with ``propagation="window"``;
    ``group`` is the coarsening factor (must divide N).  With
    ``axis_name`` (inside shard_map over Morton-range shards) the
    coarsening/refinement stay shard-local with ppermute halo slices,
    and the coarse solve + plane-table finalization use collective
    (psum/pmin) label resolution — see :func:`segment_planes`.
    """
    n, k = neigh_idx.shape
    def _psum(x):
        return x if axis_name is None else lax.psum(x, axis_name)

    if n % group:
        raise ValueError(f"N={n} must be a multiple of group={group}")
    ng = n // group
    pos = positions.astype(jnp.float32)
    nrm = normals.astype(jnp.float32)
    cmag = (lambda x: x) if signed_normals else jnp.abs
    cn = nrm if signed_normals else canonicalize_normals(nrm)
    edge_mm = float(
        max_edge_dist if max_edge_dist is not None else 2.0 * th_thickness
    )
    edge_gate = jnp.float32(edge_mm)
    # Each coarsening multiplies the typical row spacing by ~√group
    # (Morton groups of G surface samples span ~√G spacings), so the
    # child level's edge gate must scale with it or sparse scans lose
    # all coarse connectivity: at 150 mm spacing the deepest levels=3
    # rows sit ~1200 mm apart and a fixed 600 mm gate finds NO window
    # edges (r3: production multigrid returned 0 planes there, while
    # the reference's kNN graph has no density assumption at all,
    # tmc3/my_function.cpp:220-258).  Membership stays guarded by the
    # absolute plane-band thickness + normal-cos tests either way —
    # but thickness+cos cannot stop a wide gate from bridging two
    # COPLANAR planes (two buildings' roofs at one height: measured
    # bij 0.59 vs 0.90 on the 80 mm block scene when every level
    # scaled unconditionally).  With a host-proven density hint
    # (config.spacing_hint_mm, the morton_small pattern) the child
    # gate therefore grows only to what connectivity needs at the
    # MEASURED density — ~3 child-row spacings — and a dense scan
    # keeps the tight base gate at every level.  Without a hint the
    # unconditional scaling applies (sparse-safe, bridge-prone).
    edge_scale = max(2.0, float(group) ** 0.5)
    if spacing_hint_mm is not None:
        child_hint = edge_scale * float(spacing_hint_mm)
        child_edge = max(edge_mm, 3.0 * child_hint)
    else:
        child_hint = None
        child_edge = edge_scale * edge_mm

    # ------------------------------------------------------------------
    # 1. coarsen
    # ------------------------------------------------------------------
    gpos_all = pos.reshape(ng, group, 3)
    gnrm_all = cn.reshape(ng, group, 3)
    gmask_all = mask.reshape(ng, group)
    w = gmask_all.astype(jnp.float32)
    cnt = jnp.sum(w, axis=1)
    safe = jnp.maximum(cnt, 1.0)[:, None]
    gpos = jnp.sum(gpos_all * w[:, :, None], axis=1) / safe
    gsum_n = jnp.sum(gnrm_all * w[:, :, None], axis=1)
    glen = jnp.sqrt(jnp.maximum(jnp.sum(gsum_n * gsum_n, -1), 1e-20))
    gnrm = gsum_n / glen[:, None]
    # coherence: |Σ n̂| close to count (normals aligned) AND the group
    # hugs its mean plane AND stays spatially tight
    align = glen / jnp.maximum(cnt, 1.0)
    dvec = gpos_all - gpos[:, None, :]
    plane_d = jnp.abs(jnp.einsum("gkd,gd->gk", dvec, gnrm,
                                 precision=lax.Precision.HIGHEST))
    spread2 = jnp.max(
        jnp.where(gmask_all, jnp.sum(dvec * dvec, -1), 0.0), axis=1
    )
    coherent = (
        (cnt >= jnp.float32(max(2, group // 2)))
        & (align >= th_normal_cos)
        & (jnp.max(jnp.where(gmask_all, plane_d, 0.0), 1) <= th_thickness)
        & (spread2 <= edge_gate * edge_gate)
    )
    gmask = (cnt > 0) & coherent

    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    nx_, ny_, nz_ = nrm[:, 0], nrm[:, 1], nrm[:, 2]

    # coarse seed rule: the group contains a strict fine-level seed
    # (the gather-free windowized depth-0 rule — see window_seeds)
    if kth_sq_dist is not None:
        dk = kth_sq_dist  # f32[N] squared k-th NN distance, direct
    elif neigh_sq_dist is not None:
        dk = neigh_sq_dist[:, k - 1]  # squared k-th NN distance
    else:
        dk = jnp.full((n,), edge_gate * edge_gate, jnp.float32)
    if seed_override is not None:
        fine_seed = seed_override & mask
        if curvature is not None and th_seed_curvature is not None:
            fine_seed = fine_seed & (
                curvature <= jnp.float32(th_seed_curvature)
            )
        gseed = jnp.any(fine_seed.reshape(ng, group), axis=1) & gmask
    elif seed_source == "coarse":
        # Seed gate derived from the group-coherence statistics already
        # computed above — no fine-level window_seeds sweep (~4-5 ms at
        # 1M points, the largest single item in the multigrid stage's
        # non-refine floor).  The fine depth-0 rule ("every one of the
        # k−1 nearest neighbors passes the plane test",
        # tmc3/my_function.cpp:238) demands a perfectly planar
        # neighborhood; its group-level analog is a FULL group whose
        # normals agree tightly and whose points hug the group plane at
        # half the membership thickness.  Strictly a different seed
        # criterion — offered as a bench candidate whose adoption the
        # chip quality gate arbitrates (same contract as seg_levels=3).
        gseed = (
            gmask
            & (cnt >= jnp.float32(group))
            & (align >= jnp.float32(max(th_normal_cos, 0.97)))
            & (
                jnp.max(jnp.where(gmask_all, plane_d, 0.0), 1)
                <= 0.5 * th_thickness
            )
        )
        if curvature is not None and th_seed_curvature is not None:
            flat = (curvature <= jnp.float32(th_seed_curvature)) & mask
            gseed = gseed & jnp.any(flat.reshape(ng, group), axis=1)
    else:
        fine_seed = window_seeds(
            pos, nrm, mask, dk,
            window=window,
            th_thickness=th_thickness,
            th_normal_cos=th_normal_cos,
            signed_normals=signed_normals,
            axis_name=axis_name,
        )
        if curvature is not None and th_seed_curvature is not None:
            fine_seed = fine_seed & (
                curvature <= jnp.float32(th_seed_curvature)
            )
        gseed = jnp.any(fine_seed.reshape(ng, group), axis=1) & gmask

    # ------------------------------------------------------------------
    # 2. coarse solve — reuse the windowized single-level solver with a
    # synthetic "seed graph": give seeds a self-loop-only graph so the
    # solver's own seed rule passes exactly where gseed holds.
    # ------------------------------------------------------------------
    rows_g = lax.broadcasted_iota(jnp.int32, (ng, 1), 0)
    g_idx = jnp.concatenate([rows_g, rows_g], axis=1)  # placeholder graph
    coarse_th = max(1, th_point_count // group // 2)
    if levels > 1 and ng % group == 0:
        # recurse: another coarsening level solves the coarse problem
        coarse = segment_planes_multigrid(
            gpos.astype(jnp.int32),
            gnrm,
            g_idx,
            gmask,
            seed_override=gseed,
            max_edge_dist=child_edge,
            th_thickness=th_thickness,
            th_normal_cos=th_normal_cos,
            th_point_count=coarse_th,
            max_planes=max_planes,
            max_sweeps=max_sweeps,
            # tol is in fine-point units: one coarse row stands for
            # `group` fine points, so the change-count threshold keeps
            # its absolute meaning down the hierarchy
            convergence_tol=convergence_tol * group,
            signed_normals=signed_normals,
            window=window,
            group=group,
            refine_sweeps=refine_sweeps,
            levels=levels - 1,
            th_anchor_cos=th_anchor_cos,
            axis_name=axis_name,
            spacing_hint_mm=child_hint,
            heal=True,
        )
    else:
        coarse = segment_planes(
            gpos.astype(jnp.int32),
            gnrm,
            g_idx,
            gmask,
            seed_override=gseed,
            max_edge_dist=child_edge,
            neigh_sq_dist=None,
            th_thickness=th_thickness,
            th_normal_cos=th_normal_cos,
            th_point_count=coarse_th,
            max_planes=max_planes,
            max_sweeps=max_sweeps,
            convergence_tol=convergence_tol * group,
            signed_normals=signed_normals,
            propagation="window",
            window=window,
            th_anchor_cos=th_anchor_cos,
            axis_name=axis_name,
        )

    # ------------------------------------------------------------------
    # 3. refine at full resolution with plane-id labels
    # ------------------------------------------------------------------
    pn = coarse.plane_normal  # [P, 3]
    pc = coarse.plane_center
    plane_id_g = jnp.maximum(coarse.plane_idx, 0)  # [ng], 0 = none
    pid0 = jnp.repeat(plane_id_g, group)  # expand to points

    # plane-band test in offset form: |p·n_t − b_t| ≤ th with
    # b_t = n_t·c_t — algebraically |(p−c_t)·n_t| (ops/window_sweep.py)
    b_tab = jnp.sum(
        pn.astype(jnp.float32) * pc.astype(jnp.float32), axis=-1
    )
    edge_gate2 = float(
        max_edge_dist if max_edge_dist is not None else 2.0 * th_thickness
    ) ** 2
    pos3, nrm3 = (px, py, pz), (nx_, ny_, nz_)
    gates = dict(max_planes=max_planes, th_thickness=th_thickness,
                 th_normal_cos=th_normal_cos, signed=signed_normals)
    pid = refine_clean(pid0, pos3, nrm3, mask, pn, b_tab, **gates)
    padded = pad_positions(pos3, mask, window, axis_name)
    for _ in range(refine_sweeps):
        pid = refine_sweep(
            pid, pos3, nrm3, mask, pn, b_tab, padded, window=window,
            edge_gate2=edge_gate2, axis_name=axis_name, **gates,
        )

    # ------------------------------------------------------------------
    # 4. finalize: recount, MERGE coplanar overlapping planes, cull
    # (> th_point_count), renumber densely.  One combined segment
    # stats pass over OLD ids; the new (dense) table is a permutation
    # of its kept (merged-root) rows.
    #
    # The merge pass exists because the per-level refine sweeps adopt
    # by MIN plane id: when the coarse solve leaves part of a plane
    # unlabeled (incoherent groups), several coplanar ids flood-fill
    # the gap from different sides and partition it along Morton-cell
    # lines — measured on the 2-building block scene at levels=3: the
    # shared ground ended as 3 abutting coplanar planes (dominant
    # share 0.27, bij 0.57).  Re-applying the solver's own global
    # coplanar-overlap test (region_grow.py window_body step 4b:
    # mutual plane-band acceptance of centers + normal cos + extent
    # overlap within the edge gate) on the FINAL [P] table heals every
    # such split for O(P²) elementwise work.  Merging runs before the
    # cull, so fragments that individually miss th_point_count but
    # together clear it survive — like the reference's single
    # connected region would (tmc3/my_function.cpp:196-209).
    # ------------------------------------------------------------------
    sq = jnp.sum(pos * pos, axis=1, keepdims=True)
    payload = jnp.concatenate(
        [jnp.ones((n, 1), jnp.float32), cn, pos, sq], axis=1
    )  # [n, 8]: cnt, Σn̂, Σp, Σ|p|²
    member = mask & (pid > 0)
    old_row = jnp.where(member, pid - 1, max_planes)
    acc = plane_sums(old_row, payload, max_planes, table_cap=max_planes)
    acc = _psum(acc)  # global when sharded

    # --- coplanar-overlap union on the [P] table (heal=True only) ---
    rows_p = jnp.arange(max_planes, dtype=jnp.int32)
    cnt_o = acc[:, 0]
    live_o = cnt_o > 0
    if not heal:
        # inner-level finalize: identity union, no adoption — the next
        # level's band-tested refinement self-corrects coarse
        # partitioning, and the outermost call heals what remains
        parent = rows_p
        adopted = jnp.zeros((n,), bool)
        adopt_row = jnp.zeros((n,), jnp.int32)
    else:
        sc_o = jnp.maximum(cnt_o, 1.0)[:, None]
        mn_o = acc[:, 1:4] / sc_o
        n_t = mn_o / jnp.sqrt(
            jnp.maximum(jnp.sum(mn_o * mn_o, -1, keepdims=True), 1e-20)
        )
        c_t = acc[:, 4:7] / sc_o
        ccd = jnp.sum(c_t * c_t, -1)
        r_t = jnp.sqrt(jnp.maximum(acc[:, 7] / sc_o[:, 0] - ccd, 0.0))
        hi_p = lax.Precision.HIGHEST  # mm-scale cancellation (CLAUDE.md)

        # --- second pass: per-plane CENTERED second moments.  The pair
        # test below may not merge on band/cos/extent alone: on a smoothly
        # curved surface (rolling terrain) every adjacent strip passes the
        # mutual tests and union-by-min daisy-chains the whole sheet into
        # one "plane" whose members then violate the thickness band
        # (measured: max residual 641 mm at th 300, 8% of members out of
        # band).  The reference can't do this: a region only ever accepts
        # points in the SEED's own band (tmc3/my_function.cpp:226-236).
        # So each candidate pair is additionally gated on its PREDICTED
        # merged-plane RMS — computed from per-plane second moments via the
        # parallel-axis shift to the merged centroid.  Coplanar fragments
        # of one true plane (RMS ≈ noise) pass; curvature chains (RMS ≫
        # th/2) are rejected at the first link, so transitive closure
        # never starts.  Moments are accumulated about each plane's OWN
        # first-pass center: raw Σppᵀ at mm scale cancels catastrophically
        # in f32 (CLAUDE.md), centered sums keep ~mm² absolute error.
        ct_pad = jnp.concatenate(
            [c_t, jnp.zeros((1, 3), jnp.float32)], axis=0
        )
        dxc = jnp.where(member[:, None], pos - ct_pad[old_row], 0.0)
        mom = jnp.stack(
            [dxc[:, 0] * dxc[:, 0], dxc[:, 1] * dxc[:, 1],
             dxc[:, 2] * dxc[:, 2], dxc[:, 0] * dxc[:, 1],
             dxc[:, 0] * dxc[:, 2], dxc[:, 1] * dxc[:, 2]], axis=1
        )  # [n, 6]: xx, yy, zz, xy, xz, yz about own plane center
        acc_m = _psum(
            plane_sums(old_row, mom, max_planes, table_cap=max_planes)
        )

        nc = jnp.sum(n_t * c_t, -1)
        ncT = jnp.dot(n_t, c_t.T, preferred_element_type=jnp.float32,
                      precision=hi_p)
        nrm_sep = ncT - nc[:, None]
        nrm_sep_b = nc[None, :] - ncT.T
        dotnn = jnp.dot(n_t, n_t.T, preferred_element_type=jnp.float32,
                        precision=hi_p)
        cosab = cmag(dotnn)
        d2 = ccd[:, None] + ccd[None, :] - 2.0 * jnp.dot(
            c_t, c_t.T, preferred_element_type=jnp.float32, precision=hi_p
        )
        inplane2 = jnp.maximum(d2 - nrm_sep * nrm_sep, 0.0)
        reach = 2.0 * (r_t[:, None] + r_t[None, :]) + jnp.float32(edge_mm)

        # predicted merged-plane mean-square residual r2m[i,j]:
        #   q   = merged centroid, nm = count-weighted sign-aligned normal
        #   M_m = M_i + M_j + cnt_i·d_i d_iᵀ + cnt_j·d_j d_jᵀ   (d = c − q)
        #   r2m = nmᵀ M_m nm / (|nm|² · cnt_m)
        cntm = jnp.maximum(cnt_o[:, None] + cnt_o[None, :], 1.0)
        q3 = [
            (acc[:, 4 + a][:, None] + acc[:, 4 + a][None, :]) / cntm
            for a in range(3)
        ]
        di3 = [c_t[:, a][:, None] - q3[a] for a in range(3)]
        dj3 = [c_t[:, a][None, :] - q3[a] for a in range(3)]
        sgn = jnp.where(dotnn < 0.0, -1.0, 1.0)  # anti-parallel heals
        nm3 = [
            cnt_o[:, None] * n_t[:, a][:, None]
            + sgn * cnt_o[None, :] * n_t[:, a][None, :]
            for a in range(3)
        ]
        nn2 = jnp.maximum(
            nm3[0] * nm3[0] + nm3[1] * nm3[1] + nm3[2] * nm3[2], 1e-20
        )
        num = jnp.zeros_like(cntm)
        for col, a, b in ((0, 0, 0), (1, 1, 1), (2, 2, 2),
                          (3, 0, 1), (4, 0, 2), (5, 1, 2)):
            Mm = (acc_m[:, col][:, None] + acc_m[:, col][None, :]
                  + cnt_o[:, None] * di3[a] * di3[b]
                  + cnt_o[None, :] * dj3[a] * dj3[b])
            num = num + (1.0 if a == b else 2.0) * nm3[a] * nm3[b] * Mm
        r2m = num / (nn2 * cntm)

        ok_pair = (
            (jnp.abs(nrm_sep) <= th_thickness)
            & (jnp.abs(nrm_sep_b) <= th_thickness)
            & (cosab >= th_normal_cos)
            & (inplane2 <= reach * reach)
            & (r2m <= (0.5 * th_thickness) ** 2)
            & live_o[:, None]
            & live_o[None, :]
        )
        # union-by-min + jump doubling (12 rounds cover any chain ≤ 4096)
        parent = jnp.min(
            jnp.where(ok_pair, rows_p[None, :], max_planes), axis=1
        )
        parent = jnp.minimum(rows_p, parent)
        for _ in range(12):
            parent = jnp.minimum(parent, parent[parent])
        # re-aggregate sums onto root rows via one-hot matmul (a scatter
        # at [P] rows hides a sort; the [P,P]×[P,8] matmul is trivial and
        # deterministic).  HIGHEST: counts must stay exact in f32.
        onehot = (parent[None, :] == rows_p[:, None]).astype(jnp.float32)
        acc = jnp.dot(onehot, acc, preferred_element_type=jnp.float32,
                      precision=hi_p)

        if heal != True:  # noqa: E712  ("merge" mode: no adoption)
            adopted = jnp.zeros((n,), bool)
            adopt_row = jnp.zeros((n,), jnp.int32)
        else:
            # --- per-ROOT flatness (exact, f32-stable): only a plane that
            # proved FLAT may adopt holes below.  A curved strip (own RMS ~
            # 100-170 at th 300) passes the hole band test out to where the
            # surface re-enters its tangent band — e.g. the matching phase of
            # the next hump of rolling terrain — and the adopted ring then
            # drags the recomputed model off its members (measured: in-band
            # fraction 0.82 with adoption ungated).  Healing targets (Morton-
            # partition holes in genuinely planar ground/roofs) have RMS ≈
            # noise.  r2 of a merged root about its own plane decomposes over
            # fragments by the parallel-axis rule — differences first, so no
            # mm-scale cancellation:
            #   r2_root · cnt = Σ_f [ nᵀM_f n + cnt_f ((c_f − c_root)·n)² ]
            cnt_r = acc[:, 0]
            sc_r = jnp.maximum(cnt_r, 1.0)[:, None]
            mn_r = acc[:, 1:4] / sc_r
            n_r = mn_r / jnp.sqrt(
                jnp.maximum(jnp.sum(mn_r * mn_r, -1, keepdims=True), 1e-20)
            )
            c_r = acc[:, 4:7] / sc_r
            nr_f = n_r[parent]  # [P, 3] small gathers
            cr_f = c_r[parent]
            r2n_f = (
                acc_m[:, 0] * nr_f[:, 0] * nr_f[:, 0]
                + acc_m[:, 1] * nr_f[:, 1] * nr_f[:, 1]
                + acc_m[:, 2] * nr_f[:, 2] * nr_f[:, 2]
                + 2.0 * acc_m[:, 3] * nr_f[:, 0] * nr_f[:, 1]
                + 2.0 * acc_m[:, 4] * nr_f[:, 0] * nr_f[:, 2]
                + 2.0 * acc_m[:, 5] * nr_f[:, 1] * nr_f[:, 2]
            )
            off_f = jnp.sum((c_t - cr_f) * nr_f, -1)
            flat_num = jnp.dot(
                onehot, r2n_f + cnt_o * off_f * off_f,
                preferred_element_type=jnp.float32, precision=hi_p,
            )
            flat_ok = flat_num / jnp.maximum(cnt_r, 1.0) <= (
                (0.25 * th_thickness) ** 2
            )

            # --- hole fill: adjacency-free adoption against the top-K merged
            # planes.  The window refine can never reach a hole whose sorted-
            # order borders jump to distant space (whole Morton segments lost
            # to compounding group-coherence attrition at deep levels) —
            # measured on the block scene at levels=3: 90% of the unlabeled
            # ground had NO labeled row within ±16 sorted rows, with perfect
            # normals, and extra refine sweeps moved coverage by +1%.  So
            # unlabeled points test directly against the merged plane table:
            # plane-band |p·n−b| ≤ th, normal cos, and in-plane proximity to
            # the plane's extent (2·rms + gate — the point form of the pair
            # test's reach) — ops/adopt.py.
            # ------------------------------------------------------------------
            K = min(128, max_planes)
            top_cnt, top_row = lax.top_k(acc[:, 0], K)
            sck = jnp.maximum(top_cnt, 1.0)[:, None]
            acc_k = acc[top_row]  # [K, 8] — small-table gather
            mnk = acc_k[:, 1:4] / sck
            nk = mnk / jnp.sqrt(
                jnp.maximum(jnp.sum(mnk * mnk, -1, keepdims=True), 1e-20)
            )
            ck = acc_k[:, 4:7] / sck
            ccdk = jnp.sum(ck * ck, -1)
            rk = jnp.sqrt(jnp.maximum(acc_k[:, 7] / sck[:, 0] - ccdk, 0.0))
            bk = jnp.sum(nk * ck, -1)
            holes = mask & (pid == 0)
            reachk = 2.0 * rk + jnp.float32(edge_mm)
            lane_ok = ((top_cnt > 0) & flat_ok[top_row]).astype(
                jnp.float32)  # only flat planes adopt (above)
            adopted, adopt_row, acc_add = plane_adopt(
                payload, holes, nk, ck, bk, ccdk, reachk * reachk,
                lane_ok, top_row, table_cap=max_planes,
                th_thickness=th_thickness, th_cos=th_normal_cos,
                signed=signed_normals,
            )
            acc = acc + _psum(acc_add)

    counts_old = acc[:, 0].astype(jnp.int32)  # by merged root row
    keep = counts_old > th_point_count
    rank = prefix_sum_i32(keep.astype(jnp.int32))  # inclusive, over rows
    num_planes = rank[max_planes - 1]

    # per-point renumber: new_id = lut[old id] → rank of the merged
    # root (0 where culled); adopted points go through the root-row lut
    lut_rows = jnp.where(
        keep[parent] & live_o, rank[parent], 0
    ).astype(jnp.float32)
    lut = jnp.concatenate([jnp.zeros((1,), jnp.float32), lut_rows])
    lut2 = jnp.concatenate([
        jnp.zeros((1,), jnp.float32),
        jnp.where(keep, rank, 0).astype(jnp.float32),
    ])
    pid_adopt = jnp.where(adopted, adopt_row + 1, 0)
    new_id = table_lookup(
        jnp.where(member, pid, 0), lut, lut.shape[0]
    ).astype(jnp.int32)
    if heal is True:
        # disjoint supports: members and adopted holes
        new_id = new_id + table_lookup(
            pid_adopt, lut2, lut2.shape[0]
        ).astype(jnp.int32)
    plane_idx = jnp.where(new_id > 0, new_id, -1).astype(jnp.int32)

    # dense table = kept merged-root rows permuted into rank order
    slot = jnp.where(keep, rank - 1, max_planes)
    old_of_new = (
        jnp.zeros((max_planes + 1,), jnp.int32)
        .at[slot]
        .set(jnp.arange(max_planes, dtype=jnp.int32))
    )[:max_planes]
    acc_new = acc[old_of_new]  # [max_planes, 8] — small-table gather
    valid_new = jnp.arange(max_planes) < num_planes
    cnt2 = jnp.where(valid_new, acc_new[:, 0].astype(jnp.int32), 0)
    sum_n2 = acc_new[:, 1:4]
    sum_p2 = acc_new[:, 4:7]
    sc = jnp.maximum(cnt2, 1).astype(jnp.float32)[:, None]
    mn2 = sum_n2 / sc
    ln2 = jnp.sqrt(jnp.maximum(jnp.sum(mn2 * mn2, -1, keepdims=True), 1e-20))
    live2 = (cnt2 > 0)[:, None]
    plane_normal = jnp.where(live2, mn2 / ln2, 0.0)
    plane_center = jnp.where(live2, sum_p2 / sc, 0.0)

    return SegmentationResult(
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normal=plane_normal,
        plane_center=plane_center,
        plane_count=cnt2,
        num_sweeps=coarse.num_sweeps,
        # capacity/convergence sanitizers propagate from the coarse
        # solve (the refine/finalize stages cannot create new labels,
        # so the coarse counters bound the whole hierarchy)
        diagnostics=coarse.diagnostics,
    )
