"""Planar region growing — parallel fixed-point label propagation.

Data-parallel re-expression of the reference's sequential recursive region
growing (``seg_plane::{get_planes, Broad}``, tmc3/my_function.cpp:
180-258).  The reference scans points in index order and grows one plane
at a time by DFS with an evolving mean plane model — O(n²), unbounded
recursion, order-dependent.  Here the same decomposition is computed as
a data-parallel fixed point:

1. **Seed gating** (the depth-0 strictness rule, my_function.cpp:238):
   point i is a seed iff ALL K−1 of its neighbors pass the membership
   test against i's own tangent plane (|(p_j−p_i)·n_i| ≤ th_thickness
   and n_i·n_j ≥ th_normal_cos).
2. **Model-anchored label propagation**: labels are seed point
   indices; each label carries a plane model — the mean normal and
   mean position of its current members, refreshed every round by
   segment reductions.  This is the reference's running-mean model
   (my_function.cpp:241-250) made parallel.  An unlabeled point adopts
   the minimum label among neighbors whose model accepts it
   (|(p−c̄_L)·n̄_L| ≤ th_thickness and n̄_L·n ≥ th_normal_cos).  Two
   properties matter: (a) anchoring to a region model — not a local
   pair test — stops labels chaining across gradually-curving corner
   blends, which would merge walls meeting at 90°; (b) the *mean*
   model — not the seed's single-point tangent plane — averages normal
   noise so a long wall stays inside its own thickness band.
   Propagation runs along forward edges (i pushes to neigh[i, 1:], the
   reference's growth direction, via scatter-min) and reverse edges
   (gather-min from the point's own list) until a fixed point.
3. **Seed claiming order**: minimum seed index wins a region — the
   parallel analog of the reference's first-in-scan-order seeding.
4. **Size culling**: planes keep their points only when the member
   count exceeds ``th_point_count`` (strict >, my_function.cpp:199).
5. **Dense renumbering**: surviving planes get ids 1..P in ascending
   seed order, matching the reference's dense id assignment in scan
   order (my_function.cpp:200-201).

Exact per-point parity with the sequential algorithm is impossible in
general (its output depends on scan order, DFS order and model drift —
SURVEY.md §2.1.1); on well-separated building planes the two agree, and
tests/test_region_grow.py measures that agreement against the golden
oracle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from buildingsegment_tpu.ops.normals import canonicalize_normals
from buildingsegment_tpu.ops.prefix import prefix_sum_i32
from buildingsegment_tpu.ops.window_sweep import (
    label_sweep,
    pad_positions,
    pad_rows,
    window_starts,
)

__all__ = ["segment_planes", "window_seeds", "SegmentationResult"]

# Jump-doubling rounds per sweep for the windowized path's merge-chain
# collapse.  Each round is a latency-bound [ng] gather; chains deeper
# than 2^rounds simply resolve one sweep later, and one sweep of
# window+global hooks does not build chains deeper than 4.  The fixed
# point itself is unchanged (min-label union is confluent).
_JUMP_ROUNDS = 2


@functools.partial(
    jax.jit,
    static_argnames=(
        "window", "signed_normals", "axis_name", "th_thickness",
        "th_normal_cos",
    ),
)
def window_seeds(
    positions: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    kth_sq_dist: jax.Array,
    *,
    window: int = 16,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    signed_normals: bool = False,
    axis_name: str = None,
) -> jax.Array:
    """Strict depth-0 seed rule over ±window slices, gather-free.

    The reference's rule ("every one of the k−1 nearest neighbors
    passes the plane test", tmc3/my_function.cpp:238) re-expressed on a
    Morton-sorted cloud: point i is a seed iff NO window candidate
    within its k-th-NN radius fails the test — identical to the graph
    formulation when the graph came from the same window, without the
    [N, K, 3] gathers.

    Args:
        positions: float/int [N, 3] Morton-sorted.
        normals: float32[N, 3].
        mask: bool[N].
        kth_sq_dist: float32[N] squared k-th NN distance (the ball).
        axis_name: shard_map mesh axis for halo-exchanged padding.

    Returns bool[N] seed mask.
    """
    n = positions.shape[0]
    pos = positions.astype(jnp.float32)
    nrm = normals.astype(jnp.float32)
    cmag = (lambda x: x) if signed_normals else jnp.abs
    ws = window

    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    nx_, ny_, nz_ = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    ppx, ppy, ppz, smask_p = pad_positions((px, py, pz), mask, ws, axis_name)
    pnx, pny, pnz = (pad_rows(a, 0.0, ws, axis_name) for a in (nx_, ny_, nz_))

    # fully unrolled static slices (fori+dynamic_slice is kernel-launch
    # bound — see ops/fused.py sweep comment)
    bad = jnp.zeros((n,), bool)
    for start in window_starts(ws):
        sl = lambda a: lax.slice(a, (start,), (start + n,))  # noqa: E731
        cmask_ = sl(smask_p)
        dx = sl(ppx) - px
        dy = sl(ppy) - py
        dz = sl(ppz) - pz
        d2 = dx * dx + dy * dy + dz * dz
        in_ball = (d2 <= kth_sq_dist) & cmask_ & mask
        pd = jnp.abs(dx * nx_ + dy * ny_ + dz * nz_)
        pc_ = cmag(sl(pnx) * nx_ + sl(pny) * ny_ + sl(pnz) * nz_)
        bad = bad | (
            in_ball & ~((pd <= th_thickness) & (pc_ >= th_normal_cos))
        )
    return mask & ~bad


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SegmentationResult:
    """Output of :func:`segment_planes`.

    Attributes:
        plane_idx: int32[N] — plane id per point, 1..num_planes, or −1.
        num_planes: int32 scalar — number of accepted planes P.
        plane_normal: float32[max_planes, 3] — mean unit normal per
            plane (row p−1 for plane id p); zero rows beyond P.
        plane_center: float32[max_planes, 3] — mean position per plane.
        plane_count: int32[max_planes] — member count per plane.
        diagnostics: int32[4] capacity/convergence sanitizer counters
            (SURVEY §5 / §7 hard part 3 — silently-deferred work must
            be visible):
              [0] peak live labels in any sweep;
              [1] peak live labels beyond the per-sweep merge-table
                  cap L (those labels' GLOBAL coplanar merges deferred
                  to later sweeps — window merges still apply);
              [2] surviving planes beyond ``max_planes`` (dropped from
                  the plane table and the output renumbering);
              [3] 1 if the solve stopped at ``max_sweeps`` with the
                  change count still above the convergence tolerance.
    """

    plane_idx: jax.Array
    num_planes: jax.Array
    plane_normal: jax.Array
    plane_center: jax.Array
    plane_count: jax.Array
    num_sweeps: jax.Array
    diagnostics: jax.Array


@functools.partial(
    jax.jit,
    static_argnames=(
        "th_point_count", "max_planes", "max_sweeps", "signed_normals",
        "propagation", "window", "convergence_tol", "axis_name",
        "th_thickness", "th_normal_cos", "max_edge_dist",
        "th_anchor_cos",
    ),
)
def segment_planes(
    positions: jax.Array,
    normals: jax.Array,
    neigh_idx: jax.Array,
    mask: jax.Array,
    *,
    neigh_sq_dist: Optional[jax.Array] = None,
    max_edge_dist: Optional[float] = None,
    seed_override: Optional[jax.Array] = None,
    curvature: Optional[jax.Array] = None,
    th_seed_curvature: Optional[float] = None,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    th_point_count: int = 400,
    max_planes: int = 4096,
    max_sweeps: int = 64,
    convergence_tol: float = 0.0,
    signed_normals: bool = False,
    propagation: str = "graph",
    window: int = 16,
    th_anchor_cos: float = 0.95,
    axis_name: str = None,
) -> SegmentationResult:
    """Segment a point cloud into planar regions.

    ``th_anchor_cos`` — anchor-pure model estimation: a member
    contributes to its region's mean normal/center only when its normal
    agrees with the region *seed*'s normal (the anchor) by at least
    this cosine.  Without it, the running mean drifts through smooth
    normal-blend strips (e.g. the ~2×r_normal-wide band along a roof
    ridge, where PCA neighborhoods mix both pitches) until the model
    accepts BOTH sides of a dihedral that the pairwise cos test would
    reject — the reference's running-mean model
    (tmc3/my_function.cpp:241-250) has exactly this failure mode.
    Membership/acceptance tests are unchanged; only the estimator is
    robustified.  Set ≤ th_normal_cos to disable (every member then
    passes the gate).

    Args:
        positions: int32[N, 3] bbox-shifted quantized coords.
        normals: float32[N, 3] unit normals (oriented).
        neigh_idx: int32[N, K] kNN graph, self at slot 0.
        mask: bool[N] validity.
        axis_name: when running inside ``shard_map`` over Morton-range
            point shards, the mesh axis.  The label space becomes
            global: per-label statistics become a psum'd table, the
            merge parent a pmin'd table, and the ±window slice sweeps
            read ppermute-exchanged halo rows (SURVEY.md §2.5's
            collective label resolution).  Requires
            ``propagation="window"`` and an explicit ``seed_override``
            (the gather-based kNN-graph seed rule does not shard; use
            :func:`window_seeds`).

    Returns:
        :class:`SegmentationResult` — ``plane_idx`` is shard-local when
        sharded; the plane table and ``num_planes`` are replicated.
    """
    n, k = neigh_idx.shape
    pos = positions.astype(jnp.float32)
    nrm = normals.astype(jnp.float32)

    if axis_name is not None:
        if propagation != "window" or seed_override is None:
            raise ValueError(
                "sharded segment_planes requires propagation='window' "
                "and seed_override (see window_seeds)"
            )
        num_shards = lax.axis_size(axis_name)
        ng = n * num_shards  # global label space
        base = lax.axis_index(axis_name).astype(jnp.int32) * n
    else:
        ng = n
        base = jnp.int32(0)
    inf_label = jnp.int32(ng)

    def _allreduce(x, kind):
        if axis_name is None:
            return x
        return (
            lax.psum(x, axis_name) if kind == "sum" else lax.pmin(x, axis_name)
        )
    # Orientation handling: the reference's signed cos test inherits the
    # ±Z orientation pathology on vertical walls (n_z ≈ ±noise flips
    # signs at random, splitting every wall into two anti-parallel
    # populations).  By default we treat normals as unsigned lines:
    # |cos| in every test, hemisphere-canonicalized normals in model
    # means.  ``signed_normals=True`` restores strict reference
    # semantics (useful for parity runs against the golden oracle).
    if signed_normals:
        cmag = lambda x: x
        sum_nrm_src = nrm
    else:
        cmag = jnp.abs
        sum_nrm_src = canonicalize_normals(nrm)

    # the kNN-graph machinery gathers [N, K-1] neighbor rows; the
    # windowized path with caller-supplied seeds never touches it
    need_graph = propagation != "window" or seed_override is None
    if need_graph:
        nb = neigh_idx[:, 1:]  # [N, K-1] real neighbor slots
        nb_pos = pos[nb]  # [N, K-1, 3]
        nb_nrm = nrm[nb]
        nb_valid = mask[nb] & mask[:, None] & (nb != jnp.arange(n)[:, None])
        # Approximate (Morton-window) graphs can contain long edges across
        # Z-order discontinuities; a long edge between two coplanar-but-
        # distant patches would bridge regions the reference's true-kNN
        # edges never connect.  Gate edges by Euclidean length when the
        # caller provides distances (true kNN edges are implicitly short).
        if neigh_sq_dist is not None and max_edge_dist is not None:
            nb_valid = nb_valid & (
                neigh_sq_dist[:, 1:] <= jnp.float32(max_edge_dist) ** 2
            )

        # membership test of neighbor j against i's tangent plane
        dist = jnp.abs(jnp.einsum("nkd,nd->nk", nb_pos - pos[:, None, :], nrm, precision=lax.Precision.HIGHEST))
        cos = cmag(jnp.einsum("nkd,nd->nk", nb_nrm, nrm, precision=lax.Precision.HIGHEST))
        fwd_ok = (dist <= th_thickness) & (cos >= th_normal_cos) & nb_valid

    # 1. seed gating: ALL K-1 neighbors pass (depth-0 rule); optionally
    # also require low surface variation (the BASELINE north star's
    # "curvature-gated seeds" — the reference's all-neighbors rule is an
    # implicit planarity gate; an explicit curvature cap is cheaper and
    # steadier on noisy scans)
    if seed_override is not None:
        # caller-supplied seed mask (the multigrid coarse level derives
        # seeds from the fine-level rule instead of a coarse graph)
        seed = seed_override & mask
    else:
        seed = jnp.all(fwd_ok, axis=1) & mask
    if curvature is not None and th_seed_curvature is not None:
        seed = seed & (curvature <= jnp.float32(th_seed_curvature))

    # Labels live in the GLOBAL index space [0, ng); idx_arange spans it
    # (replicated when sharded), gid are the local rows' global ids.
    idx_arange = jnp.arange(ng, dtype=jnp.int32)
    gid = base + jnp.arange(n, dtype=jnp.int32)

    # Anchor table: row r of the (global) label space holds the seed
    # normal of label r — fixed for the whole solve, defined even after
    # row r itself adopts a smaller label.  Purity gate for model sums:
    # a member contributes to its label's model only when its normal
    # agrees with the anchor by ≥ th_anchor_cos (see docstring).
    anchor_gate = th_anchor_cos > th_normal_cos
    if not anchor_gate:
        anchor_tab = None  # disabled: stats stay 8-col, no purity gather
    elif axis_name is None:
        anchor_tab = jnp.where(seed[:, None], sum_nrm_src, 0.0)  # [ng, 3]
    else:
        # sharded: one-time global scatter + psum (each gid row is
        # written by exactly one shard; others contribute zeros)
        anchor_tab = _allreduce(
            jnp.zeros((ng + 1, 3), jnp.float32)
            .at[jnp.where(seed, gid, ng)]
            .add(jnp.where(seed[:, None], sum_nrm_src, 0.0))[:ng],
            "sum",
        )

    def purity(label):
        """bool[n]: member's normal agrees with its label's anchor."""
        if not anchor_gate:
            return label < inf_label
        anc = anchor_tab[jnp.clip(label, 0, ng - 1)]
        agree = cmag(jnp.sum(sum_nrm_src * anc, axis=-1))
        return (label < inf_label) & (agree >= jnp.float32(th_anchor_cos))

    # Label-invariant payload columns, assembled ONCE (loop bodies only
    # mask them): [cnt, Σn̂, Σp, Σ|p|²]
    _sq1 = jnp.sum(pos * pos, -1, keepdims=True)
    _payload8_sq = jnp.concatenate(
        [jnp.ones((n, 1), jnp.float32), sum_nrm_src, pos, _sq1], axis=1
    )
    _payload8 = jnp.concatenate(
        [jnp.ones((n, 1), jnp.float32), sum_nrm_src, pos,
         jnp.zeros((n, 1), jnp.float32)], axis=1
    )

    def stats_payload(label, valid, with_sq):
        """Per-point scatter payload for the per-label stats table.

        8 all-member columns [cnt, Σn̂, Σp, Σ|p|²] when the anchor gate
        is off; 16 (all-member + anchor-pure in the same layout) when
        on — one combined scatter either way (each XLA scatter-add
        hides a full sort of its update rows).
        """
        base = _payload8_sq if with_sq else _payload8
        if anchor_gate:
            wp = purity(label).astype(jnp.float32)[:, None]
            payload = jnp.concatenate([base, base * wp], axis=1)
        else:
            payload = base
        return jnp.where(valid[:, None], payload, 0.0)

    # 2. seed-anchored label propagation to a fixed point.
    # label[i] ∈ {seed indices} ∪ {inf}; acceptance of point t into
    # region L tests t against the seed plane (pos[L], nrm[L]).
    label0 = jnp.where(seed, gid, inf_label)

    def label_models(label):
        """Per-label mean plane model via segment reductions.

        Returns (model_normal f32[n,3] unit, model_center f32[n,3]),
        indexed by label value (= seed index); rows of unused labels
        are never gathered.  Anchor-pure sums with all-member fallback
        (see ``th_anchor_cos`` / ``acc_models``).
        """
        valid = label < inf_label
        tgt = jnp.where(valid, label, n)
        payload = stats_payload(label, valid, with_sq=False)
        acc = (
            jnp.zeros((n + 1, payload.shape[1]), jnp.float32)
            .at[tgt]
            .add(payload)
        )[:n]
        model_n, model_c, _r, _cnt = acc_models(acc)
        return model_n, model_c

    def make_accepts(model_n, model_c):
        def accepts(target_pos, target_nrm, lbl):
            """Does the model of label `lbl` accept a point?"""
            safe = jnp.clip(lbl, 0, n - 1)
            sp = model_c[safe]
            sn = model_n[safe]
            d = jnp.abs(jnp.sum((target_pos - sp) * sn, axis=-1))
            c = cmag(jnp.sum(target_nrm * sn, axis=-1))
            return (lbl < inf_label) & (d <= th_thickness) & (c >= th_normal_cos)

        return accepts

    def one_hop(label, accepts):
        # reverse edges (gather): t adopts labels of its own neighbors
        nb_label = label[nb]  # [N, K-1]
        ok = accepts(pos[:, None, :], nrm[:, None, :], nb_label) & nb_valid
        cand = jnp.where(ok, nb_label, inf_label)
        new = jnp.minimum(label, jnp.min(cand, axis=1))
        # forward edges (scatter): i pushes its label to neigh[i, 1:]
        # — the reference's growth direction (my_function.cpp:224-236)
        push_ok = accepts(
            nb_pos, nb_nrm, jnp.broadcast_to(label[:, None], nb.shape)
        ) & nb_valid
        push = jnp.where(push_ok, jnp.broadcast_to(label[:, None], nb.shape), inf_label)
        scat = (
            jnp.full((n + 1,), inf_label, jnp.int32)
            .at[jnp.where(push_ok, nb, n)]
            .min(push)
        )[:n]
        return jnp.minimum(new, scat)

    def global_merge(label):
        """Union coplanar overlapping regions via a compact pair table.

        Approximate (Morton-window) graphs lose edges at Z-order tile
        boundaries, so one physical plane can fragment into many
        regions that are never graph-adjacent.  This pass is
        graph-free: compact the top ``max_planes`` labels by size into
        a table of (count, centroid, mean normal, RMS radius), test
        every pair for mutual coplanarity (both centroids inside the
        other's thickness band, normals within the cos threshold) AND
        in-plane overlap (in-plane centroid separation ≤ slack ×
        (r_a + r_b)), and hook each region to its minimum coplanar
        partner.  Pointer jumping collapses chains; the outer loop
        iterates, so transitive merges across a long wall of tiles
        converge geometrically.  The in-plane overlap bound keeps
        coplanar-but-distant patches (separate buildings) apart —
        the true-kNN reference graph would not connect those either.
        """
        L = min(max_planes, n)
        valid = label < inf_label
        tgt = jnp.where(valid, label, n)
        payload = stats_payload(label, valid, with_sq=True)
        acc16 = (
            jnp.zeros((n + 1, payload.shape[1]), jnp.float32)
            .at[tgt]
            .add(payload)
        )[:n]
        cnt = acc16[:, 0]

        # Compact live labels into [L] slots by cumsum rank — top_k
        # with a large k lowers to a full sort, so compaction stays
        # sort-free.  Labels beyond L
        # (massive over-fragmentation) fall off; the outer loop's next
        # iteration retries after earlier merges shrink the count.
        flag = cnt > 0
        rank = prefix_sum_i32(flag.astype(jnp.int32))  # inclusive
        slot = jnp.where(flag & (rank <= L), rank - 1, L)
        # one scatter: -1 sentinel doubles as the liveness mask
        top_lab = (
            jnp.full((L + 1,), -1, jnp.int32).at[slot].set(idx_arange)
        )[:L]
        live = top_lab >= 0
        top_lab = jnp.maximum(top_lab, 0)
        # anchor-pure models (all-member fallback), RMS radius included
        mn, c, r, _cnt_a = acc_models(acc16[top_lab])

        # pair tests as [L,3]×[3,L] matmuls — never materialize [L,L,3]
        nc = jnp.sum(mn * c, -1)  # n_a · c_a
        ncT = jnp.dot(mn, c.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
        # (c_b - c_a) · n_a  and  (c_b - c_a) · n_b
        nrm_sep = ncT - nc[:, None]          # [L, L] rows a, cols b
        nrm_sep_b = nc[None, :] - ncT.T      # (c_b - c_a)·n_b
        band_a = jnp.abs(nrm_sep) <= th_thickness
        band_b = jnp.abs(nrm_sep_b) <= th_thickness
        cos_ab = (
            cmag(jnp.dot(mn, mn.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST))
            >= th_normal_cos
        )
        cc = jnp.sum(c * c, -1)
        # HIGHEST is mandatory: bf16 on mm-scale centroids puts ~4e7 mm²
        # of noise on d2 vs a reach² bound of ~3.6e5 (CLAUDE.md)
        d2 = cc[:, None] + cc[None, :] - 2.0 * jnp.dot(
            c, c.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        inplane2 = jnp.maximum(d2 - nrm_sep * nrm_sep, 0.0)
        # absolute term: regions within one edge-gate length merge even
        # when small (singleton seed regions have r = 0)
        slack = jnp.float32(2.0)
        reach = slack * (r[:, None] + r[None, :]) + jnp.sqrt(edge_gate2)
        overlap = inplane2 <= reach * reach
        ok = (
            band_a
            & band_b
            & cos_ab
            & overlap
            & live[:, None]
            & live[None, :]
        )

        la = jnp.broadcast_to(top_lab[:, None], (L, L))
        lb = jnp.broadcast_to(top_lab[None, :], (L, L))
        pair_lo = jnp.where(ok & (la != lb), jnp.minimum(la, lb), inf_label)
        # hook each region to its min coplanar partner (row reduction)
        row_min = jnp.min(pair_lo, axis=1)  # [L]
        parent = (
            jnp.concatenate([idx_arange, jnp.array([inf_label])])
            .at[jnp.where(row_min < inf_label, top_lab, n)]
            .min(jnp.where(row_min < inf_label, row_min, inf_label))
        )[:n]

        # statically unrolled jump-doubling (each fori step is a
        # separate latency-bound gather kernel; unrolling halves it)
        for _ in range(12):
            parent = jnp.minimum(parent, parent[jnp.clip(parent, 0, n - 1)])
        live_cnt = rank[n - 1]
        return (
            jnp.where(
                label < inf_label, parent[jnp.clip(label, 0, n - 1)], label
            ),
            live_cnt,
            jnp.maximum(live_cnt - L, 0),
        )

    def merge_labels(label, accepts, model_n, model_c):
        """Union adjacent territories whose seed planes mutually accept.

        One-hop flooding needs O(plane diameter) sweeps; because
        acceptance is path-independent, two territories of the same
        physical plane can instead be merged wholesale: for every graph
        edge whose endpoints carry different labels, if each seed point
        is accepted by the other seed's plane, the larger label is
        re-pointed at the smaller.  Pointer jumping collapses merge
        chains in O(log) steps — this is the Shiloach-Vishkin-style
        shortcut that makes convergence diameter-independent
        (SURVEY.md §7 hard part 5).  Seed mutual acceptance is safe
        against corner chaining: corner-blend points can never be
        strict seeds.
        """
        la = jnp.broadcast_to(label[:, None], nb.shape)
        lb = label[nb]
        pair = (la < inf_label) & (lb < inf_label) & (la != lb) & nb_valid
        sa = jnp.clip(la, 0, n - 1)
        sb = jnp.clip(lb, 0, n - 1)
        ok = (
            pair
            & accepts(model_c[sb], model_n[sb], la)
            & accepts(model_c[sa], model_n[sa], lb)
        )
        lo = jnp.minimum(la, lb)
        hi = jnp.maximum(la, lb)
        parent = (
            jnp.concatenate([idx_arange, jnp.array([inf_label])])
            .at[jnp.where(ok, hi, n)]
            .min(jnp.where(ok, lo, inf_label))
        )[:n]

        # statically unrolled jump-doubling (each fori step is a
        # separate latency-bound gather kernel; unrolling halves it)
        for _ in range(12):
            parent = jnp.minimum(parent, parent[jnp.clip(parent, 0, n - 1)])
        return jnp.where(
            label < inf_label, parent[jnp.clip(label, 0, n - 1)], label
        )

    # ------------------------------------------------------------------
    # windowized propagation (requires Morton-sorted input): edges are
    # "within ±window in sorted order AND within max_edge_dist" — every
    # neighbor access is a contiguous shifted slice, no [N, K] gathers
    # (ops/window_sweep.py).
    # ------------------------------------------------------------------
    ws = window
    edge_gate2 = jnp.float32(
        (max_edge_dist if max_edge_dist is not None else 2 * th_thickness) ** 2
    )
    # 1-D component rows (see ops/window_sweep.py), positions padded
    # once per solve
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    nx_, ny_, nz_ = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    padded = pad_positions((px, py, pz), mask, ws, axis_name)

    # Per-sweep global-merge table capacity.  Capped independently of
    # max_planes (the OUTPUT capacity): the [L, L] pair tests cost
    # ~L²·40 B of traffic per sweep, and labels beyond the cap simply
    # defer their global merge to a later sweep once window merges have
    # collapsed the live count (the cumsum-rank compaction keeps the
    # lowest labels, which win merges anyway).
    L = min(max_planes, ng, 1024)

    def acc_models(rows):
        """(unit normal, center, rms radius, cnt_all) from stats rows.

        Columns 0-7 are all-member sums [cnt, Σn̂, Σp, Σ|p|²]; 16-col
        rows add the anchor-pure sums in the same layout.  Models come
        from the pure sums (see ``th_anchor_cos``), falling back to the
        all-member sums for labels whose pure count is zero (possible
        once a seed row has itself adopted a smaller label).  8-col
        rows (anchor gate off) use the all-member sums directly.
        """
        cnt_a = rows[..., 0]
        if rows.shape[-1] == 8:
            sc = jnp.maximum(cnt_a, 1.0)[..., None]
            sn = rows[..., 1:4] / sc
            c = rows[..., 4:7] / sc
            sq = rows[..., 7] / sc[..., 0]
        else:
            cnt_p = rows[..., 8]
            usep = cnt_p > 0
            sc = jnp.where(usep, cnt_p, jnp.maximum(cnt_a, 1.0))[..., None]
            sn = jnp.where(usep[..., None], rows[..., 9:12], rows[..., 1:4]) / sc
            c = jnp.where(usep[..., None], rows[..., 12:15], rows[..., 4:7]) / sc
            sq = jnp.where(usep, rows[..., 15], rows[..., 7]) / sc[..., 0]
        ln = jnp.sqrt(jnp.maximum(jnp.sum(sn * sn, -1, keepdims=True), 1e-20))
        r = jnp.sqrt(jnp.maximum(sq - jnp.sum(c * c, -1), 0.0))
        return sn / ln, c, r, cnt_a

    def window_body(label):
        """One fused iteration of windowized region growing.

        Engineering shape (every cost center gets exactly one instance
        per iteration):
          1. per-label stats via ONE combined [N,16] scatter-add — XLA
             lowers each scatter-add to a hidden sort, so the all-member
             and anchor-pure [cnt, Σn̂, Σp, Σ|p|²] sums share a single
             scatter;
          2. live labels compacted to [L] slots by cumsum rank (the
             scatter-free replacement for top_k);
          3. one slice sweep over ±window offsets computing BOTH the
             min-label hop and the merge-hook candidates;
          4. merge hooks (window + global coplanar-overlap pairs)
             resolved by jump-doubling in the COMPACT [L] space —
             [L]-sized gathers are free, unlike [N]-sized pointer
             chasing;
          5. one [N] gather applies the collapsed parents.
        """
        valid = label < inf_label

        tgt = jnp.where(valid, label, ng)

        # 1. combined segment stats over the global label space —
        # per-shard partial scatters, one psum
        payload = stats_payload(label, valid, with_sq=True)
        acc = (
            jnp.zeros((ng + 1, payload.shape[1]), jnp.float32)
            .at[tgt]
            .add(payload)
        )[:ng]
        acc = _allreduce(acc, "sum")
        model_n, model_c, _model_r, cnt = acc_models(acc)
        flag = cnt > 0

        # 2. compact live labels → [L] slots (cumsum rank, no sort) —
        # replicated compute over the (replicated) stats table.  ONE
        # scatter: every slot < L written comes from a live label, so
        # the -1 sentinel doubles as the liveness mask (each scatter
        # hides a sort of its update rows).
        rank = prefix_sum_i32(flag.astype(jnp.int32))
        slot_of = jnp.where(flag & (rank <= L), rank - 1, L)  # [ng] by label
        top_lab = (
            jnp.full((L + 1,), -1, jnp.int32).at[slot_of].set(idx_arange)
        )[:L]
        live = top_lab >= 0
        top_lab = jnp.maximum(top_lab, 0)

        # 3. slice sweep: hop-min + merge-hook candidates.  ONE packed
        # [ng, 6] model gather (two [ng, 3] gathers would pay the
        # per-gather fixed cost twice)
        safe = jnp.clip(label, 0, ng - 1)
        model_nc = jnp.concatenate([model_n, model_c], axis=1)
        mp = jnp.where(valid[:, None], model_nc[safe], 0.0)
        new, best = label_sweep(
            (px, py, pz), (nx_, ny_, nz_), mask, label, mp, padded,
            window=ws, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, edge_gate2=edge_gate2,
            inf_label=inf_label, signed=signed_normals,
            axis_name=axis_name,
        )

        # 4b. global coplanar-overlap pairs on the compact table
        # (anchor-pure models via the shared 16-col derivation)
        n_tab, c_tab, r_tab, _cnt_tab = acc_models(acc[top_lab])
        nc = jnp.sum(n_tab * c_tab, -1)
        ncT = jnp.dot(n_tab, c_tab.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
        nrm_sep = ncT - nc[:, None]
        nrm_sep_b = nc[None, :] - ncT.T
        cosab = cmag(
            jnp.dot(n_tab, n_tab.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
        )
        ccd = jnp.sum(c_tab * c_tab, -1)
        # HIGHEST is mandatory here too (same mm-scale cancellation)
        d2 = ccd[:, None] + ccd[None, :] - 2.0 * jnp.dot(
            c_tab, c_tab.T, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        inplane2 = jnp.maximum(d2 - nrm_sep * nrm_sep, 0.0)
        reach = 2.0 * (r_tab[:, None] + r_tab[None, :]) + jnp.sqrt(edge_gate2)
        ok_pair = (
            (jnp.abs(nrm_sep) <= th_thickness)
            & (jnp.abs(nrm_sep_b) <= th_thickness)
            & (cosab >= th_normal_cos)
            & (inplane2 <= reach * reach)
            & live[:, None]
            & live[None, :]
        )
        la = jnp.broadcast_to(top_lab[:, None], (L, L))
        lb = jnp.broadcast_to(top_lab[None, :], (L, L))
        pair_lo = jnp.where(
            ok_pair & (la != lb), jnp.minimum(la, lb), inf_label
        )
        row_min = jnp.min(pair_lo, axis=1)  # [L]

        # 4a+4b. ONE combined scatter-min hooks both merge kinds:
        # window hooks (per-shard partial; resolved by the pmin) and
        # global pairs (replicated — identical on every shard, so the
        # pmin is a no-op on those rows).  Each scatter hides a sort of
        # its update rows; merging halves that per-sweep cost.
        idx_cat = jnp.concatenate([
            jnp.where(best < inf_label, label, ng),
            jnp.where(row_min < inf_label, top_lab, ng),
        ])
        val_cat = jnp.concatenate([best, row_min])
        parent = (
            jnp.concatenate([idx_arange, jnp.array([inf_label])])
            .at[idx_cat]
            .min(val_cat)
        )[:ng]
        parent = _allreduce(parent, "min")

        # 4c. collapse merge chains by jump-doubling over the FULL [ng]
        # label space (replicated when sharded — the table is already
        # globally consistent after the pmin).  (A compact [L]-space
        # collapse is cheaper per round but early iterations have ~N
        # live singleton labels, so capping participation at L slows
        # convergence from ~8 to ~25 iterations — a net loss.)
        # statically unrolled jump-doubling: 6 rounds collapse chains
        # up to 2^6 = 64 merges deep per sweep (far beyond what one
        # sweep of window+global hooks creates; the outer while_loop
        # finishes any residue next sweep)
        parent_final = parent
        for _ in range(_JUMP_ROUNDS):
            parent_final = jnp.minimum(
                parent_final, parent_final[jnp.clip(parent_final, 0, ng - 1)]
            )

        # 5. apply: one [N] gather
        live_cnt = rank[ng - 1]
        return (
            jnp.where(
                new < inf_label,
                parent_final[jnp.clip(new, 0, ng - 1)],
                new,
            ),
            live_cnt,
            jnp.maximum(live_cnt - L, 0),
        )

    # convergence by change-count tolerance: the final sweeps of an
    # exact fixed point only relabel a handful of stragglers (which
    # end up culled or absorbed either way) at full per-sweep cost.
    # The change count is summed across shards so every shard takes
    # the same number of sweeps (while_loop must stay collective).
    tol_count = jnp.int32(max(1, int(convergence_tol * ng)))

    def body(state):
        label, _, it, peak_live, peak_over = state
        if propagation == "window":
            new, live, over = window_body(label)
        else:
            model_n, model_c = label_models(label)
            accepts = make_accepts(model_n, model_c)
            new = label
            for _ in range(4):
                new = one_hop(new, accepts)
            new = merge_labels(new, accepts, model_n, model_c)
            new, live, over = global_merge(new)
        n_changed = _allreduce(
            jnp.sum((new != label).astype(jnp.int32)), "sum"
        )
        return (
            new, n_changed >= tol_count, it + 1,
            jnp.maximum(peak_live, live), jnp.maximum(peak_over, over),
        )

    def cond(state):
        _, changed, it, _, _ = state
        return changed & (it < max_sweeps)

    label, unconverged, sweeps_used, peak_live, peak_over = lax.while_loop(
        cond, body,
        (label0, jnp.bool_(True), jnp.int32(0), jnp.int32(0), jnp.int32(0)),
    )
    label = jnp.where(mask, label, inf_label)

    # 5. cull small planes (strict >, my_function.cpp:199) — counts are
    # global (psum over shards)
    ones = (label < inf_label).astype(jnp.int32)
    counts = jnp.zeros((ng + 1,), jnp.int32).at[jnp.minimum(label, ng)].add(ones)
    counts = _allreduce(counts, "sum")
    surviving = counts[:ng] > th_point_count  # indexed by seed label
    keep = (label < inf_label) & surviving[jnp.clip(label, 0, ng - 1)]
    label = jnp.where(keep, label, inf_label)

    # 6. dense renumber in ascending seed order → ids 1..P
    # (counts[s] > th implies s was used as a label, so `surviving`
    # already identifies exactly the surviving seed labels)
    is_plane_seed = surviving
    rank = prefix_sum_i32(is_plane_seed.astype(jnp.int32))  # inclusive
    plane_id = jnp.where(
        label < inf_label, rank[jnp.clip(label, 0, ng - 1)], 0
    ).astype(jnp.int32)
    plane_idx = jnp.where(plane_id > 0, plane_id, -1)
    num_planes = jnp.sum(is_plane_seed.astype(jnp.int32))

    # plane table (segment means) — fixed capacity max_planes,
    # psum-combined across shards when sharded.  Anchor-pure means with
    # all-member fallback, same as the sweep models: the table feeds
    # the multigrid refinement's band tests, so a drift-contaminated
    # mean here would re-introduce the very bias the sweeps avoided.
    seg = jnp.where(plane_id > 0, plane_id - 1, max_planes)  # [N]
    fin_payload = stats_payload(label, plane_id > 0, with_sq=False)
    acc_fin = _allreduce(
        jnp.zeros((max_planes + 1, fin_payload.shape[1]), jnp.float32)
        .at[seg]
        .add(fin_payload)[:max_planes],
        "sum",
    )
    plane_normal, plane_center, _r_fin, cnt_f = acc_models(acc_fin)
    cnt = cnt_f.astype(jnp.int32)
    plane_normal = jnp.where((cnt > 0)[:, None], plane_normal, 0.0)
    plane_center = jnp.where((cnt > 0)[:, None], plane_center, 0.0)

    diagnostics = jnp.stack(
        [
            peak_live,
            peak_over,
            jnp.maximum(num_planes - max_planes, 0),
            unconverged.astype(jnp.int32),
        ]
    )

    return SegmentationResult(
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normal=plane_normal,
        plane_center=plane_center,
        plane_count=cnt,
        num_sweeps=sweeps_used,
        diagnostics=diagnostics,
    )
