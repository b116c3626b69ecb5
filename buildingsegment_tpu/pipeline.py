"""End-to-end segmentation pipeline.

The device-pipeline equivalent of the reference's ``main()``
(tmc3/TMC3.cpp:202-229):

    read PLY (×1000 → integer mm)          ply::read, TMC3.cpp:208
    → bbox shift to origin                 buildingSeg ctor, TMC3.cpp:55-79
    → kNN graph + normals                  get_Normal_and_K_neighbor, TMC3.cpp:215
    → region-growing plane segmentation    seg_plane::get_planes, TMC3.cpp:217
    → per-plane random colors              set_plane_color, TMC3.cpp:218
    → write labeled binary PLY             ply::write, TMC3.cpp:221

Host I/O at the edges; one jitted device program in the middle (kNN →
normals → segmentation fuse under a single jit).  The written cloud is
the *shifted* one — the reference's ``buildingSeg`` constructor mutates
the caller's cloud in place (TMC3.cpp:70-72), so the output PLY contains
origin-shifted coordinates; we reproduce that contract.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from buildingsegment_tpu.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu.core.pointset import PointBatch
from buildingsegment_tpu.core.morton import morton_sort, unsort_labels
from buildingsegment_tpu.core.quantize import shift_to_origin
from buildingsegment_tpu.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu.ops.knn import knn
from buildingsegment_tpu.ops.normals import estimate_normals
from buildingsegment_tpu.seg.colorize import colorize_planes
from buildingsegment_tpu.seg.coarse import segment_planes_multigrid
from buildingsegment_tpu.seg.region_grow import SegmentationResult, segment_planes

__all__ = [
    "PipelineOutput",
    "run_device_pipeline",
    "resolve_knn_method",
    "segment_cloud",
    "segment_file",
]


def resolve_knn_method(config: PipelineConfig, capacity: int) -> str:
    """Resolve 'auto' to a concrete kNN method.

    Small clouds (≤ knn_auto_threshold) use exact XLA brute force;
    larger ones the Morton-window search.
    """
    if config.knn_method != "auto":
        return config.knn_method
    return "brute" if capacity <= config.knn_auto_threshold else "window"


@dataclasses.dataclass
class PipelineOutput:
    """Host-side results of one pipeline run."""

    cloud: HostPointCloud          # shifted positions + label colors
    plane_idx: np.ndarray          # int32[N] (1..P or -1), input order
    num_planes: int
    plane_normals: np.ndarray      # float32[P, 3]
    plane_centers: np.ndarray      # float32[P, 3]
    plane_counts: np.ndarray       # int32[P]
    bbox_min: np.ndarray           # int32[3] original-cloud bbox min
    timings: dict                  # stage → seconds
    diagnostics: dict = dataclasses.field(default_factory=dict)
    # capacity/convergence sanitizer counters (SegmentationResult
    # .diagnostics surfaced by name): peak_live_labels,
    # labels_over_merge_cap, planes_over_capacity, hit_max_sweeps
    # device-resident shifted positions + mask (capacity-padded) so the
    # ortho render can reuse them instead of re-uploading 12 MB/scan
    # through the host↔device link; None when the batch is gone
    device_shifted: Optional[jax.Array] = None
    device_mask: Optional[jax.Array] = None


@functools.partial(
    jax.jit,
    static_argnames=(
        "knn_k", "normal_radius", "normal_max_nn", "knn_window_size",
        "use_stats", "morton_small",
    ),
)
def _window_stage1(
    positions, mask, *, knn_k, normal_radius, normal_max_nn,
    knn_window_size, use_stats, morton_small=False,
):
    """Window-path stage 1: shift → Morton sort → neighborhood stats.

    Morton-sort once (multi-operand sort carrying the code words — no
    argsort-then-gather) and stay in the sorted frame: every neighbor
    access downstream is a contiguous slice instead of a (slow) XLA
    gather.
    """
    shifted, lo, _hi = shift_to_origin(positions, mask)
    spos, smask, order = morton_sort(shifted, mask, morton_small)
    sposf = spos.astype(jnp.float32)
    if use_stats:
        # production: the multigrid solver consumes only the k-th-NN
        # distance (the seed ball), never the sorted neighbor lists —
        # the stats sweep computes exactly that (ops/stats_sweep.py)
        from buildingsegment_tpu.ops.stats_sweep import (
            knn_normals_window_stats,
        )

        stats = knn_normals_window_stats(
            sposf, smask, k=knn_k, window=knn_window_size,
            radius=normal_radius, max_nn=normal_max_nn,
        )
    else:
        # fused sweep: kNN candidates and normal moments share the
        # same ±W slices — one pass instead of two
        stats = knn_normals_window_sorted(
            sposf, smask, k=max(knn_k, 16), window=knn_window_size,
            radius=normal_radius, max_nn=normal_max_nn,
        )
    return shifted, lo, spos, smask, order, stats


@functools.partial(
    jax.jit,
    static_argnames=(
        "knn_k", "th_thickness", "th_normal_cos", "th_point_count",
        "max_planes", "max_sweeps", "signed_normals",
        "th_seed_curvature", "convergence_tol", "seg_group",
        "seg_levels", "seg_refine_sweeps", "seg_anchor_cos", "use_stats",
        "seg_seed_source", "spacing_hint_mm",
    ),
)
def _window_stage2(
    spos, smask, order, stats, *, knn_k, th_thickness, th_normal_cos,
    th_point_count, max_planes, max_sweeps, signed_normals,
    th_seed_curvature, convergence_tol, seg_group, seg_levels,
    seg_refine_sweeps, use_stats, seg_anchor_cos=None,
    seg_seed_source=None, spacing_hint_mm=None,
):
    """Window-path stage 2: region growing + unsort.

    A separate XLA program from stage 1 ON PURPOSE: one program for the
    whole pipeline schedules worse than the identical ops split here,
    and the boundary only materializes [N]-sized buffers.  The split is
    also what lets chip_smoke.py time the two stages apart.
    """
    # fine-level edge gate: the reference's kNN edges reach ~2-3
    # spacings at ANY density (no distance cap, my_function.cpp:224),
    # so with a proven density hint the gate widens past 2·thickness
    # on sparse scans instead of starving connectivity
    edge0 = 2.0 * th_thickness
    if spacing_hint_mm is not None:
        edge0 = max(edge0, 3.0 * spacing_hint_mm)
    seg_kwargs = dict(
        max_edge_dist=edge0,
        th_seed_curvature=th_seed_curvature,
        th_thickness=th_thickness,
        th_normal_cos=th_normal_cos,
        th_point_count=th_point_count,
        max_planes=max_planes,
        max_sweeps=max_sweeps,
        convergence_tol=convergence_tol,
        signed_normals=signed_normals,
    )
    # None → each solver's own measured-best default (multigrid 0.0,
    # single-level 0.95); every entry point must treat None the same
    # way or 8-shard ≢ 1-shard (see PipelineConfig.seg_anchor_cos)
    if seg_anchor_cos is not None:
        seg_kwargs["th_anchor_cos"] = seg_anchor_cos
    if use_stats:
        dk, normals, curv = stats
        rows_i = jnp.arange(spos.shape[0], dtype=jnp.int32)
        g_idx = jnp.stack([rows_i, rows_i], axis=1)
        seg = segment_planes_multigrid(
            spos, normals, g_idx, smask,
            kth_sq_dist=dk, curvature=curv,
            group=seg_group, levels=seg_levels,
            refine_sweeps=seg_refine_sweeps, seed_source=seg_seed_source,
            spacing_hint_mm=spacing_hint_mm,
            **seg_kwargs,
        )
    else:
        neigh_idx, neigh_d, normals, curv = stats
        seg = segment_planes(
            spos, normals, neigh_idx[:, :knn_k], smask,
            neigh_sq_dist=neigh_d[:, :knn_k],
            curvature=curv,
            propagation="window", **seg_kwargs,
        )
    # unsort via the sorting network (a scatter hides a full sort
    # AND random-access writes — ~11 ms vs ~4 ms at 1M rows); labels
    # are small ints, so the packed single-operand variant applies
    plane_idx = unsort_labels(order, seg.plane_idx, max_planes)
    return dataclasses.replace(seg, plane_idx=plane_idx)


def run_device_pipeline(
    positions: jax.Array,
    mask: jax.Array,
    *,
    k_search: int,
    knn_k: int,
    normal_radius: float,
    normal_max_nn: int,
    th_thickness: float,
    th_normal_cos: float,
    th_point_count: int,
    max_planes: int,
    max_sweeps: int,
    signed_normals: bool = False,
    knn_method: str = "brute",
    knn_window_size: int = 64,
    th_seed_curvature=None,
    convergence_tol: float = 0.0,
    seg_group: int = 1,
    seg_levels: int = 1,
    seg_refine_sweeps: int = 2,
    seg_anchor_cos=None,
    seg_seed_source=None,
    morton_small: bool = False,
    spacing_hint_mm=None,
):
    """The on-device portion: shift → kNN → normals → segmentation.

    The window fast path dispatches two jitted stages (see
    ``_window_stage2``'s note on the split); the brute path stays a
    single program.  Remains jittable as a
    whole (nested jits inline) for compile checks.

    Returns (shifted_positions, bbox_min, seg: SegmentationResult).
    """
    if knn_method == "window":
        use_stats = (
            seg_group > 1
            and positions.shape[0] % (seg_group ** seg_levels) == 0
        )
        shifted, lo, spos, smask, order, stats = _window_stage1(
            positions, mask, knn_k=knn_k, normal_radius=normal_radius,
            normal_max_nn=normal_max_nn,
            knn_window_size=knn_window_size, use_stats=use_stats,
            morton_small=morton_small,
        )
        seg = _window_stage2(
            spos, smask, order, stats, knn_k=knn_k,
            th_thickness=th_thickness, th_normal_cos=th_normal_cos,
            th_point_count=th_point_count, max_planes=max_planes,
            max_sweeps=max_sweeps, signed_normals=signed_normals,
            th_seed_curvature=th_seed_curvature,
            convergence_tol=convergence_tol, seg_group=seg_group,
            seg_levels=seg_levels, seg_refine_sweeps=seg_refine_sweeps,
            use_stats=use_stats, seg_anchor_cos=seg_anchor_cos,
            seg_seed_source=seg_seed_source,
            spacing_hint_mm=spacing_hint_mm,
        )
        return shifted, lo, seg
    return _classic_pipeline(
        positions, mask, k_search=k_search, knn_k=knn_k,
        normal_radius=normal_radius, normal_max_nn=normal_max_nn,
        th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        th_point_count=th_point_count, max_planes=max_planes,
        max_sweeps=max_sweeps, signed_normals=signed_normals,
        knn_method=knn_method, th_seed_curvature=th_seed_curvature,
        convergence_tol=convergence_tol,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k_search", "knn_k", "normal_radius", "normal_max_nn",
        "th_thickness", "th_normal_cos", "th_point_count", "max_planes",
        "max_sweeps", "signed_normals", "knn_method",
        "th_seed_curvature", "convergence_tol",
    ),
)
def _classic_pipeline(
    positions, mask, *, k_search, knn_k, normal_radius, normal_max_nn,
    th_thickness, th_normal_cos, th_point_count, max_planes, max_sweeps,
    signed_normals, knn_method, th_seed_curvature, convergence_tol,
):
    """Single-program exact-kNN pipeline (brute-force graph)."""
    shifted, lo, _hi = shift_to_origin(positions, mask)
    neigh_idx, neigh_d = knn(shifted, mask, k=k_search)
    normals, curv = estimate_normals(
        shifted,
        mask,
        neigh_idx,
        neigh_d,
        radius=normal_radius,
        max_nn=normal_max_nn,
    )
    seg = segment_planes(
        shifted,
        normals,
        neigh_idx[:, :knn_k],
        mask,
        curvature=curv,
        th_seed_curvature=th_seed_curvature,
        th_thickness=th_thickness,
        th_normal_cos=th_normal_cos,
        th_point_count=th_point_count,
        max_planes=max_planes,
        max_sweeps=max_sweeps,
        convergence_tol=convergence_tol,
        signed_normals=signed_normals,
    )
    return shifted, lo, seg


@jax.jit
def _labels_i16(plane_idx):
    """Labels as int16 for the device→host fetch (ids ∈ [-1, 32767])."""
    return plane_idx.astype(jnp.int16)


@jax.jit
def _pack_finish(seg):
    """Labels + epilogue as ONE int16 vector — one device→host copy.

    Each ``np.asarray`` is a synchronizing copy with a fixed cost, so
    the epilogue (29 KB) rides behind the int16 labels in the same fetch.
    The f32 epilogue is split into (low, high) 16-bit halves with
    arithmetic shifts — no bitcast-layout assumptions to get wrong —
    and reassembled in :func:`_unpack_finish`.
    """
    epi = _pack_epilogue(seg)
    b = lax.bitcast_convert_type(epi, jnp.int32)
    lo = (b & 0xFFFF).astype(jnp.uint16).astype(jnp.int16)
    hi = ((b >> 16) & 0xFFFF).astype(jnp.uint16).astype(jnp.int16)
    epi16 = jnp.stack([lo, hi], axis=1).reshape(-1)
    return jnp.concatenate([seg.plane_idx.astype(jnp.int16), epi16])


def _unpack_finish(packed: np.ndarray, capacity: int, p_cap: int):
    """Invert :func:`_pack_finish`: (labels int16[capacity], epilogue
    fields via :func:`_unpack_epilogue`)."""
    labels = packed[:capacity]
    pairs = packed[capacity:].astype(np.int64) & 0xFFFF
    bits = (pairs[0::2] | (pairs[1::2] << 16)).astype(np.uint32)
    epi = bits.view(np.float32) if bits.flags.c_contiguous else (
        np.ascontiguousarray(bits).view(np.float32)
    )
    return labels, _unpack_epilogue(epi, p_cap)


@jax.jit
def _pack_epilogue(seg):
    """Pack every SMALL epilogue output into ONE f32 vector.

    Fetching num_planes, diagnostics, plane_count, plane_normal and
    plane_center separately would be five synchronizing copies per
    scan instead of one.  Layout: [num_planes, num_sweeps,
    diag(4), count(P), normal(P*3), center(P*3)] — f32 is exact for
    every field (counts < 2^24)."""
    p = seg.plane_count.shape[0]
    return jnp.concatenate([
        jnp.stack([
            seg.num_planes.astype(jnp.float32),
            seg.num_sweeps.astype(jnp.float32),
        ]),
        seg.diagnostics.astype(jnp.float32),
        seg.plane_count.astype(jnp.float32),
        seg.plane_normal.astype(jnp.float32).reshape(p * 3),
        seg.plane_center.astype(jnp.float32).reshape(p * 3),
    ])


def _unpack_epilogue(vec, p):
    num_planes = int(vec[0])
    diag = vec[2:6].astype(np.int64)
    count = vec[6:6 + p].astype(np.int32)
    normal = vec[6 + p:6 + 4 * p].reshape(p, 3)
    center = vec[6 + 4 * p:6 + 7 * p].reshape(p, 3)
    return num_planes, diag, count, normal, center


def _maybe_dedup(cloud: HostPointCloud, config: PipelineConfig):
    """Apply the opt-in quantized dedup (config.dedup_bits) before
    upload — the host analog of the reference's container-level
    ``removeDuplicatePointInQuantizedPoint`` (tmc3/PCCPointSet.h:
    457-472; unused by the reference's main, exposed here as
    ``--dedup-bits``).  Two deliberate divergences from the cited
    reference: survivors keep their ORIGINAL coordinates (the
    reference masks in place, keeping quantized coords), and
    duplicates are removed GLOBALLY by first occurrence (the
    reference's std::unique removes only consecutive duplicates in
    its sort order)."""
    if config.dedup_bits is None:
        return cloud
    from buildingsegment_tpu.core.quantize import dedup_keep_mask

    keep = dedup_keep_mask(cloud.positions, config.dedup_bits)
    return cloud if keep.all() else cloud.select(keep)


def _prepare_upload(cloud: HostPointCloud, config: PipelineConfig):
    """Host-side shift + compact device upload.

    The bbox shift (reference: buildingSeg ctor, TMC3.cpp:58-72) is an
    int32 subtract on the host, which saves a device→host fetch of the
    shifted array, so it runs HERE and the shifted coordinates are kept
    host-side for the PLY writer.  The
    device pipeline still applies its own shift_to_origin; on
    pre-shifted input its bbox min is exactly 0 per axis, so device and
    host agree bit-for-bit on every coordinate.

    Returns (batch, shifted_host int32[N,3], lo_host int32[3]).
    """
    n = cloud.count
    capacity = config.padded_count(n)
    if n:
        lo_h = cloud.positions.min(axis=0).astype(np.int32)
        shifted_h = (cloud.positions - lo_h[None, :]).astype(np.int32)
    else:
        lo_h = np.zeros(3, np.int32)
        shifted_h = np.zeros((0, 3), np.int32)
    batch = PointBatch.upload(shifted_h, capacity=capacity)
    return batch, shifted_h, lo_h


def _prove_morton_small(config: PipelineConfig, shifted_h) -> PipelineConfig:
    """Enable the 3-operand Morton sort when the host-side shifted bbox
    proves every coordinate < 2^20 (the drivers call this right after
    the shift, so the claim is exact, not heuristic)."""
    if config.morton_small or shifted_h.size == 0:
        return config
    if int(shifted_h.max()) < (1 << 20):
        return dataclasses.replace(config, morton_small=True)
    return config


def _prove_spacing(config: PipelineConfig, shifted_h) -> PipelineConfig:
    """Measure scan density host-side and set the static spacing hint
    (power-of-two bucketed → one jit variant per density bucket).  The
    multigrid edge gates then scale with MEASURED density instead of
    the conservative unconditional sqrt(group)-per-level growth — see
    seg/coarse.py and PipelineConfig.spacing_hint_mm."""
    if config.spacing_hint_mm is not None or shifted_h.size == 0:
        return config
    from buildingsegment_tpu.core.quantize import (
        estimate_spacing_mm, spacing_bucket_mm,
    )

    hint = spacing_bucket_mm(estimate_spacing_mm(shifted_h))
    return dataclasses.replace(config, spacing_hint_mm=hint)


def _dispatch_device(batch, config: PipelineConfig, signed_normals: bool):
    """Dispatch the device pipeline (async) for an uploaded batch."""
    return run_device_pipeline(
        batch.positions,
        batch.mask,
        k_search=max(config.knn_k_pad, config.normal_max_nn),
        knn_k=config.knn_k,
        normal_radius=config.normal_radius,
        normal_max_nn=config.normal_max_nn,
        th_thickness=config.th_thickness,
        th_normal_cos=config.th_normal_cos,
        th_point_count=config.th_point_count,
        max_planes=config.max_planes,
        max_sweeps=config.max_sweeps,
        signed_normals=signed_normals,
        knn_method=resolve_knn_method(config, batch.capacity),
        knn_window_size=config.knn_window,
        th_seed_curvature=config.th_seed_curvature,
        convergence_tol=config.seg_convergence_tol,
        seg_group=config.seg_group,
        seg_levels=config.seg_levels,
        seg_refine_sweeps=config.seg_refine_sweeps,
        seg_anchor_cos=config.seg_anchor_cos,
        seg_seed_source=config.seg_seed_source,
        morton_small=config.morton_small,
        spacing_hint_mm=config.spacing_hint_mm,
    )


def _finish_output(
    cloud, shifted_h, lo_h, shifted_dev, mask_dev, seg, packed16,
    config: PipelineConfig, timings: dict,
) -> PipelineOutput:
    """Fetch labels, colorize, assemble the host-side PipelineOutput.

    All device→host traffic of the epilogue lives here so multi-scan
    callers can run it on a writer thread, overlapped with the next
    scan's upload/compute.  Labels travel as int16 (ids ≤ max_planes ≤
    32767) — half the bytes of the int32 array —
    with the plane-table epilogue packed into the SAME fetch
    (:func:`_pack_finish`): one copy instead of two.
    """
    n = cloud.count
    capacity = seg.plane_idx.shape[0]
    t2 = time.perf_counter()
    p_cap = seg.plane_count.shape[0]
    labels16, epilogue = _unpack_finish(
        np.asarray(packed16), capacity, p_cap
    )
    plane_idx = labels16[:n].astype(np.int32)
    num_planes, diag, p_count, p_normal, p_center = epilogue
    colors = colorize_planes(
        plane_idx,
        num_planes,
        low=config.color_low,
        rng_range=config.color_range,
    )
    # attribute passthrough: the reference's writer keeps reflectance
    # and frameindex alongside the new label colors (tmc3/ply.cpp:
    # 131-136, 173-181); only the colors are replaced by
    # set_plane_color
    out_cloud = HostPointCloud(
        positions=shifted_h,
        colors=colors,
        reflectances=cloud.reflectances,
        frame_idx=cloud.frame_idx,
        laser_angles=cloud.laser_angles,
    )
    t3 = time.perf_counter()
    timings["colorize_host"] = t3 - t2
    timings["total"] = t3 - timings.pop("_t0")
    timings["mpoints_per_sec"] = n / max(timings["total"], 1e-9) / 1e6

    return PipelineOutput(
        cloud=out_cloud,
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normals=p_normal[:num_planes],
        plane_centers=p_center[:num_planes],
        plane_counts=p_count[:num_planes],
        # the device shift is 0 on pre-shifted input; the original bbox
        # min was computed host-side in _prepare_upload
        bbox_min=lo_h,
        timings=timings,
        device_shifted=shifted_dev,
        device_mask=mask_dev,
        diagnostics={
            "peak_live_labels": int(diag[0]),
            "labels_over_merge_cap": int(diag[1]),
            "planes_over_capacity": int(diag[2]),
            "hit_max_sweeps": int(diag[3]),
        },
    )


def segment_cloud(
    cloud: HostPointCloud,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    signed_normals: bool = False,
) -> PipelineOutput:
    """Segment an in-memory cloud; returns labeled output + plane table."""
    timings = {"_t0": time.perf_counter()}
    t0 = timings["_t0"]

    cloud = _maybe_dedup(cloud, config)
    batch, shifted_h, lo_h = _prepare_upload(cloud, config)
    config = _prove_morton_small(config, shifted_h)
    config = _prove_spacing(config, shifted_h)

    t1 = time.perf_counter()
    timings["host_to_device"] = t1 - t0

    shifted, lo, seg = _dispatch_device(batch, config, signed_normals)
    packed16 = _pack_finish(seg)
    jax.block_until_ready(packed16)
    timings["device_pipeline"] = time.perf_counter() - t1

    return _finish_output(
        cloud, shifted_h, lo_h, shifted, batch.mask, seg, packed16,
        config, timings,
    )


def _bucket_capacity(n: int, config: PipelineConfig) -> int:
    """Round capacity to an eighth-octave bucket ≥ padded_count.

    Multi-scan runs hit the jit cache when scans share a bucket; without
    bucketing every distinct point count would recompile the fused
    pipeline (minutes on the GPU).  Buckets are
    2^k × {1, 1.125, 1.25, ..., 1.875} (all pad_to_multiple-aligned):
    at most ~12.5% padding overhead.  Padding is paid TWICE per scan —
    once in device compute and once in the host→device upload — so
    the finer grid beats a quarter-octave one (≤25% overhead) even
    though it doubles the worst-case number of compiled variants.
    """
    cap = config.padded_count(n)
    octave = 1 << max(cap.bit_length() - 1, 3)
    for num in range(8, 17):
        bucket = octave // 8 * num
        if bucket >= cap:
            break
    # re-align to the capacity multiple (octave//8 below pad_to_multiple)
    bucket = config.padded_count(bucket)
    return max(bucket, config.pad_to_multiple)


def segment_files(
    input_paths,
    output_paths,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    signed_normals: bool = False,
    render_dir: Optional[str] = None,
) -> list:
    """Multi-scan pipeline (BASELINE config 5): segment each scan,
    colorize, write labeled PLYs, optionally render ortho PNGs.

    Scans are padded into power-of-two capacity buckets so the fused
    device program compiles once per bucket, not once per scan.  Host
    work is overlapped with device time from both sides: PLY decoding
    is prefetched TWO scans ahead on a reader thread (one-deep left the
    reader idle whenever decode was faster than the device pipeline but
    stalled the loop the moment it was not), and the labeled-PLY write
    + ortho PNG encode of scan i run on a writer thread while scan i+1
    dispatches to the device — the scored config-5 path overlaps its
    I/O instead of serializing read → device → write → render.
    """
    import concurrent.futures as _futures

    input_paths = list(input_paths)
    output_paths = list(output_paths)

    def _load_scan(path):
        """Reader-thread stage: decode + host shift + device upload.

        The upload (the largest single host→device transfer) rides the
        reader thread so it overlaps the PREVIOUS scan's device compute
        and epilogue instead of serializing on the main loop."""
        t0 = time.perf_counter()
        cloud = read_ply(path, position_scale=config.position_scale)
        cloud = _maybe_dedup(cloud, config)
        cfg = dataclasses.replace(
            config, pad_to_multiple=_bucket_capacity(cloud.count, config)
        )
        batch, shifted_h, lo_h = _prepare_upload(cloud, cfg)
        cfg = _prove_morton_small(cfg, shifted_h)
        cfg = _prove_spacing(cfg, shifted_h)
        jax.block_until_ready(batch.positions)
        return cloud, cfg, batch, shifted_h, lo_h, time.perf_counter() - t0

    with _futures.ThreadPoolExecutor(max_workers=1) as rpool, \
            _futures.ThreadPoolExecutor(max_workers=1) as wpool:
        pending = [rpool.submit(_load_scan, p) for p in input_paths[:2]]
        writes = []
        for i, (in_path, out_path) in enumerate(
            zip(input_paths, output_paths)
        ):
            cloud, cfg, batch, shifted_h, lo_h, t_load = pending[i].result()
            if i + 2 < len(input_paths):
                pending.append(rpool.submit(_load_scan, input_paths[i + 2]))
            # main loop only DISPATCHES device work (async); every
            # device→host fetch happens on the writer thread
            t0 = time.perf_counter()
            shifted, lo, seg = _dispatch_device(batch, cfg, signed_normals)
            packed16 = _pack_finish(seg)
            timings = {"_t0": t0, "host_to_device": t_load}
            writes.append(
                wpool.submit(
                    _finish_and_write, cloud, shifted_h, lo_h, shifted,
                    batch.mask, seg, packed16, cfg, timings, in_path,
                    out_path, config, render_dir,
                )
            )
        outputs = [w.result() for w in writes]
    return outputs


def _finish_and_write(
    cloud, shifted_h, lo_h, shifted, mask_dev, seg, packed16, cfg,
    timings, in_path, out_path, config, render_dir,
):
    """Writer-thread stage: fetch/colorize, write the labeled PLY, and
    render the ortho PNGs (raster dispatch reuses the device-resident
    shifted positions — no re-upload).

    The raster is DISPATCHED before the blocking label fetch so the
    device computes it behind the writer's host work (colorize +
    labeled-PLY write); its single packed fetch happens last."""
    rast = None
    if render_dir is not None:
        import os

        from buildingsegment_tpu.raster.ortho import (
            dispatch_ortho, finish_ortho,
        )

        rast, true_ext = dispatch_ortho(
            shifted_h, shifted, mask_dev, config
        )
    out = _finish_output(
        cloud, shifted_h, lo_h, shifted, mask_dev, seg, packed16, cfg,
        timings,
    )
    write_ply(
        out.cloud,
        out_path,
        position_scale=config.output_scale,
        ascii=not config.output_binary,
    )
    if rast is not None:
        base = os.path.splitext(os.path.basename(in_path))[0]
        finish_ortho(
            rast, true_ext, os.path.join(render_dir, base), config
        )
    return out


def dump_stages(
    output: "PipelineOutput", path: str, *, include_graph: bool = False,
    config: PipelineConfig = DEFAULT_CONFIG,
) -> None:
    """Debug checkpoint: persist stage outputs as .npz (SURVEY.md §5 —
    the rebuild's analog of the reference's mid-pipeline debug PLY,
    tmc3/my_function.h:81, but structured and opt-in).

    With ``include_graph=True`` the post-kNN and post-normals stage
    outputs are recomputed (in the sorted frame, then un-sorted) and
    included — useful when bisecting a segmentation regression.
    """
    extra = {}
    if include_graph:
        from buildingsegment_tpu.core.morton import morton_argsort
        from buildingsegment_tpu.ops.fused import knn_normals_window_sorted

        pos = jnp.asarray(output.cloud.positions)
        n = pos.shape[0]
        mask = jnp.ones((n,), bool)
        cap = config.padded_count(n)
        if cap != n:
            pos = jnp.pad(pos, ((0, cap - n), (0, 0)), constant_values=2**24)
            mask = jnp.pad(mask, (0, cap - n))
        order = morton_argsort(pos, mask)
        idx, d, nrm, curv = knn_normals_window_sorted(
            pos[order].astype(jnp.float32), mask[order],
            k=max(config.knn_k, 16), window=config.knn_window,
            radius=config.normal_radius, max_nn=config.normal_max_nn,
        )
        onp = np.asarray(order)
        inv = np.empty(cap, np.int64)
        inv[onp] = np.arange(cap)
        extra = {
            "neigh_idx": onp[np.asarray(idx)][inv][:n],
            "neigh_sq_dist": np.asarray(d)[inv][:n],
            "normals": np.asarray(nrm)[inv][:n],
            "curvature": np.asarray(curv)[inv][:n],
        }
    np.savez_compressed(
        path,
        positions=output.cloud.positions,
        plane_idx=output.plane_idx,
        plane_normals=output.plane_normals,
        plane_centers=output.plane_centers,
        plane_counts=output.plane_counts,
        bbox_min=output.bbox_min,
        num_planes=output.num_planes,
        **extra,
    )


def segment_file(
    input_path: str,
    output_path: str,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    signed_normals: bool = False,
) -> PipelineOutput:
    """File-to-file pipeline with the reference's I/O contract.

    Input positions × ``position_scale`` (1000 → mm, TMC3.cpp:207),
    output written at scale 1.0 / offset 0 as binary (TMC3.cpp:221).
    """
    t0 = time.perf_counter()
    cloud = read_ply(input_path, position_scale=config.position_scale)
    t_read = time.perf_counter() - t0

    out = segment_cloud(cloud, config, signed_normals=signed_normals)

    t1 = time.perf_counter()
    write_ply(
        out.cloud,
        output_path,
        position_scale=config.output_scale,
        position_offset=(0.0, 0.0, 0.0),
        ascii=not config.output_binary,
    )
    out.timings["read_ply"] = t_read
    out.timings["write_ply"] = time.perf_counter() - t1
    out.timings["total_with_io"] = time.perf_counter() - t0
    return out
