"""Benchmark: the five BASELINE configs on the GPU(s) of this machine.

Prints the contract as JSON lines on stdout:
    {"metric": ..., "value": N, "unit": "Mpoints/sec", "platform": ...,
     "device_kind": ..., "devices": N, "card": "<name>, <power limit>"}

The line is re-printed after EVERY completed stage with the
best-so-far numbers (a mid-run SIGTERM/SIGKILL still leaves a parseable
last line), and once more from an atexit/SIGTERM handler.  A wall-clock
budget (BST_BENCH_BUDGET_S, default 2400 s) gates every optional stage:
autotune candidates, the multiscan run and the brute-force kNN are
strictly optional refinements — the headline number lands first.

It runs on a GPU only and exits with status 2 on any other backend.
``BST_BENCH_QUICK=1`` is the exception: a tiny scene, 2 scans, no
quality gate — a smoke test of the whole flow (budget gating, fallback
paths, JSON contract) on any backend, labelled with its platform, NOT a
performance measurement.

The headline metric is end-to-end segmentation throughput (the
reference binary publishes no numbers).  Sub-metrics for the other
scored configs ride along as extra fields:
  - knn_bruteforce_mpts: config 2 (exact brute force, ops/knn.knn)
  - knn_window_mpts: the production approximate graph build
  - normals_mpts: config 3 (covariance-PCA normals + curvature)
  - segmentation_multigrid_mpts: config 4 (region growing alone)
  - multiscan_e2e_mpts: config 5 (PLY read → segment → write → render)
All numbers are steady-state (compile excluded), synthetic ~1M-point
building scene, reference-default thresholds.
"""

import atexit
import dataclasses
import json
import os
import signal
import sys
import time

import numpy as np

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BST_BENCH_BUDGET_S", "2400"))

# mutable best-so-far contract line; emit() re-prints it as stages land
STATE = {
    "metric": "end_to_end_segmentation_throughput",
    "value": 0.0,
    "unit": "Mpoints/sec",
    "status": "starting",
}
_finalized = False


def elapsed():
    return time.monotonic() - T0


def left():
    return BUDGET_S - elapsed()


def note(msg):
    print(f"[bench {elapsed():6.0f}s] {msg}", file=sys.stderr, flush=True)


def emit(status=None):
    """Print the current contract line (stdout).  A reader takes the
    LAST JSON line, so printing after every stage makes any prefix of
    the run a valid bench result."""
    if status is not None:
        STATE["status"] = status
    STATE["elapsed_s"] = round(elapsed(), 1)
    print(json.dumps(STATE), flush=True)


def _finalize(signum=None, frame=None):
    global _finalized
    if not _finalized:
        _finalized = True
        emit(status="final" if signum is None else f"signal_{signum}")
    if signum is not None:
        os._exit(0)


def _timed(fn, *args, reps=8, **kw):
    """Steady-state seconds per call: one compiling call, then ``reps``
    calls dispatched back to back and one ``block_until_ready`` on the
    last result (every output leaf, so a multi-program pipeline is
    waited for to its final program)."""
    import jax

    out = jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    signal.signal(signal.SIGTERM, _finalize)
    signal.signal(signal.SIGINT, _finalize)
    atexit.register(_finalize)

    import jax
    import jax.numpy as jnp

    from buildingsegment_tpu.utils.platform import backend_platform, card_line

    quick = os.environ.get("BST_BENCH_QUICK", "") == "1"
    spacing = 300.0 if quick else 25.0
    n_scans = 2 if quick else 4

    platform = backend_platform()
    STATE["platform"] = platform
    STATE["device_kind"] = jax.devices()[0].device_kind
    STATE["devices"] = len(jax.devices())
    STATE["card"] = card_line() if platform == "gpu" else "n/a"
    if platform != "gpu" and not quick:
        STATE["error"] = f"needs a GPU, found {platform}"
        emit(status="wrong_platform")
        os._exit(2)  # skip the atexit line: this is the last line

    from buildingsegment_tpu.cli import _enable_compile_cache

    _enable_compile_cache()
    note(f"backend: {platform} x{len(jax.devices())} [{STATE['card']}]")

    from buildingsegment_tpu.config import PipelineConfig
    from buildingsegment_tpu.core.morton import morton_argsort
    from buildingsegment_tpu.dist.mesh import make_mesh
    from buildingsegment_tpu.dist.sharded import sharded_pipeline
    from buildingsegment_tpu.ops.knn import knn, knn_window_sorted
    from buildingsegment_tpu.ops.normals import estimate_normals_window
    from buildingsegment_tpu.seg.coarse import segment_planes_multigrid
    from buildingsegment_tpu.utils.quality import bij_agreement
    from buildingsegment_tpu.utils.synthetic import make_building_cloud

    n_dev = len(jax.devices())

    # ~1M-point dense building scene: 25 mm spacing.  Ground-truth
    # plane ids ride along so the bench reports a correctness number
    # next to the throughput.
    pts, truth = make_building_cloud(
        seed=0,
        spacing_mm=spacing,
        width_mm=12_000.0,
        depth_mm=9_000.0,
        wall_h_mm=6_000.0,
        ridge_h_mm=8_000.0,
        noise_mm=8.0,
    )
    n = len(pts)
    STATE["points"] = n

    from buildingsegment_tpu.core.quantize import (
        estimate_spacing_mm, spacing_bucket_mm,
    )

    cfg = PipelineConfig(
        pad_to_multiple=2048 * max(n_dev, 1),
        morton_small=bool(pts.max() - pts.min() < (1 << 20)),
        # host-proven density hint (the morton_small pattern): the
        # multigrid edge gates scale with measured density
        spacing_hint_mm=spacing_bucket_mm(estimate_spacing_mm(pts)),
    )
    capacity = cfg.padded_count(n)
    pos = np.full((capacity, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    pos_j, mask_j = jnp.asarray(pos), jnp.asarray(mask)

    QUALITY_FLOOR = 0.0 if quick else 0.97
    STATE["quality_floor"] = QUALITY_FLOOR
    mesh = make_mesh(n_dev)
    # conservative configuration: the quality-gate fallback
    safe_cfg = dataclasses.replace(
        cfg, knn_window=64, seg_levels=2, seg_refine_sweeps=3,
    )
    tune = {}
    STATE["autotune"] = tune

    def _headline(c):
        fn = sharded_pipeline(mesh, c, capacity_hint=capacity)
        e2e_dt, (_, _, seg) = _timed(lambda: fn(pos_j, mask_j))
        agreement = bij_agreement(truth, np.asarray(seg.plane_idx)[:n])
        return fn, e2e_dt, seg, agreement

    def _adopt(c, fn, e2e_dt, seg, agreement, reps_d):
        STATE["value"] = round(n / e2e_dt / 1e6, 3)
        STATE["seconds_per_scan"] = round(e2e_dt, 4)
        STATE["planes_found"] = int(seg.num_planes)
        STATE["seg_sweeps"] = int(seg.num_sweeps)
        STATE["quality_agreement"] = round(agreement, 4)
        tune["chosen"] = dict(reps_d)
        return c, fn, e2e_dt, seg

    # ------------------------------------------------------------------
    # 1. HEADLINE FIRST at the production defaults.  A number exists
    # after the first two program compiles; everything after is
    # budget-gated refinement.
    # ------------------------------------------------------------------
    best = None
    base_t0 = time.monotonic()
    try:
        note("headline: production defaults (compiling)")
        fn0, dt0, seg0, ag0 = _headline(cfg)
        tune["cand_base"] = {"ms": round(dt0 * 1e3, 2),
                             "agreement": round(ag0, 4)}
        note(f"headline base: {dt0 * 1e3:.1f} ms, agreement {ag0:.4f}")
        if ag0 >= QUALITY_FLOOR:
            best = _adopt(cfg, fn0, dt0, seg0, ag0, {})
            emit(status="headline_base")
    except Exception as e:
        tune["cand_base"] = f"error:{type(e).__name__}"
        note(f"headline base FAILED: {type(e).__name__}: {str(e)[:160]}")
    cand_cost = time.monotonic() - base_t0

    if best is None:
        # defaults failed the gate (or crashed): the safe config is the
        # floor — slower, but conservative in every knob
        try:
            note("headline: safe fallback config (compiling)")
            fn1, dt1, seg1, ag1 = _headline(safe_cfg)
            tune["cand_safe"] = {"ms": round(dt1 * 1e3, 2),
                                 "agreement": round(ag1, 4)}
            best = _adopt(safe_cfg, fn1, dt1, seg1, ag1,
                          {"fallback": "safe_cfg"})
            if ag1 < QUALITY_FLOOR:
                STATE["quality_gate"] = "FAIL"
            emit(status="headline_safe")
        except Exception as e:
            STATE["error"] = "headline_failed"
            STATE["detail"] = f"{type(e).__name__}: {str(e)[:200]}"
            emit(status="headline_failed")
            return
    cfg, fn, e2e_dt, seg = best

    # ------------------------------------------------------------------
    # 2. stage benches on the sorted frame
    # ------------------------------------------------------------------
    order = morton_argsort(pos_j, mask_j)
    spos = pos_j[order]
    smask = mask_j[order]
    sposf = spos.astype(jnp.float32)

    def _stage(tag, thunk, min_left=90):
        if left() < min_left:
            STATE[tag] = "skipped:budget"
            return None
        try:
            dt, out = thunk()
            STATE[tag] = round(n / dt / 1e6, 2)
            note(f"{tag}: {dt * 1e3:.2f} ms = {STATE[tag]} Mpts/s")
            emit(status=tag)
            return dt, out
        except Exception as e:
            STATE[tag] = f"error:{type(e).__name__}"
            note(f"{tag} FAILED: {type(e).__name__}")
            return None

    r = _stage("knn_window_mpts", lambda: _timed(
        lambda: knn_window_sorted(sposf, smask, 16, window=cfg.knn_window)))
    nb_i, nb_d = r[1] if r else knn_window_sorted(
        sposf, smask, 16, window=cfg.knn_window)

    r = _stage("normals_mpts", lambda: _timed(
        lambda: estimate_normals_window(sposf, smask, radius=100.0,
                                        window=64)))
    normals = r[1][0] if r else estimate_normals_window(
        sposf, smask, radius=100.0, window=64)[0]

    def _mg(c):
        return segment_planes_multigrid(
            spos, normals, nb_i[:, :16], smask,
            neigh_sq_dist=nb_d[:, :16], max_edge_dist=600.0,
            th_point_count=400, max_planes=1024,
            window=16, group=c.seg_group, levels=c.seg_levels,
            refine_sweeps=c.seg_refine_sweeps,
            convergence_tol=c.seg_convergence_tol,
            seed_source=c.seg_seed_source,
            spacing_hint_mm=c.spacing_hint_mm,
        )

    # ------------------------------------------------------------------
    # 3. headline candidates, each gated on remaining budget (a
    # candidate costs ~1 pipeline re-jit ≈ the base compile).  The list
    # includes REVERSE candidates of the current defaults (w64,
    # levels=3, sweeps=3) so the gate can back off a default on a scene
    # where it loses quality.
    # ------------------------------------------------------------------
    cand_reps = [] if quick else [
        {"seg_levels": 3},
        # one-shot ×16 coarsen: one coarsen/refine/finalize instead of
        # several levels of them
        {"seg_group": 16, "seg_levels": 1, "seg_refine_sweeps": 2,
         "seg_seed_source": "coarse"},
        {"seg_seed_source": "coarse"},
        # the finalize hole-fill may cover what the second refine
        # sweep does
        {"seg_refine_sweeps": 1, "seg_seed_source": "coarse"},
        {"knn_window": 64},
        {"seg_refine_sweeps": 3},
    ]
    for reps_d in cand_reps:
        need = max(240.0, 1.3 * cand_cost)
        if left() < need:
            tune["cand_skipped"] = f"budget:{reps_d}"
            note(f"candidates stopped (need {need:.0f}s, "
                 f"left {left():.0f}s)")
            break
        c = dataclasses.replace(cfg, **reps_d)
        tag = "_".join(f"{k.split('_')[-1]}{v}" for k, v in
                       sorted(reps_d.items()))
        t0c = time.monotonic()
        try:
            note(f"candidate {tag} (compiling)")
            fn_c, dt_c, seg_c, ag_c = _headline(c)
        except Exception as e:
            tune[f"cand_{tag}"] = f"error:{type(e).__name__}"
            continue
        finally:
            cand_cost = max(cand_cost, time.monotonic() - t0c)
        tune[f"cand_{tag}"] = {"ms": round(dt_c * 1e3, 2),
                               "agreement": round(ag_c, 4)}
        note(f"candidate {tag}: {dt_c * 1e3:.1f} ms, "
             f"agreement {ag_c:.4f}")
        if ag_c >= QUALITY_FLOOR and dt_c < e2e_dt:
            cfg, fn, e2e_dt, seg = _adopt(c, fn_c, dt_c, seg_c, ag_c,
                                          reps_d)
            emit(status=f"cand_{tag}")

    # the multigrid stage at the WINNING config, so the published stage
    # rate matches what the headline runs
    _stage("segmentation_multigrid_mpts", lambda: _timed(
        lambda: _mg(cfg), reps=4), min_left=300)

    # ------------------------------------------------------------------
    # 4. config 5: ortho render + the full multi-scan pipeline
    # ------------------------------------------------------------------
    from buildingsegment_tpu.raster.ortho import compute_ortho_images

    if left() > 90:
        try:
            shifted, lo, _seg = fn(pos_j, mask_j)
            ext = tuple(
                int(v) for v in np.asarray(
                    jnp.max(jnp.where(mask_j[:, None], shifted, 0), axis=0))
            )
            render = jax.jit(
                lambda p, m: compute_ortho_images(p, m, ext, cfg))
            dt, _ = _timed(lambda: render(shifted, mask_j))
            STATE["render_mpts"] = round(n / dt / 1e6, 2)
            STATE["pipeline_with_render_mpts"] = round(
                n / (e2e_dt + dt) / 1e6, 2)
            emit(status="render")
        except Exception as e:
            STATE["render_mpts"] = f"error:{type(e).__name__}"

    import tempfile

    from buildingsegment_tpu.io.ply import HostPointCloud, write_ply
    from buildingsegment_tpu.pipeline import segment_files

    # the multiscan stage program is big; gate on a real chunk of
    # budget and fall back to the safe config on a compile failure
    if left() > (60 if quick else 420):
        try:
            tmp = tempfile.mkdtemp(prefix="bst_bench_scans_")
            scan_paths, total_pts = [], 0
            for s in range(n_scans):
                spts, _ = make_building_cloud(
                    seed=s, spacing_mm=spacing, width_mm=12_000.0,
                    depth_mm=9_000.0, wall_h_mm=6_000.0,
                    ridge_h_mm=8_000.0, noise_mm=8.0,
                )
                total_pts += len(spts)
                p = os.path.join(tmp, f"scan{s}.ply")
                # file in meters; read_ply(scale=1000) → integer mm
                write_ply(HostPointCloud(positions=spts), p,
                          position_scale=1e-3)
                scan_paths.append(p)
            out_paths = [os.path.join(tmp, f"out{s}.ply")
                         for s in range(n_scans)]
            render_dir = os.path.join(tmp, "render")
            note("multiscan (compiling)")
            ms_cfg = cfg
            try:
                segment_files(scan_paths, out_paths, ms_cfg,
                              render_dir=render_dir)
            except Exception:
                ms_cfg = safe_cfg
                STATE["multiscan_fallback"] = "safe_cfg"
                segment_files(scan_paths, out_paths, ms_cfg,
                              render_dir=render_dir)
            t0 = time.perf_counter()
            segment_files(scan_paths, out_paths, ms_cfg,
                          render_dir=render_dir)
            ms_dt = time.perf_counter() - t0
            STATE["multiscan_e2e_mpts"] = round(total_pts / ms_dt / 1e6, 2)
            STATE["multiscan_scans"] = len(scan_paths)
            note(f"multiscan: {ms_dt:.2f} s for {len(scan_paths)} scans")
            emit(status="multiscan")
        except Exception as e:
            STATE["multiscan_error"] = (
                f"{type(e).__name__}: {str(e)[:160]}")
            emit(status="multiscan_failed")
    else:
        STATE["multiscan_e2e_mpts"] = "skipped:budget"

    # ------------------------------------------------------------------
    # 5. config 2: exact brute force (ops/knn.knn), 1 rep (O(N²))
    # ------------------------------------------------------------------
    if left() > (30 if quick else 300):
        try:
            note("brute kNN (compiling)")
            dt, _ = _timed(lambda: knn(spos, smask, k=16), reps=1)
            STATE["knn_bruteforce_mpts"] = round(n / dt / 1e6, 3)
            emit(status="knn_bruteforce")
        except Exception as e:  # pragma: no cover
            STATE["knn_bruteforce_error"] = type(e).__name__
    else:
        STATE["knn_bruteforce_mpts"] = "skipped:budget"

    if STATE.get("quality_agreement", 0.0) < QUALITY_FLOOR:
        STATE["quality_gate"] = "FAIL"
    _finalize()


if __name__ == "__main__":
    main()
