"""Smoke run of the segmentation pipeline on one NVIDIA GPU.

    python chip_smoke.py              # phases (a)-(g) on one GPU
    python chip_smoke.py --devices 4  # only the sharded pipeline, 4 GPUs

Everything runs in this one process (a JAX process reserves most of a
card's memory, so a second one would fail).  Phases:

  (a) device report; exits non-zero unless JAX's platform is ``gpu``
  (b) compile-only: lower + compile both pipeline stages at the
      1.08M-point capacity, with compile seconds and memory analysis
  (c) the stats sweep's Triton kernel against its XLA form at 1.08M
      points (W=48, k=15, r=100, max_nn=50), and in its radius-only
      mode against ``estimate_normals_window``'s XLA form (W=64,
      r=100): errors and median times
  (d) the CLI end to end on the 1.08M-point scene (PLY in, labelled
      PLY out, truth agreement), then the 36k-point scene on the GPU
      and on the CPU device of this process (plane counts, agreement)
  (e) ``segment_files`` on two scans with ortho renders
  (f) exact brute-force kNN at 64k points against scipy's KD-tree
  (g) median stage times of (d)'s scene: stage 1, stage 2, fetch

``--devices 4`` runs ``sharded_pipeline`` on a 4-device mesh and on a
1-device mesh of the 1.08M-point scene and compares them.  Any failed
check raises: the process then exits non-zero and prints no result
line.  The last line of a passing run is one JSON object with the
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# the CPU device of phase (d) must exist beside the GPU: keep "cpu" in
# an explicit platform list (the first entry stays the default)
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from buildingsegment_tpu.config import PipelineConfig  # noqa: E402
from buildingsegment_tpu.utils.platform import card_line  # noqa: E402
from buildingsegment_tpu.utils.quality import bij_agreement  # noqa: E402
from buildingsegment_tpu.utils.synthetic import (  # noqa: E402
    make_building_cloud,
)

# the bench scene: a dense single-building scan of 1,082,304 points
SCENE = dict(seed=0, spacing_mm=25.0, width_mm=12_000.0, depth_mm=9_000.0,
             wall_h_mm=6_000.0, ridge_h_mm=8_000.0, noise_mm=8.0)
# the compile-check scene of __graft_entry__.entry (36k points)
SMALL = dict(seed=0, spacing_mm=60.0, width_mm=5000.0, depth_mm=4000.0,
             wall_h_mm=3000.0, ridge_h_mm=4000.0)
SMALL_N = 36 * 1024
TRUTH_FLOOR = 0.97       # bench.py's quality floor on the bench scene
CROSS_FLOOR = 0.99       # GPU vs CPU labels of one scene
SHARD_FLOOR = 0.999      # 4-device vs 1-device labels of one scene
REPS = 5


def log(msg):
    print(msg, flush=True)


def median_time(fn, reps=REPS):
    """Median wall seconds of ``fn()`` (each call ends in
    ``block_until_ready``), after one warm-up call."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def phase_a():
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"(a) devices: {info}")
    if dev.platform != "gpu":
        log("no GPU found: this script measures nothing on other devices")
        sys.exit(3)
    return info


def scene_batch(cfg, scene=SCENE, n_max=None):
    pts, truth = make_building_cloud(**scene)
    if n_max is not None:
        pts, truth = pts[:n_max], truth[:n_max]
    n = len(pts)
    cap = cfg.padded_count(n)
    pos = np.full((cap, 3), 2 ** 24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, truth, pos, mask


def stage_kwargs(cfg, pts):
    """Static arguments of the two pipeline stages, as
    ``pipeline._dispatch_device`` derives them for this scene."""
    from buildingsegment_tpu.core.quantize import (
        estimate_spacing_mm, spacing_bucket_mm,
    )

    shifted = pts - pts.min(axis=0)
    s1 = dict(knn_k=cfg.knn_k, normal_radius=cfg.normal_radius,
              normal_max_nn=cfg.normal_max_nn,
              knn_window_size=cfg.knn_window, use_stats=True,
              morton_small=bool(shifted.max() < (1 << 20)))
    s2 = dict(knn_k=cfg.knn_k, th_thickness=cfg.th_thickness,
              th_normal_cos=cfg.th_normal_cos,
              th_point_count=cfg.th_point_count,
              max_planes=cfg.max_planes, max_sweeps=cfg.max_sweeps,
              signed_normals=False,
              th_seed_curvature=cfg.th_seed_curvature,
              convergence_tol=cfg.seg_convergence_tol,
              seg_group=cfg.seg_group, seg_levels=cfg.seg_levels,
              seg_refine_sweeps=cfg.seg_refine_sweeps, use_stats=True,
              seg_anchor_cos=cfg.seg_anchor_cos,
              seg_seed_source=cfg.seg_seed_source,
              spacing_hint_mm=spacing_bucket_mm(
                  estimate_spacing_mm(shifted)))
    return s1, s2


def phase_b(cfg, pts, pos, mask):
    from buildingsegment_tpu.pipeline import _window_stage1, _window_stage2

    s1, s2 = stage_kwargs(cfg, pts)
    specs = (jax.ShapeDtypeStruct(pos.shape, jnp.int32),
             jax.ShapeDtypeStruct(mask.shape, jnp.bool_))
    out = {}
    t0 = time.perf_counter()
    c1 = _window_stage1.lower(*specs, **s1).compile()
    out["stage1_compile_s"] = time.perf_counter() - t0
    shapes = jax.eval_shape(
        lambda p, m: _window_stage1(p, m, **s1), *specs)
    _, _, spos, smask, order, stats = shapes
    t0 = time.perf_counter()
    c2 = _window_stage2.lower(spos, smask, order, stats, **s2).compile()
    out["stage2_compile_s"] = time.perf_counter() - t0
    log(f"(b) capacity {pos.shape[0]}: stage 1 compiled in "
        f"{out['stage1_compile_s']:.1f} s, stage 2 in "
        f"{out['stage2_compile_s']:.1f} s")
    log(f"    stage 1 memory: {c1.memory_analysis()}")
    log(f"    stage 2 memory: {c2.memory_analysis()}")
    return out


def phase_c(cfg, pts, pos, mask):
    from buildingsegment_tpu.ops.normals import estimate_normals_window
    from buildingsegment_tpu.ops.stats_sweep import knn_normals_window_stats
    from buildingsegment_tpu.pipeline import _window_stage1

    s1, _ = stage_kwargs(cfg, pts)
    # the Morton-sorted rows the pipeline's stats stage sees
    _, _, spos, smask, _, _ = _window_stage1(
        jnp.asarray(pos), jnp.asarray(mask), **s1)
    spos = spos.astype(jnp.float32)
    kw = dict(k=cfg.knn_k, window=cfg.knn_window, radius=cfg.normal_radius,
              max_nn=cfg.normal_max_nn)

    def run(impl):
        return knn_normals_window_stats(spos, smask, impl=impl, **kw)

    tri, xla = run("triton"), run("xla")
    sel = np.asarray(smask)
    dk_t, dk_x = np.asarray(tri[0])[sel], np.asarray(xla[0])[sel]
    dk_rel = np.abs(dk_t - dk_x) / np.maximum(np.abs(dk_x), 1.0)
    cos = np.abs(np.sum(np.asarray(tri[1]) * np.asarray(xla[1]), -1))[sel]
    ang = np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))
    dcurv = np.abs(np.asarray(tri[2]) - np.asarray(xla[2]))[sel]
    res = {
        "kth_sq_dist_max_rel_err": float(dk_rel.max()),
        "normal_angle_p999_deg": float(np.percentile(ang, 99.9)),
        "normal_angle_max_deg": float(ang.max()),
        "curvature_p999_abs_err": float(np.percentile(dcurv, 99.9)),
        "curvature_max_abs_err": float(dcurv.max()),
    }
    log(f"(c) stats kernel vs XLA at {spos.shape[0]} rows: {res}")
    # the k-th distance is an order statistic of the same d² values;
    # only FMA contraction of d² may differ (a few ulps of d²)
    check(res["kth_sq_dist_max_rel_err"] <= 1e-5,
          "kth_sq_dist within 1e-5 relative")
    # the moment sums add the same terms in another order: float32
    # rounding of ~50-term sums moves near-isotropic normals slightly
    check(res["normal_angle_p999_deg"] <= 0.1,
          "normals: 99.9% within 0.1 degree")
    check(res["curvature_p999_abs_err"] <= 1e-4,
          "curvature: 99.9% within 1e-4")
    t_tri, _ = median_time(lambda: run("triton"))
    t_xla, _ = median_time(lambda: run("xla"))
    res["triton_ms"] = t_tri * 1e3
    res["xla_ms"] = t_xla * 1e3
    log(f"    median of {REPS}: triton {t_tri * 1e3:.3f} ms, "
        f"xla {t_xla * 1e3:.3f} ms")

    # radius-only normals (config 3: bench.py's r=100, W=64)
    def run_r(impl):
        return estimate_normals_window(spos, smask, radius=cfg.normal_radius,
                                       window=64, impl=impl)

    (n_t, c_t), (n_x, c_x) = run_r("triton"), run_r("xla")
    cos = np.abs(np.sum(np.asarray(n_t) * np.asarray(n_x), -1))[sel]
    ang = np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))
    dcurv = np.abs(np.asarray(c_t) - np.asarray(c_x))[sel]
    rad = {"normal_angle_p999_deg": float(np.percentile(ang, 99.9)),
           "normal_angle_max_deg": float(ang.max()),
           "curvature_p999_abs_err": float(np.percentile(dcurv, 99.9))}
    log(f"    radius-only normals, kernel vs XLA: {rad}")
    # same terms (≤129 per point) added in another order
    check(rad["normal_angle_p999_deg"] <= 0.1,
          "radius-only normals: 99.9% within 0.1 degree")
    check(rad["curvature_p999_abs_err"] <= 1e-4,
          "radius-only curvature: 99.9% within 1e-4")
    t_rt, _ = median_time(lambda: run_r("triton"))
    t_rx, _ = median_time(lambda: run_r("xla"))
    res["radius_only"] = dict(rad, triton_ms=t_rt * 1e3, xla_ms=t_rx * 1e3)
    log(f"    radius-only, median of {REPS}: triton {t_rt * 1e3:.3f} ms, "
        f"xla {t_rx * 1e3:.3f} ms")
    return res


def labels_from_colors(colors):
    """Plane ids from a labelled PLY's colors (black = unlabelled)."""
    key = (colors[:, 0].astype(np.int64) << 32) | (
        colors[:, 1].astype(np.int64) << 16) | colors[:, 2]
    _, ids = np.unique(key, return_inverse=True)
    return np.where(key == 0, -1, ids)


def phase_d(tmp, pts, truth):
    from buildingsegment_tpu import cli
    from buildingsegment_tpu.io.ply import (
        HostPointCloud, read_ply, write_ply,
    )
    from buildingsegment_tpu.pipeline import segment_cloud

    src, dst = os.path.join(tmp, "scene.ply"), os.path.join(tmp, "out.ply")
    # file in meters; the CLI reads ×1000 → integer mm
    write_ply(HostPointCloud(positions=pts), src, position_scale=1e-3)
    t0 = time.perf_counter()
    rc = cli.main([f"-a={src}", f"-s={dst}"])
    wall = time.perf_counter() - t0
    check(rc == 0, "cli.main exit code 0")
    with open(dst, "rb") as f:
        header = f.read(512).split(b"end_header")[0].decode()
    check("binary_little_endian" in header, "output PLY is binary")
    props = [ln.split()[-1] for ln in header.splitlines()
             if ln.startswith("property")]
    check(props[3:6] == ["green", "blue", "red"],
          "output colors in green/blue/red order")
    out = read_ply(dst)
    check(out.count == len(pts), "output keeps every point")
    agree = bij_agreement(truth, labels_from_colors(out.colors))
    # both stages were compiled in (b): this run reads them from the
    # compile cache, so its wall time is a warm-cache scan
    log(f"(d) CLI on {len(pts)} points: {wall:.1f} s wall (warm compile "
        f"cache; cold compile in (b)), truth agreement {agree:.4f}")
    check(agree >= TRUTH_FLOOR, f"truth agreement >= {TRUTH_FLOOR}")

    cfg = PipelineConfig(knn_method="window")
    small, _ = make_building_cloud(**SMALL)
    cloud = HostPointCloud(positions=small[:SMALL_N])
    gpu = segment_cloud(cloud, cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = segment_cloud(cloud, cfg)
    cross = bij_agreement(cpu.plane_idx, gpu.plane_idx)
    log(f"    {cloud.count} points: gpu {gpu.num_planes} planes, cpu "
        f"{cpu.num_planes} planes, agreement {cross:.4f}")
    check(gpu.num_planes == cpu.num_planes, "equal plane counts gpu/cpu")
    # float sums arrive in another order on the GPU (atomics), which
    # can flip the odd boundary point
    check(cross >= CROSS_FLOOR, f"gpu/cpu agreement >= {CROSS_FLOOR}")
    return {"cli_wall_s": wall, "truth_agreement": agree,
            "gpu_cpu_agreement": cross, "planes_small": gpu.num_planes}


def phase_e(tmp):
    from buildingsegment_tpu.io.ply import HostPointCloud, read_ply, write_ply
    from buildingsegment_tpu.pipeline import segment_files
    from buildingsegment_tpu.raster.ortho import (
        DENSITY_HEIGHT_PNG, DENSITY_PNG, MEAN_HEIGHT_PNG,
    )

    ins, outs, counts = [], [], []
    for s in range(2):
        pts, _ = make_building_cloud(**dict(SCENE, seed=s, spacing_mm=50.0))
        p = os.path.join(tmp, f"scan{s}.ply")
        write_ply(HostPointCloud(positions=pts), p, position_scale=1e-3)
        ins.append(p)
        outs.append(os.path.join(tmp, f"scan{s}_out.ply"))
        counts.append(len(pts))
    render = os.path.join(tmp, "render")
    t0 = time.perf_counter()
    res = segment_files(ins, outs, PipelineConfig(), render_dir=render)
    wall = time.perf_counter() - t0
    for s, (r, o) in enumerate(zip(res, outs)):
        check(read_ply(o).count == counts[s] and r.num_planes > 0,
              f"scan {s}: labelled PLY with {r.num_planes} planes")
        for name in (MEAN_HEIGHT_PNG, DENSITY_PNG, DENSITY_HEIGHT_PNG):
            path = os.path.join(render, f"scan{s}", name)
            with open(path, "rb") as f:
                magic = f.read(8)
            check(magic == b"\x89PNG\r\n\x1a\n", f"scan {s}: {name}")
    log(f"(e) segment_files on 2 scans with renders: {wall:.1f} s wall")
    return {"multiscan_wall_s": wall}


def phase_f():
    from scipy.spatial import cKDTree

    from buildingsegment_tpu.ops.knn import knn

    rng = np.random.default_rng(0)
    n, k = 65536, 16
    pts = rng.integers(0, 40_000, size=(n, 3)).astype(np.int32)
    idx, d = knn(jnp.asarray(pts), jnp.ones(n, bool), k=k)
    od, _ = cKDTree(pts.astype(np.float64)).query(pts, k=k)
    d = np.asarray(d)
    check(np.array_equal(np.asarray(idx)[:, 0], np.arange(n)),
          "knn slot 0 is the point itself")
    err = np.abs(d - od ** 2)
    log(f"(f) exact kNN at {n} points: max |d² - KD-tree d²| "
        f"{err.max():.4f}")
    # integer coordinates: the diff-form re-rank is exact in float32
    check(np.allclose(d, od ** 2, rtol=1e-6, atol=0.01),
          "knn distances match the KD-tree")
    return {"knn_max_abs_err": float(err.max())}


def phase_g(cfg, pts, pos, mask):
    from buildingsegment_tpu.pipeline import (
        _pack_finish, _window_stage1, _window_stage2,
    )

    s1, s2 = stage_kwargs(cfg, pts)
    posj, maskj = jnp.asarray(pos), jnp.asarray(mask)
    st1 = lambda: _window_stage1(posj, maskj, **s1)  # noqa: E731
    t1, _ = median_time(st1)
    _, _, spos, smask, order, stats = st1()
    st2 = lambda: _window_stage2(spos, smask, order, stats, **s2)  # noqa: E731
    t2, _ = median_time(st2)
    seg = st2()
    # the pipeline's epilogue: pack labels + plane table, copy to host
    t3, _ = median_time(lambda: np.asarray(_pack_finish(seg)))
    res = {"stage1_ms": t1 * 1e3, "stage2_ms": t2 * 1e3,
           "fetch_ms": t3 * 1e3}
    log(f"(g) [{card_line()}] median of {REPS} at {pos.shape[0]} rows: "
        f"stage 1 {t1 * 1e3:.3f} ms, stage 2 {t2 * 1e3:.3f} ms, fetch "
        f"{t3 * 1e3:.3f} ms")
    return res


def phase_sharded(n_dev):
    from buildingsegment_tpu.dist.mesh import make_mesh
    from buildingsegment_tpu.dist.sharded import (
        sharded_pipeline, sharded_seg_body,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    check(len(jax.devices()) >= n_dev, f"{n_dev} devices visible")
    base = PipelineConfig(pad_to_multiple=2048 * n_dev)
    pts, truth, pos, mask = scene_batch(base)
    s1, s2 = stage_kwargs(base, pts)
    cfg = dataclasses.replace(
        base, morton_small=s1["morton_small"],
        spacing_hint_mm=s2["spacing_hint_mm"])
    n = len(pts)
    posj, maskj = jnp.asarray(pos), jnp.asarray(mask)
    fns = {m: sharded_pipeline(make_mesh(m), cfg) for m in (n_dev, 1)}
    mesh = make_mesh(n_dev)
    spec = lambda shape, dt, p: jax.ShapeDtypeStruct(  # noqa: E731
        shape, dt, sharding=NamedSharding(mesh, p))

    def seg_hlo():
        return jax.jit(sharded_seg_body(mesh, cfg)).lower(
            spec(pos.shape, jnp.float32, P("points", None)),
            spec(mask.shape, jnp.bool_, P("points")),
        ).compile().as_text()

    # the three programs compile at once (XLA's compiler releases the
    # GIL): the phase waits for the slowest compile, not for their sum
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        warm = [ex.submit(lambda f=f: jax.block_until_ready(f(posj, maskj)))
                for f in fns.values()]
        hlo = ex.submit(seg_hlo)
        for w in warm:
            w.result()
        txt = hlo.result()
    t_compile = time.perf_counter() - t0
    log(f"    {n} points, capacity {pos.shape[0]}: both meshes and the "
        f"HLO check compiled and run once in {t_compile:.1f} s")
    res = {}
    for m, fn in fns.items():
        t, _ = median_time(lambda: fn(posj, maskj))
        _, _, seg = fn(posj, maskj)
        res[m] = (np.asarray(seg.plane_idx)[:n], int(seg.num_planes), t)
        log(f"    mesh of {m}: {res[m][1]} planes, median of {REPS} "
            f"{t * 1e3:.3f} ms")
    lab_n, planes_n, t_n = res[n_dev]
    lab_1, planes_1, t_1 = res[1]
    agree = bij_agreement(lab_1, lab_n)
    log(f"(sharded) [{card_line().splitlines()[0]}] {n} points on {n_dev} "
        f"devices vs 1: agreement {agree:.5f}, truth agreement "
        f"{bij_agreement(truth, lab_n):.4f}")
    check(planes_n == planes_1, "equal plane counts 4-device/1-device")
    # psum'd float tables sum in another order per mesh (and atomics
    # within a device): the odd boundary point may flip
    check(agree >= SHARD_FLOOR, f"4-device/1-device agreement >= "
          f"{SHARD_FLOOR}")
    check("all-gather" not in txt, "no all-gather in the sharded HLO")
    return {"points": n, "compile_s": t_compile, "agreement": agree,
            "ms_sharded": t_n * 1e3, "ms_single": t_1 * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded pipeline on 4 GPUs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    info = phase_a()
    from buildingsegment_tpu.cli import _enable_compile_cache

    _enable_compile_cache()
    results = {}
    if args.devices > 1:
        results["sharded"] = phase_sharded(args.devices)
    else:
        cfg = PipelineConfig()
        pts, truth, pos, mask = scene_batch(cfg)
        log(f"scene: {len(pts)} points, capacity {pos.shape[0]}")
        results["b"] = phase_b(cfg, pts, pos, mask)
        results["c"] = phase_c(cfg, pts, pos, mask)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            results["d"] = phase_d(tmp, pts, truth)
            results["e"] = phase_e(tmp)
        results["f"] = phase_f()
        results["g"] = phase_g(cfg, pts, pos, mask)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card_line(), "device": info,
                   "seconds": time.perf_counter() - t_start,
                   "results": results}, f, indent=1, default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
