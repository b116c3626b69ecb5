"""Command-line interface.

Drop-in compatible with the reference's argv contract
(``tmc3 -a=<in.ply> -s=<out.ply>``; readme.txt example, parsed by
``analyse_path`` at tmc3/my_function.cpp:163-178, which splits each
argument on '=' and ignores the flag letter).  Extended ``--flag``
options expose the constants that the reference hard-codes (SURVEY.md
§5 config/flag system).

Usage:
    python -m buildingsegment_tpu.cli -a=scan.ply -s=labeled.ply
    python -m buildingsegment_tpu.cli -a=scan.ply -s=out.ply \
        --th-thickness 300 --th-point-count 400 --render-dir ./renders \
        --profile --json-summary
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from buildingsegment_tpu.config import PipelineConfig

__all__ = ["main", "parse_args"]


def parse_args(argv):
    """Split reference-style ``-x=path`` args from ``--flag`` extensions."""
    ref_style = {}
    rest = []
    for a in argv:
        if (
            len(a) >= 2
            and a[0] == "-"
            and a[1] != "-"
            and "=" in a
        ):
            # reference semantics: split on '=', value is field [1]
            key = a.split("=")[0].lstrip("-")
            ref_style[key] = a.split("=", 1)[1]
        else:
            rest.append(a)

    p = argparse.ArgumentParser(
        prog="buildingsegment_tpu",
        description="building point-cloud plane segmentation (JAX)",
    )
    p.add_argument("--input", help="input PLY (alias of -a=)")
    p.add_argument("--output", help="output labeled PLY (alias of -s=)")
    p.add_argument("--position-scale", type=float, default=1000.0)
    p.add_argument("--knn-k", type=int, default=15)
    p.add_argument("--normal-radius", type=float, default=100.0)
    p.add_argument(
        "--knn-method",
        choices=["auto", "brute", "window"],
        default="auto",
        help="auto: Morton-window above 65k points, exact brute below",
    )
    p.add_argument("--normal-max-nn", type=int, default=50)
    p.add_argument("--th-thickness", type=float, default=300.0)
    p.add_argument("--th-point-count", type=int, default=400)
    p.add_argument("--th-normal-cos", type=float, default=0.88)
    p.add_argument(
        "--golden",
        action="store_true",
        help="run the bit-faithful host oracle of the reference's "
        "sequential algorithm (small scans; defines behavioral parity)",
    )
    p.add_argument(
        "--signed-normals",
        action="store_true",
        help="strict reference semantics (unstable on vertical walls)",
    )
    def _dedup_bits(s):
        v = int(s)
        if v < 0:
            raise argparse.ArgumentTypeError("--dedup-bits must be >= 0")
        return v

    p.add_argument(
        "--dedup-bits",
        type=_dedup_bits,
        default=None,
        metavar="N",
        help="remove duplicate points whose quantized positions match "
        "after dropping N low bits (first occurrence survives; the "
        "reference's removeDuplicatePointInQuantizedPoint, "
        "PCCPointSet.h:457-472); 0 = exact-duplicate removal.  "
        "Divergences from the reference: duplicates are removed "
        "globally by first occurrence (the reference's std::unique "
        "only removes CONSECUTIVE duplicates in its sort order), and "
        "survivors keep their ORIGINAL coordinates (the reference "
        "keeps the masked/quantized ones)",
    )
    p.add_argument("--ascii", action="store_true", help="write ascii PLY")
    p.add_argument(
        "--render-dir",
        help="also render ortho height/density PNGs + contours into DIR "
        "(the reference's disabled raster path, TMC3.cpp:223-226)",
    )
    p.add_argument("--profile", action="store_true", help="print stage timings")
    p.add_argument(
        "--extract-contours",
        action="store_true",
        help="with --render-dir: also run contour extraction on the "
        "density render and extrude building prisms to csa.obj "
        "(the reference's full disabled path, TMC3.cpp:223-226)",
    )
    p.add_argument(
        "--trace",
        metavar="DIR",
        help="capture a jax.profiler device trace into DIR "
        "(view in TensorBoard/Perfetto)",
    )
    p.add_argument(
        "--json-summary", action="store_true", help="print a JSON run summary"
    )
    p.add_argument(
        "--batch",
        nargs=2,
        metavar=("IN_DIR", "OUT_DIR"),
        help="multi-scan mode: segment every .ply in IN_DIR into OUT_DIR",
    )
    p.add_argument(
        "--dump-stages",
        metavar="NPZ",
        help="write stage outputs (labels, plane table) as .npz for debugging",
    )
    args = p.parse_args(rest)

    input_path = ref_style.get("a") or args.input
    output_path = ref_style.get("s") or args.output
    return args, input_path, output_path


#: the compile cache when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed directory in the checkout (listed in .gitignore), so repeat
#: runs from one checkout find their compiled programs again
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else
    :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def _enable_compile_cache():
    """Persistent XLA compile cache: the first run of a new shape pays
    its compilation once; repeat invocations hit the disk cache.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is set here."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    # numeric sanitizer (SURVEY.md §5: the rebuild's stand-in for the
    # reference's nonexistent sanitizers): fail fast on NaNs
    if os.environ.get("BST_DEBUG_NANS"):
        jax.config.update("jax_debug_nans", True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _enable_compile_cache()
    args, input_path, output_path = parse_args(argv)
    if not args.batch and (not input_path or not output_path):
        print(
            "usage: buildingsegment_tpu -a=<in.ply> -s=<out.ply> [--flags]\n"
            "       buildingsegment_tpu --batch IN_DIR OUT_DIR [--flags]",
            file=sys.stderr,
        )
        return 2

    config = PipelineConfig(
        position_scale=args.position_scale,
        knn_method=args.knn_method,
        knn_k=args.knn_k,
        normal_radius=args.normal_radius,
        normal_max_nn=args.normal_max_nn,
        th_thickness=args.th_thickness,
        th_point_count=args.th_point_count,
        th_normal_cos=args.th_normal_cos,
        output_binary=not args.ascii,
        dedup_bits=args.dedup_bits,
    )

    from buildingsegment_tpu.pipeline import (
        dump_stages,
        segment_file,
        segment_files,
    )

    if args.batch:
        import glob

        in_dir, out_dir = args.batch
        inputs = sorted(glob.glob(os.path.join(in_dir, "*.ply")))
        if not inputs:
            print(f"error: no .ply files in {in_dir}", file=sys.stderr)
            return 1
        os.makedirs(out_dir, exist_ok=True)
        outs = [os.path.join(out_dir, os.path.basename(p)) for p in inputs]
        results = segment_files(
            inputs,
            outs,
            config,
            signed_normals=args.signed_normals,
            render_dir=args.render_dir,
        )
        total_pts = sum(r.cloud.count for r in results)
        total_time = sum(r.timings["total"] for r in results)
        print(
            f"{len(results)} scans, {total_pts} points, "
            f"{sum(r.num_planes for r in results)} planes, "
            f"{total_pts / max(total_time, 1e-9) / 1e6:.3f} Mpoints/sec"
        )
        if args.json_summary:
            print(
                json.dumps(
                    {
                        "scans": len(results),
                        "points": total_pts,
                        "planes": [r.num_planes for r in results],
                        "mpoints_per_sec": total_pts / max(total_time, 1e-9) / 1e6,
                        "diagnostics": [r.diagnostics for r in results],
                    }
                )
            )
        return 0

    if args.golden:
        return _run_golden(input_path, output_path, config)

    import contextlib

    trace_cm = contextlib.nullcontext()
    if args.trace:
        from buildingsegment_tpu.profiling import trace as _trace

        trace_cm = _trace(args.trace)

    try:
        with trace_cm:
            out = segment_file(
                input_path,
                output_path,
                config,
                signed_normals=args.signed_normals,
            )
    except FileNotFoundError:
        print(f"error: cannot open {input_path}", file=sys.stderr)
        return 1

    if args.dump_stages:
        dump_stages(out, args.dump_stages)

    if args.render_dir:
        from buildingsegment_tpu.raster.ortho import DENSITY_PNG, render_ortho_views

        paths = render_ortho_views(out, args.render_dir, config)
        if args.extract_contours:
            from buildingsegment_tpu.raster.contours import extracted_contour

            extracted_contour(
                paths[DENSITY_PNG],
                os.path.join(args.render_dir, "extracted_contours.png"),
                os.path.join(args.render_dir, "extracted_contours_flip.png"),
                obj_path=os.path.join(args.render_dir, "csa.obj"),
                threshold=config.contour_threshold,
                min_area=config.contour_min_area,
                min_perimeter=config.contour_min_perimeter,
                close_iterations=config.contour_close_iters,
            )

    print(
        f"{out.cloud.count} points → {out.num_planes} planes → {output_path}"
    )
    if args.profile:
        for stage, secs in out.timings.items():
            print(f"  {stage:>20}: {secs:.4f}")
    if args.json_summary:
        print(
            json.dumps(
                {
                    "points": out.cloud.count,
                    "planes": out.num_planes,
                    "plane_counts": out.plane_counts.tolist(),
                    "timings": out.timings,
                    "diagnostics": out.diagnostics,
                }
            )
        )
    return 0


def _run_golden(input_path, output_path, config) -> int:
    """Reference-semantics oracle run: numpy golden model end-to-end.

    Mirrors the reference binary exactly (sequential region growing
    with all quirks, MSVC rand colors) — the parity target for the
    device pipeline.  O(n·k) Python; intended for small scans.
    """
    import numpy as np

    from buildingsegment_tpu.io.ply import HostPointCloud, read_ply, write_ply
    from buildingsegment_tpu.ops.knn import knn
    from buildingsegment_tpu.ops.normals import estimate_normals
    from buildingsegment_tpu.seg.colorize import msvc_rand_colors
    from buildingsegment_tpu.seg.golden import golden_segment

    import jax.numpy as jnp

    try:
        cloud = read_ply(input_path, position_scale=config.position_scale)
    except FileNotFoundError:
        print(f"error: cannot open {input_path}", file=sys.stderr)
        return 1
    pts = cloud.positions - cloud.positions.min(axis=0)
    n = len(pts)
    cap = config.padded_count(n)
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    k_search = max(config.knn_k, config.normal_max_nn)
    idx, d = knn(jnp.asarray(pos), jnp.asarray(mask), k=k_search)
    normals, _ = estimate_normals(
        jnp.asarray(pos), jnp.asarray(mask), idx, d,
        radius=config.normal_radius, max_nn=config.normal_max_nn,
    )
    plane_idx, planes = golden_segment(
        pts,
        np.asarray(normals)[:n].astype(np.float64),
        np.asarray(idx)[:n, : config.knn_k],
        k=config.knn_k,
        th_thickness=config.th_thickness,
        th_point_count=config.th_point_count,
        th_normal_cos=config.th_normal_cos,
    )
    colors = np.zeros((n, 3), np.uint16)
    table = msvc_rand_colors(len(planes), config.color_low, config.color_range)
    for p, col in zip(planes, table):
        colors[np.asarray(p.point_idx)] = col
    write_ply(
        HostPointCloud(positions=pts.astype(np.int32), colors=colors),
        output_path,
        position_scale=config.output_scale,
        ascii=not config.output_binary,
    )
    print(f"{n} points → {len(planes)} planes (golden oracle) → {output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
