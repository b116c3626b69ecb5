"""Per-surface confusion breakdown of the bench-scene quality gate.

Runs the production sharded pipeline ONCE on the bench scene (exactly
bench.py's scene: seed 0, 25 mm spacing, 1.08M pts) and prints, per
ground-truth surface (1-4 walls, 5-6 roof, 7 ground), the top predicted
labels — so a sub-floor ``quality_agreement`` can be localized to a
surface / failure mode instead of guessed at.

Run (GPU):  python tools/quality_diag.py
"""

import json

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from buildingsegment_tpu.cli import _enable_compile_cache

    _enable_compile_cache()

    from buildingsegment_tpu.config import PipelineConfig
    from buildingsegment_tpu.dist.mesh import make_mesh
    from buildingsegment_tpu.dist.sharded import sharded_pipeline
    from buildingsegment_tpu.utils.quality import bij_agreement
    from buildingsegment_tpu.utils.synthetic import make_building_cloud

    pts, truth = make_building_cloud(
        seed=0, spacing_mm=25.0, width_mm=12_000.0, depth_mm=9_000.0,
        wall_h_mm=6_000.0, ridge_h_mm=8_000.0, noise_mm=8.0,
    )
    n = len(pts)
    n_dev = len(jax.devices())
    cfg = PipelineConfig(pad_to_multiple=2048 * max(n_dev, 1))
    capacity = cfg.padded_count(n)
    pos = np.full((capacity, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    mesh = make_mesh(n_dev)
    fn = sharded_pipeline(mesh, cfg, capacity_hint=capacity)
    _, _, seg = fn(jnp.asarray(pos), jnp.asarray(mask))
    pred = np.asarray(seg.plane_idx)[:n]

    agree = bij_agreement(truth, pred)
    print(json.dumps({
        "points": n,
        "agreement": round(agree, 4),
        "planes_found": int(seg.num_planes),
        "unlabeled_frac": round(float((pred <= 0).mean()), 4),
        "diagnostics": np.asarray(seg.diagnostics).tolist(),
    }))

    names = {1: "wall_y0", 2: "wall_yd", 3: "wall_x0", 4: "wall_xw",
             5: "roof_w", 6: "roof_e", 7: "ground"}
    for t in sorted(np.unique(truth).tolist()):
        sel = truth == t
        labs, cnts = np.unique(pred[sel], return_counts=True)
        o = np.argsort(-cnts)[:4]
        tops = [(int(labs[i]), int(cnts[i])) for i in o]
        best = tops[0][1] / sel.sum()
        print(f"truth {t} ({names.get(t, '?'):8s}) n={int(sel.sum()):7d} "
              f"purity={best:.4f} top={tops}")
    # and the reverse: any predicted label that straddles truth planes
    for p in sorted(np.unique(pred).tolist()):
        sel = pred == p
        if sel.sum() < 400:
            continue
        labs, cnts = np.unique(truth[sel], return_counts=True)
        o = np.argsort(-cnts)[:4]
        tops = [(int(labs[i]), int(cnts[i])) for i in o]
        best = tops[0][1] / sel.sum()
        if best < 0.995:
            print(f"pred {p} n={int(sel.sum()):7d} "
                  f"purity={best:.4f} truth-mix={tops}")


if __name__ == "__main__":
    main()
