"""The ±W window sweeps (ops/window_sweep.py, window_seeds) vs numpy.

Each sweep is re-computed here point by point in numpy float32, in the
same arithmetic order, so labels and seed masks must match exactly.
The seed sweep is also checked against the reference's own depth-0
rule (seg/golden.py) on a graph built from the same window.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from buildingsegment_tpu.core.morton import morton_sort
from buildingsegment_tpu.ops.normals import estimate_normals_window
from buildingsegment_tpu.ops.window_sweep import (
    FAR,
    label_sweep,
    pad_positions,
    pad_rows,
    refine_clean,
    refine_sweep,
    window_starts,
)
from buildingsegment_tpu.seg.golden import golden_seeds
from buildingsegment_tpu.seg.region_grow import window_seeds
from buildingsegment_tpu.utils.synthetic import make_building_cloud

W = 16
TH, CTH, EG2 = 300.0, 0.88, 600.0 ** 2


@pytest.fixture(scope="module")
def scene():
    pts, _ = make_building_cloud(seed=9, spacing_mm=140.0, noise_mm=10.0)
    n = len(pts)
    cap = ((n + 1023) // 1024) * 1024
    pos = np.full((cap, 3), 2 ** 24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    spos, smask, _ = morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    posf = spos.astype(jnp.float32)
    nrm, _ = estimate_normals_window(posf, smask, radius=400.0, window=W)
    return np.asarray(posf), np.asarray(nrm), np.asarray(smask)


def _pairs(n, w):
    """(i, j) index pairs of every in-range window offset."""
    for o in list(range(-w, 0)) + list(range(1, w + 1)):
        i = np.arange(max(0, -o), min(n, n - o))
        yield i, i + o


def _cols(a):
    return tuple(jnp.asarray(a[:, c]) for c in range(3))


def _label_reference(pos, nrm, mask, lab, model, inf, signed):
    cm = (lambda x: x) if signed else np.abs
    new, best = lab.copy(), np.full_like(lab, inf)
    mn, mc = model[:, :3], model[:, 3:]
    for i, j in _pairs(len(lab), W):
        d = pos[i] - pos[j]
        near = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
                 <= np.float32(EG2)) & mask[i] & mask[j])
        e = pos[i] - mc[j]
        dist = np.abs(e[:, 0] * mn[j, 0] + e[:, 1] * mn[j, 1]
                      + e[:, 2] * mn[j, 2])
        c = cm(nrm[i, 0] * mn[j, 0] + nrm[i, 1] * mn[j, 1]
               + nrm[i, 2] * mn[j, 2])
        hop = (lab[j] < inf) & near & (dist <= TH) & (c >= CTH)
        np.minimum.at(new, i[hop], lab[j][hop])
        dc = mc[j] - mc[i]
        mutual = (
            (np.abs(dc[:, 0] * mn[i, 0] + dc[:, 1] * mn[i, 1]
                    + dc[:, 2] * mn[i, 2]) <= TH)
            & (np.abs(dc[:, 0] * mn[j, 0] + dc[:, 1] * mn[j, 1]
                      + dc[:, 2] * mn[j, 2]) <= TH)
            & (cm(mn[i, 0] * mn[j, 0] + mn[i, 1] * mn[j, 1]
                  + mn[i, 2] * mn[j, 2]) >= CTH)
        )
        mrg = (lab[i] < inf) & (lab[j] < lab[i]) & near & mutual
        np.minimum.at(best, i[mrg], lab[j][mrg])
    return new, best


@pytest.mark.parametrize("signed", [False, True])
def test_label_sweep_matches_numpy(scene, signed):
    pos, nrm, mask = scene
    n = len(mask)
    rng = np.random.default_rng(2)
    inf = n
    lab = np.where(rng.random(n) < 0.3, rng.integers(0, n, n),
                   inf).astype(np.int32)
    # each label's model: a perturbed copy of its seed row's plane
    mn = nrm[np.minimum(lab, n - 1)] + rng.normal(size=(n, 3)) * 0.05
    mn /= np.linalg.norm(mn, axis=1, keepdims=True)
    mc = pos[np.minimum(lab, n - 1)] + rng.normal(size=(n, 3)) * 50.0
    model = np.where((lab < inf)[:, None],
                     np.concatenate([mn, mc], 1), 0.0).astype(np.float32)
    new, best = label_sweep(
        _cols(pos), _cols(nrm), jnp.asarray(mask), jnp.asarray(lab),
        jnp.asarray(model),
        pad_positions(_cols(pos), jnp.asarray(mask), W),
        window=W, th_thickness=TH, th_normal_cos=CTH,
        edge_gate2=jnp.float32(EG2), inf_label=jnp.int32(inf),
        signed=signed,
    )
    want_new, want_best = _label_reference(pos, nrm, mask, lab, model,
                                           inf, signed)
    np.testing.assert_array_equal(np.asarray(new), want_new)
    np.testing.assert_array_equal(np.asarray(best), want_best)
    assert (want_new < lab).sum() > 0 and (want_best < inf).sum() > 0


def _plane_tables(rng, pos, nrm, n_planes=140, max_planes=256):
    """Plane models near the scene's own rows, so sweeps do adopt."""
    rows = rng.integers(0, len(pos), n_planes)
    pn = np.zeros((max_planes, 3), np.float32)
    pc = np.zeros((max_planes, 3), np.float32)
    pn[:n_planes] = nrm[rows]
    pc[:n_planes] = pos[rows]
    return pn, np.sum(pn * pc, axis=1), n_planes


def _model(pid, mask, pn, b, max_planes):
    t = np.clip(pid - 1, 0, max_planes - 1)
    has = (pid > 0) & mask
    return (np.where(has[:, None], pn[t], 0.0).astype(np.float32),
            np.where(has, b[t], 0.0).astype(np.float32))


def _refine_reference(pos, nrm, mask, pid, pn, b, max_planes, clean,
                      sweep):
    if clean:
        mnp, mb = _model(pid, mask, pn, b, max_planes)
        d = np.abs(pos[:, 0] * mnp[:, 0] + pos[:, 1] * mnp[:, 1]
                   + pos[:, 2] * mnp[:, 2] - mb)
        c = np.abs(nrm[:, 0] * mnp[:, 0] + nrm[:, 1] * mnp[:, 1]
                   + nrm[:, 2] * mnp[:, 2])
        pid = np.where((pid > 0) & mask & (d <= TH) & (c >= CTH), pid, 0)
    if not sweep:
        return pid
    mnp, mb = _model(pid, mask, pn, b, max_planes)
    big = max_planes + 1
    best = np.full_like(pid, big)
    for i, j in _pairs(len(pid), W):
        e = pos[i] - pos[j]
        near = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
                <= np.float32(EG2))
        d = np.abs(pos[i, 0] * mnp[j, 0] + pos[i, 1] * mnp[j, 1]
                   + pos[i, 2] * mnp[j, 2] - mb[j])
        c = np.abs(nrm[i, 0] * mnp[j, 0] + nrm[i, 1] * mnp[j, 1]
                   + nrm[i, 2] * mnp[j, 2])
        ok = ((pid[j] > 0) & near & mask[j] & mask[i] & (d <= TH)
              & (c >= CTH))
        np.minimum.at(best, i[ok], pid[j][ok])
    return np.where(pid > 0, pid, np.where(best < big, best, 0))


@pytest.mark.parametrize("clean,sweep", [
    (True, True), (False, True), (True, False),
])
def test_refine_matches_numpy(scene, clean, sweep):
    pos, nrm, mask = scene
    rng = np.random.default_rng(1)
    max_planes = 256
    pn, b, n_live = _plane_tables(rng, pos, nrm)
    pid0 = np.where(rng.random(len(mask)) < 0.5,
                    rng.integers(1, n_live + 1, len(mask)), 0
                    ).astype(np.int32)
    gates = dict(max_planes=max_planes, th_thickness=TH, th_normal_cos=CTH)
    pos3, nrm3, maskj = _cols(pos), _cols(nrm), jnp.asarray(mask)
    pnj, bj = jnp.asarray(pn), jnp.asarray(b)
    got = jnp.asarray(pid0)
    if clean:
        got = refine_clean(got, pos3, nrm3, maskj, pnj, bj, **gates)
    if sweep:
        got = refine_sweep(got, pos3, nrm3, maskj, pnj, bj,
                           pad_positions(pos3, maskj, W), window=W,
                           edge_gate2=EG2, **gates)
    want = _refine_reference(pos, nrm, mask, pid0, pn, b, max_planes,
                             clean, sweep)
    np.testing.assert_array_equal(np.asarray(got), want)
    if sweep:
        assert ((want > 0) & (pid0 == 0)).sum() > 0  # rows did adopt


def _window_graph(pos, mask, k):
    """k−1 nearest window candidates of each row (float64, exact on
    integer mm); rows without k−1 candidates or with a distance tie at
    the ball's edge are flagged unusable."""
    n = len(mask)
    d2 = np.full((n, 2 * W), np.inf)
    idx = np.zeros((n, 2 * W), np.int64)
    for s, (i, j) in enumerate(_pairs(n, W)):
        ok = mask[i] & mask[j]
        d2[i[ok], s] = ((pos[i[ok]].astype(np.float64)
                         - pos[j[ok]]) ** 2).sum(1)
        idx[i, s] = j
    order = np.argsort(d2, axis=1, kind="stable")
    ds = np.take_along_axis(d2, order, 1)
    nb = np.take_along_axis(idx, order, 1)[:, : k - 1]
    usable = (mask & np.isfinite(ds[:, k - 2]) & (ds[:, k - 2] < ds[:, k - 1])
              & (ds[:, k - 1] < 2.0 ** 24))
    neigh = np.concatenate([np.arange(n)[:, None], nb], 1)
    return neigh, np.where(np.isfinite(ds[:, k - 2]), ds[:, k - 2], 0.0), usable


def test_seeds_match_golden_depth0_rule(scene):
    """Signed seeds over the window ≡ the reference's depth-0 rule on
    the graph of each row's k−1 nearest window candidates."""
    pos, nrm, mask = scene
    k = 15
    neigh, kth, usable = _window_graph(pos, mask, k)
    got = np.asarray(window_seeds(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(mask),
        jnp.asarray(kth.astype(np.float32)), window=W, signed_normals=True,
    ))
    want = golden_seeds(pos.astype(np.int64), nrm, neigh, k=k)
    np.testing.assert_array_equal(got[usable], want[usable])
    assert got[usable].sum() > 50 and (~got[usable]).sum() > 50


def test_seeds_match_numpy_sweep(scene):
    pos, nrm, mask = scene
    rng = np.random.default_rng(3)
    dk = (rng.uniform(100.0, 900.0, len(mask)) ** 2).astype(np.float32)
    got = np.asarray(window_seeds(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(mask),
        jnp.asarray(dk), window=W,
    ))
    bad = np.zeros(len(mask), bool)
    for i, j in _pairs(len(mask), W):
        d = pos[j] - pos[i]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        ball = (d2 <= dk[i]) & mask[j] & mask[i]
        pd = np.abs(d[:, 0] * nrm[i, 0] + d[:, 1] * nrm[i, 1]
                    + d[:, 2] * nrm[i, 2])
        pc = np.abs(nrm[j, 0] * nrm[i, 0] + nrm[j, 1] * nrm[i, 1]
                    + nrm[j, 2] * nrm[i, 2])
        bad[i] |= ball & ~((pd <= TH) & (pc >= CTH))
    np.testing.assert_array_equal(got, mask & ~bad)


def test_padding_and_slot_order():
    assert window_starts(2) == [0, 1, 3, 4]  # offsets -2, -1, +1, +2
    a = jnp.arange(3, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(pad_rows(a, FAR, 2)), [FAR, FAR, 0, 1, 2, FAR, FAR])
    px, py, pz, pm = pad_positions((a, a, a), jnp.ones(3, bool), 1)
    np.testing.assert_array_equal(np.asarray(pm), [0, 1, 1, 1, 0])
    assert float(px[0]) == FAR and float(pz[-1]) == FAR
