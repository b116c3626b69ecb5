"""Hole fill of the multigrid finalize (ops/adopt.py) vs numpy.

The numpy reference below applies the adoption rule point by point in
float64: a hole adopts the candidate plane with the smallest |p·n − b|
among those whose band, normal and reach tests it passes (first lane on
ties), and its payload row lands on that candidate's table row.

Tolerance: the XLA form evaluates the band offset and the expanded
in-plane distance |p|² − 2p·c + |c|² in float32 at mm scale, so a point
within a few mm of a gate may decide differently from the float64
reference.  Decisions are compared only away from such margins; the
sums are checked against a float64 sum of the rows the XLA form adopted.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from buildingsegment_tpu.ops.adopt import plane_adopt

TABLE = 1024


def _numpy_reference(pos, cn, holes, nk, ck, bk, ccdk, reach2, lane_ok,
                     rows, th, th_cos, signed):
    pos = pos.astype(np.float64)
    off = pos @ nk.T.astype(np.float64) - bk[None, :]
    cos = cn.astype(np.float64) @ nk.T.astype(np.float64)
    if not signed:
        cos = np.abs(cos)
    d2 = ((pos[:, None, :] - ck[None, :, :]) ** 2).sum(-1)
    inpl2 = np.maximum(d2 - off * off, 0.0)
    ok = ((np.abs(off) <= th) & (cos >= th_cos)
          & (inpl2 <= reach2[None, :]) & (lane_ok > 0)[None, :]
          & holes[:, None])
    adopted = ok.any(1)
    lane = np.argmin(np.where(ok, np.abs(off), np.inf), axis=1)
    row = np.where(adopted, rows[lane], 0)
    # distance of every gate value from its threshold (mm or cos units)
    margin = np.min(np.stack([
        np.abs(np.abs(off) - th),
        np.abs(cos - th_cos) * 1e4,
        np.abs(np.sqrt(inpl2) - np.sqrt(reach2)[None, :]),
    ]), axis=0).min(1)
    return adopted, row, margin


def _payload(pos, cn):
    sq = np.sum(pos.astype(np.float64) ** 2, axis=1, keepdims=True)
    return np.concatenate(
        [np.ones((len(pos), 1)), cn, pos, sq], axis=1).astype(np.float32)


def _problem(seed, n=700, k=96, coincide=False, hole_frac=0.6):
    rng = np.random.default_rng(seed)
    nk = rng.normal(size=(k, 3))
    nk /= np.linalg.norm(nk, axis=1, keepdims=True)
    ck = rng.uniform(0, 30_000, size=(k, 3))
    if coincide:
        # shared centers/normals so |off| ties are exact
        nk = np.repeat(nk[: k // 2], 2, axis=0)[:k]
        ck = np.repeat(ck[: k // 2], 2, axis=0)[:k]
    nk, ck = nk.astype(np.float32), ck.astype(np.float32)
    bk = np.sum(nk * ck, axis=1)
    ccdk = np.sum(ck * ck, axis=1)
    reach2 = rng.uniform(500, 4000, size=k).astype(np.float32) ** 2
    lane_ok = (rng.uniform(size=k) < 0.8).astype(np.float32)
    rows = rng.integers(0, TABLE, size=k).astype(np.int32)
    # points scattered near the planes so every gate has both outcomes
    t = rng.integers(0, k, size=n)
    along = rng.normal(size=(n, 3)).astype(np.float32) * 800
    off = rng.normal(size=n).astype(np.float32) * 250
    pos = ck[t] + along - np.sum(along * nk[t], 1, keepdims=True) * nk[t]
    pos = np.round(pos + off[:, None] * nk[t]).astype(np.float32)
    cn = nk[t] + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    cn *= rng.choice([-1.0, 1.0], size=(n, 1)).astype(np.float32)
    holes = rng.uniform(size=n) < hole_frac
    return dict(pos=pos, cn=cn.astype(np.float32), holes=holes, nk=nk,
                ck=ck, bk=bk, ccdk=ccdk, reach2=reach2, lane_ok=lane_ok,
                rows=rows)


def _run(p, th, th_cos, signed):
    return [np.asarray(a) for a in plane_adopt(
        jnp.asarray(_payload(p["pos"], p["cn"])), jnp.asarray(p["holes"]),
        *(jnp.asarray(p[k]) for k in
          ("nk", "ck", "bk", "ccdk", "reach2", "lane_ok", "rows")),
        table_cap=TABLE, th_thickness=th, th_cos=th_cos, signed=signed,
    )]


def _check_against_reference(p, th, th_cos, signed):
    ad, row, acc = _run(p, th, th_cos, signed)
    ref_ad, ref_row, margin = _numpy_reference(
        p["pos"], p["cn"], p["holes"], p["nk"], p["ck"], p["bk"],
        p["ccdk"], p["reach2"], p["lane_ok"], p["rows"], th, th_cos,
        signed)
    clear = margin > 5.0  # away from every float32 decision margin
    np.testing.assert_array_equal(ad[clear], ref_ad[clear])
    both = clear & ad & ref_ad
    np.testing.assert_array_equal(row[both], ref_row[both])
    return ad, row, acc, ref_ad


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("hole_frac", [0.6, 1.0])
def test_adopt_matches_numpy_reference(seed, signed, hole_frac):
    p = _problem(seed, hole_frac=hole_frac)
    ad, _, _, _ = _check_against_reference(p, 300.0, 0.88, signed)
    assert int(ad.sum()) > 20  # the scene exercises adoption


@pytest.mark.parametrize("signed", [False, True])
def test_adopt_tie_breaks_first_lane(signed):
    p = _problem(7, coincide=True)
    p["lane_ok"] = np.ones_like(p["lane_ok"])  # ties survive the gates
    _check_against_reference(p, 400.0, 0.5, signed)


@pytest.mark.parametrize("signed", [False, True])
def test_adopt_accumulates_payload_sums(signed):
    p = _problem(3, n=1000)
    ad, row, acc = _run(p, 300.0, 0.88, signed)
    pay = _payload(p["pos"], p["cn"]).astype(np.float64)
    ref = np.zeros((TABLE, 8))
    np.add.at(ref, row[ad], pay[ad])
    # the count column is an exact integer sum; the others are float32
    # sums of mm-scale values (|p|² ~ 1e9) in another order
    np.testing.assert_array_equal(acc[:, 0], ref[:, 0])
    np.testing.assert_allclose(acc, ref, rtol=1e-5, atol=1e-3)


def test_adopt_non_holes_never_adopt():
    p = _problem(5, n=333)
    ad, _, acc = _run(p, 300.0, 0.88, False)
    assert ad.shape == (333,)
    assert not ad[~p["holes"]].any()
    # the table counts exactly the adopted points
    assert int(acc[:, 0].sum()) == int(ad.sum())


def test_adopt_masked_lanes_never_chosen():
    p = _problem(13, n=1024)
    p["rows"] = np.arange(len(p["rows"]), dtype=np.int32) * 10  # distinct
    p["lane_ok"][::2] = 0.0
    ad, row, _ = _run(p, 300.0, 0.88, False)
    assert ad.sum() > 0
    assert not np.isin(row[ad], p["rows"][::2]).any()
