"""The stats sweep's Triton kernel (interpret mode) vs its XLA form.

Contract (ops/stats_sweep.py): ``kth_sq_dist`` equals the fused XLA
op's ``neigh_sq_dist[:, k-1]`` — an order statistic of the same float32
values: bit-exact wherever d² < 2^24 mm² (integer coordinates, exact
arithmetic), within an ulp beyond, where the two forms may round
dx²+dy²+dz² in another association — and the moment sums
are the same terms added in another order, so normals and curvature
agree to float32 rounding.  The interpreter runs the kernel body as
written for the GPU; the card's own compile is checked by the
``gpu``-marked test at the end and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from buildingsegment_tpu.core.morton import morton_sort
from buildingsegment_tpu.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu.ops.stats_sweep import (
    knn_normals_window_stats,
    stats_impl,
    stats_sweep_triton,
)
from buildingsegment_tpu.utils.synthetic import make_building_cloud


def _sorted_cloud(n_pts, cap, spacing=120.0, seed=5):
    pts, _ = make_building_cloud(
        seed=seed, spacing_mm=spacing, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    pts = pts[:n_pts]
    pos = np.full((cap, 3), 2 ** 24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    return spos.astype(jnp.float32), smask


@pytest.fixture(scope="module")
def cloud():
    return _sorted_cloud(3900, 4096)


def _assert_kth_close(got, want):
    """Exact below 2^24 (integer d² in float32); beyond, the sum
    dx²+dy²+dz² may round differently by an ulp (2^-23 relative)."""
    got, want = np.asarray(got), np.asarray(want)
    small = want < 2.0 ** 24
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0.0)


def _assert_normals_close(nrm, nrm2, curv, curv2, sel):
    """Reordered float32 moment sums: most rows agree to rounding, and
    near-degenerate neighbourhoods (few or nearly collinear points)
    amplify that rounding in the normal and in λ0/Σλ."""
    cos = np.abs(np.sum(np.asarray(nrm) * np.asarray(nrm2), -1))[sel]
    ang = np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))
    assert np.percentile(ang, 99) < 0.2
    dc = np.abs(np.asarray(curv2) - np.asarray(curv))[sel]
    assert np.percentile(dc, 99.9) <= 1e-4
    assert dc.max() <= 1e-3


def _compare(sposf, smask, k, w, radius, max_nn):
    _, nb_d, nrm, curv = knn_normals_window_sorted(
        sposf, smask, max(k, 16), window=w, radius=radius, max_nn=max_nn
    )
    dk, nrm2, curv2 = knn_normals_window_stats(
        sposf, smask, k, window=w, radius=radius, max_nn=max_nn,
        impl="triton", interpret=True,
    )
    _assert_kth_close(dk, nb_d[:, k - 1])
    _assert_normals_close(nrm, nrm2, curv, curv2, np.asarray(smask))


@pytest.mark.parametrize(
    "k,w,radius,max_nn",
    [
        (15, 48, 100.0, 50),     # the production configuration
        (15, 64, 100.0, 50),     # 2W = 128: no power-of-two padding
        (15, 32, 100.0, 50),     # cap inactive: max_nn - 1 > 2W
        (16, 32, 1e6, 16),       # cap binds before the radius
        (15, 32, 300.0, None),   # no hybrid cap
        (15, 24, 300.0, 20),     # 2W = 48: padded to 64 columns
        (2, 16, 200.0, 8),       # smallest ball
        (33, 16, 500.0, None),   # k - 1 = 2W: every candidate ranked
    ],
)
def test_kernel_matches_xla(cloud, k, w, radius, max_nn):
    _compare(*cloud, k, w, radius, max_nn)


@pytest.mark.parametrize("n_pts,cap", [(900, 1000), (3000, 3001)])
def test_rows_not_a_multiple_of_the_block(n_pts, cap):
    """The wrapper pads rows to a whole block; padded rows are masked
    and sliced off (cap 1000 and 3001 are not multiples of 32)."""
    sposf, smask = _sorted_cloud(n_pts, cap)
    _compare(sposf, smask, 15, 32, 100.0, 50)


@pytest.mark.parametrize("block_rows", [8, 64])
def test_block_size_does_not_change_results(cloud, block_rows):
    sposf, smask = cloud
    kw = dict(k=15, window=32, radius=100.0, max_nn=50, interpret=True)
    ref = stats_sweep_triton(sposf, smask, **kw)
    got = stats_sweep_triton(sposf, smask, block_rows=block_rows, **kw)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        # the per-row sums are the same; only the tile shape differs
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-3)


def test_masked_rows_are_zero_ball_and_up_normal(cloud):
    sposf, smask = cloud
    dk, nrm, curv = knn_normals_window_stats(
        sposf, smask, 15, window=32, radius=100.0, max_nn=50,
        impl="triton", interpret=True,
    )
    off = ~np.asarray(smask)
    assert off.sum() > 0
    assert np.all(np.asarray(dk)[off] == 0.0)
    np.testing.assert_array_equal(np.asarray(nrm)[off],
                                  np.tile([0.0, 0.0, 1.0], (off.sum(), 1)))
    assert np.all(np.asarray(curv)[off] == 0.0)


def test_radius_only_mode_matches_window_normals(cloud):
    """k=1 without a cap skips the bisection; the moments must equal
    the XLA radius-window normals (ops/normals.py)."""
    from buildingsegment_tpu.ops.fused import finish_normals
    from buildingsegment_tpu.ops.normals import estimate_normals_window

    sposf, smask = cloud
    dk, s0, s1, s2 = stats_sweep_triton(
        sposf, smask, k=1, window=32, radius=300.0, interpret=True
    )
    assert float(jnp.max(jnp.abs(dk))) == 0.0
    nrm2, curv2 = finish_normals(s0, s1, s2)
    nrm, curv = estimate_normals_window(sposf, smask, radius=300.0,
                                        window=32)
    _assert_normals_close(nrm, nrm2, curv, curv2, np.asarray(smask))


def test_sparse_cloud_degenerate_balls():
    """Fewer than k-1 candidates → dk = 0.0 (the XLA kNN convention)."""
    n = 512
    pos = np.full((n, 3), 2 ** 24, np.int32)
    pos[:3] = [[0, 0, 0], [100000, 0, 0], [0, 100000, 0]]
    mask = np.zeros(n, bool)
    mask[:3] = True
    spos, smask, _ = morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    sposf = spos.astype(jnp.float32)
    dk, _, _ = knn_normals_window_stats(
        sposf, smask, 15, window=32, radius=100.0, max_nn=50,
        impl="triton", interpret=True,
    )
    _, nb_d, _, _ = knn_normals_window_sorted(
        sposf, smask, 15, window=32, radius=100.0, max_nn=50
    )
    np.testing.assert_array_equal(np.asarray(dk), np.asarray(nb_d[:, 14]))
    assert float(jnp.max(dk)) == 0.0


def test_sharded_rows_match_single_device(cloud):
    """Under ``shard_map`` the ±W rows beside each shard come from the
    halo exchange (dist/halo.py) instead of fill; the sharded kernel
    must equal the unsharded one row for row."""
    import jax
    from jax.sharding import PartitionSpec as P

    from buildingsegment_tpu.dist.mesh import POINTS_AXIS, make_mesh

    sposf, smask = cloud
    kw = dict(k=15, window=32, radius=100.0, max_nn=50, interpret=True)
    ref = stats_sweep_triton(sposf, smask, **kw)
    rows, cols = P(POINTS_AXIS), P(POINTS_AXIS, None)
    got = jax.shard_map(
        lambda p, m: stats_sweep_triton(p, m, axis_name=POINTS_AXIS, **kw),
        mesh=make_mesh(4), in_specs=(cols, rows),
        out_specs=(rows, rows, cols, cols), check_vma=False,
    )(sposf, smask)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        # the same terms per row, summed by the same program
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_window_too_small_raises(cloud):
    with pytest.raises(ValueError):
        stats_sweep_triton(*cloud, k=40, window=16, radius=100.0,
                           interpret=True)


def test_cpu_default_is_the_xla_form(cloud):
    """Without ``impl`` the wrapper asks utils.platform: on CPU that is
    the fused XLA op, bit for bit."""
    sposf, smask = cloud
    _, nb_d, nrm, curv = knn_normals_window_sorted(
        sposf, smask, 15, window=48, radius=100.0, max_nn=50
    )
    dk, nrm2, curv2 = knn_normals_window_stats(
        sposf, smask, 15, window=48, radius=100.0, max_nn=50
    )
    np.testing.assert_array_equal(np.asarray(dk), np.asarray(nb_d[:, 14]))
    np.testing.assert_array_equal(np.asarray(nrm2), np.asarray(nrm))
    np.testing.assert_array_equal(np.asarray(curv2), np.asarray(curv))


def test_unknown_impl_raises(cloud):
    with pytest.raises(ValueError):
        knn_normals_window_stats(*cloud, 15, window=32, impl="mosaic")


@pytest.mark.parametrize("impl,want", [(None, "xla"), ("xla", "xla"),
                                       ("triton", "triton")])
def test_stats_impl_resolves(impl, want):
    """One resolver serves both callers: on CPU the default is XLA."""
    assert stats_impl(impl) == want


def test_window_normals_share_the_resolver(cloud):
    from buildingsegment_tpu.ops.normals import estimate_normals_window

    with pytest.raises(ValueError):
        estimate_normals_window(*cloud, radius=300.0, window=32,
                                impl="mosaic")


@pytest.mark.gpu
def test_compiled_kernel_on_card(gpu):
    """The Triton kernel compiled for the card against the XLA form at
    the bench scene's 1.08M points (chip_smoke.py phase c)."""
    import chip_smoke
    from buildingsegment_tpu.config import PipelineConfig

    cfg = PipelineConfig()
    pts, _, pos, mask = chip_smoke.scene_batch(cfg)
    chip_smoke.phase_c(cfg, pts, pos, mask)
