"""Distributed tests on the fake 8-device CPU mesh (SURVEY.md §4).

The distributed correctness criteria:
  * numerical identity between the single-device and 8-shard runs of
    the shard_map pipeline, and against the single-device production
    path (same algorithm, no resharding artifacts);
  * the compiled HLO of the sweep body contains NO all-gather — the
    collectives are ppermute halo exchanges and psum/pmin table
    reductions only (VERDICT round-1 item 2's done criterion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from buildingsegment_tpu.config import PipelineConfig
from buildingsegment_tpu.dist.mesh import (
    POINTS_AXIS, make_mesh, make_multihost_mesh, point_sharding,
)
from buildingsegment_tpu.dist.sharded import sharded_pipeline, sharded_seg_body
from buildingsegment_tpu.utils.synthetic import make_building_cloud

CFG = PipelineConfig(normal_radius=1e6, pad_to_multiple=1024)
# denser scan so walls clear the reference's >400-point cull
DENSE_CFG = PipelineConfig(
    normal_radius=1e6, pad_to_multiple=1024, th_point_count=100
)

pytestmark = pytest.mark.slow


def _padded(pts, cap):
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    return pos, mask


@pytest.fixture(scope="module")
def cloud():
    pts, truth = make_building_cloud(seed=11, spacing_mm=250.0, noise_mm=10.0)
    n = len(pts)
    cap = CFG.padded_count(n)
    pos, mask = _padded(pts, cap)
    return pos, mask, n


def test_eight_fake_devices_available():
    assert len(jax.devices()) == 8


def test_multihost_mesh_single_host_equals_make_mesh():
    # host-contiguous ordering reduces to the plain mesh on one host
    m1 = make_mesh(8)
    m2 = make_multihost_mesh(8)
    assert m2.size == 8 and m2.axis_names == (POINTS_AXIS,)
    assert [d.id for d in m2.devices.ravel()] == [
        d.id for d in m1.devices.ravel()
    ]


def test_make_mesh_refuses_truncation():
    with pytest.raises(RuntimeError, match="9-device"):
        make_mesh(9)


def test_halo_pad_ring():
    from buildingsegment_tpu.dist.halo import halo_pad

    mesh = make_mesh(4)
    x = jnp.arange(32, dtype=jnp.int32)

    def body(xl):
        return halo_pad(xl, 2, POINTS_AXIS)

    out = jax.shard_map(
        body, mesh=mesh, in_specs=P(POINTS_AXIS), out_specs=P(POINTS_AXIS),
        check_vma=False,
    )(x)
    out = np.asarray(out).reshape(4, 12)
    # shard 1 local rows 8..15: left halo = 6,7 right halo = 16,17
    np.testing.assert_array_equal(out[1], [6, 7, *range(8, 16), 16, 17])
    # global edges zero-filled
    np.testing.assert_array_equal(out[0][:2], [0, 0])
    np.testing.assert_array_equal(out[3][-2:], [0, 0])


def test_halo_pad_multihop_short_shards():
    """Regression: halo width > local shard rows.

    8 rows per shard against window 16 (the dryrun's deepest coarse
    level) must still return exactly w rows per side by walking the
    ring two hops — a single-hop version silently truncated and the
    static window slices then walked off the padded array."""
    from buildingsegment_tpu.dist.halo import halo_pad

    mesh = make_mesh(8)
    x = jnp.arange(64, dtype=jnp.int32)  # 8 rows per shard

    out = jax.shard_map(
        lambda xl: halo_pad(xl, 16, POINTS_AXIS), mesh=mesh,
        in_specs=P(POINTS_AXIS), out_specs=P(POINTS_AXIS),
        check_vma=False,
    )(x)
    out = np.asarray(out).reshape(8, 40)
    # shard 2 local rows 16..23: left halo = rows 0..15, right = 24..39
    np.testing.assert_array_equal(out[2], np.arange(40))
    # shard 1: left halo = 8 zeros (past the global edge) then rows 0..7
    np.testing.assert_array_equal(out[1][:16], [0] * 8 + list(range(8)))
    # last shard: right halo fully zero
    np.testing.assert_array_equal(out[7][-16:], [0] * 16)


def test_dryrun_shape_small_coarse_shards():
    """``__graft_entry__.dryrun_multichip``'s exact shape on the CPU
    mesh: 4096 points,
    8 shards, production seg_levels — the deepest coarse level has
    fewer rows per shard than the propagation window."""
    cfg = PipelineConfig(knn_method="window", pad_to_multiple=1024)
    pts, _ = make_building_cloud(
        seed=0, spacing_mm=50.0, width_mm=3000.0, depth_mm=2500.0,
        wall_h_mm=2000.0, ridge_h_mm=2600.0,
    )
    pts = pts[:4096]
    pos, mask = _padded(pts, cfg.padded_count(len(pts)))
    fn = sharded_pipeline(make_mesh(8), cfg)
    _, _, seg = fn(jnp.asarray(pos), jnp.asarray(mask))
    assert int(seg.num_planes) >= 1


def test_sharded_matches_single_device(cloud):
    pos, mask, n = cloud
    fn8 = sharded_pipeline(make_mesh(8), CFG)
    fn1 = sharded_pipeline(make_mesh(1), CFG)

    s8, lo8, seg8 = fn8(jnp.asarray(pos), jnp.asarray(mask))
    s1, lo1, seg1 = fn1(jnp.asarray(pos), jnp.asarray(mask))

    np.testing.assert_array_equal(np.asarray(lo8), np.asarray(lo1))
    np.testing.assert_array_equal(np.asarray(s8), np.asarray(s1))
    np.testing.assert_array_equal(
        np.asarray(seg8.plane_idx), np.asarray(seg1.plane_idx)
    )
    assert int(seg8.num_planes) == int(seg1.num_planes)
    np.testing.assert_array_equal(
        np.asarray(seg8.plane_count), np.asarray(seg1.plane_count)
    )


def test_sharded_matches_production_single_device(cloud):
    # the shard_map path must compute exactly what the single-device
    # production path (window kNN + multigrid) computes
    from buildingsegment_tpu.pipeline import run_device_pipeline

    pos, mask, n = cloud
    fn8 = sharded_pipeline(make_mesh(8), CFG)
    _, _, seg8 = fn8(jnp.asarray(pos), jnp.asarray(mask))
    _, _, seg = run_device_pipeline(
        jnp.asarray(pos), jnp.asarray(mask),
        k_search=16, knn_k=CFG.knn_k, normal_radius=CFG.normal_radius,
        normal_max_nn=CFG.normal_max_nn, th_thickness=CFG.th_thickness,
        th_normal_cos=CFG.th_normal_cos, th_point_count=CFG.th_point_count,
        max_planes=CFG.max_planes, max_sweeps=CFG.max_sweeps,
        knn_method="window", knn_window_size=CFG.knn_window,
        convergence_tol=CFG.seg_convergence_tol,
        seg_group=CFG.seg_group, seg_levels=CFG.seg_levels,
        seg_refine_sweeps=CFG.seg_refine_sweeps,
    )
    np.testing.assert_array_equal(
        np.asarray(seg8.plane_idx), np.asarray(seg.plane_idx)
    )
    assert int(seg8.num_planes) == int(seg.num_planes)


def test_sharded_output_sharding(cloud):
    pos, mask, n = cloud
    fn = sharded_pipeline(make_mesh(8), CFG)
    shifted, lo, seg = fn(jnp.asarray(pos), jnp.asarray(mask))
    assert shifted.shape == pos.shape
    assert seg.plane_idx.shape == (pos.shape[0],)


def test_finds_planes_sharded():
    pts, truth = make_building_cloud(seed=3, spacing_mm=150.0, noise_mm=8.0)
    cap = DENSE_CFG.padded_count(len(pts))
    pos, mask = _padded(pts, cap)
    fn = sharded_pipeline(make_mesh(8), DENSE_CFG)
    _, _, seg = fn(jnp.asarray(pos), jnp.asarray(mask))
    assert int(seg.num_planes) >= 5


def test_sweep_hlo_has_no_all_gather(cloud):
    """The done criterion for the distribution layer (VERDICT item 2):
    the compiled sweep body moves halo rows (collective-permute) and
    label tables (all-reduce) — never a full-[N] all-gather."""
    pos, mask, n = cloud
    mesh = make_mesh(8)
    body = sharded_seg_body(mesh, CFG)
    spos = jax.ShapeDtypeStruct(
        (pos.shape[0], 3), jnp.float32,
        sharding=NamedSharding(mesh, P(POINTS_AXIS, None)),
    )
    smask = jax.ShapeDtypeStruct(
        (pos.shape[0],), jnp.bool_,
        sharding=NamedSharding(mesh, P(POINTS_AXIS)),
    )
    txt = jax.jit(body).lower(spos, smask).compile().as_text()
    assert "all-gather" not in txt, "sweep body all-gathers point data"
    # sanity: the collectives we DO expect are present
    assert "collective-permute" in txt  # ppermute halo exchange
    assert "all-reduce" in txt  # psum/pmin label tables
