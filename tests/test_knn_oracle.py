"""Exact brute-force kNN (ops/knn.knn) against scipy's KD-tree.

The distances come from a [query, candidate] matrix product at
``Precision.HIGHEST`` plus an exact diff-form re-rank, so on integer
coordinates they match the float64 KD-tree to float32 rounding of d²
(rtol 1e-6, atol 0.01 mm²).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from buildingsegment_tpu.ops.knn import knn


def _pad(pts, capacity):
    n = pts.shape[0]
    pos = np.full((capacity, 3), 2 ** 24, np.int32)
    pos[:n] = pts
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return jnp.asarray(pos), jnp.asarray(mask), n


def _oracle(pts, k):
    od, _ = cKDTree(pts.astype(np.float64)).query(pts, k=k)
    return od ** 2


@pytest.mark.parametrize("query_tile,cand_tile", [
    (128, 128), (256, 1024), (512, 2048),
])
def test_matches_kdtree(rng, query_tile, cand_tile):
    pts = rng.integers(0, 5000, size=(2000, 3)).astype(np.int32)
    pos, mask, n = _pad(pts, 2048)
    # the plain reference runs at full float32 matmul precision
    with jax.default_matmul_precision("highest"):
        idx, d = knn(pos, mask, k=15, query_tile=query_tile,
                     cand_tile=cand_tile)
    idx, d = np.asarray(idx), np.asarray(d)
    np.testing.assert_array_equal(idx[:n, 0], np.arange(n))
    np.testing.assert_allclose(d[:n], _oracle(pts, 15), rtol=1e-6,
                               atol=0.01)


def test_morton_sorted_scene_matches_kdtree():
    """A building scan in Morton order (the production row order)."""
    from buildingsegment_tpu.core.morton import morton_argsort
    from buildingsegment_tpu.utils.synthetic import make_building_cloud

    pts, _ = make_building_cloud(seed=2, spacing_mm=150.0)
    pts = pts[:4000]
    pos, mask, n = _pad(pts, 4096)
    order = np.asarray(morton_argsort(pos, mask))
    pos, mask = pos[order], mask[order]
    spts = np.asarray(pos[:n])
    _, d = knn(pos, mask, k=15)
    np.testing.assert_allclose(np.asarray(d)[:n], _oracle(spts, 15),
                               rtol=1e-6, atol=0.01)


def test_sorted_ascending(rng):
    pts = rng.integers(0, 2000, size=(256, 3)).astype(np.int32)
    pos, mask, n = _pad(pts, 256)
    _, d = knn(pos, mask, k=8, query_tile=128, cand_tile=128)
    d = np.asarray(d)[:n]
    assert (np.diff(d, axis=1) >= 0).all()


def test_padding_and_small_clouds():
    pts = np.array([[0, 0, 0], [5, 0, 0], [0, 5, 0]], np.int32)
    pos, mask, n = _pad(pts, 128)
    idx, d = knn(pos, mask, k=6)
    idx = np.asarray(idx)
    assert idx[0, 0] == 0
    assert set(idx[0, 1:3]) == {1, 2}
    assert (idx[0, 3:] == 0).all()  # empty slots → self
    assert (idx[3:] == np.arange(3, 128)[:, None]).all()


def test_tiles_shrink_to_divide_n(rng):
    """N = 1000 is no multiple of the default tiles: they halve until
    they divide it (8 here), and the result stays exact."""
    pts = rng.integers(0, 20_000, size=(1000, 3)).astype(np.int32)
    _, d = knn(jnp.asarray(pts), jnp.ones(1000, bool), k=10)
    np.testing.assert_allclose(np.asarray(d), _oracle(pts, 10), rtol=1e-6,
                               atol=0.01)


def test_multi_tile_grid(rng):
    pts = rng.integers(0, 20_000, size=(1000, 3)).astype(np.int32)
    pos, mask, n = _pad(pts, 1024)
    _, d = knn(pos, mask, k=10, query_tile=128, cand_tile=256)
    np.testing.assert_allclose(np.asarray(d)[:n], _oracle(pts, 10),
                               rtol=1e-6, atol=0.01)


@pytest.mark.gpu
def test_exact_knn_on_card(gpu):
    """64k points on the card against the KD-tree (chip_smoke phase f)."""
    import chip_smoke

    chip_smoke.phase_f()
