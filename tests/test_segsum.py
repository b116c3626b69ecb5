"""Small-table segment sums and lookups (ops/segsum.py) vs numpy.

These reductions build the finalize tables of seg/coarse.py.  Count
columns are integer sums and must match exactly; the float columns are
float32 sums in another order than numpy's float64 reference (and, on
the GPU, in an atomics order that changes from run to run), so they are
compared with a relative tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from buildingsegment_tpu.ops.segsum import (
    plane_payload_moment_sums,
    plane_sums,
    table_lookup,
    table_lookup_cols,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    n = 20_000
    ids = rng.integers(0, 700, size=n).astype(np.int32)
    payload = rng.normal(size=(n, 8)).astype(np.float32)
    payload[:, 0] = 1.0  # count column
    return ids, payload


class TestPlaneSums:
    def test_matches_scatter_add(self, data):
        ids, payload = data
        ref = np.zeros((1024, 8), np.float64)
        np.add.at(ref, ids, payload.astype(np.float64))
        got = np.asarray(plane_sums(
            jnp.asarray(ids), jnp.asarray(payload), jnp.int32(700),
            table_cap=1024,
        ))
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)

    def test_live_bound_excludes(self, data):
        ids, payload = data
        got = np.asarray(plane_sums(
            jnp.asarray(ids), jnp.asarray(payload), jnp.int32(256),
            table_cap=1024,
        ))
        assert np.all(got[256:] == 0.0)
        assert got[:256, 0].sum() == (ids < 256).sum()

    def test_out_of_range_ids_dropped(self):
        ids = jnp.asarray(np.array([-1, 0, 4, 5, 128, 9999], np.int32))
        got = np.asarray(plane_sums(ids, jnp.ones((6, 2), jnp.float32),
                                    jnp.int32(5), table_cap=128))
        assert got.shape == (128, 2)
        ref = np.zeros(128)
        ref[[0, 4]] = 1.0
        np.testing.assert_array_equal(got[:, 0], ref)


class TestTableLookup:
    def test_matches_gather(self, data):
        ids, _ = data
        lut = np.random.default_rng(4).normal(size=(1025,)).astype(
            np.float32)
        got = np.asarray(table_lookup(
            jnp.asarray(ids), jnp.asarray(lut), jnp.int32(701)))
        np.testing.assert_array_equal(got, lut[ids])

    def test_dead_ids_zero(self):
        ids = jnp.asarray(np.array([0, 5, 200, 900], np.int32))
        lut = jnp.asarray(np.ones(1024, np.float32))
        got = np.asarray(table_lookup(ids, lut, jnp.int32(128)))
        np.testing.assert_array_equal(got, [1.0, 1.0, 0.0, 0.0])


class TestTableLookupCols:
    def test_matches_gather(self, data):
        ids, _ = data
        lut = np.random.default_rng(9).normal(size=(1025, 3)).astype(
            np.float32)
        got = np.asarray(table_lookup_cols(
            jnp.asarray(ids), jnp.asarray(lut), jnp.int32(701)))
        assert got.shape == (3, len(ids))
        np.testing.assert_array_equal(got.T, lut[ids])

    def test_dead_ids_zero(self):
        ids = jnp.asarray(np.array([0, 5, 200, 900, 3], np.int32))
        lut = jnp.asarray(np.ones((1024, 2), np.float32))
        got = np.asarray(table_lookup_cols(ids, lut, jnp.int32(128)))
        np.testing.assert_array_equal(
            got, [[1, 1, 0, 0, 1], [1, 1, 0, 0, 1]]
        )

    def test_matches_single_col_lookup(self, data):
        ids, _ = data
        lut = np.random.default_rng(11).normal(size=(512, 3)).astype(
            np.float32)
        multi = np.asarray(table_lookup_cols(
            jnp.asarray(ids % 512), jnp.asarray(lut), jnp.int32(512)))
        for c in range(3):
            single = np.asarray(table_lookup(
                jnp.asarray(ids % 512), jnp.asarray(lut[:, c]),
                jnp.int32(512)))
            np.testing.assert_array_equal(multi[c], single)


class TestPlanePayloadMomentSums:
    def test_matches_two_pass_reference(self):
        rng = np.random.default_rng(21)
        n, P = 5000, 300
        ids = rng.integers(0, P, n).astype(np.int32)
        ids[::7] = 1024  # excluded rows (≥ live bound)
        pos = rng.uniform(0, 3e4, (n, 3)).astype(np.float32)
        cn = rng.normal(size=(n, 3)).astype(np.float32)
        pay = np.concatenate(
            [np.ones((n, 1)), cn, pos, (pos * pos).sum(1)[:, None]], 1
        ).astype(np.float32)
        q = rng.uniform(0, 3e4, (1024, 3)).astype(np.float32)
        A, M = plane_payload_moment_sums(
            jnp.asarray(ids), jnp.asarray(pay), jnp.asarray(q),
            jnp.int32(P), table_cap=1024)
        A, M = np.asarray(A), np.asarray(M)
        keep = ids < P
        refA = np.zeros((1024, 8))
        np.add.at(refA, ids[keep], pay[keep].astype(np.float64))
        d = pos[keep].astype(np.float64) - q[ids[keep]]
        mom = np.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1],
                        d[:, 2] * d[:, 2], d[:, 0] * d[:, 1],
                        d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], 1)
        refM = np.zeros((1024, 6))
        np.add.at(refM, ids[keep], mom)
        assert np.abs(A - refA).max() / np.abs(refA).max() < 1e-5
        assert np.abs(M - refM).max() / np.abs(refM).max() < 1e-4
        assert A[:, 0].sum() == keep.sum()
