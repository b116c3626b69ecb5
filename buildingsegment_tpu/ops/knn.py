"""k-nearest-neighbor graph construction — on-device.

Data-parallel replacement for the reference's Open3D KD-tree queries
(``KDTreeFlann::SearchKNN`` per-point loop, tmc3/my_function.h:71-78).
KD-trees are pointer-chasing structures that do not map to wide
data-parallel hardware.  Two strategies replace them:

:func:`knn` — exact tiled brute force.  Distances for a
  (query_tile × cand_tile) block come from one matrix product via the
  expansion |q-c|² = |q|² - 2 q·c + |c|², a running top-k per query is
  merged tile by tile with ``lax.top_k`` (never materializing the full
  N×N matrix), and an exact diff-form refinement pass re-ranks the
  k + margin survivors (float32 cancellation in the matmul expansion
  can misrank near-ties at mm scale).  O(N²) — the correctness oracle
  and the small-cloud path.

:func:`knn_window` — Morton-window search, the production path for
  large clouds.  Points are sorted by 60-bit Morton code (spatially
  coherent order); each point's candidates are the ±W window around it
  in sorted order, so the whole graph is one batched gather + diff-form
  distance + top_k with O(N·W) work and no sequential dependency —
  exactly the access pattern accelerators like.  Z-order
  discontinuities make this approximate: neighbor-set recall vs the
  brute-force oracle is
  ~0.78 at W=32 / ~0.83 at W=64 on sparse surface scans (tests pin the
  floor).  A single curve's misses live at Z-cell boundaries, so a
  SECOND pass over a TRANSLATED Morton order (coordinates offset by an
  alternating-bit constant — moves the cell boundaries at every scale)
  unioned with the first recovers almost all of them:
  recall 0.844 → 0.990 at W=64, 0.794 → 0.982 at W=48 (80 mm scan,
  seed 2) for 2× the sweep cost — :func:`knn_window` does this by
  default (``dual=True``).  The downstream region growing tolerates
  missing edges either way (window + global merges reconnect), and
  ground-truth segmentation agreement stays at 0.95+ on dense scans.
  (Measured dead ends, so nobody re-tries them: a Hilbert order
  changes single-pass recall by <1 point and its union with Z-order
  buys only ~+3 points — UNTRANSLATED curves' misses correlate on
  surfaces; a union over a second axis interleave buys ~+1.7.
  Translation is what decorrelates.)

Matching the reference layout, slot 0 of each neighbor list is the
query point itself (Open3D returns self as the nearest neighbor;
``seg_plane::Broad`` iterates slots 1..K-1, tmc3/my_function.cpp:224).

The padded-row convention: invalid (mask=False) rows never appear as
neighbors of valid rows; their own neighbor lists are all-self.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["knn", "knn_window", "knn_window_sorted", "window_offsets"]

_INF = float("inf")  # plain float: a device constant here would force backend init at import


def window_offsets(window: int) -> jax.Array:
    """Candidate offsets [-W..-1, 1..W] (self excluded), int32[2W]."""
    return jnp.concatenate(
        [jnp.arange(-window, 0), jnp.arange(1, window + 1)]
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "window"))
def knn_window_sorted(
    spos: jax.Array,
    smask: jax.Array,
    k: int,
    *,
    window: int = 32,
) -> Tuple[jax.Array, jax.Array]:
    """kNN over a ±window in an ALREADY Morton-sorted cloud.

    Zero general gathers: each offset's candidate column is a contiguous
    shifted slice of the sorted array, distances accumulate into a [2W, N]
    scratch, and one ``top_k`` ranks the window.

    Args:
        spos: float32[N, 3] positions in Morton order.
        smask: bool[N].
        k: neighbors per point INCLUDING self at slot 0.
        window: half-width (2·window candidates; 2·window ≥ k−1).

    Returns:
        (indices int32[N, k] in the SORTED frame, sq_dists float32[N, k]),
        slot 0 = self; empty slots fall back to self with distance 0.
    """
    n = spos.shape[0]
    if 2 * window < k - 1:
        raise ValueError(f"window {window} too small for k={k}")
    w2 = 2 * window

    # pad W rows of far-sentinel on both sides → every window is a
    # static contiguous slice
    pad_val = jnp.float32(-3e7)
    ppos = jnp.concatenate(
        [
            jnp.full((window, 3), pad_val, jnp.float32),
            spos.astype(jnp.float32),
            jnp.full((window, 3), pad_val, jnp.float32),
        ]
    )
    pmask = jnp.concatenate(
        [jnp.zeros(window, bool), smask, jnp.zeros(window, bool)]
    )

    base = spos.astype(jnp.float32)

    # fully unrolled static slices: a fori_loop + dynamic_slice version
    # pays a thunk launch and a slice copy per offset (kernel-launch
    # bound); static slices of the one padded array fuse into a few
    # big elementwise kernels
    # 1-D concat then reshape: jnp.stack of [n] rows would go through
    # [1, n] intermediates, which some layouts pad along the unit
    # dimension
    rows_d = []
    for slot in range(w2):
        start = slot if slot < window else slot + 1
        cand = lax.slice(ppos, (start, 0), (start + n, 3))
        cmask = lax.slice(pmask, (start,), (start + n,))
        diff = cand - base
        d = jnp.sum(diff * diff, axis=-1)
        rows_d.append(jnp.where(cmask & smask, d, _INF))
    d_all = jnp.concatenate(rows_d).reshape(w2, n)
    neg_top, arg = lax.top_k(-d_all.T, k - 1)  # [N, k-1]
    nb_d = -neg_top
    # slot index → signed offset, arithmetically (no table gather)
    off = jnp.where(arg < window, arg - window, arg - window + 1)
    rows = lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    nb_i = rows + off

    invalid = jnp.isinf(nb_d)
    nb_i = jnp.where(invalid, rows, nb_i)
    nb_d = jnp.where(invalid, 0.0, nb_d)
    nb_i = jnp.concatenate([rows, nb_i], axis=1)
    nb_d = jnp.concatenate([jnp.zeros((n, 1), jnp.float32), nb_d], axis=1)
    nb_i = jnp.where(smask[:, None], nb_i, rows)
    nb_d = jnp.where(smask[:, None], nb_d, 0.0)
    return nb_i, nb_d


#: per-axis translation for the second Morton pass: alternating-bit
#: constants shift every power-of-two cell boundary by ~1/3-1/2 cell at
#: every scale (measured best of {20,15,12}-bit variants; see module
#: docstring).  Distinct patterns per axis decorrelate the axes too.
_DUAL_SHIFT = (0xAAA, 0x555, 0x924)


@functools.partial(jax.jit, static_argnames=("k", "window", "presorted",
                                             "dual"))
def knn_window(
    positions: jax.Array,
    mask: jax.Array,
    k: int,
    *,
    window: int = 32,
    presorted: bool = False,
    dual: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Approximate kNN via ±window searches in Morton order.

    Convenience wrapper over :func:`knn_window_sorted` that sorts,
    searches, and maps the result back to the ORIGINAL point order.
    With ``dual=True`` (default) a second pass over a TRANSLATED
    Morton order is unioned in — recall 0.99 vs 0.84 single-pass at
    W=64 (module docstring) for 2× the sweep cost.  With
    ``presorted=True`` the input is assumed already Morton-sorted and
    results stay in that frame (no unsort scatter; the dual pass still
    internally re-sorts its translated copy).
    """
    from buildingsegment_tpu.core.morton import morton_argsort

    n = positions.shape[0]
    self_idx = lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]

    def one_pass(order):
        """Window kNN along ``order``; ids mapped back to input frame."""
        spos = positions[order].astype(jnp.float32)
        smask = mask[order]
        nb_sorted, nb_d = knn_window_sorted(spos, smask, k, window=window)
        nb_orig = order[nb_sorted]
        out_i = jnp.zeros((n, k), jnp.int32).at[order].set(nb_orig)
        out_d = jnp.zeros((n, k), jnp.float32).at[order].set(nb_d)
        return out_i, out_d

    if presorted and not dual:
        return knn_window_sorted(
            positions.astype(jnp.float32), mask, k, window=window
        )
    if presorted:
        i1, d1 = knn_window_sorted(
            positions.astype(jnp.float32), mask, k, window=window
        )
    else:
        i1, d1 = one_pass(morton_argsort(positions, mask))

    if dual:
        shift = jnp.asarray(_DUAL_SHIFT, positions.dtype)
        order2 = morton_argsort(positions + shift, mask)
        i2, d2 = one_pass(order2)
        # union of the two passes (slot 0 = self dropped, restored at
        # the end): entries that fell back to self (not enough valid
        # peers in that pass) must not poison the merge with d=0
        cand_i = jnp.concatenate([i1[:, 1:], i2[:, 1:]], axis=1)
        cand_d = jnp.concatenate([d1[:, 1:], d2[:, 1:]], axis=1)
        cand_d = jnp.where(cand_i == self_idx[:, None], _INF, cand_d)
        # dedup: per-row sort by id, mark repeats, then rank by distance
        s_i, s_d = lax.sort((cand_i, cand_d), dimension=1, num_keys=1,
                            is_stable=False)
        dup = jnp.concatenate(
            [jnp.zeros((n, 1), bool), s_i[:, 1:] == s_i[:, :-1]], axis=1
        )
        s_d = jnp.where(dup, _INF, s_d)
        # 2-operand sort, NOT top_k + take_along_axis: the sort carries
        # the ids along instead of gathering them per row
        r_d, r_i = lax.sort((s_d, s_i), dimension=1, num_keys=1,
                            is_stable=False)
        nb_d = r_d[:, : k - 1]
        nb_i = r_i[:, : k - 1]
        invalid = jnp.isinf(nb_d)
        nb_i = jnp.where(invalid, self_idx[:, None], nb_i)
        nb_d = jnp.where(invalid, 0.0, nb_d)
        out_i = jnp.concatenate([self_idx[:, None], nb_i], axis=1)
        out_d = jnp.concatenate([jnp.zeros((n, 1), jnp.float32), nb_d],
                                axis=1)
    else:
        out_i, out_d = i1, d1

    out_i = jnp.where(mask[:, None], out_i, self_idx[:, None])
    out_d = jnp.where(mask[:, None], out_d, 0.0)
    return out_i, out_d


@functools.partial(
    jax.jit, static_argnames=("k", "query_tile", "cand_tile", "refine_margin")
)
def knn(
    positions: jax.Array,
    mask: jax.Array,
    k: int,
    *,
    query_tile: int = 512,
    cand_tile: int = 2048,
    refine_margin: int = 8,
) -> Tuple[jax.Array, jax.Array]:
    """Exact brute-force kNN graph.

    Args:
        positions: int32/float [N, 3]; N must be a multiple of
            query_tile and of cand_tile (pad the batch first).
        mask: bool[N] validity.
        k: neighbors per point INCLUDING self at slot 0.
        query_tile / cand_tile: block sizes for the tiled ranking.
        refine_margin: extra candidates kept for the exact re-rank.

    Returns:
        (indices int32[N, k], sq_dists float32[N, k]) — slot 0 is self
        with distance 0; slots 1.. are nearest others, ascending.
    """
    n = positions.shape[0]
    # shrink tiles to the largest power-of-two divisors of N (shapes are
    # static at trace time, so this costs nothing at runtime)
    while query_tile > 1 and n % query_tile:
        query_tile //= 2
    while cand_tile > 1 and n % cand_tile:
        cand_tile //= 2
    if n % query_tile or n % cand_tile:
        raise ValueError(
            f"N={n} must be divisible by a power-of-two tile; pad the "
            f"batch capacity (got query_tile={query_tile}, "
            f"cand_tile={cand_tile})"
        )
    kk = k - 1  # neighbors excluding self
    kr = kk + refine_margin  # ranked candidates before exact re-rank

    # Center to cut float32 magnitude (cancellation mitigation #1).
    center = jnp.sum(
        jnp.where(mask[:, None], positions, 0).astype(jnp.float32), axis=0
    ) / jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    pos = positions.astype(jnp.float32) - center

    # Padded rows get a far-away sentinel; their distances are also
    # masked to inf below so they can never occupy a slot even when
    # real peers run out.
    far = jnp.float32(3e7)
    pos = jnp.where(mask[:, None], pos, far)

    cand_sq = jnp.sum(pos * pos, axis=-1)  # [N]
    cand_valid = mask

    num_q_tiles = n // query_tile
    num_c_tiles = n // cand_tile

    def per_query_tile(qi):
        q_start = qi * query_tile
        q = lax.dynamic_slice(pos, (q_start, 0), (query_tile, 3))
        q_sq = jnp.sum(q * q, axis=-1)
        q_idx = q_start + lax.broadcasted_iota(jnp.int32, (query_tile, 1), 0)[:, 0]

        def merge_tile(carry, ci):
            best_d, best_i = carry
            c_start = ci * cand_tile
            c = lax.dynamic_slice(pos, (c_start, 0), (cand_tile, 3))
            c_sq = lax.dynamic_slice(cand_sq, (c_start,), (cand_tile,))
            # [qt, ct] block as one matrix product.  precision=HIGHEST:
            # a bf16 or TF32 product's ~1e-3 relative error on q·c
            # (~1e9 at mm scale) swamps real squared distances and
            # drops true neighbors
            d = (
                q_sq[:, None]
                - 2.0 * jnp.dot(
                    q, c.T,
                    preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST,
                )
                + c_sq[None, :]
            )
            c_idx = c_start + lax.broadcasted_iota(
                jnp.int32, (query_tile, cand_tile), 1
            )
            # exclude self — it is prepended at slot 0 afterwards —
            # and padded candidates
            c_valid = lax.dynamic_slice(cand_valid, (c_start,), (cand_tile,))
            d = jnp.where(
                (c_idx == q_idx[:, None]) | ~c_valid[None, :], _INF, d
            )
            all_d = jnp.concatenate([best_d, d], axis=1)
            all_i = jnp.concatenate([best_i, c_idx], axis=1)
            neg_top, arg = lax.top_k(-all_d, kr)
            return (
                -neg_top,
                jnp.take_along_axis(all_i, arg, axis=1),
            ), None

        init = (
            jnp.full((query_tile, kr), _INF, jnp.float32),
            jnp.zeros((query_tile, kr), jnp.int32),
        )
        (best_d, best_i), _ = lax.scan(
            merge_tile, init, jnp.arange(num_c_tiles)
        )

        # Exact diff-form re-rank of the kr survivors (cancellation
        # mitigation #2): gather candidate coords, recompute precisely.
        cand_pos = pos[best_i]  # [qt, kr, 3]
        diff = cand_pos - q[:, None, :]
        d_exact = jnp.sum(diff * diff, axis=-1)
        d_exact = jnp.where(jnp.isinf(best_d), _INF, d_exact)
        neg_top, arg = lax.top_k(-d_exact, kk)
        nb_d = -neg_top
        nb_i = jnp.take_along_axis(best_i, arg, axis=1)

        # slot 0 = self (reference layout, my_function.h:76-78)
        nb_i = jnp.concatenate([q_idx[:, None], nb_i], axis=1)
        nb_d = jnp.concatenate(
            [jnp.zeros((query_tile, 1), jnp.float32), nb_d], axis=1
        )
        return nb_i, nb_d

    nb_i, nb_d = lax.map(per_query_tile, jnp.arange(num_q_tiles))
    nb_i = nb_i.reshape(n, k)
    nb_d = nb_d.reshape(n, k)

    # Invalid rows: all-self, distance 0.  Valid rows with fewer than k-1
    # valid peers keep self-index entries (inf distance slots clamp to self).
    self_idx = lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    invalid_slot = jnp.isinf(nb_d)
    nb_i = jnp.where(invalid_slot, self_idx[:, None], nb_i)
    nb_d = jnp.where(invalid_slot, 0.0, nb_d)
    nb_i = jnp.where(mask[:, None], nb_i, self_idx[:, None])
    nb_d = jnp.where(mask[:, None], nb_d, 0.0)
    return nb_i, nb_d
