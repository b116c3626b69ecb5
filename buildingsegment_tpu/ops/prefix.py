"""Integer prefix sum of the label compaction and dense renumbering.

Used by ``seg.region_grow`` / ``seg.coarse`` on every backend, so CPU
tests exercise the identical op.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["prefix_sum_i32"]


def prefix_sum_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum of an int32[n] vector (exact: int32 adds)."""
    return jnp.cumsum(x.astype(jnp.int32), dtype=jnp.int32)
