"""Bilinear scatter-add rasterization — on-device ortho splatting.

Data-parallel replacement for the reference's per-point 2×2 splat loop
(tmc3/TMC3.cpp:132-148): every point at or above the ground threshold
deposits bilinear weights into a (height × width) raster — weight into
the density channel, weight × z into the height channel.  Here all four
corner contributions for all points are expressed as one batched
scatter-add (XLA lowers to efficient on-device scatter), no host loop.

Semantics parity notes:
  * integer cell = floor(p/bin) via integer division on non-negative
    coords; fractional weight = p/bin − cell (tmc3/TMC3.cpp:134-142).
  * points below the threshold are skipped (the reference's ``continue``
    is inside the 2×2 loop but is equivalent to skipping the point,
    tmc3/TMC3.cpp:139-140).
  * raster dims are (bbox_extent / bin + 2) (tmc3/TMC3.cpp:75-77) so
    the +1 corner never lands out of bounds.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["bilinear_splat"]


@functools.partial(jax.jit, static_argnames=("width", "height", "bin_size"))
def bilinear_splat(
    positions: jax.Array,
    mask: jax.Array,
    z_threshold: jax.Array,
    *,
    width: int,
    height: int,
    bin_size: int = 100,
) -> Tuple[jax.Array, jax.Array]:
    """Splat points into (density, height_sum) rasters.

    Args:
        positions: int32[N, 3], non-negative (bbox-shifted) coords.
        mask: bool[N].
        z_threshold: scalar — points with z < threshold are skipped
            (the ground filter, tmc3/TMC3.cpp:139).
        width/height/bin_size: raster geometry.

    Returns:
        (density float32[height, width], height_sum float32[height, width])
        — the reference's channel 1 and channel 0 respectively
        (tmc3/TMC3.cpp:144-145).
    """
    pos = positions
    keep = mask & (pos[:, 2] >= z_threshold)

    cx = pos[:, 0] // bin_size
    cy = pos[:, 1] // bin_size
    fx = pos[:, 0].astype(jnp.float32) / bin_size - cx.astype(jnp.float32)
    fy = pos[:, 1].astype(jnp.float32) / bin_size - cy.astype(jnp.float32)

    wm = keep.astype(jnp.float32)
    z = pos[:, 2].astype(jnp.float32)

    # corner weights: (xi, yi) ∈ {0,1}² with s = wx(xi) * wy(yi)
    w00 = (1.0 - fx) * (1.0 - fy) * wm
    w10 = fx * (1.0 - fy) * wm
    w01 = (1.0 - fx) * fy * wm
    w11 = fx * fy * wm

    n = pos.shape[0]
    flat = lambda x, y: jnp.clip(y, 0, height - 1) * width + jnp.clip(
        x, 0, width - 1
    )
    idx = jnp.concatenate(
        [flat(cx, cy), flat(cx + 1, cy), flat(cx, cy + 1), flat(cx + 1, cy + 1)]
    )
    w = jnp.concatenate([w00, w10, w01, w11])

    # two flat scatters (one [4N, 2] scatter is the alternative; not
    # measured on the H100 yet)
    density = jnp.zeros(width * height, jnp.float32).at[idx].add(w)
    height_sum = jnp.zeros(width * height, jnp.float32).at[idx].add(
        w * jnp.tile(z, 4)
    )
    return density.reshape(height, width), height_sum.reshape(height, width)
