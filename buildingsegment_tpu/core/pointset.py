"""PointBatch — the device-resident point-cloud container.

Device-array re-expression of the reference's ``PCCPointSet3`` SoA container
(reference: tmc3/PCCPointSet.h:64-614): positions ``int32[N,3]``, colors
``uint16[N,3]`` (internal channel order (g, b, r), matching the
reference's storage convention at tmc3/ply.cpp:412-414), a per-point
plane label ``int32[N]`` (the reference's author-added ``planeIdx``
vector, tmc3/PCCPointSet.h:67), plus a validity mask because device
arrays are padded to a fixed capacity.

Unlike the C++ container (dynamic vectors, per-point accessors), this is
an immutable JAX pytree with static shapes: every transform returns a new
batch; XLA fuses the functional updates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Reference initializes planeIdx to -1 (tmc3/my_function.h:103).  Plain int
# so importing the package never touches a device backend.
UNLABELED = -1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointBatch:
    """A padded, fixed-capacity struct-of-arrays point cloud.

    Attributes:
        positions: int32[N, 3] — quantized positions (typically integer mm).
        mask: bool[N] — True for real points, False for padding.
        colors: optional uint16[N, 3] in internal (g, b, r) order.
        plane_idx: int32[N] — segmentation label; -1 = unlabeled; padding
            rows hold -1 and are excluded by ``mask``.
        reflectances: optional uint16[N] (tmc3/PCCPointSet.h:606).
        frame_idx: optional uint8[N] (tmc3/PCCPointSet.h:608).
        laser_angles: optional int32[N] (tmc3/PCCPointSet.h:613).

    The attribute arrays ride every gather/reorder so device-side
    filtering or resorting can never desynchronize them from positions
    (the reference's SoA container gives the same guarantee via
    ``swapPoints``/``append``, tmc3/PCCPointSet.h:414-547).
    """

    positions: jax.Array
    mask: jax.Array
    colors: Optional[jax.Array] = None
    plane_idx: Optional[jax.Array] = None
    reflectances: Optional[jax.Array] = None
    frame_idx: Optional[jax.Array] = None
    laser_angles: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def count(self) -> jax.Array:
        """Number of real points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def has_colors(self) -> bool:
        return self.colors is not None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @staticmethod
    def from_numpy(
        positions: np.ndarray,
        colors: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        reflectances: Optional[np.ndarray] = None,
        frame_idx: Optional[np.ndarray] = None,
        laser_angles: Optional[np.ndarray] = None,
    ) -> "PointBatch":
        """Build a padded batch from host arrays.

        Padding positions are filled with a large sentinel so padded rows
        never appear as nearest neighbors of real points.
        """
        n = positions.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pos = np.full((cap, 3), _PAD_COORD, dtype=np.int32)
        pos[:n] = positions.astype(np.int32)
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True

        def _pad1(a, dtype):
            if a is None:
                return None
            out = np.zeros((cap,) + a.shape[1:], dtype=dtype)
            out[:n] = a.astype(dtype)
            return jnp.asarray(out)

        plane_idx = np.full((cap,), -1, dtype=np.int32)
        return PointBatch(
            positions=jnp.asarray(pos),
            mask=jnp.asarray(mask),
            colors=_pad1(colors, np.uint16),
            plane_idx=jnp.asarray(plane_idx),
            reflectances=_pad1(reflectances, np.uint16),
            frame_idx=_pad1(frame_idx, np.uint8),
            laser_angles=_pad1(laser_angles, np.int32),
        )

    @staticmethod
    def upload(
        positions: np.ndarray, capacity: Optional[int] = None
    ) -> "PointBatch":
        """Compact host→device upload of positions only.

        The host↔device copy is on the multiscan pipeline's critical
        path, so this constructor ships the minimum: the raw
        coordinates — as ``uint16`` when the
        cloud's extent fits (building scans shifted to the origin
        almost always do: 65.5 m at mm scale), halving the transfer —
        plus a scalar count.  The padded int32 positions and the
        validity mask are materialized on device by a tiny jitted
        expansion; ``plane_idx``/attributes are left ``None`` (the
        segmentation pipeline reads only positions+mask).
        """
        n = positions.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        compact = (
            n > 0
            and positions.min() >= 0
            and positions.max() < 65535
        )
        raw = np.zeros((cap, 3), np.uint16 if compact else np.int32)
        if n:
            raw[:n] = positions.astype(raw.dtype)
        pos, mask = _expand_upload(
            jax.device_put(raw), jnp.int32(n)
        )
        return PointBatch(positions=pos, mask=mask)

    @staticmethod
    def from_host_cloud(cloud, capacity: Optional[int] = None) -> "PointBatch":
        """Build from an :class:`io.ply.HostPointCloud`, carrying every
        attribute onto the device."""
        return PointBatch.from_numpy(
            cloud.positions,
            colors=cloud.colors,
            capacity=capacity,
            reflectances=cloud.reflectances,
            frame_idx=cloud.frame_idx,
            laser_angles=cloud.laser_angles,
        )

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def with_positions(self, positions: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, positions=positions)

    def with_colors(self, colors: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, colors=colors)

    def with_plane_idx(self, plane_idx: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, plane_idx=plane_idx)

    def gather(self, order: jax.Array) -> "PointBatch":
        """Reorder ALL per-point arrays by ``order`` (e.g. a Morton sort).

        Every optional attribute moves with its point — a reorder can
        never desynchronize attributes from positions.
        """
        g = lambda a: None if a is None else a[order]
        return PointBatch(
            positions=self.positions[order],
            mask=self.mask[order],
            colors=g(self.colors),
            plane_idx=g(self.plane_idx),
            reflectances=g(self.reflectances),
            frame_idx=g(self.frame_idx),
            laser_angles=g(self.laser_angles),
        )

    def dedup_quantized(self, min_geom_node_size_log2: int = 0) -> "PointBatch":
        """Drop duplicate quantized positions (container-level dedup).

        Device re-expression of the reference's
        ``removeDuplicatePointInQuantizedPoint`` (tmc3/PCCPointSet.h:
        457-472): positions are low-bit-masked by
        ``min_geom_node_size_log2`` (when > 0), duplicates removed, and
        ``count`` reflects the new size (the reference's return value).

        Two deliberate departures from the C++ quirks, both documented:
        (a) the reference calls ``std::unique`` WITHOUT sorting, so it
        only collapses *adjacent* duplicates — here the sort-based
        global dedup (:func:`core.quantize.dedup_quantized`) removes
        every duplicate, keeping the first occurrence in index order
        (what the C++ achieves only on pre-sorted input); (b) the
        reference erases only the ``positions`` vector, leaving every
        attribute vector at the old length (an out-of-sync container) —
        here the whole row is masked out so attributes can never
        desynchronize.  Static shapes mean rows are masked, not erased.
        """
        from buildingsegment_tpu.core.quantize import dedup_quantized

        pos = self.positions
        if min_geom_node_size_log2 > 0:
            bitmask = jnp.int32(-1 << min_geom_node_size_log2)
            pos = jnp.where(self.mask[:, None], pos & bitmask, pos)
        keep = dedup_quantized(pos, self.mask)
        return dataclasses.replace(self, positions=pos, mask=keep)

    # ------------------------------------------------------------------
    # host export
    # ------------------------------------------------------------------

    def to_numpy(self) -> dict:
        """Copy the valid prefix back to host numpy arrays."""
        mask = np.asarray(self.mask)
        out = {"positions": np.asarray(self.positions)[mask]}
        for name in (
            "colors", "plane_idx", "reflectances", "frame_idx",
            "laser_angles",
        ):
            v = getattr(self, name)
            if v is not None:
                out[name] = np.asarray(v)[mask]
        return out


# Sentinel coordinate for padding rows: far away from any real point but
# small enough that squared distances stay well inside float32/int64 range.
_PAD_COORD = np.int32(2**24)


@jax.jit
def _expand_upload(raw, n):
    """Expand a compact upload: padded int32 positions + validity mask.

    Rows ≥ n become the large pad sentinel so they never appear as
    nearest neighbors of real points (same convention as from_numpy).
    """
    cap = raw.shape[0]
    rows = jnp.arange(cap, dtype=jnp.int32)
    mask = rows < n
    pos = jnp.where(
        mask[:, None], raw.astype(jnp.int32), jnp.int32(_PAD_COORD)
    )
    return pos, mask
