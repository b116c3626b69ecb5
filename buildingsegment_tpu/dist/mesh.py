"""Device-mesh construction and sharding specs.

The reference is a single-process, single-thread CPU binary with no
parallelism of any kind (SURVEY.md §2.5).  The rebuild's scaling axis is
*points*: the padded point tensor shards across a 1-D ``points`` mesh
axis (the data/sequence-parallel analog for a geometry pipeline), and
XLA's SPMD partitioner inserts the collectives (all-gathers for
neighbor lookups across shard boundaries, reductions for segment
statistics) — instead of a hand-written NCCL/MPI backend.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh", "make_multihost_mesh", "point_sharding", "replicated",
    "POINTS_AXIS",
]

POINTS_AXIS = "points"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """1-D mesh over the ``points`` axis.

    Raises when fewer than ``n_devices`` devices exist — silently
    truncating would turn an "8-device" run into a 1-device one.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise RuntimeError(
                    f"requested a {n_devices}-device mesh but only "
                    f"{len(devices)} devices are visible "
                    f"({devices[0].platform}); for a virtual CPU mesh "
                    "set XLA_FLAGS=--xla_force_host_platform_device_count"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(POINTS_AXIS,))


def make_multihost_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D ``points`` mesh ordered host-contiguously (multi-host).

    The sharded pipeline's communication is ring-structured: the only
    per-sweep exchanges are (a) ±W halo rows between *adjacent* shards
    (``lax.ppermute`` in dist/halo.py) and (b) O(L)-sized psum/pmin
    label tables.  Ordering the mesh by ``(process_index, local id)``
    maps Morton-contiguous shard ranges host-contiguously, so the halo
    ring crosses the inter-host network only at the H−1 host
    boundaries — one W-row message per boundary per sweep — and stays
    on the intra-host links (NVLink) everywhere else; the table
    reductions are small enough to tolerate the slower link by size.
    On a single host this is exactly :func:`make_mesh`.

    (The reference has no multi-process story at all — single-thread
    CPU binary, tmc3/TMC3.cpp:202-229; SURVEY.md §2.5 names this layout
    as the rebuild's multi-host design.)
    """
    devices = sorted(
        jax.devices(),
        key=lambda d: (d.process_index, getattr(d, "local_hardware_id", 0), d.id),
    )
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(POINTS_AXIS,))


def point_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (points) dimension; replicate the rest."""
    return NamedSharding(mesh, P(POINTS_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
