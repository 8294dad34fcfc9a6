"""Device-mesh construction and sharding helpers.

The reference is single-GPU (SURVEY.md §2.2: no NCCL/MPI anywhere); the
north star requires scaling over the cards of a host. The mesh is
jax.sharding.Mesh + shard_map, and XLA runs its collectives over NCCL.
Every card of the host reaches every other at the same rate, so the mesh
is 1-D and follows the algorithm alone.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "x"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D data mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_1d(x: jax.Array, mesh: Mesh, axis: str = DATA_AXIS) -> jax.Array:
    """Shard a 1-D array evenly over the mesh's data axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicated(x, mesh: Mesh) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))
