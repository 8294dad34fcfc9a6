"""Distributed digit histogram: per-shard histograms + psum.

The multi-device analog of BuildHistogramsKernel + the digit-major global
scan (LSDRadixSort.cu:660-702, 877-895): every shard histograms its rows
on its device, then one psum over the mesh axis yields the exact global
digit counts — the metadata driving distributed radix partitioning.
"""
from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from lsdradixsort.ops.primitives import digit_histogram
from lsdradixsort.parallel.mesh import DATA_AXIS


@functools.partial(jax.jit, static_argnames=("r", "group", "mesh", "axis"))
def dist_digit_histogram(keys: jax.Array, r: int, group: int, mesh: Mesh,
                         axis: str = DATA_AXIS) -> jax.Array:
    """Global histogram of the `group`-th r-bit digit over sharded keys.

    Returns the replicated (2**r,) uint32 global counts.
    """
    def shard_fn(k):
        local = digit_histogram(k, r, group)
        return jax.lax.psum(local, axis)

    return shard_map(shard_fn, mesh=mesh, in_specs=P(axis),
                     out_specs=P())(keys)
