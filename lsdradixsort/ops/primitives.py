"""The reference's primitives in plain JAX.

The reference builds its LSD radix sort from per-block digit histograms
(BuildHistogramsKernel, LSDRadixSort.cu:660-702), exclusive prefix sums
(BlockPrefixSumKernel / GPUPrefixSum, cu:141-302) and a stable
rank-and-scatter. Here each is the plain `jax.numpy`/`lax` spelling that
XLA compiles for the GPU: a scatter-add histogram per block, `cumsum`,
and a `cummax` + gather fill-forward. Every result is an exact integer,
checked bit-for-bit against the numpy golden models (golden/oracles.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.core.digits import get_digit


# keys per histogram in digit_histogram: one count table per block spreads
# the scatter-add's atomic increments over many counters, where a single
# 2**r-bin table makes them contend
_HIST_BLOCK = 1 << 15


def _block_counts(keys, r: int, group: int, block_size: int):
    n = keys.shape[0]
    blocks = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) // block_size
    hist = jnp.zeros((-(-n // block_size), 1 << r), jnp.uint32)
    return hist.at[blocks, get_digit(keys, r, group)].add(jnp.uint32(1))


@functools.partial(jax.jit, static_argnames=("r", "group", "block_size"))
def block_digit_histograms(keys: jax.Array, r: int, group: int,
                           block_size: int) -> jax.Array:
    """Per-block digit histograms: (num_blocks, 2**r) uint32.

    Block i's row counts r-bit digit `group` occurrences among
    keys[i*block_size:(i+1)*block_size] — the contract of
    BuildHistogramsKernel (LSDRadixSort.cu:660-702). Requires
    len(keys) % block_size == 0.
    """
    n = keys.shape[0]
    if n % block_size:
        raise ValueError(f"n={n} must be divisible by block_size="
                         f"{block_size}")
    return _block_counts(keys, r, group, block_size)


@functools.partial(jax.jit, static_argnames=("r", "group"))
def digit_histogram(keys: jax.Array, r: int, group: int) -> jax.Array:
    """Whole-array digit histogram: (2**r,) uint32, any length."""
    return jnp.sum(_block_counts(keys, r, group, _HIST_BLOCK), axis=0,
                   dtype=jnp.uint32)


@jax.jit
def exclusive_scan(x: jax.Array) -> jax.Array:
    """Exclusive prefix sum of a 1-D integer array, modular in its dtype
    (GPUPrefixSum, LSDRadixSort.cu:265-302, without its divisibility
    requirement)."""
    return jnp.cumsum(x, dtype=x.dtype) - x


@functools.partial(jax.jit, static_argnames=("block_size",))
def block_prefix_sums(x: jax.Array, block_size: int):
    """Independent exclusive scan of each block + per-block totals.

    Mirrors BlockPrefixSumKernel with carry-out (LSDRadixSort.cu:180-207):
    returns (scans, block_sums) where scans[i*B:(i+1)*B] is the exclusive
    scan of block i and block_sums[i] its total. Requires
    n % block_size == 0.
    """
    n = x.shape[0]
    if n % block_size:
        raise ValueError(f"n={n} must be divisible by block_size="
                         f"{block_size}")
    blocks = x.reshape(n // block_size, block_size)
    incl = jnp.cumsum(blocks, axis=1, dtype=x.dtype)
    return (incl - blocks).reshape(n), incl[:, -1]


@jax.jit
def fill_forward_last(flag: jax.Array, key: jax.Array, val: jax.Array):
    """For each row i: the (key, val) of the last row j <= i with flag[j],
    plus a validity mask (0 until the first flagged row).

    The segmented broadcast behind the join and the window ranks: a
    running max of flagged row indices, then one gather per column.
    Returns (keys, vals, valid), each (n,) uint32; keys and vals are 0
    where valid is 0.
    """
    idx = jax.lax.broadcasted_iota(jnp.int32, flag.shape, 0)
    last = jax.lax.cummax(jnp.where(flag, idx, -1), axis=0)
    valid = last >= 0
    src = jnp.maximum(last, 0)
    zero = jnp.uint32(0)
    return (jnp.where(valid, key[src], zero), jnp.where(valid, val[src], zero),
            valid.astype(jnp.uint32))
