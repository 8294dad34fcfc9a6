"""Filter / selection operators (north star config 3, BASELINE.json).

Order-preserving compaction is an exclusive scan of the predicate (each
selected row's output slot) followed by one scatter per column. Static
shapes are preserved (XLA requirement): ops return the full-length array
plus the count of selected rows; the tail beyond `count` is unspecified.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def compact(mask: jax.Array, *arrays):
    """Stable compaction: rows where mask is True move to the front.

    Returns (count, *compacted_arrays). Order among selected rows is
    preserved (stable), matching the golden model bit-exactly on the first
    `count` rows. The tail beyond `count` is unspecified.
    """
    n = mask.shape[0]
    m = mask.astype(jnp.int32)
    kept_before = jnp.cumsum(m) - m
    # rejected rows get distinct slots past the end, which the scatter
    # drops: every index is unique, so no write conflicts
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    dst = jnp.where(mask, kept_before, n + idx - kept_before)
    outs = [jnp.zeros_like(a).at[dst].set(a, mode="drop",
                                          unique_indices=True)
            for a in arrays]
    return (jnp.sum(m).astype(jnp.uint32), *outs)


@jax.jit
def filter_keys(keys: jax.Array, lo, hi):
    """Range selection: rows with lo <= key < hi (order-preserving).

    Returns (count, packed_keys).
    """
    lo = jnp.asarray(lo, keys.dtype)
    hi = jnp.asarray(hi, keys.dtype)
    mask = (keys >= lo) & (keys < hi)
    return compact(mask, keys)


@jax.jit
def filter_kv(keys: jax.Array, values: jax.Array, lo, hi):
    """Range selection over key-value rows. Returns (count, keys, values)."""
    lo = jnp.asarray(lo, keys.dtype)
    hi = jnp.asarray(hi, keys.dtype)
    mask = (keys >= lo) & (keys < hi)
    return compact(mask, keys, values)


def _in_set_mask(keys: jax.Array, set_keys: jax.Array) -> jax.Array:
    """Membership mask by binary search in the sorted set. The unrolled
    search measured 2-2.5x the looped one on the GPU (PERF.md)."""
    ss = jnp.sort(set_keys)
    idx = jnp.searchsorted(ss, keys, method="scan_unrolled")
    idx = jnp.clip(idx, 0, set_keys.shape[0] - 1)
    return ss[idx] == keys


@jax.jit
def filter_in_set(keys: jax.Array, set_keys: jax.Array, *values):
    """IN-list semi-join filter: keep rows whose key appears in `set_keys`
    (unique membership keys, order-preserving). Returns (count, keys,
    *values)."""
    return compact(_in_set_mask(keys, set_keys), keys, *values)


@jax.jit
def filter_not_in_set(keys: jax.Array, set_keys: jax.Array, *values):
    """NOT IN anti-join filter: keep rows whose key does NOT appear in
    `set_keys` (unique membership keys, order-preserving). Returns
    (count, keys, *values). Same engine as filter_in_set, inverted."""
    return compact(~_in_set_mask(keys, set_keys), keys, *values)
