"""Deterministic test/benchmark data generation.

The equivalent of the reference's seeded ``RNG`` (Utils.h:24-33,
Utils.cpp:12-15): all inputs are reproducible from an integer seed. Device
data comes from jax.random (threefry, generated on-device — no host
transfer); golden-model data is mirrored with numpy from the same values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_keys(n: int, seed: int = 0, dtype=jnp.uint32) -> jax.Array:
    """Uniform random keys over the full dtype range, generated on device."""
    return jax.random.bits(jax.random.PRNGKey(seed), (n,), dtype=dtype)


def random_kv(n: int, seed: int = 0):
    """(keys, values) pair; values are distinct row ids so stability is
    checkable bit-exactly (the reference sorts keys only — LSDRadixSort.cu:978;
    key-value is a north-star extension)."""
    keys = random_keys(n, seed)
    values = jnp.arange(n, dtype=jnp.uint32)
    return keys, values


def random_keys_bounded(n: int, lo: int, hi: int, seed: int = 0) -> jax.Array:
    """Uniform keys in [lo, hi) — mirrors RNG(seed, min, max) (Utils.cpp:12-15)."""
    bits = jax.random.bits(jax.random.PRNGKey(seed), (n,), dtype=jnp.uint32)
    span = jnp.uint32(hi - lo)
    return (bits % span + jnp.uint32(lo)).astype(jnp.uint32)


def skewed_keys(n: int, seed: int = 0, hot_fraction: float = 0.9,
                hot_key: int = 0xDEADBEEF) -> jax.Array:
    """Adversarially skewed keys: `hot_fraction` of rows share one key.

    Exercises the skew-aware repartitioning path of the distributed shuffle
    (north star, BASELINE.json) — no counterpart in the reference.
    """
    k = jax.random.PRNGKey(seed)
    ku, kb = jax.random.split(k)
    uniform = jax.random.bits(ku, (n,), dtype=jnp.uint32)
    is_hot = jax.random.uniform(kb, (n,)) < hot_fraction
    return jnp.where(is_hot, jnp.uint32(hot_key), uniform)


def to_numpy(*arrays):
    out = tuple(np.asarray(a) for a in arrays)
    return out[0] if len(out) == 1 else out
