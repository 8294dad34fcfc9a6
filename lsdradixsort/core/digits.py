"""Digit math for radix decomposition of integer keys.

The equivalent of the reference's ``GET_R_BITS(n, r, i)`` macro
(reference: Utils.h:22), which extracts the i-th r-bit digit of a key.
Everything here is shape-polymorphic jnp (usable inside jit) with numpy
mirrors for the golden models.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

KEY_BITS = 32
KEY_DTYPE = jnp.uint32


def num_digit_groups(r: int, key_bits: int = KEY_BITS) -> int:
    """Number of r-bit digit groups in a key (reference: LSDRadixSort.cu:64)."""
    if r <= 0 or r > key_bits:
        raise ValueError(f"digit width r={r} must be in [1, {key_bits}]")
    return (key_bits + r - 1) // r


def get_digit(keys, r: int, group: int):
    """Extract the `group`-th r-bit digit of each key (Utils.h:22 equivalent).

    Returns an int32 array of digit values in [0, 2**r), ready to use as
    scatter indices.
    """
    mask = jnp.uint32((1 << r) - 1)
    shifted = jnp.right_shift(keys.astype(jnp.uint32), jnp.uint32(r * group))
    return jnp.bitwise_and(shifted, mask).astype(jnp.int32)


def get_digit_np(keys: np.ndarray, r: int, group: int) -> np.ndarray:
    """numpy mirror of :func:`get_digit` for golden models."""
    mask = np.uint32((1 << r) - 1)
    shifted = (keys.astype(np.uint32) >> np.uint32(r * group))
    return (shifted & mask).astype(np.int64)


def low_bits_mask(r: int, group: int) -> int:
    """Mask covering digit groups 0..group inclusive (the already-sorted prefix
    after LSD pass `group`)."""
    total = min(r * (group + 1), KEY_BITS)
    return (1 << total) - 1 if total < 64 else (1 << 64) - 1
