"""Order-preserving key codecs: int32/float32 (and descending order) on
the uint32 sort engine.

The engine (kernels/merge.py, kernels/tile_sort.py, the composed radix
pipeline) compares uint32 codes. Signed and float keys sort through a
monotone bijection into u32 — the classic radix-sort key transforms:

  * int32   -> flip the sign bit (x ^ 0x80000000): two's-complement order
    becomes unsigned order.
  * float32 -> IEEE-754 sign-magnitude flip: negative floats reverse
    (bitwise NOT), non-negative floats get the sign bit set. This is the
    IEEE total order: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN
    (NaNs ordered by payload bits; -0.0 sorts before +0.0 but compares
    equal as floats). np.sort/jnp.sort instead place every NaN last —
    callers who need that must pre-normalize NaNs.
  * descending -> bitwise NOT of the code: a stable ascending sort of
    complemented codes is exactly a stable descending sort (tie groups
    are unchanged, so input order within ties is preserved).

The reference sorts raw u32 only (LSDRadixSort.cu:62-69); these codecs are
the standard extension any query engine needs for ORDER BY over signed /
float columns, kept out of the kernels: encode on the way in, decode on
the way out, both fused into the surrounding jit (one elementwise op per
stream pass — XLA folds it into the first/last kernel's HBM sweep).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

SIGN = jnp.uint32(0x80000000)

#: dtypes `encode`/`decode` accept
SUPPORTED_KEY_DTYPES = (jnp.uint32, jnp.int32, jnp.float32)


def encode(keys: jax.Array, descending: bool = False) -> jax.Array:
    """Map keys to uint32 codes whose unsigned ascending order equals the
    requested order on the original dtype (see module docstring)."""
    dt = keys.dtype
    if dt == jnp.uint32:
        code = keys
    elif dt == jnp.int32:
        code = jax.lax.bitcast_convert_type(keys, jnp.uint32) ^ SIGN
    elif dt == jnp.float32:
        b = jax.lax.bitcast_convert_type(keys, jnp.uint32)
        code = b ^ jnp.where(b >> 31 == 0, SIGN, jnp.uint32(0xFFFFFFFF))
    else:
        raise TypeError(f"sortable key dtypes are u32/i32/f32, got {dt}")
    return ~code if descending else code


def decode(codes: jax.Array, dtype, descending: bool = False) -> jax.Array:
    """Inverse of `encode` (codes -> original-dtype keys)."""
    code = ~codes if descending else codes
    dtype = jnp.dtype(dtype)
    if dtype == jnp.uint32:
        return code
    if dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(code ^ SIGN, jnp.int32)
    if dtype == jnp.float32:
        b = code ^ jnp.where(code >> 31 != 0, SIGN, jnp.uint32(0xFFFFFFFF))
        return jax.lax.bitcast_convert_type(b, jnp.float32)
    raise TypeError(f"sortable key dtypes are u32/i32/f32, got {dtype}")


# --- 64-bit keys as (hi, lo) u32 planes -----------------------------------
#
# JAX runs with x64 disabled by default, so 64-bit key columns are represented
# the columnar way: two u32 planes (hi = bits 63..32, lo = bits 31..0).
# The codecs below make lexicographic-(hi, lo) unsigned order equal the
# source-dtype order; ops/sort.sort64_with_ranks then sorts in two stable
# LSD passes (lo first, hi second) on the 32-bit engine.

#: logical 64-bit key dtypes `encode64`/`decode64` accept
SUPPORTED_KEY_DTYPES64 = ("uint64", "int64", "float64")


def encode64(hi: jax.Array, lo: jax.Array, dtype: str = "uint64",
             descending: bool = False):
    """Map (hi, lo) u32 planes of a 64-bit key to u32 code planes whose
    lexicographic (hi, lo) unsigned order equals the requested order.

    int64: flip the sign bit of hi. float64: IEEE sign-magnitude flip of
    the full 64 bits (negative -> NOT both planes; non-negative -> set
    hi's sign bit) — total order, same NaN/-0.0 semantics as `encode`.
    """
    if dtype == "uint64":
        chi, clo = hi, lo
    elif dtype == "int64":
        chi, clo = hi ^ SIGN, lo
    elif dtype == "float64":
        neg = hi >> 31 != 0
        chi = hi ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF), SIGN)
        clo = lo ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    else:
        raise TypeError(
            f"64-bit key dtypes are {SUPPORTED_KEY_DTYPES64}, got {dtype}")
    return (~chi, ~clo) if descending else (chi, clo)


def decode64(chi: jax.Array, clo: jax.Array, dtype: str = "uint64",
             descending: bool = False):
    """Inverse of `encode64` (code planes -> original (hi, lo) planes)."""
    if descending:
        chi, clo = ~chi, ~clo
    if dtype == "uint64":
        return chi, clo
    if dtype == "int64":
        return chi ^ SIGN, clo
    if dtype == "float64":
        neg = chi >> 31 == 0  # encoded negatives have hi's sign bit clear
        hi = chi ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF), SIGN)
        lo = clo ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
        return hi, lo
    raise TypeError(
        f"64-bit key dtypes are {SUPPORTED_KEY_DTYPES64}, got {dtype}")
