"""Sort operators — the flagship op family.

The counterpart of GPULSDRadixSort (reference: LSDRadixSort.cu:839-910),
the host orchestrator that loops histogram → local scans → transpose →
global scan → rank-and-scatter over 32/r digit groups.

Strategies:

  * ``"xla"`` (default) — jax.lax.sort. On the GPU, XLA hands a sort with
    one compared key and at most one riding operand to CUB's LSD radix
    sort, the same algorithm family as the reference.
  * ``"composed"`` — a faithful LSD radix pipeline composed from this
    framework's own primitives (block_digit_histograms → per-block digit
    scans → digit-major global scan → stable rank + scatter), the direct
    analog of the reference's pass structure (cu:845-906).

All sorts are stable (key-value variants preserve the input order of
equal keys bit-exactly, verified against the golden model). Keys may be
uint32, int32, or float32 and the order ascending (default) or
descending — non-u32 dtypes and descending order run through the
order-preserving u32 codecs in core/keycodec.py, so every strategy sees
only u32 codes.

Stable spelling: ``lax.sort((code, iota), num_keys=1, is_stable=True)``
returns the sorted codes and the stable permutation, and every further
column is gathered by that permutation. A comparator over two keys, or
more than one riding operand, keeps XLA from handing the sort to CUB.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.core import keycodec
from lsdradixsort.core.digits import get_digit, num_digit_groups
from lsdradixsort.ops.primitives import block_digit_histograms, exclusive_scan

_STRATEGIES = ("xla", "composed")


def stable_argsort(codes: jax.Array):
    """Stable sort of u32 codes: (sorted_codes, permutation u32)."""
    iota = jax.lax.broadcasted_iota(jnp.uint32, codes.shape, 0)
    return jax.lax.sort((codes, iota), num_keys=1, is_stable=True)


def lex_argsort(primary: jax.Array, secondary: jax.Array):
    """Permutation ordering rows by (primary, secondary), ties stable.

    Two stable passes, least significant column first (the reference's
    LSD digit loop, LSDRadixSort.cu:62-69, with whole columns as digits).
    Returns (sorted_primary, permutation u32).
    """
    _, p1 = stable_argsort(secondary)
    sk, p2 = stable_argsort(primary[p1])
    return sk, p1[p2]


@functools.partial(jax.jit, static_argnames=("strategy", "r", "block_size",
                                             "descending"))
def sort(keys: jax.Array, strategy: str = "xla", r: int = 8,
         block_size: int = 1 << 13, descending: bool = False) -> jax.Array:
    """Sort u32/i32/f32 keys (TestGPULSDRadixSort path, cu:912-1030).

    Signed/float keys and descending order run through the
    order-preserving u32 codecs (core/keycodec.py; float NaN/-0.0
    semantics documented there).
    """
    code = keycodec.encode(keys, descending)
    if strategy == "xla":
        out = jax.lax.sort(code)
    elif strategy == "composed":
        out = _composed_lsd_sort(code, r=r, block_size=block_size)
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; pick from {_STRATEGIES}")
    return keycodec.decode(out, keys.dtype, descending)


@functools.partial(jax.jit, static_argnames=("strategy", "r", "block_size",
                                             "descending"))
def sort_kv(keys: jax.Array, values, strategy: str = "xla", r: int = 8,
            block_size: int = 1 << 13, descending: bool = False):
    """Stable key-value sort (keys u32/i32/f32, any payload pytree).

    "xla" (default): a single payload array rides the radix sort as its
    value operand; a pytree of several payloads is gathered by the stable
    permutation. "composed" is the faithful LSD radix scaffold. Signed/
    float keys and descending order run through the u32 codecs
    (core/keycodec.py); stability is unaffected (tie groups are invariant
    under the bijection).
    """
    code = keycodec.encode(keys, descending)
    if strategy == "xla":
        sk, sv = _stable_sort_kv_xla(code, values)
    elif strategy == "composed":
        sk, sv = _composed_lsd_sort_kv(code, values, r=r,
                                       block_size=block_size)
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; pick from {_STRATEGIES}")
    return keycodec.decode(sk, keys.dtype, descending), sv


@functools.partial(jax.jit, static_argnames=("descending",))
def sort_with_ranks(keys: jax.Array, descending: bool = False):
    """Sort keys, returning (sorted_keys, original_positions).

    The columnar-engine primitive: sort one key column, use the returned
    permutation to gather every other column. Equivalent to a stable
    key-value sort whose payload is the row index — BASELINE config 2's
    "keys + 32-bit payloads" with payload = row id.
    """
    sk, perm = stable_argsort(keycodec.encode(keys, descending))
    return keycodec.decode(sk, keys.dtype, descending), perm


@functools.partial(jax.jit, static_argnames=("descending",))
def argsort(keys: jax.Array, descending: bool = False) -> jax.Array:
    """Stable argsort of u32/i32/f32 keys."""
    _, perm = sort_with_ranks(keys, descending)
    return perm


@functools.partial(jax.jit, static_argnames=("descending",))
def sort_lex(key_cols, descending=False):
    """Stable multi-column lexicographic sort: ORDER BY col0, col1, ...
    (col0 primary). Returns (sorted_cols_tuple, original_positions).

    key_cols: sequence of equal-length u32/i32/f32 columns. descending:
    one bool for all columns or a per-column tuple (mixed ASC/DESC).
    Ties across ALL columns break by original position (stable).

    This is the reference's LSD digit-group loop (LSDRadixSort.cu:62-69)
    lifted to whole columns as digits: one stable pass per column, least
    significant (last) first. A segmented sort (sort within runs of a
    segment-id column) is exactly sort_lex([segment_id, key]).
    """
    cols = list(key_cols)
    k = len(cols)
    if k == 0:
        raise ValueError("sort_lex needs at least one key column")
    if isinstance(descending, bool):
        descending = (descending,) * k
    if len(descending) != k:
        raise ValueError("descending must be a bool or one per column")
    codes = [keycodec.encode(c, d) for c, d in zip(cols, descending)]
    perm = None
    for code in reversed(codes):
        _, p = stable_argsort(code if perm is None else code[perm])
        perm = p if perm is None else perm[p]
    decoded = tuple(keycodec.decode(c[perm], col.dtype, d)
                    for c, col, d in zip(codes, cols, descending))
    return decoded, perm


@functools.partial(jax.jit, static_argnames=("dtype", "descending"))
def sort64_with_ranks(key_hi: jax.Array, key_lo: jax.Array,
                      dtype: str = "uint64", descending: bool = False):
    """Stable sort by a 64-bit key column given as (hi, lo) u32 planes.

    Returns (sorted_hi, sorted_lo, original_positions) — the columnar
    64-bit analog of sort_with_ranks (64-bit columns live as two u32
    planes, core/keycodec.py). dtype is the logical key type: "uint64",
    "int64", or "float64" (IEEE total order, as the 32-bit codec). Two
    stable 32-bit passes, low plane first.
    """
    chi, clo = keycodec.encode64(key_hi, key_lo, dtype, descending)
    hi_o, perm = lex_argsort(chi, clo)
    return (*keycodec.decode64(hi_o, clo[perm], dtype, descending), perm)


@functools.partial(jax.jit, static_argnames=("block_size",))
def sort_blocks_kv(keys: jax.Array, values: jax.Array,
                   block_size: int = 1 << 14):
    """Stable kv sort within each `block_size` block.

    The user-facing form of the reference's block-local sort
    (TestLSDBinaryRadixSort, cu:423-477) — a partial-sort primitive for
    windowed/segmented query plans: one batched sort along the rows of
    (n // block_size, block_size). n must be a multiple of block_size.
    """
    n = keys.shape[0]
    if n % block_size:
        raise ValueError(f"n={n} must be divisible by block_size="
                         f"{block_size}")
    shape = (n // block_size, block_size)
    sk, sv = jax.lax.sort((keys.reshape(shape), values.reshape(shape)),
                          dimension=1, num_keys=1, is_stable=True)
    return sk.reshape(n), sv.reshape(n)


def _stable_sort_kv_xla(keys, values):
    """Stable kv sort: one payload array rides the sort as its value
    operand; several are gathered by the stable permutation."""
    flat_vals, treedef = jax.tree.flatten(values)
    if len(flat_vals) == 1:
        sk, sv = jax.lax.sort((keys, flat_vals[0]), num_keys=1,
                              is_stable=True)
        return sk, jax.tree.unflatten(treedef, [sv])
    sk, perm = stable_argsort(keys)
    return sk, jax.tree.unflatten(treedef, [v[perm] for v in flat_vals])


# ---------------------------------------------------------------------------
# Composed LSD radix pipeline (reference pass structure, cu:845-906)
# ---------------------------------------------------------------------------

def _pass_destinations(keys, r: int, group: int, block_size: int):
    """Global stable destination of every element for one radix pass.

    dst = global_offset[digit][block] + local_rank, where global offsets are
    the exclusive scan of the digit-major (transposed) histogram matrix
    (cu:877-895) and local_rank is the element's stable rank among equal
    digits within its block (cu:829-833).
    """
    n = keys.shape[0]
    nb = n // block_size
    digits = get_digit(keys, r, group)                      # (n,) int32
    # per-block histograms (C7)
    hist = block_digit_histograms(keys, r, group, block_size)  # (nb, bins) u32
    # digit-major global offsets: transpose + flat exclusive scan (C6 + C4)
    gscan = exclusive_scan(hist.T.reshape(-1).astype(jnp.uint32))
    gofs = gscan.reshape(-1, nb)                            # (bins, nb)
    # per-block exclusive digit offsets (local scan of each histogram row,
    # the BlockPrefixSumKernel-per-row step at cu:866-870)
    lofs = jnp.cumsum(hist, axis=1, dtype=jnp.uint32) - hist  # (nb, bins)
    # stable local rank among equal digits within the block, via
    # argsort/inverse-argsort (vectorized equivalent of the shared-memory
    # binary split sort, cu:373-402)
    dig2 = digits.reshape(nb, block_size)
    order = jnp.argsort(dig2, axis=1, stable=True)
    sorted_dig = jnp.take_along_axis(dig2, order, axis=1)
    pos = jnp.broadcast_to(jnp.arange(block_size, dtype=jnp.uint32),
                           (nb, block_size))
    rank_sorted = pos - jnp.take_along_axis(lofs, sorted_dig, axis=1)
    inv = jnp.argsort(order, axis=1)
    local_rank = jnp.take_along_axis(rank_sorted, inv, axis=1)  # (nb, B)
    block_ids = jnp.broadcast_to(jnp.arange(nb)[:, None], (nb, block_size))
    dst = gofs[dig2, block_ids] + local_rank
    return dst.reshape(n)


def _composed_pass(keys, payload, r, group, block_size):
    dst = _pass_destinations(keys, r, group, block_size)
    out_keys = jnp.zeros_like(keys).at[dst].set(keys, unique_indices=True)
    if payload is None:
        return out_keys, None
    out_payload = jax.tree.map(
        lambda v: jnp.zeros_like(v).at[dst].set(v, unique_indices=True),
        payload)
    return out_keys, out_payload


def _composed_lsd_sort(keys, r: int, block_size: int):
    n = keys.shape[0]
    if n % block_size:
        raise ValueError(f"composed strategy needs n % block_size == 0 "
                         f"(n={n}, block_size={block_size})")
    for group in range(num_digit_groups(r)):
        keys, _ = _composed_pass(keys, None, r, group, block_size)
    return keys


def _composed_lsd_sort_kv(keys, values, r: int, block_size: int):
    n = keys.shape[0]
    if n % block_size:
        raise ValueError(f"composed strategy needs n % block_size == 0 "
                         f"(n={n}, block_size={block_size})")
    for group in range(num_digit_groups(r)):
        keys, values = _composed_pass(keys, values, r, group, block_size)
    return keys, values
