"""Window rank functions: ROW_NUMBER / RANK / DENSE_RANK
OVER (PARTITION BY p ORDER BY k [DESC]).

No reference analog; the natural next layer over the sort family. One
sort_lex pass groups rows by partition and orders them (ties by input
position), per-row arithmetic over partition/tie-run starts produces the
rank, and one scatter by the permutation puts ranks back in input row
order.

Run starts are delivered by the fill-forward primitive
(ops/primitives.py), the same segmented broadcast the join family uses.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.core import keycodec
from lsdradixsort.ops.primitives import fill_forward_last
from lsdradixsort.ops.sort import sort_lex

_METHODS = ("row_number", "rank", "dense_rank")


@functools.partial(jax.jit, static_argnames=("method", "descending"))
def window_rank(partition_keys: jax.Array, order_keys: jax.Array,
                method: str = "row_number", descending: bool = False
                ) -> jax.Array:
    """1-based ranks in INPUT ROW ORDER (u32), SQL semantics:

      * row_number — position within the partition (ties by input order);
      * rank       — competition ranking: ties share the rank of their
                     first row; the next distinct value skips past them;
      * dense_rank — ties share a rank; no gaps.

    partition_keys / order_keys: u32/i32/f32 columns (core/keycodec.py);
    `descending` orders the ORDER BY column.
    """
    if method not in _METHODS:
        raise ValueError(f"method {method!r}: pick from {_METHODS}")
    n = partition_keys.shape[0]
    (sp, sk), perm = sort_lex([partition_keys, order_keys],
                              descending=(False, descending))
    # boundary detection on raw bits: any total order groups partitions
    spb = keycodec.encode(sp)
    skb = keycodec.encode(sk, descending)
    pos = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    one = jnp.ones((1,), jnp.bool_)
    is_pstart = jnp.concatenate([one, spb[1:] != spb[:-1]])
    if method == "row_number":
        _, pstart, _ = fill_forward_last(is_pstart, spb, pos)
        rank_sorted = pos - pstart + jnp.uint32(1)
    else:
        is_pairstart = jnp.concatenate(
            [one, (spb[1:] != spb[:-1]) | (skb[1:] != skb[:-1])])
        _, pstart, _ = fill_forward_last(is_pstart, spb, pos)
        if method == "rank":
            _, pairstart, _ = fill_forward_last(is_pairstart, spb, pos)
            rank_sorted = pairstart - pstart + jnp.uint32(1)
        else:  # dense_rank: distinct order-values at-or-before me in my
            # partition = cumsum of pair starts, rebased at partition start
            c = jnp.cumsum(is_pairstart.astype(jnp.uint32))
            _, c_at_pstart, _ = fill_forward_last(is_pstart, spb, c)
            rank_sorted = c - c_at_pstart + jnp.uint32(1)
    # back to input order (perm is a bijection on [0, n))
    return jnp.zeros_like(rank_sorted).at[perm].set(rank_sorted,
                                                    unique_indices=True)
