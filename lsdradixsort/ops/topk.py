"""Top-K and DISTINCT operators (ORDER BY ... LIMIT k / SELECT DISTINCT).

No reference analog (the reference sorts whole arrays only,
LSDRadixSort.cu:62-69); these are the standard query-engine companions of
the sort, built from the framework's own primitives:

  * `top_k` — histogram-guided selection: one digit histogram
    (ops/primitives.py) over the high byte of the key codes finds the
    smallest bin threshold containing the k-th order statistic; one
    compaction (ops/filter.compact) extracts the <= (k-1) + bin_count
    survivors; a small static-B sort finishes. Two streaming passes + a
    B-row tail instead of a full sort. A lax.cond falls back to the full
    sort when the threshold bin is fat (skewed keys) — correctness never
    depends on the distribution.
  * `unique` — sort + boundary compaction (run starts detected on the
    sorted stream), returning counts per distinct key: the DISTINCT /
    histogram-of-keys primitive.

Both accept u32/i32/f32 keys via core/keycodec.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.core import keycodec
from lsdradixsort.ops.filter import compact
from lsdradixsort.ops.primitives import digit_histogram
from lsdradixsort.ops.sort import sort_with_ranks

_SENTINEL = jnp.uint32(0xFFFFFFFF)


def _full_sort_topk(codes, k: int):
    """Fallback: full stable sort of the codes, first k rows."""
    sk, perm = sort_with_ranks(codes)
    return sk[:k], perm[:k]


@functools.partial(jax.jit, static_argnames=("k", "largest"))
def top_k(keys: jax.Array, k: int, largest: bool = True):
    """The k extreme keys and their original indices, sorted (ties broken
    by original position — stable). keys u32/i32/f32; k static.

    Returns (values, indices), both length k. largest=True gives the k
    largest in descending order; largest=False the k smallest ascending.
    """
    n = keys.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n}")
    # encode so that the answer is always the k SMALLEST codes ascending
    codes = keycodec.encode(keys, descending=largest)

    # static survivor budget: the fast path holds iff the k-th order
    # statistic's 256-bin prefix holds <= B rows
    B = max(4 * k, 1 << 15)
    B = min(B, n)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)

    if B == n:
        # budget covers everything: the "fallback" is the whole answer
        sk, perm = _full_sort_topk(codes, k)
        vals = keycodec.decode(sk, keys.dtype, descending=largest)
        return vals, perm

    hist = digit_histogram(codes, 8, 3)            # high byte, 256 bins
    csum = jnp.cumsum(hist, dtype=jnp.uint32)      # inclusive prefix
    t = jnp.argmax(csum >= jnp.uint32(k)).astype(jnp.uint32)  # threshold bin
    survivors = csum[t]                            # rows with byte <= t

    def _fast(codes, iota):
        mask = (codes >> 24) <= t
        cnt, ck, ci = compact(mask, codes, iota)
        ck, ci = ck[:B], ci[:B]
        # sink the unspecified compaction tail below every survivor: max
        # both the key AND the position tiebreak (a real code can itself
        # be 0xFFFFFFFF — real rows then still win the tie because their
        # position is < n <= 0xFFFFFFFF)
        pos = jax.lax.broadcasted_iota(jnp.uint32, (B,), 0)
        live = pos < cnt
        ck = jnp.where(live, ck, _SENTINEL)
        ci = jnp.where(live, ci, _SENTINEL)
        # live rows precede the tail and keep position order, so a
        # stable one-key sort breaks ties by position
        sk, si = jax.lax.sort((ck, ci), num_keys=1, is_stable=True)
        return sk[:k], si[:k]

    def _slow(codes, iota):
        del iota
        return _full_sort_topk(codes, k)

    sk, perm = jax.lax.cond(survivors <= jnp.uint32(B), _fast, _slow,
                            codes, iota)
    vals = keycodec.decode(sk, keys.dtype, descending=largest)
    return vals, perm


@jax.jit
def unique(keys: jax.Array):
    """Sorted distinct keys with occurrence counts: SELECT key, COUNT(*)
    GROUP BY key ORDER BY key, for the key column alone.

    Returns (n_unique, unique_keys, counts): the first n_unique rows of
    unique_keys/counts are the distinct keys ascending and their
    multiplicities; the tail is unspecified (static shapes, as every op
    in this framework). keys u32/i32/f32.
    """
    n = keys.shape[0]
    codes = keycodec.encode(keys)
    sk = jax.lax.sort(codes)
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             sk[1:] != sk[:-1]])
    iota = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    cnt, uk, starts = compact(first, sk, iota)
    # counts = next run start - this run start; the row at cnt-1 closes
    # at n (rows beyond cnt are unspecified garbage either way)
    pos = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), n, jnp.uint32)])
    nxt = jnp.where(pos == cnt - 1, jnp.uint32(n), nxt)
    counts = nxt - starts
    return cnt, keycodec.decode(uk, keys.dtype), counts
