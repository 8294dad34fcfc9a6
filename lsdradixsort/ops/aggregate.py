"""Hash-aggregate operators: GROUP BY key → reduce(values).

North-star config 3 (BASELINE.json): "filter + hash aggregate (GROUP BY
SUM) over 100M-row columnar batch".

Design: sort-based aggregation instead of a hash table. Sums are modular
and order-independent, so the plan is

  1. sort rows by group key (one key, one riding value: XLA's radix sort);
  2. mark run boundaries where the sorted key changes;
  3. per-run reduction via the *cumsum-at-boundaries* trick: the sum of a
     run equals the difference of the inclusive cumsum at consecutive run
     ends — one vectorized cumsum, no segment scatter;
  4. compact boundary rows to the front (ops/filter.compact).

Sums use modular uint arithmetic so results are bit-exact against the
golden model regardless of association order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.core import keycodec
from lsdradixsort.ops.filter import compact
from lsdradixsort.ops.sort import lex_argsort


@jax.jit
def group_by_sum(group_keys: jax.Array, values: jax.Array):
    """GROUP BY group_keys SUM(values).

    Returns (num_groups, unique_keys_sorted, sums): the first `num_groups`
    rows of the outputs are the result; the tail is unspecified.
    """
    return group_by_aggregate(group_keys, values, reduction="sum")


@functools.partial(jax.jit, static_argnames=("reduction",))
def group_by_aggregate(group_keys: jax.Array, values: jax.Array,
                       reduction: str = "sum"):
    """GROUP BY with reduction in {"sum", "min", "max", "count"}.

    Dtypes (core/keycodec.py): group keys may be u32/i32/f32 (groups
    return sorted in that dtype's order). Values may be u32/i32 for sum
    (i32 sums are exact two's-complement mod 2^32 — the bits of the true
    sum) and u32/i32/f32 for min/max (codec-monotone, so the reduced
    code IS the reduced value). f32 SUM is rejected: float addition is
    not associative, so no order-independent bit-exact spelling exists.
    """
    kdt = group_keys.dtype
    group_keys = keycodec.encode(group_keys)
    vdt = values.dtype
    if reduction == "sum":
        if vdt == jnp.float32:
            raise TypeError("f32 SUM is order-dependent; no bit-exact "
                            "spelling (cast to int or use min/max/count)")
        if vdt == jnp.int32:
            values = jax.lax.bitcast_convert_type(values, jnp.uint32)
    elif reduction in ("min", "max"):
        values = keycodec.encode(values)

    def _key_out(uk):
        return keycodec.decode(uk, kdt)

    def _val_out(v):
        if reduction == "sum" and vdt == jnp.int32:
            return jax.lax.bitcast_convert_type(v, jnp.int32)
        if reduction in ("min", "max"):
            return keycodec.decode(v, vdt)
        return v

    n = group_keys.shape[0]
    if reduction == "sum":
        # modular sums are order-independent: no stability needed
        sk, sv = jax.lax.sort((group_keys, values), num_keys=1,
                              is_stable=False)
        is_last = jnp.concatenate([sk[1:] != sk[:-1],
                                   jnp.ones((1,), dtype=bool)])
    elif reduction == "count":
        sk = jax.lax.sort(group_keys)
        is_last = jnp.concatenate([sk[1:] != sk[:-1],
                                   jnp.ones((1,), dtype=bool)])
    if reduction == "sum":
        csum = jnp.cumsum(sv, dtype=sv.dtype)           # modular wraparound
        count, uk, run_end_csum = compact(is_last, sk, csum)
        # order among run-ends is preserved, so consecutive compacted rows
        # are consecutive runs; subtract the previous run's cumsum
        prev = jnp.concatenate([jnp.zeros((1,), sv.dtype), run_end_csum[:-1]])
        sums = run_end_csum - prev
        return count, _key_out(uk), _val_out(sums)
    if reduction == "count":
        pos = jnp.arange(n, dtype=jnp.uint32)
        count, uk, run_end_pos = compact(is_last, sk, pos)
        prev = jnp.concatenate([-jnp.ones((1,), jnp.uint32), run_end_pos[:-1]])
        return count, _key_out(uk), run_end_pos - prev
    if reduction in ("min", "max"):
        # sort by (key, value): a run's min is then its FIRST value and
        # its max its LAST — no segmented reduction needed
        sk2, perm = lex_argsort(group_keys, values)
        sv2 = values[perm]
        if reduction == "min":
            is_head = jnp.concatenate([jnp.ones((1,), dtype=bool),
                                       sk2[1:] != sk2[:-1]])
            count, uk, agg = compact(is_head, sk2, sv2)
        else:  # max
            is_tail = jnp.concatenate([sk2[1:] != sk2[:-1],
                                       jnp.ones((1,), dtype=bool)])
            count, uk, agg = compact(is_tail, sk2, sv2)
        return count, _key_out(uk), _val_out(agg)
    raise ValueError(f"unknown reduction {reduction!r}")


@jax.jit
def filtered_group_by_sum(keys: jax.Array, group_keys: jax.Array,
                          values: jax.Array, lo, hi):
    """BASELINE config 3 as one fused plan: SELECT group, SUM(value) WHERE
    lo <= key < hi GROUP BY group (u32 groups and values, modular sums).

    Filtering is folded into the aggregation sort instead of materializing
    a compacted intermediate: rejected rows get the sentinel group key
    0xFFFFFFFF and a zero value, so they sort last and add nothing. One
    sort total. A real group 0xFFFFFFFF shares that run with the rejected
    rows; it is summed apart by one masked reduction and appended, as the
    largest key, after the other groups. Returns (num_groups,
    unique_group_keys_sorted, sums).
    """
    lo = jnp.asarray(lo, keys.dtype)
    hi = jnp.asarray(hi, keys.dtype)
    n = keys.shape[0]
    top = jnp.uint32(0xFFFFFFFF)
    keep = (keys >= lo) & (keys < hi)
    gk = jnp.where(keep, group_keys, top)
    sk, sv = jax.lax.sort((gk, jnp.where(keep, values, jnp.uint32(0))),
                          num_keys=1, is_stable=False)
    csum = jnp.cumsum(sv, dtype=sv.dtype)
    is_last = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
    count, uk, run_end_csum = compact(is_last & (sk != top), sk, csum)
    prev = jnp.concatenate([jnp.zeros((1,), sv.dtype), run_end_csum[:-1]])
    sums = run_end_csum - prev
    top_rows = keep & (group_keys == top)
    top_sum = jnp.sum(jnp.where(top_rows, values, jnp.uint32(0)),
                      dtype=jnp.uint32)
    # the top group's slot: `count` when present, out of range (dropped)
    # otherwise; count < n whenever a top row exists
    slot = jnp.where(jnp.any(top_rows), count, jnp.uint32(n))
    uk = uk.at[slot].set(top, mode="drop")
    sums = sums.at[slot].set(top_sum, mode="drop")
    return count + jnp.any(top_rows).astype(jnp.uint32), uk, sums
