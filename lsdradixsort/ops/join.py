"""Hash join (north star config 4: build 10M / probe 100M uint32 keys).

A *sort-merge* join expressed in sorts, scans and scatters:

  1. concatenate build and probe rows (build first) and sort them stably
     by key: every probe row lands after the build row with the same key,
     if any, and the sort's permutation says which input row each sorted
     row came from;
  2. a fill-forward (segmented broadcast) propagates the build value and
     key to every following row; a probe row matches when the carried
     key equals its own;
  3. one scatter by probe position puts the per-probe results back in
     probe order, and a compaction packs the matches to the front,
     matching the golden model bit-exactly.

`hash_join` requires unique build keys (primary-key join), as in the
golden oracle; output arrays are full probe length, first `count` rows
valid. `hash_join_multi` lifts the restriction to many-to-many (duplicate
build keys) with a caller-supplied static output bound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsdradixsort.ops.filter import compact
from lsdradixsort.ops.primitives import fill_forward_last
from lsdradixsort.ops.sort import lex_argsort, stable_argsort


def _to_probe_order(perm, nb: int, np_: int, *cols):
    """Scatter per-row columns of the combined sorted order back to probe
    input order (build rows, perm < nb, are dropped)."""
    # build rows get distinct out-of-range slots, so indices stay unique
    dst = jnp.where(perm < nb, perm + np_, perm - nb).astype(jnp.int32)
    return [jnp.zeros((np_,), c.dtype).at[dst].set(c, mode="drop",
                                                   unique_indices=True)
            for c in cols]


@jax.jit
def hash_join(build_keys: jax.Array, build_vals: jax.Array,
              probe_keys: jax.Array, probe_vals: jax.Array):
    """Inner equi-join. Returns (count, probe_keys, probe_vals, build_vals)
    in probe order; rows past `count` are unspecified."""
    m, bv = probe_lookup(build_keys, build_vals, probe_keys)
    return compact(m == 1, probe_keys, probe_vals, bv)


@jax.jit
def probe_lookup(build_keys: jax.Array, build_vals: jax.Array,
                 probe_keys: jax.Array):
    """Per-row dictionary lookup: for every probe row, (match u32 0/1,
    build_val) in PROBE INPUT ORDER (build_val 0 where unmatched).
    Unique build keys. The relational building block behind the join
    family: LEFT OUTER JOIN = attach these columns to the probe table;
    semi-join = filter on match (ops/filter.filter_in_set); anti-join =
    filter on ~match (filter_not_in_set)."""
    nb, np_ = build_keys.shape[0], probe_keys.shape[0]
    sk, perm = stable_argsort(jnp.concatenate([build_keys, probe_keys]))
    is_build = perm < nb
    sval = build_vals[jnp.minimum(perm, nb - 1)]
    # the last build row at-or-before a probe row belongs to its key iff
    # the keys are equal (build keys are unique and sort first per key)
    bk_fill, seg_bval, has_build = fill_forward_last(is_build, sk, sval)
    matched = ~is_build & (has_build == 1) & (bk_fill == sk)
    return _to_probe_order(perm, nb, np_, matched.astype(jnp.uint32),
                           jnp.where(matched, seg_bval, jnp.uint32(0)))


@jax.jit
def probe_lookup64(build_hi: jax.Array, build_lo: jax.Array,
                   build_vals: jax.Array, probe_hi: jax.Array,
                   probe_lo: jax.Array):
    """probe_lookup for 64-bit keys given as (hi, lo) u32 planes (the
    columnar 64-bit representation, core/keycodec.py §64-bit): per probe
    row, (match u32 0/1, build_val) in probe input order. Unique build
    keys. Join equality is bit-equality, so i64/f64 callers pass their
    bit planes directly — no codec needed.

    Same sort-merge design as probe_lookup with a two-pass (hi, lo) sort
    and one fill-forward sweep per key plane; the segment hit test
    compares BOTH planes."""
    nb, np_ = build_hi.shape[0], probe_hi.shape[0]
    hi = jnp.concatenate([build_hi, probe_hi])
    lo = jnp.concatenate([build_lo, probe_lo])
    shi, perm = lex_argsort(hi, lo)
    slo = lo[perm]
    is_build = perm < nb
    sval = build_vals[jnp.minimum(perm, nb - 1)]
    hi_fill, seg_bval, has_build = fill_forward_last(is_build, shi, sval)
    lo_fill, _, _ = fill_forward_last(is_build, slo, sval)
    matched = (~is_build & (has_build == 1)
               & (hi_fill == shi) & (lo_fill == slo))
    return _to_probe_order(perm, nb, np_, matched.astype(jnp.uint32),
                           jnp.where(matched, seg_bval, jnp.uint32(0)))


@jax.jit
def hash_join64(build_hi: jax.Array, build_lo: jax.Array,
                build_vals: jax.Array, probe_hi: jax.Array,
                probe_lo: jax.Array, probe_vals: jax.Array):
    """Inner equi-join on 64-bit keys as (hi, lo) u32 planes (unique
    build keys). Returns (count, probe_hi, probe_lo, probe_vals,
    build_vals) in probe order; rows past `count` unspecified."""
    m, bv = probe_lookup64(build_hi, build_lo, build_vals,
                           probe_hi, probe_lo)
    return compact(m == 1, probe_hi, probe_lo, probe_vals, bv)


@functools.partial(jax.jit, static_argnames=("max_out", "return_build_idx"))
def hash_join_multi(build_keys: jax.Array, build_vals: jax.Array,
                    probe_keys: jax.Array, probe_vals,
                    max_out: int,
                    probe_valid: jax.Array | None = None,
                    return_build_idx: bool = False):
    """Inner equi-join with DUPLICATE build keys allowed (many-to-many).

    Lifts hash_join's primary-key restriction: every probe row matches ALL
    build rows sharing its key. Probe-major output — for each probe row in
    input order, one output row per matching build row, matching build rows
    in stable build order. Returns (count, probe_keys, probe_vals,
    build_vals); the arrays are `max_out` long, rows past min(count,
    max_out) are unspecified, and if count > max_out the arrays hold the
    correct first max_out rows (count is the untruncated total, so callers
    can detect overflow and re-run with a larger bound — a data-dependent
    output size under static shapes).

    probe_vals may be a tuple of uint32 streams (all returned, same
    positions); probe_valid masks probe rows out entirely (used by the
    distributed fragment join for padded exchanges); return_build_idx
    appends the index into the stable-sorted build side for each output
    row — callers can gather any extra build column, or derive a global
    build rank.

    Same sort-based design as hash_join, plus run geometry: the sorted
    build side is described per run by (start, length); probes pick their
    run up via the fill-forward broadcast, and a rank-decode expansion
    (exclusive scan of per-probe lengths + searchsorted) materializes the
    cross-product rows.
    """
    single = not isinstance(probe_vals, (tuple, list))
    pvals = (probe_vals,) if single else tuple(probe_vals)
    nb, np_ = build_keys.shape[0], probe_keys.shape[0]

    # sorted build side, stable (original position tiebreak)
    sbk, bperm = stable_argsort(build_keys)
    sbv = build_vals[bperm]
    bpos = jnp.arange(nb, dtype=jnp.uint32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sbk[1:] != sbk[:-1]])
    # run start index per build row: last run-head row at-or-before me
    _, run_start, _ = fill_forward_last(is_start, sbk, bpos)
    # run length, valid AT THE LAST ROW of each run (the only row whose
    # value the probe-side fill-forward ever delivers)
    run_len = bpos - run_start + jnp.uint32(1)

    # combined stable sort by key — build rows first per key; each probe
    # row learns its key's build run (start, len) from the last build row
    # at-or-before it, which is its run's LAST row, where run_len is exact
    sk, perm = stable_argsort(jnp.concatenate([sbk, probe_keys]))
    is_build = perm < nb
    brow = jnp.minimum(perm, nb - 1)
    bk_fill, f_start, has_build = fill_forward_last(is_build, sk,
                                                    run_start[brow])
    _, f_len, _ = fill_forward_last(is_build, sk, run_len[brow])
    matched = ~is_build & (has_build == 1) & (bk_fill == sk)
    start_p, len_p = _to_probe_order(
        perm, nb, np_, f_start, jnp.where(matched, f_len, jnp.uint32(0)))
    if probe_valid is not None:
        len_p = jnp.where(probe_valid, len_p, jnp.uint32(0))

    # hit probes to the front in probe order; the tail carries length 0
    cnt, cpk, cstart, clen, *cpv = compact(len_p > 0, probe_keys, start_p,
                                           len_p, *pvals)
    clen = jnp.where(jnp.arange(np_, dtype=jnp.uint32) < cnt, clen,
                     jnp.uint32(0))
    count = jnp.sum(clen, dtype=jnp.uint32)

    # rank-decode expansion: output row j belongs to the hit probe r with
    # offs[r] <= j < offs[r]+clen[r]; offsets are strictly increasing over
    # hits (len >= 1) and flat (= count) after them, so r is a searchsorted
    offs = jnp.cumsum(clen, dtype=jnp.uint32) - clen
    j = jnp.arange(max_out, dtype=jnp.uint32)
    r = jnp.searchsorted(offs, j, side="right").astype(jnp.uint32)
    r = jnp.maximum(r, jnp.uint32(1)) - jnp.uint32(1)
    d = j - offs[r]
    bidx = jnp.minimum(cstart[r] + d, jnp.uint32(max(nb - 1, 0)))
    out_pv = cpv[0][r] if single else tuple(c[r] for c in cpv)
    out = (count, cpk[r], out_pv, sbv[bidx])
    return out + (bidx,) if return_build_idx else out
