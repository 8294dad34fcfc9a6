"""Distributed query operators: GROUP BY and hash join over a device mesh.

North-star config 5 (BASELINE.json): "distributed sort+join query: 1B rows
hash-partitioned across 2+ hosts with skew-aware radix shuffle".

Design: both operators ride the distributed sort (parallel/dist_sort.py),
which already solves the hard distributed problems — exact balanced
partitioning under arbitrary skew (equal-key rank splitting) and the
ragged all-to-all shuffle. Sorting replaces hash partitioning because a
sorted layout is simultaneously (a) perfectly balanced for ANY key
distribution — a hash-partitioned heavy key overloads one shard, which is
exactly the skew problem the north star calls out — and (b) the layout
local sort-based aggregation/join kernels want.

After the global sort, a key's rows are contiguous but may span shard
boundaries; the cross-shard fix-up gathers each shard's head/tail run
summaries (O(D) scalars) and resolves ownership chains — including runs
spanning many whole shards (all-equal-keys input) — with closed-form
vector math over the gathered (D,) arrays.

Outputs are ragged per shard: each shard's first `count` slots are valid.
`undistribute()` compacts them on host for oracle comparison in tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from lsdradixsort.parallel.mesh import DATA_AXIS
from lsdradixsort.parallel.dist_sort import _dist_sort_shard
from lsdradixsort.ops.filter import compact
from lsdradixsort.ops.primitives import fill_forward_last
from lsdradixsort.ops.sort import stable_argsort


def _chain_correction(t_key, h_key, h_sum, full, me, d):
    """Sum of following shards' head-run sums that continue my tail run.

    contribution of shard j > me: h_sum[j] if h_key[j] == my tail key and
    every shard strictly between me and j is entirely that key.
    """
    j = jnp.arange(d)
    same = h_key == t_key                       # (D,)
    # chain[j] = all shards in (me, j) are full & same-key
    blocker = ~(full & same)                    # shard that breaks the chain
    blocked_before = jnp.cumsum(
        jnp.where((j > me) & blocker, 1, 0)) - jnp.where(
        (j > me) & blocker, 1, 0)               # exclusive count in (me, j)
    take = (j > me) & same & (blocked_before == 0)
    return jnp.sum(jnp.where(take, h_sum, jnp.zeros_like(h_sum)),
                   dtype=h_sum.dtype)


def _dist_group_by_sum_shard(keys, vals, ranks, axis, n_total):
    d = n_total // keys.shape[0]
    sk, sv = _dist_sort_shard(keys, (vals,), ranks, axis, n_total,
                              stable=False)
    n_local = sk.shape[0]
    me = jax.lax.axis_index(axis)

    # run structure within the shard
    csum = jnp.cumsum(sv, dtype=sv.dtype)
    head_key, tail_key = sk[0], sk[-1]
    head_len = jnp.sum((sk == head_key).astype(jnp.uint32))
    head_sum = csum[head_len - 1]

    h_key = jax.lax.all_gather(head_key, axis)   # (D,)
    t_key = jax.lax.all_gather(tail_key, axis)
    h_sum = jax.lax.all_gather(head_sum, axis)
    full = h_key == t_key                        # single-key shards

    own_head = jnp.where(me == 0, True, t_key[jnp.maximum(me - 1, 0)]
                         != head_key)
    corr = _chain_correction(tail_key, h_key, h_sum, full, me, d)

    # local per-run sums (diff of csum at boundaries, as in ops/aggregate.py)
    is_last = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
    pos = jnp.arange(n_local, dtype=jnp.uint32)
    # drop the head run when a previous shard owns it
    drop_head = (~own_head) & (sk == head_key)
    valid = is_last & ~drop_head
    # compact valid runs to the front, keeping key order
    count, vk, vcs, vpos = compact(valid, sk, csum, pos)
    # run sum = csum[last] - csum[previous run's last within this shard];
    # for the first valid run, subtract csum just before the run start
    # (which is the dropped-head prefix when the head is foreign, else 0)
    prev_last = jnp.concatenate([jnp.zeros((1,), jnp.uint32), vpos[:-1] + 1])
    first_start = jnp.where(own_head, jnp.uint32(0), head_len)
    run_start = jnp.where(jnp.arange(n_local) == 0, first_start, prev_last)
    sums = jnp.where(run_start > 0,
                     vcs - jnp.take(csum, jnp.maximum(run_start, 1) - 1),
                     vcs)
    # add the cross-shard continuation to my tail run (only if it is mine
    # and it is valid == owned)
    is_my_tail = vk == tail_key
    in_range = jnp.arange(n_local, dtype=jnp.uint32) < count
    sums = jnp.where(is_my_tail & in_range, sums + corr, sums)
    return (count.reshape(1), vk, sums)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def dist_group_by_sum(keys: jax.Array, values: jax.Array, mesh: Mesh,
                      axis: str = DATA_AXIS):
    """Distributed GROUP BY key SUM(value) (modular uint32 sums).

    Returns (counts, keys, sums): counts is (D,); shard s's valid result
    rows are keys/sums[s*n/D : s*n/D + counts[s]], keys globally sorted
    across the valid rows.
    """
    n = keys.shape[0]
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"n={n} must be divisible by mesh size {d}")
    ranks = jnp.arange(1, d, dtype=jnp.uint32) * jnp.uint32(n // d)

    fn = shard_map(
        lambda k, v: _dist_group_by_sum_shard(k, v, ranks, axis, n),
        mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)))
    return fn(keys, values)


def _dist_join_shard(keys, val, src, ranks, axis, n_total):
    """Local step of the distributed join after a stable global sort by key.

    `src` packs (tag, global row position) — bit 31 = 1 for probe rows —
    so it is simultaneously the stability rank (build rows rank below all
    probe rows of the same key) and the carrier of the probe position; the
    exchange ships only 3 streams (key, src, val) where val holds the build
    value on build rows and the probe value on probe rows. After the
    per-shard re-sort by (key, src) a key's build row —
    unique by contract — is the FIRST row of that key's run within whichever
    shard it landed in. The exchange splits equal-key rows across shards in
    mesh order of their origin, so the build row can land in ANY shard of a
    key's span: propagation must run both forward (probes after the build's
    shard) and backward (probes before it), across chains of shards fully
    occupied by the key.
    """
    sk, ssrc, sval = _dist_sort_shard(
        keys, (val,), ranks, axis, n_total, stable=True, src=src,
        keep_src=True)
    is_build = ssrc < jnp.uint32(0x80000000)

    me = jax.lax.axis_index(axis)
    # within-shard broadcast of each build row's value to its key's probe
    # rows (build keys unique; build rows sort before probes of the same
    # key)
    bk_fill, seg_bval, has_build = fill_forward_last(is_build, sk, sval)
    seg_hit = (has_build == jnp.uint32(1)) & (bk_fill == sk)
    head_is_build = is_build

    head_key, tail_key = sk[0], sk[-1]
    h_key = jax.lax.all_gather(head_key, axis)   # (D,)
    t_key = jax.lax.all_gather(tail_key, axis)
    t_bval = jax.lax.all_gather(seg_bval[-1], axis)
    t_hit = jax.lax.all_gather(seg_hit[-1], axis)
    # head-run build row sits at position 0 when present (build-first order)
    f_isb = jax.lax.all_gather(head_is_build[0], axis)
    f_bval = jax.lax.all_gather(sval[0], axis)
    full = h_key == t_key
    d = t_key.shape[0]
    j = jnp.arange(d)

    # FORWARD: nearest shard j < me with tail key == my head key, build seen
    # in its tail run, and every shard in (j, me) fully that key.
    same_f = t_key == head_key
    blocker_f = ~(full & same_f)
    blk = jnp.where((j < me) & blocker_f, 1, 0)
    blocked_fwd = jnp.cumsum(blk[::-1])[::-1] - blk    # blockers in (j, me)
    cand_f = (j < me) & same_f & (blocked_fwd == 0) & t_hit
    best_f = jnp.max(jnp.where(cand_f, j, -1))
    fwd_hit = best_f >= 0
    fwd_bval = jnp.where(fwd_hit, t_bval[jnp.maximum(best_f, 0)],
                         jnp.uint32(0))
    in_head_run = sk == head_key
    seg_bval = jnp.where(in_head_run & ~seg_hit & fwd_hit, fwd_bval, seg_bval)
    seg_hit = seg_hit | (in_head_run & fwd_hit)

    # BACKWARD: nearest shard j > me whose head key == my tail key with the
    # build row at its head, chain of fully-occupied shards in (me, j).
    same_b = h_key == tail_key
    blocker_b = ~(full & same_b)
    blk_b = jnp.where((j > me) & blocker_b, 1, 0)
    blocked_bwd = jnp.cumsum(blk_b) - blk_b            # blockers in (me, j)
    cand_b = (j > me) & same_b & (blocked_bwd == 0) & f_isb
    best_b = jnp.min(jnp.where(cand_b, j, d))
    bwd_hit = best_b < d
    bwd_bval = jnp.where(bwd_hit, f_bval[jnp.minimum(best_b, d - 1)],
                         jnp.uint32(0))
    in_tail_run = sk == tail_key
    seg_bval = jnp.where(in_tail_run & ~seg_hit & bwd_hit, bwd_bval, seg_bval)
    seg_hit = seg_hit | (in_tail_run & bwd_hit)

    matched = (~is_build) & seg_hit
    ppos = ssrc & jnp.uint32(0x7FFFFFFF)
    count, *outs = compact(matched, sk, sval, seg_bval, ppos)
    return (count.reshape(1), *outs)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def dist_join(build_keys: jax.Array, build_vals: jax.Array,
              probe_keys: jax.Array, probe_vals: jax.Array, mesh: Mesh,
              axis: str = DATA_AXIS):
    """Distributed inner equi-join (unique build keys).

    Inputs are sharded over `axis`; build and probe sizes must each be
    divisible by the mesh size. Returns (counts, keys, probe_vals,
    build_vals, probe_pos) ragged per shard; `undistribute` + a sort by
    probe_pos reproduces the single-chip oracle order.
    """
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    n = nb + npr
    d = mesh.shape[axis]
    if nb % d or npr % d:
        raise ValueError("build/probe sizes must divide the mesh size")
    ranks = jnp.arange(1, d, dtype=jnp.uint32) * jnp.uint32(n // d)

    # shard_map shards the leading axis: shard s holds build-shard s then
    # probe-shard s; tag-biased src ranks every build row below every probe
    # row of the same key for the stable global sort.
    def shard_fn(bk, bv, pk, pv):
        nbl, npl = bk.shape[0], pk.shape[0]
        keys = jnp.concatenate([bk, pk])
        val = jnp.concatenate([bv, pv])
        me = jax.lax.axis_index(axis)
        gprobe = (me.astype(jnp.uint32) * jnp.uint32(npl)
                  + jnp.arange(npl, dtype=jnp.uint32))
        gbuild = (me.astype(jnp.uint32) * jnp.uint32(nbl)
                  + jnp.arange(nbl, dtype=jnp.uint32))
        src = jnp.concatenate([gbuild, gprobe | jnp.uint32(0x80000000)])
        return _dist_join_shard(keys, val, src, ranks, axis, n)

    return shard_map(shard_fn, mesh=mesh, in_specs=(P(axis),) * 4,
                     out_specs=(P(axis),) * 5)(
        build_keys, build_vals, probe_keys, probe_vals)


def undistribute(counts, *arrays):
    """Host helper: compact ragged per-shard outputs to dense numpy arrays."""
    counts = np.asarray(counts)
    d = counts.shape[0]
    outs = []
    for a in arrays:
        a = np.asarray(a)
        per = a.shape[0] // d
        outs.append(np.concatenate(
            [a[s * per: s * per + counts[s]] for s in range(d)]))
    return (int(counts.sum()),) + tuple(outs)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def dist_filter_kv(keys: jax.Array, values: jax.Array, lo, hi, mesh: Mesh,
                   axis: str = DATA_AXIS):
    """Distributed range filter: embarrassingly parallel shard-local
    compaction. Returns (counts, keys, values) ragged per shard (shard s's
    valid rows at [s*n/D, s*n/D + counts[s])), original order preserved
    within and across shards."""
    from lsdradixsort.ops.filter import filter_kv

    def shard_fn(k, v):
        count, fk, fv = filter_kv(k, v, lo, hi)
        return count.reshape(1), fk, fv

    return shard_map(shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)),
                     out_specs=(P(axis), P(axis), P(axis)))(keys, values)


def _dist_join_multi_shard(sbk, sbv, pk, pv, axis, d, max_out):
    """Fragment join on one shard: local sorted build fragment x every
    probe whose key falls in this fragment's key range.

    Output balance under skew is structural: build rows are spread exactly
    evenly by the distributed sort, so a heavy key's B x P cross-product
    materializes as P x (B/D) rows per shard — the all-equal-keys input
    (maximum skew) is perfectly balanced, the same guarantee the
    distributed sort gives.
    """
    import jax
    from lsdradixsort.ops.join import hash_join_multi
    from lsdradixsort.parallel.dist_sort import _exchange

    npl = pk.shape[0]
    nbl = sbk.shape[0]
    me = jax.lax.axis_index(axis)

    # every shard's build key range, in mesh (= global sorted) order
    los = jax.lax.all_gather(sbk[0], axis)             # (D,)
    his = jax.lax.all_gather(sbk[-1], axis)

    # local probes sorted by key: each destination shard's probes form one
    # contiguous slice [searchsorted(lo), searchsorted(hi)) — slices for
    # adjacent shards may OVERLAP when a build run spans shards, which is
    # exactly the replication the exchange must perform (reads, so
    # overlapping input segments are legal)
    gpos = (me.astype(jnp.uint32) * jnp.uint32(npl)
            + jnp.arange(npl, dtype=jnp.uint32))
    spk, perm = stable_argsort(pk)
    sppos, spv = gpos[perm], pv[perm]
    starts = jnp.searchsorted(spk, los, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(spk, his, side="right").astype(jnp.int32)
    send_sizes = ends - starts
    out_len = npl * d                                   # worst case: all
    rpk, rppos, rpv = _exchange((spk, sppos, spv), starts, send_sizes,
                                axis, out_len)
    sizes_matrix = jax.lax.all_gather(send_sizes, axis)  # (src D, dst D)
    m = jnp.sum(sizes_matrix[:, me], dtype=jnp.int32)
    valid = jnp.arange(out_len, dtype=jnp.int32) < m

    count, jk, (jpv, jppos), jbv, bidx = hash_join_multi(
        sbk, sbv, rpk, (rpv, rppos), max_out=max_out, probe_valid=valid,
        return_build_idx=True)
    # global stable build rank: fragment rows are globally sorted and
    # exactly balanced, so rank = me * (nb/D) + local index
    brank = me.astype(jnp.uint32) * jnp.uint32(nbl) + bidx
    return (count.reshape(1), jk, jppos, jpv, jbv, brank)


@functools.partial(jax.jit, static_argnames=("mesh", "max_out", "axis"))
def dist_join_multi(build_keys: jax.Array, build_vals: jax.Array,
                    probe_keys: jax.Array, probe_vals: jax.Array,
                    mesh: Mesh, max_out: int, axis: str = DATA_AXIS):
    """Distributed many-to-many inner equi-join (duplicate build keys).

    Fragment-join design: the build side is distributed-sorted (exactly
    balanced under any skew), each shard owns one contiguous fragment of
    the global build order, and every probe is routed — with replication —
    to each shard whose fragment key range contains its key. Each shard
    then joins its fragment against the received probes locally
    (ops/join.hash_join_multi), producing a disjoint piece of every
    probe's cross-product. Probes stay where they are unless shipped; no
    scatter anywhere.

    Returns (counts, keys, probe_pos, probe_vals, build_vals, build_rank)
    ragged per shard: shard s's valid rows sit at [s*max_out, s*max_out +
    counts[s]). (probe_pos, build_rank) is a unique global order — sorting
    the undistributed rows by it reproduces the single-chip oracle order.
    counts are untruncated totals per shard, so callers detect max_out
    overflow per shard.

    Memory: each shard's receive buffer is probe-count x 3 streams
    (worst-case replication); tighten with a range-intersection pre-count
    if that ever binds.
    """
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    d = mesh.shape[axis]
    if nb % d or npr % d:
        raise ValueError("build/probe sizes must divide the mesh size")
    from lsdradixsort.parallel.dist_sort import dist_sort_kv
    sbk, sbv = dist_sort_kv(build_keys, build_vals, mesh, axis=axis)

    fn = shard_map(
        lambda bk, bv, pk, pv: _dist_join_multi_shard(bk, bv, pk, pv, axis,
                                                      d, max_out),
        mesh=mesh, in_specs=(P(axis),) * 4, out_specs=(P(axis),) * 6)
    return fn(sbk, sbv, probe_keys, probe_vals)


@functools.partial(jax.jit, static_argnames=("k", "largest", "mesh", "axis"))
def dist_top_k(keys: jax.Array, k: int, mesh: Mesh, largest: bool = True,
               axis: str = DATA_AXIS):
    """Distributed ORDER BY ... LIMIT k: every global top-k row is in its
    shard's local top-k, so one local top_k per shard (ops/topk.py:
    histogram-guided selection) yields D*k candidate (value, global index)
    pairs, and one small sort of the candidates finishes it. O(n/D) local
    work, k*D candidate rows. Requires k <= n/D.

    Returns (values, global_indices), both length k. Ties broken by global
    position (stable), matching the single-chip ops/topk.top_k exactly.
    """
    from lsdradixsort.core import keycodec
    from lsdradixsort.ops.topk import top_k

    d = mesh.devices.size
    nl = keys.shape[0] // d
    if k > nl:
        raise ValueError(f"k={k} must be <= rows per shard ({nl})")

    def shard_fn(x):
        lv, li = top_k(x, k, largest=largest)
        me = jax.lax.axis_index(axis).astype(jnp.uint32)
        return lv, me * jnp.uint32(nl) + li

    av, ai = shard_map(shard_fn, mesh=mesh, in_specs=(P(axis),),
                       out_specs=(P(axis), P(axis)))(keys)
    # candidates are shard-major with ascending global indices within
    # each shard, so a stable sort reproduces the global stable order
    sv, si = jax.lax.sort((keycodec.encode(av, descending=largest), ai),
                          num_keys=1, is_stable=True)
    return keycodec.decode(sv[:k], keys.dtype, descending=largest), si[:k]


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def dist_unique(keys: jax.Array, mesh: Mesh, axis: str = DATA_AXIS):
    """Distributed SELECT DISTINCT + counts: sorted distinct keys with
    multiplicities, ragged per shard like every dist operator (shard s's
    valid rows at [s*n/D, s*n/D + counts[s])). One distributed group-by
    with unit values — the counts are the run lengths."""
    ones = jnp.ones((keys.shape[0],), jnp.uint32)
    return dist_group_by_sum(keys, ones, mesh=mesh, axis=axis)
