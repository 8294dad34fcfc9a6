"""Distributed sort over a device mesh (north star config 5).

This lifts the reference's per-pass decomposition — per-block histograms →
global digit offsets → stable scatter (LSDRadixSort.cu:839-910) — to hosts:

  1. every shard sorts its rows locally (stable, with a global source-rank
     tiebreaker so equal keys keep input order);
  2. exact global splitter keys are found by a psum-counted multi-probe
     search over the key space (5 rounds of 255 probes per boundary), i.e.
     a distributed radix/quantile select — the multi-host analog of the
     digit-major global scan;
  3. ties on the splitter key are broken *by global stable rank* using
     all-gathered per-shard equal-key counts, so even an all-equal-keys
     input (maximum skew) balances perfectly — this is the skew-aware
     repartitioning the north star requires;
  4. rows move to their owner shard with ONE jax.lax.ragged_all_to_all
     per column (exact sizes — no padded traffic), which XLA runs over
     NCCL on the GPU;
  5. every shard sorts its received rows; the concatenation over the mesh
     axis is the globally sorted, stable result.

Every shard ends up with exactly n_total/num_devices rows, for any key
distribution. Requires n_total % num_devices == 0 (pad upstream with
0xFFFFFFFF sentinels if needed).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from lsdradixsort.ops.sort import lex_argsort, stable_argsort
from lsdradixsort.parallel.mesh import DATA_AXIS


def _local_sort_stable(keys, src, vals, src_ordered: bool):
    """Stable per-shard sort by (key, src) with riding payload streams.
    src is a unique tiebreak (the global source rank). When src already
    rises with position (src_ordered), a stable sort by key alone gives
    the (key, src) order; otherwise src is sorted first (two LSD passes).
    """
    if src_ordered:
        sk, perm = stable_argsort(keys)
    else:
        sk, perm = lex_argsort(keys, src)
    return (sk, src[perm], *(v[perm] for v in vals))


def _splitter_keys(sk: jax.Array, ranks: jax.Array, axis: str,
                   fanout: int = 256, rounds: int = 5) -> jax.Array:
    """Exact global splitter keys by psum-counted multi-probe search.

    For each boundary rank R (0-indexed), finds the key of the R-th row of
    the global sorted order: the smallest K with count(key <= K) >= R+1.
    `sk` is this shard's locally sorted keys.

    Each round probes fanout-1 evenly spaced candidates per boundary — the
    first at lo, step max((hi-lo)//(fanout-1), 1), offsets clamped to the
    interval — and all boundaries' probe counts ride ONE psum. The
    interval shrinks ~fanout x per round, so 5 blocking collective rounds
    replace bisection's 32. Worst-case interval-width recurrence at
    fanout=256:
    2^32 -> 16.8M -> 66K -> 266 -> 11 -> 0, i.e. exact after 5 rounds.
    """
    nb = ranks.shape[0]
    F = fanout
    jj = jnp.arange(F - 1, dtype=jnp.uint32)[None, :]
    lo = jnp.zeros((nb,), jnp.uint32)
    hi = jnp.full((nb,), 0xFFFFFFFF, jnp.uint32)

    def body(_, lohi):
        lo, hi = lohi
        w = hi - lo
        step = jnp.maximum(w // jnp.uint32(F - 1), jnp.uint32(1))
        # step*(F-2) <= (w//(F-1))*(F-2) < 2^32: no uint32 overflow
        offs = jnp.minimum(step[:, None] * jj, w[:, None])     # (nb, F-1)
        probes = lo[:, None] + offs
        local = jnp.searchsorted(sk, probes.reshape(-1),
                                 side="right").astype(jnp.uint32)
        total = jax.lax.psum(local, axis).reshape(nb, F - 1)
        geq = total >= (ranks + jnp.uint32(1))[:, None]        # monotone in j
        any_ = jnp.any(geq, axis=1)
        first = jnp.argmax(geq, axis=1)                        # 0 if none
        pf = jnp.take_along_axis(probes, first[:, None], 1)[:, 0]
        pprev = jnp.take_along_axis(
            probes, jnp.maximum(first - 1, 0)[:, None], 1)[:, 0]
        new_hi = jnp.where(any_, pf, hi)
        # ~any_ implies probes[:,-1] < hi (count(<=hi) >= R+1 is the loop
        # invariant), so the +1 below cannot wrap
        new_lo = jnp.where(any_, jnp.where(first > 0, pprev + 1, lo),
                           probes[:, -1] + 1)
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, rounds, body, (lo, hi))
    return lo


def _local_send_plan(sk, splitter_keys, ranks, axis):
    """Where this shard's locally sorted rows go.

    Returns (cut_positions, send_sizes): cut_positions[d] is the index in
    `sk` where the chunk for device d+1 begins. Equal-splitter-key rows are
    split by *global stable rank*: shards own equal rows in mesh order, so
    each shard's share below a boundary is a clamp of the boundary's
    residual rank against the all-gathered per-shard counts.
    """
    less = jnp.searchsorted(sk, splitter_keys, side="left").astype(jnp.uint32)
    leq = jnp.searchsorted(sk, splitter_keys, side="right").astype(jnp.uint32)
    my_eq = leq - less                                     # (nb,) my equal-key rows
    global_less = jax.lax.psum(less, axis)
    r_eq = ranks - global_less                             # boundary rank among equals
    all_eq = jax.lax.all_gather(my_eq, axis)               # (D, nb)
    me = jax.lax.axis_index(axis)
    mask_before = (jnp.arange(all_eq.shape[0])[:, None] < me)
    prefix_eq = jnp.sum(jnp.where(mask_before, all_eq, 0), axis=0,
                        dtype=jnp.uint32)
    my_before = jnp.clip(r_eq - jnp.minimum(r_eq, prefix_eq), 0, my_eq)
    cuts = less + my_before                                # (nb,)
    n_local = sk.shape[0]
    bounds = jnp.concatenate([jnp.zeros((1,), jnp.uint32), cuts,
                              jnp.full((1,), n_local, jnp.uint32)])
    send_sizes = (bounds[1:] - bounds[:-1]).astype(jnp.int32)  # (D,)
    return bounds[:-1].astype(jnp.int32), send_sizes


def _exchange(arrays, input_offsets, send_sizes, axis, out_len):
    """Move each shard's per-destination chunks to their owners; chunks are
    received in mesh (source-rank) order.

    One jax.lax.ragged_all_to_all per column — exact sizes, no padded
    traffic. XLA:CPU has no ragged-all-to-all thunk, so the CPU mesh the
    tests run on takes a padded all_to_all at worst-case capacity
    followed by a sort-based repack instead.
    """
    sizes_matrix = jax.lax.all_gather(send_sizes, axis)    # (src D, dst D)
    me = jax.lax.axis_index(axis)
    d = sizes_matrix.shape[0]
    recv_sizes = sizes_matrix[:, me]                       # from each src
    # my chunk lands in dst d's buffer after all lower-ranked shards' chunks
    below = jnp.where(jnp.arange(d)[:, None] < me, sizes_matrix, 0)
    output_offsets = jnp.sum(below, axis=0, dtype=jnp.int32)  # (D,)
    if jax.default_backend() != "cpu":
        outs = []
        for a in arrays:
            out = jnp.zeros((out_len,) + a.shape[1:], a.dtype)
            outs.append(jax.lax.ragged_all_to_all(
                a, out, input_offsets, send_sizes, output_offsets, recv_sizes,
                axis_name=axis))
        return outs
    return _exchange_padded(arrays, input_offsets, send_sizes, recv_sizes,
                            output_offsets, axis, out_len, d)


def _exchange_padded(arrays, input_offsets, send_sizes, recv_sizes,
                     output_offsets, axis, out_len, d):
    del output_offsets  # sender-centric; the repack needs receiver offsets
    cap = arrays[0].shape[0]
    lane = jnp.arange(cap, dtype=jnp.int32)
    gidx = jnp.clip(input_offsets[:, None] + lane[None, :], 0, cap - 1)
    valid_recv = lane[None, :] < recv_sizes[:, None]          # (D, cap)
    recv_offsets = jnp.cumsum(recv_sizes) - recv_sizes        # excl, (D,)
    dst = recv_offsets[:, None] + lane[None, :]               # (D, cap)
    sort_key = jnp.where(valid_recv, dst, out_len + lane[None, :] +
                         cap * jnp.arange(d, dtype=jnp.int32)[:, None]
                         ).astype(jnp.int32).reshape(-1)
    recvs = []
    for a in arrays:
        sendbuf = a[gidx]                                     # (D, cap)
        recvbuf = jax.lax.all_to_all(sendbuf, axis, split_axis=0,
                                     concat_axis=0, tiled=True)
        recvs.append(recvbuf.reshape(d * cap, *a.shape[1:]))
    packed = jax.lax.sort((sort_key, *recvs), num_keys=1, is_stable=False)
    return [p[:out_len] for p in packed[1:]]


def _dist_sort_shard(keys, values, ranks, axis, n_total, stable, src=None,
                     keep_src=False):
    n_local = keys.shape[0]
    d = n_total // n_local
    me = jax.lax.axis_index(axis)
    if stable:
        # a caller's src rises with local position, but after the exchange
        # it need not (src_ordered below); the generated global source
        # rank does: chunks arrive in source-rank order
        src_given = src is not None
        if not src_given:
            src = (me.astype(jnp.uint32) * jnp.uint32(n_local)
                   + jnp.arange(n_local, dtype=jnp.uint32))
        sk, ssrc, *svals = _local_sort_stable(keys, src, values, True)
    else:
        sk, *svals = (jax.lax.sort((keys,) + values, num_keys=1,
                                   is_stable=False) if values
                      else (jax.lax.sort(keys),))
        ssrc = None
    spk = _splitter_keys(sk, ranks, axis)
    input_offsets, send_sizes = _local_send_plan(sk, spk, ranks, axis)
    payload = (sk,) + ((ssrc,) if stable else ()) + tuple(svals)
    received = _exchange(payload, input_offsets, send_sizes, axis,
                         out_len=n_total // d)
    if stable:
        rk, rsrc, *rvals = received
        out = _local_sort_stable(rk, rsrc, rvals, not src_given)
        if keep_src:
            return out
        return (out[0],) + tuple(out[2:])
    rk, *rvals = received
    if rvals:
        return tuple(jax.lax.sort((rk,) + tuple(rvals), num_keys=1,
                                  is_stable=False))
    return (jax.lax.sort(rk),)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "descending"))
def dist_sort(keys: jax.Array, mesh: Mesh, axis: str = DATA_AXIS,
              descending: bool = False) -> jax.Array:
    """Globally sort keys (u32/i32/f32, asc/desc) sharded over `axis`.
    Exact and balanced for any distribution; n must be divisible by the
    mesh size. Non-u32 dtypes ride the order-preserving codecs
    (core/keycodec.py) — elementwise, so they commute with the sharding
    and add one fused op per stream end."""
    from lsdradixsort.core import keycodec
    n = keys.shape[0]
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"n={n} must be divisible by mesh size {d}")
    code = keycodec.encode(keys, descending)
    if d == 1:
        # one shard owns every row: no collective is needed
        return keycodec.decode(jax.lax.sort(code), keys.dtype, descending)
    ranks = (jnp.arange(1, d, dtype=jnp.uint32) * jnp.uint32(n // d))

    def shard_fn(k):
        (out,) = _dist_sort_shard(k, (), ranks, axis, n, stable=False)
        return out

    out = shard_map(shard_fn, mesh=mesh, in_specs=P(axis),
                    out_specs=P(axis))(code)
    return keycodec.decode(out, keys.dtype, descending)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "descending"))
def dist_sort_kv(keys: jax.Array, values: jax.Array, mesh: Mesh,
                 axis: str = DATA_AXIS, descending: bool = False):
    """Globally stable key-value sort, sharded over `axis`. Keys
    u32/i32/f32, ascending or descending (core/keycodec.py).

    Stability across shards comes from shipping a 32-bit global source rank
    with each row (n < 2**32) and sorting received rows by (key, rank).
    """
    from lsdradixsort.core import keycodec
    n = keys.shape[0]
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"n={n} must be divisible by mesh size {d}")
    code = keycodec.encode(keys, descending)
    if d == 1:
        # one shard owns every row: no collective is needed
        ok, ov = jax.lax.sort((code, values), num_keys=1, is_stable=True)
        return keycodec.decode(ok, keys.dtype, descending), ov
    ranks = (jnp.arange(1, d, dtype=jnp.uint32) * jnp.uint32(n // d))

    def shard_fn(k, v):
        return _dist_sort_shard(k, (v,), ranks, axis, n, stable=True)

    ok, ov = shard_map(shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)),
                       out_specs=(P(axis), P(axis)))(code, values)
    return keycodec.decode(ok, keys.dtype, descending), ov
