"""Chip smoke test: the engine's main path on the card, each result compared
bit-exactly with a plain reference.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: the distributed phase only

Every phase calls the public entry points (`lsdradixsort.ops`,
`lsdradixsort.parallel`) at the data sizes of BASELINE.json's
configurations and compares the result with numpy or the golden models
(`lsdradixsort/golden/oracles.py`). Every result on this path is an
integer or a 32-bit value moved without arithmetic, so the tolerance is
zero everywhere: a comparison is bit equality, and a float column is
compared through its bits. No phase catches its own failure; any mismatch
or error exits non-zero.

Each phase prints its comparison, its compile time, the median of three
timed calls and rows/s on its own line (informational, not a benchmark
cell). The line before the last is `nvidia-smi`'s name and power limit of
each card; the last line is exactly
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
Without a GPU the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from lsdradixsort import golden, ops
from lsdradixsort import parallel
from lsdradixsort.core.cache import enable_persistent_cache
from lsdradixsort.core.device import card_lines, require_gpu
from lsdradixsort.parallel.dist_query import undistribute

# BASELINE.json configurations: 2 = stable kv of 100M rows, 3 = filter +
# GROUP BY SUM over 100M rows, 4 = join of a 10M build with a 100M probe,
# 5 = distributed sort of 1B rows; the keys-only flagship is 2^27 keys
KEYS_N = 1 << 27
CODEC_N = 1 << 24
KV_N = 100_000_000
QUERY_N = 100_000_000
GROUPS = 1 << 20
BUILD_N = 10_000_000
PROBE_N = 100_000_000
TOPK_N = 1 << 27
TOPK_K = 1000
COPY_N = 1 << 28
DIST_KV_N = 1 << 30


def _bits(seed: int, n: int) -> jax.Array:
    return jax.random.bits(jax.random.PRNGKey(seed), (n,), dtype=jnp.uint32)


def _host(x) -> np.ndarray:
    """A device result on the host, floats as their bits."""
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def check(name: str, got, want) -> None:
    """Bit equality of every column, or AssertionError."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _host(g), _host(np.asarray(w))
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: column {i} differs from the "
                                 f"reference (shapes {g.shape}, {w.shape})")
    print(f"  {name}: bit-exact vs reference ({len(want)} columns)",
          flush=True)


def run(name: str, fn, *args, rows: int, memory: bool = False):
    """Compile `fn` for `args`, run it once, time three more calls; print
    the compile time, the median call and rows/s. Returns the result and
    the median in seconds."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    if memory:
        print(f"  {name} memory_analysis: {compiled.memory_analysis()}",
              flush=True)
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"{name}: compile {t_compile:.2f} s, median {med * 1e3:.3f} ms, "
          f"{rows / med / 1e6:.1f} Mrows/s", flush=True)
    return out, med


def phase_copy(n: int = COPY_N) -> None:
    x = _bits(1, n)
    out, t = run("copy x+1 (u32)", lambda a: a + jnp.uint32(1), x, rows=n)
    print(f"  copy: {2 * 4 * n / t / 1e9:.1f} GB/s read+write "
          f"(context only)", flush=True)
    check("copy", [out], [np.asarray(x) + np.uint32(1)])


def phase_keys(n: int = KEYS_N, n_codec: int = CODEC_N) -> None:
    k = _bits(2, n)
    got, _ = run("sort u32", ops.sort, k, rows=n)
    check("sort u32", [got], [np.sort(np.asarray(k))])
    ki = jax.lax.bitcast_convert_type(_bits(3, n_codec), jnp.int32)
    got, _ = run("sort i32 descending",
                 lambda a: ops.sort(a, descending=True), ki, rows=n_codec)
    check("sort i32 descending", [got], [np.sort(np.asarray(ki))[::-1]])
    kf = jax.random.normal(jax.random.PRNGKey(4), (n_codec,), jnp.float32)
    got, _ = run("sort f32 descending",
                 lambda a: ops.sort(a, descending=True), kf, rows=n_codec)
    check("sort f32 descending", [got], [np.sort(np.asarray(kf))[::-1]])


def phase_kv(n: int = KV_N) -> None:
    k, v = _bits(5, n), _bits(6, n)
    vf = jax.random.normal(jax.random.PRNGKey(7), (n,), jnp.float32)
    hk = np.asarray(k)
    perm = np.argsort(hk, kind="stable")
    got, _ = run("sort_kv u32 payload (config 2)", ops.sort_kv, k, v,
                 rows=n, memory=True)
    check("sort_kv u32 payload", got, [hk[perm], np.asarray(v)[perm]])
    got, _ = run("sort_kv f32 payload", ops.sort_kv, k, vf, rows=n)
    check("sort_kv f32 payload", got, [hk[perm], np.asarray(vf)[perm]])
    got, _ = run("sort_with_ranks", ops.sort_with_ranks, k, rows=n)
    check("sort_with_ranks", got, [hk[perm], perm.astype(np.uint32)])


def phase_query(n: int = QUERY_N, groups: int = GROUPS) -> None:
    k, v = _bits(8, n), _bits(9, n)
    g = _bits(10, n) % jnp.uint32(groups)
    lo, hi = jnp.uint32(1 << 30), jnp.uint32(3 << 30)     # half the rows
    hk, hv, hg = np.asarray(k), np.asarray(v), np.asarray(g)
    mask = (hk >= (1 << 30)) & (hk < (3 << 30))
    (cnt, fk, fv), _ = run("filter_kv (config 3)",
                           lambda a, b: ops.filter_kv(a, b, lo, hi), k, v,
                           rows=n)
    c = int(cnt)
    check("filter_kv", [np.asarray([c]), fk[:c], fv[:c]],
          [np.asarray([mask.sum()]), golden.filter_keys(hk, 1 << 30, 3 << 30),
           hv[mask]])
    (cnt, uk, sums), _ = run(
        "filtered_group_by_sum (config 3)",
        lambda a, b, w: ops.filtered_group_by_sum(a, b, w, lo, hi),
        k, g, v, rows=n)
    wk, ws = golden.group_by_sum(hg[mask], hv[mask])
    c = int(cnt)
    check("filtered_group_by_sum", [np.asarray([c]), uk[:c], sums[:c]],
          [np.asarray([wk.size]), wk, ws])


def phase_join(nb: int = BUILD_N, npr: int = PROBE_N) -> None:
    # unique build keys: an odd multiplier is a bijection mod 2^32
    bk = jnp.arange(nb, dtype=jnp.uint32) * jnp.uint32(2654435761)
    bv = _bits(11, nb)
    pick = _bits(12, npr) % jnp.uint32(nb)
    hit = (_bits(13, npr) & jnp.uint32(1)) == 0             # half the rows
    pk = jnp.where(hit, bk[pick], _bits(14, npr))
    pv = _bits(15, npr)
    hbk, hbv, hpk, hpv = map(np.asarray, (bk, bv, pk, pv))
    wk, wpv, wbv = golden.hash_join(hbk, hbv, hpk, hpv)
    (cnt, jk, jpv, jbv), _ = run("hash_join (config 4)", ops.hash_join,
                                 bk, bv, pk, pv, rows=nb + npr, memory=True)
    c = int(cnt)
    check("hash_join", [np.asarray([c]), jk[:c], jpv[:c], jbv[:c]],
          [np.asarray([wk.size]), wk, wpv, wbv])
    (m, v), _ = run("probe_lookup", ops.probe_lookup, bk, bv, pk,
                    rows=nb + npr)
    order = np.argsort(hbk, kind="stable")
    pos = np.minimum(np.searchsorted(hbk[order], hpk), nb - 1)
    found = hbk[order][pos] == hpk
    check("probe_lookup", [m, v],
          [found.astype(np.uint32), np.where(found, hbv[order][pos], 0)])


def phase_topk_unique(n: int = TOPK_N, k: int = TOPK_K) -> None:
    x = _bits(16, n)
    hx = np.asarray(x)
    (vals, idx), _ = run("top_k", lambda a: ops.top_k(a, k), x, rows=n)
    # the k largest, ties by position: candidates at or past the k-th
    # largest value, then a stable sort of those alone
    kth = np.partition(hx, n - k)[n - k]
    cand = np.flatnonzero(hx >= kth)
    want = cand[np.argsort(~hx[cand], kind="stable")][:k]
    check("top_k", [vals, idx], [hx[want], want.astype(np.uint32)])
    xd = x % jnp.uint32(1 << 26)                 # repeated keys
    (cnt, uk, counts), _ = run("unique", ops.unique, xd, rows=n)
    wk, wc = np.unique(np.asarray(xd), return_counts=True)
    c = int(cnt)
    check("unique", [np.asarray([c]), uk[:c], counts[:c]],
          [np.asarray([wk.size]), wk, wc.astype(np.uint32)])


def phase_dist(n_kv: int = DIST_KV_N, n_query: int = QUERY_N,
               groups: int = GROUPS, nb: int = BUILD_N,
               npr: int = PROBE_N, cards: int = 4) -> None:
    if len(jax.devices()) < cards:
        raise SystemExit(f"need {cards} devices, found {len(jax.devices())}")
    mesh = parallel.make_mesh(cards)
    # config 5: distributed stable kv sort; the payload is the row id, so
    # the sorted payload is the permutation and the check is exact
    k = parallel.shard_1d(_bits(17, n_kv), mesh)
    v = parallel.shard_1d(jnp.arange(n_kv, dtype=jnp.uint32), mesh)
    (ok, ov), _ = run(f"dist_sort_kv over {cards} cards (config 5)",
                      lambda a, b: parallel.dist_sort_kv(a, b, mesh), k, v,
                      rows=n_kv)
    _check_stable_sort(f"dist_sort_kv {n_kv} rows", np.asarray(k),
                       np.asarray(ok), np.asarray(ov))
    del k, v, ok, ov
    # config 3 size: distributed GROUP BY SUM
    g = parallel.shard_1d(_bits(18, n_query) % jnp.uint32(groups), mesh)
    w = parallel.shard_1d(_bits(19, n_query), mesh)
    (counts, gk, gs), _ = run(
        f"dist_group_by_sum over {cards} cards",
        lambda a, b: parallel.dist_group_by_sum(a, b, mesh), g, w,
        rows=n_query)
    total, ck, cs = undistribute(counts, gk, gs)
    wk, ws = golden.group_by_sum(np.asarray(g), np.asarray(w))
    check("dist_group_by_sum", [np.asarray([total]), ck, cs],
          [np.asarray([wk.size]), wk, ws])
    del g, w
    # config 4 size: distributed join
    bk = parallel.shard_1d(
        jnp.arange(nb, dtype=jnp.uint32) * jnp.uint32(2654435761), mesh)
    bv = parallel.shard_1d(_bits(20, nb), mesh)
    hbk = np.asarray(bk)
    pick = np.asarray(_bits(21, npr) % jnp.uint32(nb))
    hit = (np.asarray(_bits(22, npr)) & 1) == 0
    hpk = np.where(hit, hbk[pick], np.asarray(_bits(23, npr)))
    pk = parallel.shard_1d(jnp.asarray(hpk), mesh)
    pv = parallel.shard_1d(_bits(24, npr), mesh)
    res, _ = run(f"dist_join over {cards} cards",
                 lambda a, b, c, d: parallel.dist_join(a, b, c, d, mesh),
                 bk, bv, pk, pv, rows=nb + npr)
    total, jk, jpv, jbv, jpos = undistribute(*res)
    order = np.argsort(jpos, kind="stable")
    wk, wpv, wbv = golden.hash_join(hbk, np.asarray(bv), hpk, np.asarray(pv))
    check("dist_join", [np.asarray([total]), jk[order], jpv[order],
                        jbv[order]],
          [np.asarray([wk.size]), wk, wpv, wbv])


def _check_stable_sort(name: str, keys, sorted_keys, perm) -> None:
    """Exact check of a stable sort whose payload is the row id, in O(n):
    the keys are in order, the payload is a permutation that maps the
    input onto them, and equal keys keep their input order. Together
    these determine the stable sort uniquely."""
    n = keys.shape[0]
    assert (sorted_keys[1:] >= sorted_keys[:-1]).all(), f"{name}: order"
    seen = np.zeros(n, np.bool_)
    seen[perm] = True
    assert seen.all(), f"{name}: payload is not a permutation"
    assert np.array_equal(keys[perm], sorted_keys), f"{name}: rows moved"
    tie = sorted_keys[1:] == sorted_keys[:-1]
    assert (perm[1:][tie] > perm[:-1][tie]).all(), f"{name}: tie order"
    print(f"  {name}: bit-exact stable sort (order, permutation, rows, "
          f"tie order)", flush=True)


SINGLE_CARD = (("copy", phase_copy), ("keys sort", phase_keys),
               ("stable kv", phase_kv), ("filter + group by", phase_query),
               ("hash join", phase_join), ("top-k / distinct",
                                          phase_topk_unique))
FOUR_CARDS = (("distributed", phase_dist),)


def phases(four_cards: bool):
    """The (name, function) phases a run executes."""
    return FOUR_CARDS if four_cards else SINGLE_CARD


def last_line(devices) -> str:
    """The result line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the distributed phase, over four cards")
    args = p.parse_args(argv)
    dev = require_gpu()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
          f"jax {jax.__version__}, compile cache "
          f"{enable_persistent_cache()}", flush=True)
    print("tolerance: zero — every comparison is bit equality", flush=True)
    t_all = time.perf_counter()
    for name, phase in phases(args.four_cards):
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        phase()
        print(f"== phase {name}: passed in {time.perf_counter() - t0:.1f} s "
              f"wall", flush=True)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    for line in card_lines():
        print(line)
    print(last_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
