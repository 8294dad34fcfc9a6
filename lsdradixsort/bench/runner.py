"""Benchmark suite runner — the reference's L4/L5 layers as a CLI.

The reference fuses testing and benchmarking: each Test* function times the
CPU golden, times the GPU kernels, verifies element-by-element, and prints a
per-config report; main() sweeps configs behind compile-time #defines
(LSDRadixSort.cu:912-1185). Here the same discipline is a CLI:

    python -m lsdradixsort.bench sort --n 27 --verify
    python -m lsdradixsort.bench histogram --n 27 --sweep
    python -m lsdradixsort.bench all --out report

Every record names the device it ran on and carries achieved GB/s and
its share of the card's published peak bandwidth (core/roofline.py); on
a device the peak table does not list (the CPU), the share is not
measured. Reports are structured JSON plus the same human-readable lines
the Benchmark*.md files capture.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from lsdradixsort.core import datagen, roofline
from lsdradixsort.core.timing import time_fn, time_host
from lsdradixsort.utils import check_arrays


@dataclasses.dataclass
class Record:
    suite: str
    config: dict
    device: str                # "<platform>/<device_kind>"
    ms: float
    melems_per_s: float
    gbytes_per_s: float
    roofline_frac: float | None   # None: the device has no published peak
    host_ms: float | None = None
    speedup_vs_host: float | None = None
    verified: bool | None = None

    def line(self) -> str:
        share = ("share of peak not measured" if self.roofline_frac is None
                 else f"{100 * self.roofline_frac:.1f}% of peak")
        s = (f"[{self.suite}] {self.config} on {self.device}: "
             f"{self.ms:.3f} ms, {self.melems_per_s:.1f} Melem/s, "
             f"{self.gbytes_per_s:.1f} GB/s ({share})")
        if self.speedup_vs_host is not None:
            s += f", x{self.speedup_vs_host:.2f} vs host"
        if self.verified is not None:
            s += ", verified" if self.verified else ", VERIFY FAILED"
        return s


# --budget deadline, enforced at this single choke point: once exceeded,
# remaining configs are SKIPPED LOUDLY (printed + recorded in the report's
# "skipped" list — a silent cap would read as full coverage)
_DEADLINE: float | None = None
_SKIPPED: list[dict] = []


def set_budget(seconds: float | None) -> None:
    global _DEADLINE
    _DEADLINE = None if seconds is None else time.time() + seconds
    _SKIPPED.clear()


def _bench(suite, config, fn, args, n, bytes_moved, host_fn=None,
           host_args=None, verify=None, iters=5) -> Record | None:
    if _DEADLINE is not None and time.time() > _DEADLINE:
        _SKIPPED.append({"suite": suite, "config": config})
        print(f"[{suite}] {config} : SKIPPED (budget exhausted)", flush=True)
        return None
    dev = jax.devices()[0]
    try:
        rl = roofline.detect(dev)
    except KeyError:
        rl = None
    t = time_fn(fn, *args, iters=iters)
    rec = Record(
        suite=suite, config=config,
        device=f"{dev.platform}/{dev.device_kind}", ms=t.ms,
        melems_per_s=n / t.seconds / 1e6,
        gbytes_per_s=bytes_moved / t.seconds / 1e9,
        roofline_frac=(None if rl is None
                       else rl.fraction(bytes_moved, t.seconds)),
    )
    if host_fn is not None:
        th = time_host(host_fn, *host_args)
        rec.host_ms = th.ms
        rec.speedup_vs_host = th.seconds / t.seconds
    if verify is not None:
        try:
            verify()
            rec.verified = True
        except AssertionError:
            rec.verified = False
    return rec


# ---------------------------------------------------------------------------
# Suites (mirror the reference's Benchmark* sweeps, cu:1064-1150)
# ---------------------------------------------------------------------------

def suite_sort(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    from lsdradixsort.ops.sort import sort, sort_kv, sort_with_ranks
    from lsdradixsort import native
    n = 1 << n_log2
    keys = datagen.random_keys(n)
    out = []
    fn = jax.jit(lambda k: sort(k))
    ver = None
    host_fn = host_args = None
    if native.available():
        # host baseline: the reference's CPU-golden timing (cu:984-990)
        keys_np = np.asarray(keys)
        host_fn = lambda: native.radix_sort(keys_np)
        host_args = ()
    if verify:
        keys_np = np.asarray(keys)
        ver = lambda: check_arrays(fn(keys), np.sort(keys_np))
    out.append(_bench("sort/keys", {"n": n}, fn, (keys,), n,
                      bytes_moved=8 * n, host_fn=host_fn,
                      host_args=host_args, verify=ver))
    # f32 keys through the order-preserving codec (core/keycodec.py):
    # prices the encode/decode overhead on the same sort
    fkeys = jax.lax.bitcast_convert_type(
        datagen.random_keys(n, seed=3) >> 9, jnp.float32) + jnp.float32(1.0)
    ff = jax.jit(lambda k: sort(k))
    vf = None
    if verify:
        fkeys_np = np.asarray(fkeys)
        def vf():
            got = np.asarray(ff(fkeys))
            want = np.sort(fkeys_np)
            assert (got == want).all()
    out.append(_bench("sort/keys_f32", {"n": n}, ff, (fkeys,), n,
                      bytes_moved=8 * n, verify=vf))
    vals = jnp.arange(n, dtype=jnp.uint32)
    fkv = jax.jit(sort_kv)
    fr = jax.jit(sort_with_ranks)
    vkv = vr = None
    if verify:
        keys_np = np.asarray(keys)
        perm = np.argsort(keys_np, kind="stable")
        def vkv():
            sk, sv = fkv(keys, vals)
            check_arrays(sk, keys_np[perm])
            check_arrays(sv, perm.astype(np.uint32))
        def vr():
            sk, sv = fr(keys)
            check_arrays(sk, keys_np[perm])
            check_arrays(sv, perm.astype(np.uint32))
    out.append(_bench("sort/kv", {"n": n}, fkv, (keys, vals), n,
                      bytes_moved=16 * n, verify=vkv))
    out.append(_bench("sort/ranks", {"n": n}, fr, (keys,), n,
                      bytes_moved=16 * n, verify=vr))
    if sweep:
        # 64-bit keys as two u32 planes: two stable 32-bit passes
        from lsdradixsort.ops.sort import sort64_with_ranks
        hi64 = datagen.random_keys(n, seed=11)
        lo64 = datagen.random_keys(n, seed=12)
        f64 = jax.jit(sort64_with_ranks)
        v64 = None
        if verify:
            h_np, l_np = np.asarray(hi64), np.asarray(lo64)
            w64 = np.argsort(h_np.astype(np.uint64) << np.uint64(32)
                             | l_np, kind="stable")
            def v64():
                sh, sl, sp = f64(hi64, lo64)
                check_arrays(sh, h_np[w64])
                check_arrays(sl, l_np[w64])
                check_arrays(sp, w64.astype(np.uint32))
        out.append(_bench("sort/64bit", {"n": n}, f64, (hi64, lo64), n,
                          bytes_moved=24 * n, verify=v64))
        # the composed LSD radix pipeline (histogram -> scans -> scatter,
        # the reference's pass structure)
        nc = min(n, 1 << 24)
        ckeys = keys[:nc]
        cfn = jax.jit(lambda k: sort(k, strategy="composed"))
        cver = None
        if verify:
            ck_np = np.asarray(ckeys)
            cver = lambda: check_arrays(cfn(ckeys), np.sort(ck_np))
        out.append(_bench("sort/composed_r8", {"n": nc}, cfn, (ckeys,), nc,
                          bytes_moved=8 * nc, verify=cver, iters=2))
    return out


def suite_histogram(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    from lsdradixsort.ops.primitives import block_digit_histograms
    from lsdradixsort import golden
    n = 1 << n_log2
    keys = datagen.random_keys(n)
    rs = (1, 2, 4, 8) if sweep else (4, 8)
    blocks = (1 << 13, 1 << 15, 1 << 17) if sweep else (1 << 15,)
    out = []
    for r in rs:
        for block in blocks:
            if n % block:
                continue
            fn = jax.jit(lambda k, r=r, b=block:
                         block_digit_histograms(k, r, 0, b))
            ver = None
            if verify:
                keys_np = np.asarray(keys)
                ver = lambda r=r, b=block, f=fn: check_arrays(
                    f(keys), golden.digit_histograms(keys_np, r, 0, b))
            out.append(_bench(
                "histogram", {"n": n, "r": r, "block": block},
                fn, (keys,), n, bytes_moved=4 * n, verify=ver))
    return out


def suite_scan(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    from lsdradixsort.ops.primitives import exclusive_scan
    from lsdradixsort import golden
    n = 1 << n_log2
    a = datagen.random_keys(n)
    ver = None
    if verify:
        a_np = np.asarray(a)
        ver = lambda: check_arrays(exclusive_scan(a), golden.prefix_sum(a_np))
    return [_bench("scan", {"n": n}, exclusive_scan, (a,), n,
                   bytes_moved=8 * n, verify=ver)]


def suite_transpose(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    """Matrix transpose (TestTranspose analog, cu:546-637): XLA's own
    transpose, which tiles through shared memory as the reference's
    kernel does."""
    n = 1 << n_log2
    shapes = [(1 << (n_log2 // 2), n >> (n_log2 // 2))]
    if sweep:
        shapes += [(256, n // 256), (n // 256, 256)]
    out = []
    fn = jax.jit(lambda a: a.T)
    for rows, cols in shapes:
        a = datagen.random_keys(n).reshape(rows, cols)
        ver = None
        if verify:
            a_np = np.asarray(a)
            ver = lambda a=a, a_np=a_np: check_arrays(fn(a), a_np.T)
        out.append(_bench("transpose", {"rows": rows, "cols": cols}, fn,
                          (a,), n, bytes_moved=8 * n, verify=ver))
    return out


def suite_query(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    """filter + aggregate + join — north star configs 3-4."""
    from lsdradixsort.ops import filter_kv, group_by_sum, hash_join
    n = 1 << n_log2
    keys = datagen.random_keys_bounded(n, 0, 1 << 20, seed=1)
    vals = jnp.arange(n, dtype=jnp.uint32)
    out = []
    from lsdradixsort import golden
    lo, hi = jnp.uint32(1 << 18), jnp.uint32(1 << 19)
    ffn = jax.jit(lambda k, v: filter_kv(k, v, lo, hi))
    fver = None
    if verify:
        k_np, v_np = np.asarray(keys), np.asarray(vals)
        def fver():
            cnt, fk, fv = ffn(keys, vals)
            mask = (k_np >= (1 << 18)) & (k_np < (1 << 19))
            wk, wv = k_np[mask], v_np[mask]
            assert int(cnt) == wk.size
            check_arrays(fk[:wk.size], wk)
            check_arrays(fv[:wk.size], wv)
    out.append(_bench("query/filter", {"n": n}, ffn, (keys, vals), n,
                      bytes_moved=16 * n, verify=fver))
    gfn = jax.jit(group_by_sum)
    gver = None
    if verify:
        k_np, v_np = np.asarray(keys), np.asarray(vals)
        def gver():
            cnt, uk, sums = gfn(keys, vals)
            wk, ws = golden.group_by_sum(k_np, v_np)
            assert int(cnt) == wk.size
            check_arrays(uk[:wk.size], wk)
            check_arrays(sums[:wk.size], ws)
    out.append(_bench("query/group_by_sum", {"n": n}, gfn, (keys, vals), n,
                      bytes_moved=16 * n, verify=gver))
    from lsdradixsort.ops.aggregate import filtered_group_by_sum
    gk2 = datagen.random_keys_bounded(n, 0, 1 << 10, seed=7)
    qfn = jax.jit(lambda k, g, v: filtered_group_by_sum(
        k, g, v, jnp.uint32(1 << 18), jnp.uint32(1 << 19)))
    qver = None
    if verify:
        k_np = np.asarray(keys)
        g_np, v_np = np.asarray(gk2), np.asarray(vals)
        def qver():
            cnt, uk, sums = qfn(keys, gk2, vals)
            mask = (k_np >= (1 << 18)) & (k_np < (1 << 19))
            wk, ws = golden.group_by_sum(g_np[mask], v_np[mask])
            assert int(cnt) == wk.size
            check_arrays(uk[:wk.size], wk)
            check_arrays(sums[:wk.size], ws)
    out.append(_bench("query/filtered_group_by (config 3)", {"n": n}, qfn,
                      (keys, gk2, vals), n, bytes_moved=20 * n, verify=qver))
    nb = max(n // 10, 1)
    bkeys = jax.random.permutation(
        jax.random.PRNGKey(2), jnp.arange(nb, dtype=jnp.uint32))
    bvals = bkeys * jnp.uint32(3)
    pkeys = datagen.random_keys_bounded(n, 0, 2 * nb, seed=3)
    jfn = jax.jit(hash_join)
    jver = None
    if verify:
        bk_np, bv_np = np.asarray(bkeys), np.asarray(bvals)
        pk_np, pv_np = np.asarray(pkeys), np.asarray(vals)
        def jver():
            cnt, jk, jpv, jbv = jfn(bkeys, bvals, pkeys, vals)
            wk, wpv, wbv = golden.hash_join(bk_np, bv_np, pk_np, pv_np)
            assert int(cnt) == wk.size
            check_arrays(jk[:wk.size], wk)
            check_arrays(jpv[:wk.size], wpv)
            check_arrays(jbv[:wk.size], wbv)
    out.append(_bench("query/hash_join", {"build": nb, "probe": n}, jfn,
                      (bkeys, bvals, pkeys, vals), n,
                      bytes_moved=8 * (n + nb) + 24 * n, verify=jver))
    # many-to-many join: ~4 build rows per key, output bound 2x probe count
    from lsdradixsort.ops import hash_join_multi
    bkeys_m = datagen.random_keys_bounded(nb, 0, max(nb // 4, 1), seed=5)
    max_out = 2 * n
    jmfn = jax.jit(lambda b, bv, p, pv: hash_join_multi(
        b, bv, p, pv, max_out=max_out))
    jmver = None
    if verify:
        bkm_np = np.asarray(bkeys_m)
        bv_np2 = np.asarray(bvals)
        pk_np2, pv_np2 = np.asarray(pkeys), np.asarray(vals)
        def jmver():
            cnt, jk, jpv, jbv = jmfn(bkeys_m, bvals, pkeys, vals)
            wk, wpv, wbv = golden.hash_join_multi(bkm_np, bv_np2, pk_np2,
                                                  pv_np2)
            assert int(cnt) == wk.size
            m = min(wk.size, max_out)
            check_arrays(jk[:m], wk[:m])
            check_arrays(jpv[:m], wpv[:m])
            check_arrays(jbv[:m], wbv[:m])
    out.append(_bench("query/hash_join_multi", {"build": nb, "probe": n,
                                                "max_out": max_out},
                      jmfn, (bkeys_m, bvals, pkeys, vals), n,
                      bytes_moved=8 * (n + nb) + 24 * max_out, verify=jmver))

    # small build side: dimension-table join + IN-list semi-join
    from lsdradixsort.ops import filter_in_set
    nbs = 1 << 10
    bkeys_s = jax.random.permutation(
        jax.random.PRNGKey(7), jnp.arange(1 << 12, dtype=jnp.uint32))[:nbs]
    bvals_s = bkeys_s ^ jnp.uint32(0xABC)
    pkeys_s = datagen.random_keys_bounded(n, 0, 1 << 12, seed=8)
    jsfn = jax.jit(hash_join)
    jsver = None
    if verify:
        bks_np, bvs_np = np.asarray(bkeys_s), np.asarray(bvals_s)
        pks_np, pvs_np = np.asarray(pkeys_s), np.asarray(vals)
        def jsver():
            cnt, jk, jpv, jbv = jsfn(bkeys_s, bvals_s, pkeys_s, vals)
            wk, wpv, wbv = golden.hash_join(bks_np, bvs_np, pks_np, pvs_np)
            assert int(cnt) == wk.size
            check_arrays(jk[:wk.size], wk)
            check_arrays(jpv[:wk.size], wpv)
            check_arrays(jbv[:wk.size], wbv)
    out.append(_bench("query/hash_join_small_build",
                      {"build": nbs, "probe": n}, jsfn,
                      (bkeys_s, bvals_s, pkeys_s, vals), n,
                      bytes_moved=16 * n, verify=jsver))
    sfn = jax.jit(filter_in_set)
    sver = None
    if verify:
        pks_np2, v_np2 = np.asarray(pkeys_s), np.asarray(vals)
        bks_np2 = np.asarray(bkeys_s)
        def sver():
            cnt, fk, fv = sfn(pkeys_s, bkeys_s, vals)
            mask = np.isin(pks_np2, bks_np2)
            assert int(cnt) == int(mask.sum())
            check_arrays(fk[:int(cnt)], pks_np2[mask])
            check_arrays(fv[:int(cnt)], v_np2[mask])
    out.append(_bench("query/filter_in_set", {"set": nbs, "n": n}, sfn,
                      (pkeys_s, bkeys_s, vals), n,
                      bytes_moved=16 * n, verify=sver))

    # ORDER BY ... LIMIT k: histogram-guided top-k (ops/topk.py) — one
    # histogram pass + one compaction pass + a static-B tail sort.
    # Full-range keys so the 256-bin threshold actually selects (the
    # bounded `keys` above all share one high byte = permanent fallback)
    from lsdradixsort.ops.topk import top_k, unique
    kk = 1 << 10
    tkeys = datagen.random_keys(n, seed=9)
    tfn = jax.jit(lambda x: top_k(x, kk, largest=True))
    tver = None
    if verify:
        tkeys_np = np.asarray(tkeys)
        def tver():
            tv, ti = tfn(tkeys)
            order = np.argsort(~tkeys_np, kind="stable")[:kk]
            check_arrays(tv, tkeys_np[order])
            check_arrays(ti, order.astype(np.uint32))
    out.append(_bench("query/top_k", {"n": n, "k": kk}, tfn, (tkeys,), n,
                      bytes_moved=8 * n, verify=tver))

    # SELECT DISTINCT + counts
    ufn = jax.jit(unique)
    uver = None
    if verify:
        keys_np2 = np.asarray(keys)
        def uver():
            cnt, uk, cts = ufn(keys)
            wk, wc = np.unique(keys_np2, return_counts=True)
            assert int(cnt) == wk.size
            check_arrays(uk[:wk.size], wk)
            check_arrays(cts[:wk.size], wc.astype(np.uint32))
    out.append(_bench("query/unique", {"n": n}, ufn, (keys,), n,
                      bytes_moved=16 * n, verify=uver))
    return out


def suite_dist(n_log2: int, verify: bool, sweep: bool) -> list[Record]:
    """Distributed kv-sort over all local devices (north-star config 5).

    On several cards this measures scaling efficiency vs the one-card
    sort; on one card it runs the D=1 path, which needs no collective.
    Reports per-shard balance (exact by construction — equal-key rank
    splitting keeps shards balanced under any skew).
    """
    from lsdradixsort.parallel import make_mesh, shard_1d, dist_sort_kv
    from lsdradixsort.ops.sort import sort_with_ranks
    d = len(jax.devices())
    n = 1 << n_log2
    mesh = make_mesh(d)
    keys = datagen.random_keys(n)
    vals = jnp.arange(n, dtype=jnp.uint32)
    sk = shard_1d(keys, mesh)
    sv = shard_1d(vals, mesh)
    fn = jax.jit(lambda k, v: dist_sort_kv(k, v, mesh))
    ver = None
    if verify:
        keys_np = np.asarray(keys)
        perm = np.argsort(keys_np, kind="stable")
        def ver():
            ok, ov = fn(sk, sv)
            check_arrays(ok, keys_np[perm])
            check_arrays(ov, perm.astype(np.uint32))
    out = [_bench("dist/sort_kv", {"n": n, "devices": d}, fn, (sk, sv), n,
                  bytes_moved=16 * n, verify=ver)]
    # single-device reference for scaling efficiency, recorded as a
    # structured field on the dist record
    t1 = time_fn(sort_with_ranks, keys, iters=3)
    rec = out[0]
    ratio = t1.seconds / rec.ms * 1e3
    if d > 1:
        eff = ratio / d
        rec.config["scaling_eff"] = round(eff, 4)
        print(f"# scaling efficiency vs 1-device sort_with_ranks: "
              f"{100 * eff:.1f}% at D={d}")
    else:
        # at D=1 the ratio measures dist-machinery overhead vs the local
        # sort, not scaling
        rec.config["d1_dist_overhead"] = round(1.0 / ratio, 4)
        print(f"# D=1: dist path costs {1.0 / ratio:.2f}x the local "
              f"sort_with_ranks (machinery overhead, not scaling)")
    return out


SUITES: dict[str, Callable] = {
    "dist": suite_dist,
    "sort": suite_sort,
    "histogram": suite_histogram,
    "scan": suite_scan,
    "transpose": suite_transpose,
    "query": suite_query,
}


def run_suite(name: str, n_log2: int = 24, verify: bool = False,
              sweep: bool = False) -> tuple[list[Record], list[dict]]:
    """Run suites; a crashed suite is recorded in `failed`, not swallowed
    (the reference only skips *known-infeasible* configs with a printed
    reason, cu:940-964 — we keep the sweep going but surface the failure
    in the report and the exit code)."""
    names = list(SUITES) if name == "all" else [name]
    records: list[Record] = []
    failed: list[dict] = []
    for s in names:
        try:
            for rec in SUITES[s](n_log2, verify, sweep):
                if rec is None:          # budget-skipped config
                    continue
                print(rec.line(), flush=True)
                records.append(rec)
        except Exception as e:
            msg = str(e).splitlines()[0][:160]
            failed.append({"suite": s, "error": msg})
            print(f"[{s}] SUITE FAILED: {msg}", flush=True)
    return records, failed


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("suite", choices=[*SUITES, "all"])
    p.add_argument("--n", type=int, default=24, help="log2 element count")
    p.add_argument("--verify", action="store_true",
                   help="check against golden models (reference discipline)")
    p.add_argument("--sweep", action="store_true",
                   help="sweep block sizes / digit widths like the reference")
    p.add_argument("--out", type=str, default=None,
                   help="write <out>.json and <out>.md reports")
    p.add_argument("--budget", type=float, default=None,
                   help="wall-clock budget in seconds; configs past the "
                        "deadline are skipped loudly and listed in the "
                        "report")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the persistent XLA compilation cache")
    args = p.parse_args()
    if not args.no_cache:
        from lsdradixsort.core.cache import enable_persistent_cache
        d = enable_persistent_cache()
        print(f"# compilation cache: {d}")
    set_budget(args.budget)
    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    records, failed = run_suite(args.suite, args.n, args.verify, args.sweep)
    if args.out:
        with open(args.out + ".json", "w") as f:
            json.dump({"records": [dataclasses.asdict(r) for r in records],
                       "failed_suites": failed,
                       "skipped": _SKIPPED,
                       "session": time.strftime("%Y-%m-%d %H:%M")}, f,
                      indent=1)
        with open(args.out + ".md", "w") as f:
            f.write(f"# Benchmark report — {dev.device_kind}, "
                    f"{time.strftime('%Y-%m-%d')}\n\n")
            for r in records:
                f.write(r.line() + "\n")
            for fl in failed:
                f.write(f"FAILED {fl['suite']}: {fl['error']}\n")
    # automation keys on the exit code: any verify failure or crashed
    # suite is a nonzero exit
    bad_verify = [r for r in records if getattr(r, "verified", None) is False]
    if failed or bad_verify:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
