"""Every public operator on every adversarial key distribution, against a
plain numpy reference: all-equal, few-unique, presorted, reverse, the
0/0xFFFFFFFF extremes, and a non-power-of-two length."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort import golden, ops

N = 1 << 12
N_ODD = 3 * 1000 + 7


def _uniform(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


INPUTS = {
    "uniform": lambda rng: _uniform(rng, N),
    "all_equal": lambda rng: np.full(N, 0xDEADBEEF, np.uint32),
    "few_unique": lambda rng: rng.integers(0, 4, N).astype(np.uint32),
    "presorted": lambda rng: np.sort(_uniform(rng, N)),
    "reverse": lambda rng: np.sort(_uniform(rng, N))[::-1].copy(),
    "extremes": lambda rng: rng.choice(
        np.array([0, 0xFFFFFFFF], np.uint32), N),
    "non_pow2_n": lambda rng: _uniform(rng, N_ODD),
}


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _second(rng, n):
    """A second column with ties, for the multi-column operators."""
    return rng.integers(0, 8, n).astype(np.uint32)


def _build_side(k):
    """Unique build keys drawn from the probe's values (every other
    distinct value, so some probes miss) and their payloads."""
    bk = np.unique(k)[::2]
    return bk, bk ^ np.uint32(0x5A5A5A5A)


def _window_ref(p, o):
    """RANK() OVER (PARTITION BY p ORDER BY o), in input row order."""
    n = p.size
    order = np.lexsort((np.arange(n), o, p))
    out = np.zeros(n, np.uint32)
    for t, i in enumerate(order):
        if t == 0 or p[order[t - 1]] != p[i]:
            start, rank = t, 1
        elif o[order[t - 1]] != o[i]:
            rank = t - start + 1
        out[i] = rank
    return out


def check_sort_kv(k, rng):
    v = _uniform(rng, k.size)
    perm = np.argsort(k, kind="stable")
    sk, sv = ops.sort_kv(jnp.asarray(k), jnp.asarray(v))
    _eq(sk, k[perm])
    _eq(sv, v[perm])


def check_sort_with_ranks(k, rng):
    perm = np.argsort(k, kind="stable")
    sk, sp = ops.sort_with_ranks(jnp.asarray(k))
    _eq(sk, k[perm])
    _eq(sp, perm.astype(np.uint32))


def check_sort_lex(k, rng):
    c1 = _second(rng, k.size)
    order = np.lexsort((c1, k))
    (s0, s1), perm = ops.sort_lex([jnp.asarray(k), jnp.asarray(c1)])
    _eq(perm, order.astype(np.uint32))
    _eq(s0, k[order])
    _eq(s1, c1[order])


def check_sort64_with_ranks(k, rng):
    lo = _second(rng, k.size)
    order = np.argsort(k.astype(np.uint64) << np.uint64(32) | lo,
                       kind="stable")
    hi_s, lo_s, perm = ops.sort64_with_ranks(jnp.asarray(k), jnp.asarray(lo))
    _eq(hi_s, k[order])
    _eq(lo_s, lo[order])
    _eq(perm, order.astype(np.uint32))


def check_sort_blocks_kv(k, rng):
    block = 1024 if k.size % 1024 == 0 else k.size
    v = np.arange(k.size, dtype=np.uint32)
    sk, sv = ops.sort_blocks_kv(jnp.asarray(k), jnp.asarray(v),
                                block_size=block)
    for s in range(0, k.size, block):
        p = np.argsort(k[s:s + block], kind="stable")
        _eq(np.asarray(sk)[s:s + block], k[s:s + block][p])
        _eq(np.asarray(sv)[s:s + block], v[s:s + block][p])


def check_compact(k, rng):
    mask = (k & np.uint32(1)) == 0
    v = np.arange(k.size, dtype=np.uint32)
    cnt, ck, cv = ops.compact(jnp.asarray(mask), jnp.asarray(k),
                              jnp.asarray(v))
    c = int(cnt)
    assert c == int(mask.sum())
    _eq(np.asarray(ck)[:c], k[mask])
    _eq(np.asarray(cv)[:c], v[mask])


def check_filtered_group_by_sum(k, rng):
    # the adversarial column is the group key; filter on a second column
    f = _uniform(rng, k.size)
    v = _uniform(rng, k.size)
    lo, hi = np.uint32(1 << 30), np.uint32(3 << 30)
    cnt, uk, sums = ops.filtered_group_by_sum(
        jnp.asarray(f), jnp.asarray(k), jnp.asarray(v), lo, hi)
    mask = (f >= lo) & (f < hi)
    wk, ws = golden.group_by_sum(k[mask], v[mask])
    c = int(cnt)
    assert c == wk.size
    _eq(np.asarray(uk)[:c], wk)
    _eq(np.asarray(sums)[:c], ws)


def check_hash_join(k, rng):
    bk, bv = _build_side(k)
    pv = np.arange(k.size, dtype=np.uint32)
    wk, wpv, wbv = golden.hash_join(bk, bv, k, pv)
    cnt, jk, jpv, jbv = ops.hash_join(jnp.asarray(bk), jnp.asarray(bv),
                                      jnp.asarray(k), jnp.asarray(pv))
    c = int(cnt)
    assert c == wk.size
    _eq(np.asarray(jk)[:c], wk)
    _eq(np.asarray(jpv)[:c], wpv)
    _eq(np.asarray(jbv)[:c], wbv)


def check_hash_join_multi(k, rng):
    # duplicate build keys: a quarter of the probe column itself
    bk = k[: k.size // 4].copy()
    bv = np.arange(bk.size, dtype=np.uint32)
    pv = np.arange(k.size, dtype=np.uint32)
    max_out = 1 << 13
    wk, wpv, wbv = golden.hash_join_multi(bk, bv, k, pv)
    cnt, jk, jpv, jbv = ops.hash_join_multi(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(k), jnp.asarray(pv),
        max_out=max_out)
    assert int(cnt) == wk.size
    m = min(wk.size, max_out)
    _eq(np.asarray(jk)[:m], wk[:m])
    _eq(np.asarray(jpv)[:m], wpv[:m])
    _eq(np.asarray(jbv)[:m], wbv[:m])


def check_probe_lookup(k, rng):
    bk, bv = _build_side(k)
    m, v = ops.probe_lookup(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(k))
    pos = np.minimum(np.searchsorted(bk, k), bk.size - 1)
    hit = bk[pos] == k
    _eq(m, hit.astype(np.uint32))
    _eq(v, np.where(hit, bv[pos], np.uint32(0)))


def check_filter_in_set(k, rng):
    s, _ = _build_side(k)
    v = np.arange(k.size, dtype=np.uint32)
    cnt, fk, fv = ops.filter_in_set(jnp.asarray(k), jnp.asarray(s),
                                    jnp.asarray(v))
    mask = np.isin(k, s)
    c = int(cnt)
    assert c == int(mask.sum())
    _eq(np.asarray(fk)[:c], k[mask])
    _eq(np.asarray(fv)[:c], v[mask])


def check_top_k(k, rng):
    kk = 100
    vals, idx = ops.top_k(jnp.asarray(k), kk)
    want = np.argsort(~k, kind="stable")[:kk]
    _eq(vals, k[want])
    _eq(idx, want.astype(np.uint32))


def check_unique(k, rng):
    cnt, uk, counts = ops.unique(jnp.asarray(k))
    wk, wc = np.unique(k, return_counts=True)
    c = int(cnt)
    assert c == wk.size
    _eq(np.asarray(uk)[:c], wk)
    _eq(np.asarray(counts)[:c], wc.astype(np.uint32))


def check_window_rank(k, rng):
    o = _second(rng, k.size)
    got = ops.window_rank(jnp.asarray(k), jnp.asarray(o), method="rank")
    _eq(got, _window_ref(k, o))


OPS = {f.__name__[len("check_"):]: f for f in (
    check_sort_kv, check_sort_with_ranks, check_sort_lex,
    check_sort64_with_ranks, check_sort_blocks_kv, check_compact,
    check_filtered_group_by_sum, check_hash_join, check_hash_join_multi,
    check_probe_lookup, check_filter_in_set, check_top_k, check_unique,
    check_window_rank)}


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("op", OPS)
def test_op_on_adversarial_input(op, kind):
    rng = np.random.default_rng([list(OPS).index(op),
                                 list(INPUTS).index(kind)])
    OPS[op](INPUTS[kind](rng), rng)
