"""top_k / unique (ops/topk.py) vs goldens, including the skew fallback
(fat threshold bin), the small-n full-sort path, non-128-multiple n, and
the i32/f32 codec surface."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.core.keycodec import encode
from lsdradixsort.ops.topk import top_k, unique


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _golden_topk(keys, k, largest):
    codes = np.asarray(encode(jnp.asarray(keys), descending=largest))
    order = np.argsort(codes, kind="stable")[:k]
    return keys[order], order.astype(np.uint32)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n,k", [(1 << 17, 100), (1 << 17, 1 << 14),
                                 (50_000, 7), (1 << 12, 1 << 12)])
def test_top_k_u32(rng, largest, n, k):
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vals, idx = top_k(jnp.asarray(keys), k, largest=largest)
    wv, wi = _golden_topk(keys, k, largest)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_skew_fallback(rng, largest):
    # all keys in ONE high-byte bin: survivors = n > B -> cond fallback
    n, k = 1 << 17, 64
    keys = (np.uint32(0xAB000000) | rng.integers(
        0, 1 << 24, n, dtype=np.uint64).astype(np.uint32))
    vals, idx = top_k(jnp.asarray(keys), k, largest=largest)
    wv, wi = _golden_topk(keys, k, largest)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


def test_top_k_all_equal_stable():
    n, k = 1 << 17, 10
    keys = np.full(n, 42, np.uint32)
    vals, idx = top_k(jnp.asarray(keys), k)
    np.testing.assert_array_equal(np.asarray(vals), keys[:k])
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.arange(k, dtype=np.uint32))


def test_top_k_boundary_max_code(rng):
    # largest=False with many 0xFFFFFFFF keys: survivor codes equal the
    # sentinel — garbage tail rows must not leak into the answer
    n, k = 1 << 17, 200
    keys = rng.integers(0, 100, n, dtype=np.uint64).astype(np.uint32)
    keys[rng.choice(n, 300, replace=False)] = np.uint32(0xFFFFFFFF)
    vals, idx = top_k(jnp.asarray(keys), k, largest=True)
    wv, wi = _golden_topk(keys, k, True)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_top_k_dtypes(rng, dtype):
    n, k = 1 << 17, 50
    if dtype == np.int32:
        keys = rng.integers(-(1 << 31), 1 << 31, n,
                            dtype=np.int64).astype(np.int32)
    else:
        keys = (rng.standard_normal(n) * 1e6).astype(np.float32)
    vals, idx = top_k(jnp.asarray(keys), k, largest=True)
    wv, wi = _golden_topk(keys, k, True)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_unique(rng, dtype):
    n = 1 << 13
    keys = rng.integers(0, 200, n, dtype=np.int64).astype(dtype)
    if dtype == np.int32:
        keys -= 100
    cnt, uk, counts = unique(jnp.asarray(keys))
    wk, wc = np.unique(keys, return_counts=True)
    c = int(cnt)
    assert c == wk.size
    np.testing.assert_array_equal(np.asarray(uk)[:c], wk)
    np.testing.assert_array_equal(np.asarray(counts)[:c],
                                  wc.astype(np.uint32))


def test_unique_single_run(rng):
    keys = np.full(4096, 7, np.uint32)
    cnt, uk, counts = unique(jnp.asarray(keys))
    assert int(cnt) == 1
    assert int(np.asarray(uk)[0]) == 7
    assert int(np.asarray(counts)[0]) == 4096


def test_unique_all_distinct(rng):
    keys = rng.permutation(1 << 12).astype(np.uint32)
    cnt, uk, counts = unique(jnp.asarray(keys))
    assert int(cnt) == keys.size
    np.testing.assert_array_equal(np.asarray(uk), np.sort(keys))
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.ones(keys.size, np.uint32))


def test_compact_streaming_preserves_float_bits(rng):
    # compaction moves float payloads bit-exactly (no value conversion)
    from lsdradixsort.ops.filter import compact
    n = 1 << 16
    keys = rng.integers(0, 1 << 20, n, dtype=np.uint64).astype(np.uint32)
    fvals = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    mask = (keys & 1) == 0
    cnt, fk, fv = compact(jnp.asarray(mask), jnp.asarray(keys),
                          jnp.asarray(fvals))
    c = int(cnt)
    np.testing.assert_array_equal(np.asarray(fk)[:c], keys[mask])
    np.testing.assert_array_equal(
        np.asarray(fv)[:c].view(np.uint32), fvals[mask].view(np.uint32))


# --- aggregate dtype surface ------------------------------------------------

def test_group_by_i32_keys_i32_sums(rng):
    from lsdradixsort.ops import group_by_sum
    n = 1 << 12
    gk = (rng.integers(0, 60, n)).astype(np.int32) - 30
    vals = (rng.integers(-1000, 1000, n)).astype(np.int32)
    cnt, uk, sums = group_by_sum(jnp.asarray(gk), jnp.asarray(vals))
    wk = np.unique(gk)
    ws = np.zeros_like(wk, dtype=np.int64)
    np.add.at(ws, np.searchsorted(wk, gk), vals.astype(np.int64))
    c = int(cnt)
    assert c == wk.size
    np.testing.assert_array_equal(np.asarray(uk)[:c], wk)
    # i32 sums are exact two's-complement mod 2^32
    np.testing.assert_array_equal(np.asarray(sums)[:c],
                                  ws.astype(np.int32))


@pytest.mark.parametrize("red", ["min", "max"])
def test_group_by_f32_minmax(rng, red):
    from lsdradixsort.ops import group_by_aggregate
    n = 1 << 12
    gk = (rng.standard_normal(n // 64).repeat(64)).astype(np.float32)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    cnt, uk, agg = group_by_aggregate(jnp.asarray(gk), jnp.asarray(vals),
                                      reduction=red)
    wk = np.unique(gk)
    fn = np.minimum if red == "min" else np.maximum
    init = np.inf if red == "min" else -np.inf
    wagg = np.full(wk.size, init, np.float32)
    idx = np.searchsorted(wk, gk)
    np.__dict__[red + "imum"].at(wagg, idx, vals)
    c = int(cnt)
    assert c == wk.size
    np.testing.assert_array_equal(np.asarray(uk)[:c], wk)
    np.testing.assert_array_equal(np.asarray(agg)[:c], wagg)
    del fn


def test_group_by_f32_sum_rejected(rng):
    from lsdradixsort.ops import group_by_sum
    with pytest.raises(TypeError):
        group_by_sum(jnp.arange(8, dtype=jnp.uint32),
                     jnp.ones(8, jnp.float32))


# --- window ranks -----------------------------------------------------------

def _golden_window(p, k, method, desc):
    n = p.size
    kk = -k.astype(np.int64) if desc else k.astype(np.int64)
    order = np.lexsort((np.arange(n), kk, p))
    out = np.zeros(n, np.uint32)
    rank = {}
    i = 0
    while i < n:
        j = i
        while j < n and p[order[j]] == p[order[i]]:
            j += 1
        rn, rk, dr, prev = 0, 0, 0, None
        for t in range(i, j):
            rn += 1
            cur = k[order[t]]
            if prev is None or cur != prev:
                rk, dr, prev = rn, dr + 1, cur
            out[order[t]] = {"row_number": rn, "rank": rk,
                             "dense_rank": dr}[method]
        i = j
    return out


@pytest.mark.parametrize("method", ["row_number", "rank", "dense_rank"])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("n", [1 << 11, 1500])
def test_window_rank(rng, method, desc, n):
    from lsdradixsort.ops.window import window_rank
    p = rng.integers(0, 12, n, dtype=np.uint64).astype(np.uint32)
    k = rng.integers(0, 6, n, dtype=np.uint64).astype(np.uint32)  # ties!
    got = np.asarray(window_rank(jnp.asarray(p), jnp.asarray(k),
                                 method=method, descending=desc))
    np.testing.assert_array_equal(got, _golden_window(p, k, method, desc))


def test_window_rank_i32_order(rng):
    from lsdradixsort.ops.window import window_rank
    n = 1 << 11
    p = rng.integers(0, 8, n, dtype=np.uint64).astype(np.uint32)
    k = (rng.integers(0, 10, n)).astype(np.int32) - 5
    got = np.asarray(window_rank(jnp.asarray(p), jnp.asarray(k),
                                 method="rank"))
    np.testing.assert_array_equal(
        got, _golden_window(p, k.astype(np.int64), "rank", False))
