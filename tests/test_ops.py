"""Operator correctness vs golden models, including the property tests the
reference lacks (SURVEY.md §4): stability with duplicate keys, non-power-of-2
sizes, already-sorted / reverse / all-equal inputs."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort import golden, ops
from lsdradixsort.utils import check_arrays, check_sorted


def _keys(rng, n, hi=1 << 32):
    return rng.integers(0, hi, size=n, dtype=np.uint32)


SPECIAL_INPUTS = {
    "uniform": lambda rng, n: _keys(rng, n),
    "all_equal": lambda rng, n: np.full(n, 0xDEADBEEF, dtype=np.uint32),
    "sorted": lambda rng, n: np.sort(_keys(rng, n)),
    "reverse": lambda rng, n: np.sort(_keys(rng, n))[::-1].copy(),
    "few_uniques": lambda rng, n: _keys(rng, n, hi=4),
    "extremes": lambda rng, n: rng.choice(
        np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32), size=n),
}


@pytest.mark.parametrize("kind", SPECIAL_INPUTS)
@pytest.mark.parametrize("strategy", ["xla", "composed"])
def test_sort(rng, kind, strategy):
    n = 1 << 13 if strategy == "composed" else 10_000
    keys = SPECIAL_INPUTS[kind](rng, n)
    block = 1 << 10
    got = ops.sort(jnp.asarray(keys), strategy=strategy, block_size=block)
    check_arrays(got, np.sort(keys), f"sort[{strategy}] {kind}")


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_composed_sort_digit_widths(rng, r):
    keys = _keys(rng, 1 << 12)
    got = ops.sort(jnp.asarray(keys), strategy="composed", r=r,
                   block_size=1 << 9)
    check_arrays(got, np.sort(keys), f"composed r={r}")


@pytest.mark.parametrize("strategy", ["xla", "composed"])
@pytest.mark.parametrize("kind", ["uniform", "all_equal", "few_uniques"])
def test_sort_kv_stable(rng, kind, strategy):
    n = 1 << 12
    keys = SPECIAL_INPUTS[kind](rng, n)
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = ops.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                         strategy=strategy, block_size=1 << 9)
    wk, wv = golden.lsd_radix_sort_kv(keys, vals)
    check_arrays(gk, wk, f"kv keys {kind}")
    check_arrays(gv, wv, f"kv vals {kind} (stability)")


def test_sort_non_power_of_two(rng):
    keys = _keys(rng, 99_991)  # prime size
    check_arrays(ops.sort(jnp.asarray(keys)), np.sort(keys), "np2")


def test_argsort(rng):
    keys = _keys(rng, 5000, hi=16)
    perm = np.asarray(ops.argsort(jnp.asarray(keys)))
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))


def test_filter(rng):
    keys = _keys(rng, 20_000)
    lo, hi = np.uint32(1 << 30), np.uint32(3 << 30)
    count, packed = ops.filter_keys(jnp.asarray(keys), lo, hi)
    want = golden.filter_keys(keys, lo, hi)
    assert int(count) == want.size
    check_arrays(np.asarray(packed)[:want.size], want, "filter")


def test_filter_kv_order_preserving(rng):
    keys = _keys(rng, 10_000, hi=100)
    vals = np.arange(10_000, dtype=np.uint32)
    count, fk, fv = ops.filter_kv(jnp.asarray(keys), jnp.asarray(vals), 10, 50)
    mask = (keys >= 10) & (keys < 50)
    c = int(count)
    check_arrays(np.asarray(fk)[:c], keys[mask], "fkv keys")
    check_arrays(np.asarray(fv)[:c], vals[mask], "fkv vals")


def test_group_by_sum(rng):
    gk = _keys(rng, 50_000, hi=1000)
    v = _keys(rng, 50_000)
    count, uk, sums = ops.group_by_sum(jnp.asarray(gk), jnp.asarray(v))
    wk, ws = golden.group_by_sum(gk, v)
    c = int(count)
    assert c == wk.size
    check_arrays(np.asarray(uk)[:c], wk, "gb keys")
    check_arrays(np.asarray(sums)[:c], ws, "gb sums (u32 wraparound)")


def test_group_by_sum_single_group(rng):
    gk = np.zeros(4096, dtype=np.uint32)
    v = _keys(rng, 4096)
    count, uk, sums = ops.group_by_sum(jnp.asarray(gk), jnp.asarray(v))
    assert int(count) == 1
    assert np.uint32(sums[0]) == np.sum(v, dtype=np.uint32)


@pytest.mark.parametrize("red", ["min", "max", "count"])
def test_group_by_other_reductions(rng, red):
    gk = _keys(rng, 10_000, hi=100)
    v = _keys(rng, 10_000)
    count, uk, agg = ops.group_by_aggregate(jnp.asarray(gk), jnp.asarray(v),
                                            reduction=red)
    c = int(count)
    wk = np.unique(gk)
    assert c == wk.size
    fn = {"min": np.min, "max": np.max, "count": lambda x: x.size}[red]
    want = np.array([fn(v[gk == k]) for k in wk], dtype=np.uint32)
    check_arrays(np.asarray(agg)[:c], want, f"gb {red}")


def test_hash_join(rng):
    bk = rng.permutation(np.arange(1000, dtype=np.uint32))
    bv = bk * 3 + 1
    pk = _keys(rng, 20_000, hi=2000)
    pv = np.arange(20_000, dtype=np.uint32)
    count, jk, jpv, jbv = ops.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv))
    wk, wpv, wbv = golden.hash_join(bk, bv, pk, pv)
    c = int(count)
    assert c == wk.size
    check_arrays(np.asarray(jk)[:c], wk, "join keys")
    check_arrays(np.asarray(jpv)[:c], wpv, "join probe vals")
    check_arrays(np.asarray(jbv)[:c], wbv, "join build vals")


def test_hash_join_no_matches(rng):
    bk = np.arange(100, dtype=np.uint32)
    pk = np.arange(100, 200, dtype=np.uint32)
    count, *_ = ops.hash_join(jnp.asarray(bk), jnp.asarray(bk),
                              jnp.asarray(pk), jnp.asarray(pk))
    assert int(count) == 0


def test_hash_join_all_match_duplicated_probes(rng):
    bk = np.arange(10, dtype=np.uint32)
    bv = bk + 100
    pk = np.tile(bk, 50)
    pv = np.arange(500, dtype=np.uint32)
    count, jk, jpv, jbv = ops.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv))
    assert int(count) == 500
    check_arrays(np.asarray(jk), pk, "dup join keys")
    check_arrays(np.asarray(jbv), pk + 100, "dup join build vals")


def test_sort_with_ranks_matches_stable_argsort():
    from lsdradixsort.ops.sort import sort_with_ranks
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 50, 4096, dtype=np.uint64).astype(np.uint32)
    sk, perm = sort_with_ranks(jnp.asarray(keys))
    want = np.argsort(keys, kind="stable").astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(perm), want)
    np.testing.assert_array_equal(np.asarray(sk), keys[want])


@pytest.mark.parametrize("n", [1 << 12, 4097])
def test_filtered_group_by_sum(n):
    from lsdradixsort.ops.aggregate import filtered_group_by_sum
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 1000, n, dtype=np.uint64).astype(np.uint32)
    gk = rng.integers(0, 37, n, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo, hi = 200, 700
    cnt, uk, sums = filtered_group_by_sum(
        jnp.asarray(keys), jnp.asarray(gk), jnp.asarray(vals), lo, hi)
    mask = (keys >= lo) & (keys < hi)
    wk, ws = golden.group_by_sum(gk[mask], vals[mask])
    assert int(cnt) == wk.size
    np.testing.assert_array_equal(np.asarray(uk)[:wk.size], wk)
    np.testing.assert_array_equal(np.asarray(sums)[:wk.size], ws)


def test_filtered_group_by_sum_sentinel_group():
    # a real group key equal to the sentinel must still aggregate correctly
    from lsdradixsort.ops.aggregate import filtered_group_by_sum
    keys = np.array([5, 5, 50, 50], np.uint32)
    gk = np.array([0xFFFFFFFF, 1, 0xFFFFFFFF, 1], np.uint32)
    vals = np.array([10, 20, 30, 40], np.uint32)
    cnt, uk, sums = filtered_group_by_sum(
        jnp.asarray(keys), jnp.asarray(gk), jnp.asarray(vals), 0, 100)
    assert int(cnt) == 2
    np.testing.assert_array_equal(np.asarray(uk)[:2],
                                  np.array([1, 0xFFFFFFFF], np.uint32))
    np.testing.assert_array_equal(np.asarray(sums)[:2],
                                  np.array([60, 40], np.uint32))


def test_group_by_sum_merge_engine(rng):
    gk = _keys(rng, 40_000, hi=500)
    v = _keys(rng, 40_000)
    count, uk, sums = ops.group_by_sum(jnp.asarray(gk), jnp.asarray(v))
    wk, ws = golden.group_by_sum(gk, v)
    c = int(count)
    assert c == wk.size
    check_arrays(np.asarray(uk)[:c], wk, "gb keys (merge)")
    check_arrays(np.asarray(sums)[:c], ws, "gb sums (merge)")


def test_hash_join_merge_engine(rng):
    bk = rng.permutation(np.arange(1000, dtype=np.uint32))
    bv = bk * 3 + 1
    pk = _keys(rng, 20_000, hi=2000)
    pv = np.arange(20_000, dtype=np.uint32)
    count, jk, jpv, jbv = ops.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv))
    wk, wpv, wbv = golden.hash_join(bk, bv, pk, pv)
    c = int(count)
    assert c == wk.size
    check_arrays(np.asarray(jk)[:c], wk, "join keys (merge)")
    check_arrays(np.asarray(jpv)[:c], wpv, "join probe vals (merge)")
    check_arrays(np.asarray(jbv)[:c], wbv, "join build vals (merge)")


def test_sort_kv_merge_strategy(rng):
    n = 10_000
    keys = rng.integers(0, 64, n, dtype=np.uint32)   # heavy duplicates
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    gk, gv = ops.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    wk, wv = golden.lsd_radix_sort_kv(keys, vals)
    check_arrays(gk, wk, "kv keys merge")
    check_arrays(gv, wv, "kv vals merge (stability)")


def test_sort_kv_merge_f32_payload(rng):
    # a float payload moves bit-exactly (no value conversion)
    n = 10_000
    keys = rng.integers(0, 64, n, dtype=np.uint32)
    vals = rng.standard_normal(n).astype(np.float32)
    gk, gv = ops.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    perm = np.argsort(keys, kind="stable")
    check_arrays(gk, keys[perm], "kv keys merge f32")
    assert np.asarray(gv).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(gv).view(np.uint32),
                                  vals[perm].view(np.uint32))


def test_sort_kv_merge_u16_payload_falls_back(rng):
    # a 16-bit payload keeps its dtype and values
    n = 8_192
    keys = rng.integers(0, 64, n, dtype=np.uint32)
    vals = rng.integers(0, 2**16, n, dtype=np.uint16)
    gk, gv = ops.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    perm = np.argsort(keys, kind="stable")
    check_arrays(gk, keys[perm], "kv keys u16 fallback")
    assert np.asarray(gv).dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(gv), vals[perm])


@pytest.mark.parametrize("masked", [False, True])
def test_hash_join_multi(rng, masked):
    # many-to-many: ~6 build rows per key, every probe key may repeat;
    # probe_valid drops the masked probe rows entirely
    bk = _keys(rng, 3000, hi=500)
    bv = _keys(rng, 3000)
    pk = _keys(rng, 10_000, hi=800)
    pv = np.arange(10_000, dtype=np.uint32)
    valid = (rng.random(10_000) < 0.7) if masked else np.ones(10_000, bool)
    wk, wpv, wbv = golden.hash_join_multi(bk, bv, pk[valid], pv[valid])
    count, jk, jpv, jbv = ops.hash_join_multi(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv),
        max_out=1 << 16,
        probe_valid=jnp.asarray(valid) if masked else None)
    c = int(count)
    assert c == wk.size
    check_arrays(np.asarray(jk)[:c], wk, "m2m join keys")
    check_arrays(np.asarray(jpv)[:c], wpv, "m2m join probe vals")
    check_arrays(np.asarray(jbv)[:c], wbv, "m2m join build vals")


def test_hash_join_multi_truncates_to_prefix(rng):
    bk = np.zeros(64, dtype=np.uint32)   # one key, 64 dups
    bv = np.arange(64, dtype=np.uint32)
    pk = np.zeros(32, dtype=np.uint32)
    pv = np.arange(32, dtype=np.uint32)
    wk, wpv, wbv = golden.hash_join_multi(bk, bv, pk, pv)  # 2048 rows
    count, jk, jpv, jbv = ops.hash_join_multi(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv),
        max_out=256)
    assert int(count) == 2048          # untruncated total for detection
    check_arrays(np.asarray(jk), wk[:256], "truncated keys")
    check_arrays(np.asarray(jpv), wpv[:256], "truncated probe vals")
    check_arrays(np.asarray(jbv), wbv[:256], "truncated build vals")


def test_hash_join_multi_no_matches(rng):
    bk = np.arange(100, dtype=np.uint32)
    pk = np.arange(200, 300, dtype=np.uint32)
    count, *_ = ops.hash_join_multi(jnp.asarray(bk), jnp.asarray(bk),
                                    jnp.asarray(pk), jnp.asarray(pk),
                                    max_out=128)
    assert int(count) == 0
