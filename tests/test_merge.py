"""The full sort through the public ops (ops/sort.py), golden-checked
against numpy: ragged and power-of-two sizes, heavy duplicates, all-equal,
presorted and reversed inputs, extreme values, and stable ranks."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.ops.sort import sort, sort_kv, sort_lex, sort_with_ranks


def _msort(keys):
    return sort(jnp.asarray(keys, jnp.uint32))


@pytest.mark.parametrize("n", [1 << 13, (1 << 14) - 777])
def test_merge_sort_multi_op(rng, n):
    # two payloads ride one stable sort: the first is the row id, the
    # second arbitrary bits
    k = rng.integers(0, 50, n, dtype=np.uint32)
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    sk, (s0, s1) = sort_kv(jnp.asarray(k), (jnp.asarray(v0),
                                            jnp.asarray(v1)))
    want = np.lexsort((v0, k))
    np.testing.assert_array_equal(np.asarray(sk), k[want])
    np.testing.assert_array_equal(np.asarray(s0), v0[want])
    np.testing.assert_array_equal(np.asarray(s1), v1[want])


def test_merge_sort_multi_sentinel_collision(rng):
    # rows equal to (0xFFFFFFFF, 0xFFFFFFFF) in (key, secondary): ordering
    # by both columns must keep every riding value, ties by position
    n = (1 << 13) - 100
    k = rng.integers(0, 50, n, dtype=np.uint32)
    v0 = np.arange(n, dtype=np.uint32)
    v1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    hot = rng.choice(n, 5, replace=False)
    k[hot] = 0xFFFFFFFF
    v0[hot] = 0xFFFFFFFF
    (sk, s0), perm = sort_lex([jnp.asarray(k), jnp.asarray(v0)])
    s1 = v1[np.asarray(perm)]
    want = np.lexsort((v0, k))
    np.testing.assert_array_equal(np.asarray(sk), k[want])
    np.testing.assert_array_equal(np.asarray(s0), v0[want])
    np.testing.assert_array_equal(s1[:-5], v1[want][:-5])
    np.testing.assert_array_equal(s1[-5:], v1[np.sort(hot)])


@pytest.mark.parametrize("n", [1 << 13, 1 << 16, (1 << 16) - 777, 1000, 1,
                               11 * (1 << 10) + 5])
def test_merge_sort_keys_random(rng, n):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(_msort(x)), np.sort(x))


def test_merge_sort_duplicates_heavy(rng):
    x = rng.integers(0, 7, 1 << 16, dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(_msort(x)), np.sort(x))


def test_merge_sort_all_equal():
    x = np.full(1 << 16, 0xDEADBEEF, np.uint32)
    np.testing.assert_array_equal(np.asarray(_msort(x)), x)


def test_merge_sort_presorted_and_reverse(rng):
    x = np.arange(1 << 16, dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(_msort(x)), x)
    np.testing.assert_array_equal(np.asarray(_msort(x[::-1].copy())), x)


def test_merge_sort_extreme_values(rng):
    x = rng.choice(np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32),
                   1 << 13).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(_msort(x)), np.sort(x))


def test_sort_op_merge_strategy(rng):
    # the public op's default path
    x = rng.integers(0, 2**32, 1 << 15, dtype=np.uint32)
    got = sort(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


def test_merge_pass_kv_and_ranks(rng):
    for n in (1 << 13, (1 << 16) - 333):
        x = rng.integers(0, 50, n, dtype=np.uint32)  # heavy duplicates
        sk, perm = sort_with_ranks(jnp.asarray(x))
        want = np.argsort(x, kind="stable")
        np.testing.assert_array_equal(np.asarray(perm), want.astype(np.uint32))
        np.testing.assert_array_equal(np.asarray(sk), x[want])


def test_merge_ranks_stability_all_equal():
    n = 1 << 13
    x = np.full(n, 42, np.uint32)
    sk, perm = sort_with_ranks(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(perm),
                                  np.arange(n, dtype=np.uint32))
