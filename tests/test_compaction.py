"""Order-preserving compaction (ops/filter.compact) and the filter ops."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.ops.filter import compact, filter_keys, filter_kv


@pytest.mark.parametrize("nt", [1, 3])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0, 0.01])
def test_compact_stream(rng, nt, p):
    n = nt * (1 << 15)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    mask = rng.random(n) < p
    cnt, out = compact(jnp.asarray(mask), jnp.asarray(x))
    assert int(cnt) == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[:int(cnt)], x[mask])


def test_compact_stream_carry_chains(rng):
    # 1/7 selectivity: selected rows never line up with any block size
    n = 4 << 15
    x = np.arange(n, dtype=np.uint32)
    mask = np.zeros(n, bool)
    mask[::7] = True
    cnt, out = compact(jnp.asarray(mask), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(out)[:int(cnt)], x[mask])


def test_compact_stream_multi_three(rng):
    n = 2 << 15
    xs = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    mask = rng.random(n) < 0.3
    cnt, *outs = compact(jnp.asarray(mask), *[jnp.asarray(x) for x in xs])
    c = int(cnt)
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(np.asarray(out)[:c], x[mask])


def test_filter_ops_large(rng):
    n = (1 << 16) + 12345
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo, hi = np.uint32(1 << 30), np.uint32(3 << 30)
    count, packed = filter_keys(jnp.asarray(keys), lo, hi)
    want = keys[(keys >= lo) & (keys < hi)]
    assert int(count) == want.size
    np.testing.assert_array_equal(np.asarray(packed)[: want.size], want)

    vals = np.arange(n, dtype=np.uint32)
    count2, pk, pv = filter_kv(jnp.asarray(keys), jnp.asarray(vals), lo, hi)
    sel = (keys >= lo) & (keys < hi)
    np.testing.assert_array_equal(np.asarray(pk)[: want.size], keys[sel])
    np.testing.assert_array_equal(np.asarray(pv)[: want.size], vals[sel])


def test_filter_small_path(rng):
    n = 1000
    keys = rng.integers(0, 100, n, dtype=np.uint32)
    count, packed = filter_keys(jnp.asarray(keys), 10, 50)
    want = keys[(keys >= 10) & (keys < 50)]
    assert int(count) == want.size
    np.testing.assert_array_equal(np.asarray(packed)[: want.size], want)
