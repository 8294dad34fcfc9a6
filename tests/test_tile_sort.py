"""Block-local stable kv sort (ops/sort.sort_blocks_kv), the reference's
block-local sort (TestLSDBinaryRadixSort, cu:423-477), vs numpy."""
import collections

import jax.numpy as jnp
import numpy as np
import pytest

from lsdradixsort.ops.sort import sort_blocks_kv


def _check_blocks(keys, vals, ok, ov, block):
    for t in range(keys.size // block):
        seg = keys[t * block:(t + 1) * block]
        perm = np.argsort(seg, kind="stable")
        np.testing.assert_array_equal(
            np.asarray(ok)[t * block:(t + 1) * block], seg[perm])
        np.testing.assert_array_equal(
            np.asarray(ov)[t * block:(t + 1) * block],
            vals[t * block:(t + 1) * block][perm])


@pytest.mark.parametrize("tile_rows,ntiles", [(8, 4), (32, 2), (128, 1)])
def test_sort_tiles_kv_stable(tile_rows, ntiles):
    n = tile_rows * 128 * ntiles
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 100, n, dtype=np.uint32)  # heavy duplicates
    vals = np.arange(n, dtype=np.uint32)
    ok, ov = sort_blocks_kv(jnp.asarray(keys), jnp.asarray(vals),
                            block_size=tile_rows * 128)
    _check_blocks(keys, vals, ok, ov, tile_rows * 128)


@pytest.mark.parametrize("tile_rows,ntiles", [(32, 2), (128, 1)])
def test_sort_tiles_kv_stable_reshape_ce(tile_rows, ntiles):
    # random payload bits and a block size that is not a power of two
    n = tile_rows * 120 * ntiles
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 100, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ok, ov = sort_blocks_kv(jnp.asarray(keys), jnp.asarray(vals),
                            block_size=tile_rows * 120)
    _check_blocks(keys, vals, ok, ov, tile_rows * 120)


def test_sort_tiles_multi_tied_compare_pair():
    # heavy key ties with a distinct payload: nothing duplicated or lost
    n = 32 * 128
    rng = np.random.default_rng(5)
    k = rng.integers(0, 4, n, dtype=np.uint32)
    v = np.arange(n, dtype=np.uint32)
    sk, sv = map(np.asarray, sort_blocks_kv(jnp.asarray(k), jnp.asarray(v),
                                            block_size=n))
    assert (sk[1:] >= sk[:-1]).all()
    got = collections.Counter(zip(sk.tolist(), sv.tolist()))
    want = collections.Counter(zip(k.tolist(), v.tolist()))
    assert got == want


def test_sort_tiles_keys_full_range():
    n = 16 * 128
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    ok, ov = sort_blocks_kv(jnp.asarray(keys), jnp.asarray(vals),
                            block_size=n)
    np.testing.assert_array_equal(np.asarray(ok), np.sort(keys))


def test_sort_tiles_adversarial():
    n = 8 * 128
    vals = np.arange(n, dtype=np.uint32)
    for arr in (np.zeros(n, np.uint32),                    # all equal
                np.arange(n, dtype=np.uint32),             # pre-sorted
                np.arange(n, dtype=np.uint32)[::-1].copy(),  # reversed
                np.full(n, 0xFFFFFFFF, np.uint32)):        # max values
        ok, ov = sort_blocks_kv(jnp.asarray(arr), jnp.asarray(vals),
                                block_size=n)
        _check_blocks(arr, vals, ok, ov, n)


def test_sort_blocks_kv_rejects_ragged():
    with pytest.raises(ValueError):
        sort_blocks_kv(jnp.zeros(1000, jnp.uint32),
                       jnp.zeros(1000, jnp.uint32), block_size=256)
