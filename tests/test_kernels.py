"""The reference's primitives in plain JAX (ops/primitives.py) vs the
golden models.

Mirrors the reference's per-primitive Test* functions (TestBuildHistogram
cu:704-793, TestBlockPrefixSumKernel cu:209-263, TestGPUPrefixSum
cu:304-371, TestTranspose cu:546-637) as parametrized pytest cases.
"""
import jax
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort import golden
from lsdradixsort.ops.primitives import (block_digit_histograms,
                                         block_prefix_sums, digit_histogram,
                                         exclusive_scan, fill_forward_last)
from lsdradixsort.utils import check_arrays


def _keys(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("r,group", [(1, 0), (2, 5), (4, 3), (8, 0), (8, 3)])
@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("nblocks", [4, 7])
def test_block_histograms_vs_golden(rng, r, group, block, nblocks):
    keys = _keys(rng, nblocks * block)
    got = block_digit_histograms(jnp.asarray(keys), r, group, block)
    want = golden.digit_histograms(keys, r, group, block)
    check_arrays(got, want, f"hist r={r} g={group} b={block} x{nblocks}")


def test_block_histogram_nibble_overflow_guard(rng):
    # all-equal digits: every count lands in one bin of one block
    keys = np.zeros(512 * 128, dtype=np.uint32)
    got = block_digit_histograms(jnp.asarray(keys), 8, 0, 512 * 128)
    assert int(got[0, 0]) == 512 * 128


def test_block_histogram_byte_overflow_guard(rng):
    # a count far past 8 bits in one bin, at 4-bit digits
    keys = np.zeros(512 * 128, dtype=np.uint32)
    got = block_digit_histograms(jnp.asarray(keys), 4, 0, 512 * 128)
    assert int(got[0, 0]) == 512 * 128


@pytest.mark.parametrize("n", [1 << 15, 100_001])
def test_whole_array_histogram(rng, n):
    keys = _keys(rng, n)
    got = digit_histogram(jnp.asarray(keys), 8, 2)
    want = golden.digit_histograms(keys, 8, 2, keys.size).sum(axis=0)
    check_arrays(got, want.astype(np.uint32), "digit_histogram")


@pytest.mark.parametrize("n", [128, 1 << 12, 1 << 16, 100_000, 131_072 + 640])
def test_exclusive_scan_vs_golden(rng, n):
    a = _keys(rng, n)  # full-range values exercise uint32 wraparound
    got = exclusive_scan(jnp.asarray(a))
    check_arrays(got, golden.prefix_sum(a), f"scan n={n}")


def test_exclusive_scan_int32(rng):
    a = rng.integers(0, 100, size=5000, dtype=np.int32)
    got = exclusive_scan(jnp.asarray(a))
    want = np.zeros_like(a)
    np.cumsum(a[:-1], out=want[1:])
    check_arrays(got, want, "scan i32")


@pytest.mark.parametrize("block", [128, 512])
def test_block_prefix_sums(rng, block):
    a = _keys(rng, 4 * block)
    scans, sums = block_prefix_sums(jnp.asarray(a), block)
    for i in range(4):
        blk = a[i * block:(i + 1) * block]
        check_arrays(scans[i * block:(i + 1) * block],
                     golden.prefix_sum(blk), f"block {i}")
        assert np.uint32(sums[i]) == np.sum(blk, dtype=np.uint32)


def test_transpose_vs_golden(rng):
    # the reference's tiled transpose kernel is XLA's own transpose here
    a = rng.integers(0, 1 << 32, size=(128, 256), dtype=np.uint32)
    transpose = jax.jit(lambda x: x.T)
    check_arrays(transpose(jnp.asarray(a)), golden.transpose(a), "u32 T")
    check_arrays(transpose(jnp.asarray(a.astype(np.int32))),
                 golden.transpose(a.astype(np.int32)), "i32 T")


@pytest.mark.parametrize("n", [128 * 128, 128 * 1000 + 17])
def test_exclusive_scan_hierarchical(n):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got = exclusive_scan(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), golden.prefix_sum(x))


@pytest.mark.parametrize("n", [128 * 16, 128 * 40 + 55])
def test_fill_forward_last(n):
    rng = np.random.default_rng(7)
    flag = rng.random(n) < 0.05
    key = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    val = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ok, ov, ovalid = fill_forward_last(jnp.asarray(flag), jnp.asarray(key),
                                       jnp.asarray(val))
    wk = np.zeros(n, np.uint32)
    wv = np.zeros(n, np.uint32)
    wvalid = np.zeros(n, np.uint32)
    ck = cv = np.uint32(0)
    cval = 0
    for i in range(n):
        if flag[i]:
            ck, cv, cval = key[i], val[i], 1
        wk[i], wv[i], wvalid[i] = ck, cv, cval
    np.testing.assert_array_equal(np.asarray(ovalid), wvalid)
    np.testing.assert_array_equal(np.asarray(ok), wk * wvalid)
    np.testing.assert_array_equal(np.asarray(ov), wv * wvalid)
