"""Golden-model self-consistency: the numpy oracles vs numpy's own sort
(the reference validates its CPU LSD sort against std::sort, cu:120)."""
import numpy as np
import pytest

from lsdradixsort import golden


def _keys(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 128, 1000, 1 << 14])
def test_lsd_radix_sort_vs_npsort(rng, r, n):
    keys = _keys(rng, n)
    np.testing.assert_array_equal(golden.lsd_radix_sort(keys, r),
                                  np.sort(keys))


def test_lsd_pass_is_stable(rng):
    # after a low-digit pass, equal digits keep relative order
    keys = rng.integers(0, 16, size=4096, dtype=np.uint32) << 4 | \
           (np.arange(4096, dtype=np.uint32) % 16)
    out = golden.lsd_radix_sort_pass(keys, r=4, group=1)
    digits = (out >> 4) & 0xF
    assert np.all(np.diff(digits) >= 0)
    for d in range(16):
        sub = out[digits == d]
        orig = keys[((keys >> 4) & 0xF) == d]
        np.testing.assert_array_equal(sub, orig)


def test_sort_kv_stability(rng):
    keys = rng.integers(0, 4, size=1000, dtype=np.uint32)
    vals = np.arange(1000, dtype=np.uint32)
    sk, sv = golden.lsd_radix_sort_kv(keys, vals)
    np.testing.assert_array_equal(sk, np.sort(keys))
    for k in range(4):
        np.testing.assert_array_equal(sv[sk == k], vals[keys == k])


def test_prefix_sum(rng):
    a = rng.integers(0, 1 << 31, size=1 << 12, dtype=np.uint32)
    out = golden.prefix_sum(a)
    assert out[0] == 0
    # uint32 wraparound semantics
    np.testing.assert_array_equal(out[1:], np.cumsum(a[:-1], dtype=np.uint32))


@pytest.mark.parametrize("r,block", [(4, 256), (8, 512), (1, 128)])
def test_digit_histograms(rng, r, block):
    keys = _keys(rng, 4 * block)
    h = golden.digit_histograms(keys, r, group=0, block_size=block)
    assert h.shape == (4, 1 << r)
    assert h.sum() == keys.size
    for i in range(4):
        blk = keys[i * block:(i + 1) * block] & ((1 << r) - 1)
        np.testing.assert_array_equal(h[i], np.bincount(blk, minlength=1 << r))


def test_transpose(rng):
    a = rng.integers(0, 100, size=(13, 7), dtype=np.uint32)
    np.testing.assert_array_equal(golden.transpose(a), a.T)


def test_filter(rng):
    keys = _keys(rng, 1000)
    out = golden.filter_keys(keys, 1 << 30, 1 << 31)
    assert np.all((out >= 1 << 30) & (out < 1 << 31))
    assert out.size == np.sum((keys >= 1 << 30) & (keys < 1 << 31))


def test_group_by_sum(rng):
    gk = rng.integers(0, 10, size=1000, dtype=np.uint32)
    v = rng.integers(0, 1 << 31, size=1000, dtype=np.uint32)
    uk, sums = golden.group_by_sum(gk, v)
    np.testing.assert_array_equal(uk, np.unique(gk))
    for i, k in enumerate(uk):
        assert sums[i] == np.sum(v[gk == k], dtype=np.uint32)


def test_hash_join(rng):
    bk = rng.permutation(np.arange(100, dtype=np.uint32))
    bv = bk * 7
    pk = rng.integers(0, 200, size=500, dtype=np.uint32)
    pv = np.arange(500, dtype=np.uint32)
    mk, mpv, mbv = golden.hash_join(bk, bv, pk, pv)
    mask = pk < 100
    np.testing.assert_array_equal(mk, pk[mask])
    np.testing.assert_array_equal(mpv, pv[mask])
    np.testing.assert_array_equal(mbv, pk[mask] * 7)


def test_hash_join_multi_golden(rng):
    # duplicate build keys: every probe matches ALL build rows of its key,
    # in stable build order, probe-major
    bk = np.array([5, 3, 5, 7, 3], dtype=np.uint32)
    bv = np.array([50, 30, 51, 70, 31], dtype=np.uint32)
    pk = np.array([3, 9, 5, 3], dtype=np.uint32)
    pv = np.array([100, 101, 102, 103], dtype=np.uint32)
    mk, mpv, mbv = golden.hash_join_multi(bk, bv, pk, pv)
    np.testing.assert_array_equal(mk, [3, 3, 5, 5, 3, 3])
    np.testing.assert_array_equal(mpv, [100, 100, 102, 102, 103, 103])
    np.testing.assert_array_equal(mbv, [30, 31, 50, 51, 30, 31])


def test_hash_join_multi_reduces_to_unique(rng):
    # with unique build keys the many-to-many oracle equals hash_join
    bk = rng.permutation(np.arange(100, dtype=np.uint32))
    bv = bk * 7
    pk = rng.integers(0, 200, size=500, dtype=np.uint32)
    pv = np.arange(500, dtype=np.uint32)
    for a, b in zip(golden.hash_join_multi(bk, bv, pk, pv),
                    golden.hash_join(bk, bv, pk, pv)):
        np.testing.assert_array_equal(a, b)
