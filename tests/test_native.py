"""Tests for the native C++ host runtime (and its numpy fallback).

Mirrors the reference's golden-model discipline (SURVEY.md §4): every native
routine is differentially tested against an independent numpy computation on
seeded inputs.
"""
import numpy as np
import pytest

from lsdradixsort import native


@pytest.fixture(scope="module")
def keys():
    return native.fill_random_u32(1 << 16, seed=7)


def test_fill_random_deterministic():
    a = native.fill_random_u32(4096, seed=3)
    b = native.fill_random_u32(4096, seed=3)
    c = native.fill_random_u32(4096, seed=4)
    assert (a == b).all()
    assert (a != c).any()


def test_fill_random_bounds():
    a = native.fill_random_u32(4096, seed=0, lo=10, hi=20)
    assert a.min() >= 10 and a.max() <= 20


def test_check_arrays(keys):
    assert native.check_arrays(keys, keys) == -1
    other = keys.copy()
    other[123] ^= 1
    assert native.check_arrays(keys, other) == 123


def test_check_sorted(keys):
    assert native.check_sorted(np.sort(keys)) == -1
    bad = np.sort(keys)
    bad[100] = 0xFFFFFFFF
    assert native.check_sorted(bad) == 101


def test_exclusive_prefix_sum(keys):
    got = native.exclusive_prefix_sum(keys)
    want = np.concatenate(
        [[np.uint32(0)], np.cumsum(keys, dtype=np.uint32)[:-1]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,group", [(8, 0), (8, 3), (4, 5), (2, 0)])
def test_block_histograms(keys, r, group):
    block = 1 << 12
    got = native.block_histograms(keys, block, r, group)
    digits = (keys >> (r * group)) & ((1 << r) - 1)
    want = np.stack([
        np.bincount(digits[i * block:(i + 1) * block], minlength=1 << r)
        for i in range(keys.size // block)]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_transpose(keys):
    m = keys[:96 * 160].reshape(96, 160)
    np.testing.assert_array_equal(native.transpose(m), m.T)


def test_radix_sort(keys):
    np.testing.assert_array_equal(native.radix_sort(keys), np.sort(keys))


def test_radix_sort_kv_stable():
    k = native.fill_random_u32(1 << 14, seed=9, lo=0, hi=63)  # many dups
    v = np.arange(k.size, dtype=np.uint32)
    sk, sv = native.radix_sort_kv(k, v)
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(sk, k[perm])
    np.testing.assert_array_equal(sv, perm.astype(np.uint32))


@pytest.mark.parametrize("r,group", [(8, 0), (8, 2), (4, 7)])
def test_radix_sort_pass(keys, r, group):
    got = native.radix_sort_pass(keys, r, group)
    digits = (keys >> (r * group)) & ((1 << r) - 1)
    want = keys[np.argsort(digits, kind="stable")]
    np.testing.assert_array_equal(got, want)


def test_native_library_loads():
    """The compiled library must be present in CI (built by make)."""
    assert native.available(), "liblsdnative.so missing and build failed"
