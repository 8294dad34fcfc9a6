"""core/ utilities: digit math vs the reference GET_R_BITS semantics."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.core import digits, datagen, roofline


@pytest.mark.parametrize("r", [1, 2, 4, 8, 16])
def test_get_digit_matches_numpy(rng, r):
    keys = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    for g in range(digits.num_digit_groups(r)):
        got = np.asarray(digits.get_digit(jnp.asarray(keys), r, g))
        want = digits.get_digit_np(keys, r, g)
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_num_digit_groups():
    assert digits.num_digit_groups(8) == 4
    assert digits.num_digit_groups(1) == 32
    assert digits.num_digit_groups(5) == 7  # ceil(32/5)
    with pytest.raises(ValueError):
        digits.num_digit_groups(0)


def test_datagen_deterministic():
    a = np.asarray(datagen.random_keys(1000, seed=3))
    b = np.asarray(datagen.random_keys(1000, seed=3))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint32


def test_datagen_bounded():
    a = np.asarray(datagen.random_keys_bounded(1000, 10, 20, seed=1))
    assert a.min() >= 10 and a.max() < 20


def test_skewed_keys():
    a = np.asarray(datagen.skewed_keys(10_000, hot_fraction=0.9))
    assert np.mean(a == np.uint32(0xDEADBEEF)) > 0.85


def test_roofline_model():
    rl = roofline.lookup("NVIDIA H200")
    assert rl.light_speed_s(4800e9) == pytest.approx(1.0)
    assert rl.fraction(4800e9, 2.0) == pytest.approx(0.5)
    # one 8-bit pass on keys-only: read for hist + read + write = 12 B/elem
    assert roofline.sort_pass_bytes(100, 4, 0) == 1200
    assert roofline.sort_bytes(100, 8, 4, 0) == 4 * 1200


def test_roofline_h200_entry_resolves():
    rl = roofline.lookup("NVIDIA H200")
    assert rl.hbm_gbps == 4800.0
    assert "data sheet" in rl.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", ""])
def test_roofline_unknown_kind_raises(kind):
    with pytest.raises(KeyError):
        roofline.lookup(kind)


def test_roofline_detect_on_cpu_raises():
    # the CPU has no published peak: a share against it is not measured
    with pytest.raises(KeyError):
        roofline.detect()


def test_cache_defers_to_env(monkeypatch, tmp_path):
    import jax
    from lsdradixsort.core import cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.enable_persistent_cache() == str(tmp_path / "c")
    # JAX reads the variable itself: no other directory is set
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_cache_fixed_dir_in_checkout(monkeypatch):
    import os
    import jax
    from lsdradixsort.core import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = cache.enable_persistent_cache()
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
