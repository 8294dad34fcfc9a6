"""Distributed path on an 8-virtual-device CPU mesh (SURVEY.md §4): the
same shard_map/collective code that runs over the cards, with the padded
exchange in place of the ragged all-to-all XLA:CPU lacks."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lsdradixsort import golden
from lsdradixsort.parallel import (make_mesh, shard_1d, dist_sort,
                                   dist_sort_kv, dist_digit_histogram)
from lsdradixsort.utils import check_arrays


def _keys(rng, n, hi=1 << 32):
    return rng.integers(0, hi, size=n, dtype=np.uint32)


SKEWS = {
    "uniform": lambda rng, n: _keys(rng, n),
    "all_equal": lambda rng, n: np.full(n, 7, dtype=np.uint32),  # max skew
    "sorted": lambda rng, n: np.sort(_keys(rng, n)),
    "one_hot_key": lambda rng, n: np.where(rng.random(n) < 0.9,
                                           np.uint32(42), _keys(rng, n)),
    "few_uniques": lambda rng, n: _keys(rng, n, hi=3),
}


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.mark.parametrize("kind", SKEWS)
def test_dist_sort(rng, mesh, kind):
    n = 1 << 13
    keys = SKEWS[kind](rng, n)
    x = shard_1d(jnp.asarray(keys), mesh)
    out = dist_sort(x, mesh)
    check_arrays(np.asarray(out), np.sort(keys), f"dist_sort {kind}")


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "one_hot_key",
                                  "few_uniques"])
def test_dist_sort_kv_stable(rng, mesh, kind):
    n = 1 << 12
    keys = SKEWS[kind](rng, n)
    vals = np.arange(n, dtype=np.uint32)
    k = shard_1d(jnp.asarray(keys), mesh)
    v = shard_1d(jnp.asarray(vals), mesh)
    ok, ov = dist_sort_kv(k, v, mesh)
    wk, wv = golden.lsd_radix_sort_kv(keys, vals)
    check_arrays(np.asarray(ok), wk, f"dist kv keys {kind}")
    check_arrays(np.asarray(ov), wv, f"dist kv vals {kind} (global stability)")


def test_dist_sort_balanced_shards(rng, mesh):
    # every shard must hold exactly n/D rows even under maximum skew
    n = 1 << 12
    keys = np.full(n, 3, dtype=np.uint32)
    out = dist_sort(shard_1d(jnp.asarray(keys), mesh), mesh)
    assert out.shape == (n,)
    check_arrays(np.asarray(out), keys, "all-equal balanced")


@pytest.mark.parametrize("r,group", [(4, 0), (8, 1)])
def test_dist_histogram(rng, mesh, r, group):
    n = 1 << 13
    keys = _keys(rng, n)
    got = dist_digit_histogram(shard_1d(jnp.asarray(keys), mesh), r, group,
                               mesh)
    want = golden.digit_histograms(keys, r, group, n).sum(axis=0)
    check_arrays(np.asarray(got), want.astype(np.uint32), "dist hist")


def test_dist_sort_f32_descending(mesh):
    from lsdradixsort.parallel import dist_sort, shard_1d
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    n = 1 << 12
    keys = (rng.standard_normal(n) * 1e3).astype(np.float32)
    out = dist_sort(shard_1d(jnp.asarray(keys), mesh), mesh,
                    descending=True)
    got = np.asarray(out)
    want = np.sort(keys)[::-1]
    np.testing.assert_array_equal(got == want, np.full(n, True))


def test_dist_sort_kv_i32(mesh):
    from lsdradixsort.parallel import dist_sort_kv, shard_1d
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n = 1 << 12
    keys = rng.integers(-40, 40, n, dtype=np.int64).astype(np.int32)
    vals = np.arange(n, dtype=np.uint32)
    ok, ov = dist_sort_kv(shard_1d(jnp.asarray(keys), mesh),
                          shard_1d(jnp.asarray(vals), mesh), mesh)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), keys[perm])
    np.testing.assert_array_equal(np.asarray(ov), perm.astype(np.uint32))


@pytest.mark.parametrize("kind", ["uniform", "all_equal"])
def test_dist_sort_merge_engine(rng, mesh, kind):
    n = 1 << 13
    keys = SKEWS[kind](rng, n)
    x = shard_1d(jnp.asarray(keys), mesh)
    out = dist_sort(x, mesh)
    check_arrays(np.asarray(out), np.sort(keys), f"dist_sort {kind}")


def test_dist_sort_kv_merge_engine_stable(rng, mesh):
    n = 1 << 13
    keys = SKEWS["few_uniques"](rng, n)  # heavy ties: stability stress
    vals = np.arange(n, dtype=np.uint32)
    k = shard_1d(jnp.asarray(keys), mesh)
    v = shard_1d(jnp.asarray(vals), mesh)
    ok, ov = dist_sort_kv(k, v, mesh)
    order = np.argsort(keys, kind="stable")
    check_arrays(np.asarray(ok), keys[order], "kv keys")
    check_arrays(np.asarray(ov), vals[order], "kv vals (stable)")


def test_dist_sort_kv_merge_engine_f32_payload(rng, mesh):
    """A float payload moves bit-exactly through the exchange."""
    n = 1 << 13
    keys = SKEWS["few_uniques"](rng, n)
    vals = rng.standard_normal(n).astype(np.float32)
    k = shard_1d(jnp.asarray(keys), mesh)
    v = shard_1d(jnp.asarray(vals), mesh)
    ok, ov = dist_sort_kv(k, v, mesh)
    order = np.argsort(keys, kind="stable")
    check_arrays(np.asarray(ok), keys[order], "kv f32 keys")
    assert np.asarray(ov).dtype == np.float32
    np.testing.assert_array_equal(
        np.asarray(ov).view(np.uint32), vals[order].view(np.uint32),
        "kv f32 payload bits")


def test_dist_sort_d1_degenerate_mesh(rng):
    """A D=1 mesh needs no collective and takes the local sort; output
    must be bit-identical to the D>1 semantics."""
    m1 = make_mesh(1)
    n = 1 << 12
    keys = SKEWS["few_uniques"](rng, n)
    vals = np.arange(n, dtype=np.uint32)
    out = dist_sort(jnp.asarray(keys), m1)
    check_arrays(np.asarray(out), np.sort(keys), "dist_sort d1")
    ok, ov = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals), m1)
    order = np.argsort(keys, kind="stable")
    check_arrays(np.asarray(ok), keys[order], "dist_sort_kv d1 keys")
    check_arrays(np.asarray(ov), vals[order], "dist_sort_kv d1 vals")
