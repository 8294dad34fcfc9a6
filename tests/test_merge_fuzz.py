"""Randomized differential fuzz of the sort family: small configurations
(n, key distribution, payload count) against numpy.

The targeted tests (test_merge.py) pin the known-hard cases; this sweep
guards the space between them — ragged tails, pathological
distributions, multi-payload tie handling."""
import numpy as np
import jax.numpy as jnp

from lsdradixsort.ops.sort import sort, sort_kv, sort_with_ranks

NS = (1777, 6 << 10, 20_480, 33_000)   # ragged + aligned


def _dist(rng, n, kind):
    if kind == 0:
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == 1:
        return rng.integers(0, 4, n, dtype=np.uint64).astype(np.uint32)
    if kind == 2:
        return np.sort(rng.integers(0, 1 << 32, n,
                                    dtype=np.uint64)).astype(np.uint32)
    if kind == 3:
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64))[
            ::-1].astype(np.uint32)
    if kind == 4:
        return np.full(n, rng.integers(0, 1 << 32), np.uint32)
    # mostly-one-value with a sprinkle
    x = np.full(n, 7, np.uint32)
    m = rng.random(n) < 0.02
    x[m] = rng.integers(0, 1 << 32, int(m.sum()), dtype=np.uint64).astype(
        np.uint32)
    return x


def test_merge_engine_fuzz():
    rng = np.random.default_rng(2026)
    for n in NS:
        for kind in range(6):
            keys = _dist(rng, n, kind)
            cfg = f"n={n} kind={kind}"
            jk = jnp.asarray(keys)
            perm = np.argsort(keys, kind="stable")
            if kind % 3 == 0:
                got = np.asarray(sort(jk))
                np.testing.assert_array_equal(got, np.sort(keys),
                                              err_msg=cfg)
            elif kind % 3 == 1:
                sk, ranks = sort_with_ranks(jk)
                np.testing.assert_array_equal(np.asarray(sk), keys[perm],
                                              err_msg=cfg)
                np.testing.assert_array_equal(np.asarray(ranks),
                                              perm.astype(np.uint32),
                                              err_msg=cfg)
            else:
                vals = [np.arange(n, dtype=np.uint32),
                        rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                            np.uint32)]
                sk, outs = sort_kv(jk, tuple(jnp.asarray(v) for v in vals))
                np.testing.assert_array_equal(np.asarray(sk), keys[perm],
                                              err_msg=cfg)
                for v, o in zip(vals, outs):
                    np.testing.assert_array_equal(np.asarray(o), v[perm],
                                                  err_msg=cfg)
