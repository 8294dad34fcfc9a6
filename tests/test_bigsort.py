"""Sorts of concatenated segments at the 2^30 plan's shape (many sorted
or duplicate-heavy segments), now one flat sort_with_ranks / sort_kv."""
import numpy as np
import jax.numpy as jnp

from lsdradixsort.ops.sort import sort_kv, sort_with_ranks

L = 1 << 12


def test_sort_with_ranks_chunked(rng):
    segs = [rng.integers(0, 1000, L, dtype=np.uint32) for _ in range(8)]
    host = np.concatenate(segs)
    got_k, got_r = sort_with_ranks(jnp.asarray(host))
    perm = np.argsort(host, kind="stable")
    np.testing.assert_array_equal(np.asarray(got_k), host[perm])
    np.testing.assert_array_equal(np.asarray(got_r), perm.astype(np.uint32))


def test_sort_kv_chunked_payload(rng):
    segs = [rng.integers(0, 500, L, dtype=np.uint32) for _ in range(4)]
    vals = [rng.integers(0, 2**32, L, dtype=np.uint32) for _ in range(4)]
    hostk = np.concatenate(segs)
    hostv = np.concatenate(vals)
    got_k, got_v = sort_kv(jnp.asarray(hostk), jnp.asarray(hostv))
    perm = np.argsort(hostk, kind="stable")
    np.testing.assert_array_equal(np.asarray(got_k), hostk[perm])
    np.testing.assert_array_equal(np.asarray(got_v), hostv[perm])
