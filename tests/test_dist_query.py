"""Distributed GROUP BY and join vs the single-process golden models,
on the 8-virtual-device CPU mesh (conftest.py forces CPU backend)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsdradixsort.parallel.mesh import make_mesh
from lsdradixsort.parallel.dist_query import (dist_group_by_sum,
                                              dist_join, undistribute)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _golden_group_by(keys, vals):
    uk = np.unique(keys)
    sums = np.zeros_like(uk, dtype=np.uint32)
    np.add.at(sums, np.searchsorted(uk, keys), vals)
    return uk.astype(np.uint32), sums


def _check_group_by(mesh, keys, vals):
    counts, gk, gs = dist_group_by_sum(jnp.asarray(keys), jnp.asarray(vals),
                                       mesh=mesh)
    total, ck, cs = undistribute(counts, gk, gs)
    uk, us = _golden_group_by(keys, vals)
    assert total == uk.size
    np.testing.assert_array_equal(ck, uk)
    np.testing.assert_array_equal(cs, us)


def test_group_by_random(mesh):
    rng = np.random.default_rng(0)
    n = 1 << 12
    keys = rng.integers(0, 200, n, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check_group_by(mesh, keys, vals)


def test_group_by_all_equal(mesh):
    n = 1 << 10
    keys = np.full(n, 7, np.uint32)          # one group spanning all shards
    vals = np.arange(n, dtype=np.uint32)
    _check_group_by(mesh, keys, vals)


def test_group_by_all_unique(mesh):
    n = 1 << 10
    rng = np.random.default_rng(1)
    keys = rng.permutation(n).astype(np.uint32)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    _check_group_by(mesh, keys, vals)


def test_group_by_boundary_runs(mesh):
    # a few huge groups so runs straddle multiple shard boundaries
    n = 1 << 12
    keys = np.sort(np.random.default_rng(2).integers(0, 3, n)).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    _check_group_by(mesh, keys, vals)


def _golden_join(bk, bv, pk, pv):
    lut = dict(zip(bk.tolist(), bv.tolist()))
    rows = [(k, pv_i, lut[k], i) for i, (k, pv_i) in enumerate(zip(
        pk.tolist(), pv.tolist())) if k in lut]
    return rows


def _check_join(mesh, bk, bv, pk, pv):
    counts, k, pvo, bvo, pos = dist_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv),
        mesh=mesh)
    total, ck, cpv, cbv, cpos = undistribute(counts, k, pvo, bvo, pos)
    rows = _golden_join(bk, bv, pk, pv)
    assert total == len(rows)
    got = sorted(zip(cpos.tolist(), ck.tolist(), cpv.tolist(), cbv.tolist()))
    want = sorted((pos, k, pv_i, bv_i) for (k, pv_i, bv_i, pos) in rows)
    assert got == want


def test_join_random(mesh):
    rng = np.random.default_rng(3)
    nb, npr = 1 << 9, 1 << 11
    bk = rng.permutation(1 << 10)[:nb].astype(np.uint32)   # unique
    bv = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 1 << 10, npr, dtype=np.uint64).astype(np.uint32)
    pv = rng.integers(0, 2**32, npr, dtype=np.uint64).astype(np.uint32)
    _check_join(mesh, bk, bv, pk, pv)


def test_join_all_probe_same_key(mesh):
    # maximum skew: every probe row hits one build key -> spans all shards
    nb, npr = 8, 1 << 11
    bk = np.arange(nb, dtype=np.uint32)
    bv = bk * np.uint32(10)
    pk = np.full(npr, 3, np.uint32)
    pv = np.arange(npr, dtype=np.uint32)
    _check_join(mesh, bk, bv, pk, pv)


def test_join_no_matches(mesh):
    nb, npr = 8, 1 << 9
    bk = np.arange(nb, dtype=np.uint32)
    bv = bk
    pk = np.full(npr, 10_000, np.uint32)
    pv = np.arange(npr, dtype=np.uint32)
    _check_join(mesh, bk, bv, pk, pv)


def test_join_probe_before_and_after_build_shard(mesh):
    # heavy key whose probes surround the build row's landing shard
    rng = np.random.default_rng(4)
    nb, npr = 8, 1 << 11
    bk = np.arange(nb, dtype=np.uint32)
    bv = bk * np.uint32(100)
    pk = np.concatenate([np.full(npr // 2, 0, np.uint32),
                         np.full(npr // 2, 7, np.uint32)])
    pv = rng.integers(0, 100, npr).astype(np.uint32)
    _check_join(mesh, bk, bv, pk, pv)


@pytest.mark.parametrize("d", [2, 4])
def test_group_by_and_join_small_meshes(d):
    m = make_mesh(d)
    rng = np.random.default_rng(d)
    n = 1 << 10
    keys = rng.integers(0, 50, n, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check_group_by(m, keys, vals)
    nb = 64
    bk = rng.permutation(128)[:nb].astype(np.uint32)
    bv = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 128, n, dtype=np.uint64).astype(np.uint32)
    pv = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check_join(m, bk, bv, pk, pv)


def test_dist_filter_kv(mesh):
    from lsdradixsort.parallel.dist_query import dist_filter_kv
    rng = np.random.default_rng(9)
    n = 1 << 12
    keys = rng.integers(0, 1000, n, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    counts, fk, fv = dist_filter_kv(jnp.asarray(keys), jnp.asarray(vals),
                                    100, 600, mesh=mesh)
    total, ck, cv = undistribute(counts, fk, fv)
    mask = (keys >= 100) & (keys < 600)
    assert total == int(mask.sum())
    np.testing.assert_array_equal(ck, keys[mask])
    np.testing.assert_array_equal(cv, vals[mask])


def test_config5_distributed_query_pipeline(mesh):
    """End-to-end distributed plan (north-star config 5 shape):
    filter probe rows -> join against build table -> GROUP BY build value.

    Each stage runs distributed; ragged stage outputs are compacted and
    re-sharded between stages (host glue, as a driver would)."""
    from lsdradixsort.parallel.dist_query import dist_filter_kv
    from lsdradixsort.parallel.mesh import shard_1d
    rng = np.random.default_rng(33)
    d = mesh.shape["x"]
    nb, npr = 1 << 8, 1 << 13
    bk = rng.permutation(1 << 9)[:nb].astype(np.uint32)
    bv = rng.integers(0, 100, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 1 << 9, npr, dtype=np.uint64).astype(np.uint32)
    pv = rng.integers(0, 1000, npr, dtype=np.uint64).astype(np.uint32)

    # stage 1: filter probes by value predicate
    counts, fk, fv = dist_filter_kv(jnp.asarray(pk), jnp.asarray(pv),
                                    0, 500, mesh=mesh)
    total, ck, cv = undistribute(counts, fk, fv)
    pad = -total % d
    ck = np.pad(ck, (0, pad), constant_values=0xFFFFFFFF)  # never matches
    cv = np.pad(cv, (0, pad))

    # stage 2: join filtered probes against the build table
    jc, jk, jpv, jbv, jpos = dist_join(
        jnp.asarray(bk), jnp.asarray(bv),
        shard_1d(jnp.asarray(ck), mesh), shard_1d(jnp.asarray(cv), mesh),
        mesh=mesh)
    jt, mk, mpv, mbv = undistribute(jc, jk, jpv, jbv)
    pad2 = -jt % d
    gk = np.pad(mbv, (0, pad2), constant_values=0xFFFFFFFF)
    gv = np.pad(mpv, (0, pad2))

    # stage 3: GROUP BY build value, SUM(probe value)
    gc, guk, gsums = dist_group_by_sum(
        shard_1d(jnp.asarray(gk), mesh), shard_1d(jnp.asarray(gv), mesh),
        mesh=mesh)
    gt, cuk, csums = undistribute(gc, guk, gsums)

    # golden: the whole plan in numpy
    mask = pk < 500
    k_f, v_f = pk[mask], pv[mask]
    lut = dict(zip(bk.tolist(), bv.tolist()))
    hits = [(lut[k], v) for k, v in zip(k_f.tolist(), v_f.tolist())
            if k in lut]
    want = {}
    for g, v in hits:
        want[g] = (want.get(g, 0) + v) % (1 << 32)
    wk = np.array(sorted(want), dtype=np.uint32)
    ws = np.array([want[k] for k in sorted(want)], dtype=np.uint32)
    got = dict(zip(cuk.tolist(), csums.tolist()))
    got.pop(0xFFFFFFFF, None)  # padding group
    assert got == dict(zip(wk.tolist(), ws.tolist()))


# ---------------------------------------------------------------------------
# many-to-many distributed join (fragment join)
# ---------------------------------------------------------------------------

def _check_join_multi(mesh, bk, bv, pk, pv, max_out=1 << 14):
    from lsdradixsort.parallel.mesh import shard_1d
    from lsdradixsort.parallel.dist_query import dist_join_multi
    from lsdradixsort.golden.oracles import hash_join_multi as gold
    counts, jk, jpos, jpv, jbv, jbr = dist_join_multi(
        shard_1d(jnp.asarray(bk), mesh), shard_1d(jnp.asarray(bv), mesh),
        shard_1d(jnp.asarray(pk), mesh), shard_1d(jnp.asarray(pv), mesh),
        mesh=mesh, max_out=max_out)
    total, ck, cpos, cpv, cbv, cbr = undistribute(counts, jk, jpos, jpv,
                                                  jbv, jbr)
    gk, gpv, gbv = gold(bk, bv, pk, pv)
    assert total == gk.size
    order = np.lexsort((cbr, cpos))
    np.testing.assert_array_equal(ck[order], gk)
    np.testing.assert_array_equal(cpv[order], gpv)
    np.testing.assert_array_equal(cbv[order], gbv)
    return np.asarray(counts)


def test_dist_join_multi_random(mesh):
    rng = np.random.default_rng(0)
    nb, npr = 1 << 10, 1 << 12
    _check_join_multi(
        mesh,
        rng.integers(0, 200, nb, dtype=np.uint32),
        rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 300, npr, dtype=np.uint32),
        rng.integers(0, 1 << 32, npr, dtype=np.uint64).astype(np.uint32))


def test_dist_join_multi_all_equal_keys_balanced(mesh):
    # maximum skew: ONE key on both sides. The fragment join must still
    # produce the full B x P cross-product AND balance it exactly:
    # every shard holds B/D build rows, so every shard emits P * B/D rows.
    from lsdradixsort.parallel.mesh import DATA_AXIS
    d = mesh.shape[DATA_AXIS]
    nb, npr = 1 << 7, 1 << 7
    bk = np.full(nb, 42, dtype=np.uint32)
    bv = np.arange(nb, dtype=np.uint32)
    pk = np.full(npr, 42, dtype=np.uint32)
    pv = np.arange(npr, dtype=np.uint32) + 1000
    counts = _check_join_multi(mesh, bk, bv, pk, pv, max_out=1 << 11)
    assert counts.sum() == nb * npr
    np.testing.assert_array_equal(counts, np.full(d, npr * nb // d))


def test_dist_join_multi_no_matches(mesh):
    nb, npr = 1 << 6, 1 << 7
    bk = np.arange(nb, dtype=np.uint32)
    pk = np.arange(1000, 1000 + npr, dtype=np.uint32)
    counts = _check_join_multi(mesh, bk, bk, pk, pk, max_out=256)
    assert counts.sum() == 0


def test_dist_join_multi_runs_span_shards(mesh):
    # few distinct keys with many duplicates: build runs straddle shard
    # boundaries, so probes must be replicated to multiple shards
    rng = np.random.default_rng(7)
    nb, npr = 1 << 9, 1 << 10
    _check_join_multi(
        mesh,
        rng.integers(0, 5, nb, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 8, npr, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 1 << 32, npr, dtype=np.uint64).astype(np.uint32),
        max_out=1 << 17)


def test_dist_join_multi_unique_matches_dist_join(mesh):
    # unique build keys: many-to-many totals must equal the primary-key join
    rng = np.random.default_rng(3)
    nb, npr = 1 << 9, 1 << 11
    bk = rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 2 * nb, npr, dtype=np.uint64).astype(np.uint32)
    pv = rng.integers(0, 1 << 32, npr, dtype=np.uint64).astype(np.uint32)
    counts = _check_join_multi(mesh, bk, bv, pk, pv)
    from lsdradixsort.parallel.mesh import shard_1d
    c2, *rest = dist_join(
        shard_1d(jnp.asarray(bk), mesh), shard_1d(jnp.asarray(bv), mesh),
        shard_1d(jnp.asarray(pk), mesh), shard_1d(jnp.asarray(pv), mesh),
        mesh=mesh)
    assert counts.sum() == np.asarray(c2).sum()


# --- dist_top_k -------------------------------------------------------------

def _golden_topk_u32(keys, k, largest):
    codes = ~keys if largest else keys
    order = np.argsort(codes, kind="stable")[:k]
    return keys[order], order.astype(np.uint32)


@pytest.mark.parametrize("largest", [True, False])
def test_dist_top_k(mesh, largest):
    from lsdradixsort.parallel.dist_query import dist_top_k
    from lsdradixsort.parallel.mesh import shard_1d
    rng = np.random.default_rng(5)
    n, k = 1 << 13, 37
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sk = shard_1d(jnp.asarray(keys), mesh)
    vals, idx = dist_top_k(sk, k, mesh=mesh, largest=largest)
    wv, wi = _golden_topk_u32(keys, k, largest)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


def test_dist_top_k_ties_across_shards(mesh):
    from lsdradixsort.parallel.dist_query import dist_top_k
    from lsdradixsort.parallel.mesh import shard_1d
    n, k = 1 << 13, 64
    keys = np.full(n, 9, np.uint32)  # every row ties: stability across shards
    sk = shard_1d(jnp.asarray(keys), mesh)
    vals, idx = dist_top_k(sk, k, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(vals), keys[:k])
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.arange(k, dtype=np.uint32))


def test_dist_top_k_skewed_one_shard(mesh):
    # the global top-k lives entirely in one shard
    from lsdradixsort.parallel.dist_query import dist_top_k
    from lsdradixsort.parallel.mesh import shard_1d
    rng = np.random.default_rng(6)
    n, k = 1 << 13, 50
    keys = rng.integers(0, 1 << 16, n, dtype=np.uint64).astype(np.uint32)
    shard = n // 8
    keys[3 * shard: 3 * shard + 200] += np.uint32(1 << 30)
    sk = shard_1d(jnp.asarray(keys), mesh)
    vals, idx = dist_top_k(sk, k, mesh=mesh)
    wv, wi = _golden_topk_u32(keys, k, True)
    np.testing.assert_array_equal(np.asarray(vals), wv)
    np.testing.assert_array_equal(np.asarray(idx), wi)


def test_dist_unique(mesh):
    from lsdradixsort.parallel.dist_query import dist_unique
    rng = np.random.default_rng(12)
    n = 1 << 12
    keys = rng.integers(0, 97, n, dtype=np.uint64).astype(np.uint32)
    counts, uk, cts = dist_unique(jnp.asarray(keys), mesh=mesh)
    total, ck, cc = undistribute(counts, uk, cts)
    wk, wc = np.unique(keys, return_counts=True)
    assert total == wk.size
    np.testing.assert_array_equal(ck, wk)
    np.testing.assert_array_equal(cc, wc.astype(np.uint32))
