"""The join family on inputs built to defeat hashing (every key in one
hash bucket of a multiplicative hash) and on small build sides: the
sort-merge join, probe_lookup and the IN-list filters stay exact."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.ops.filter import filter_in_set
from lsdradixsort.ops.join import hash_join

MIX = 0x9E3779B1      # Fibonacci hashing multiplier
ROWS = 32             # keys per colliding set


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _unique_keys(rng, n):
    return rng.permutation((1 << 22))[:n].astype(np.uint32)


def _colliding_keys(rows_plus: int):
    """Keys that share the top 7 bits of key * MIX: one bucket of a
    128-bucket multiplicative hash."""
    ks, k = [], np.uint32(1)
    target = ((np.uint32(12345) * np.uint32(MIX)) >> np.uint32(25))
    while len(ks) < rows_plus:
        if ((k * np.uint32(MIX)) >> np.uint32(25)) == target:
            ks.append(k)
        k += np.uint32(1)
    return np.array(ks, dtype=np.uint32)


def _join_golden(bk, bv, pk, pv):
    lut = dict(zip(bk.tolist(), bv.tolist()))
    rows = [(k, v, lut[k]) for k, v in zip(pk.tolist(), pv.tolist())
            if k in lut]
    return rows


@pytest.mark.parametrize("nb", [128, 2000])
def test_hash_join_vmem_engine(rng, nb):
    bk = _unique_keys(rng, nb)
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    npr = 1 << 15
    pk = rng.choice(np.concatenate([bk, _unique_keys(rng, nb)]),
                    npr).astype(np.uint32)
    pv = np.arange(npr, dtype=np.uint32)
    count, k, v, b = hash_join(jnp.asarray(bk), jnp.asarray(bv),
                               jnp.asarray(pk), jnp.asarray(pv))
    want = _join_golden(bk, bv, pk, pv)
    c = int(count)
    assert c == len(want)
    got = list(zip(np.asarray(k)[:c].tolist(), np.asarray(v)[:c].tolist(),
                   np.asarray(b)[:c].tolist()))
    assert got == want  # probe order preserved


def test_hash_join_vmem_overflow_fallback(rng):
    # every build key in one hash bucket
    bk = _colliding_keys(ROWS + 3)
    nb = bk.size
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    npr = 4096
    pk = rng.choice(np.concatenate([bk, bk + np.uint32(1)]),
                    npr).astype(np.uint32)
    pv = np.arange(npr, dtype=np.uint32)
    count, k, v, b = hash_join(jnp.asarray(bk), jnp.asarray(bv),
                               jnp.asarray(pk), jnp.asarray(pv))
    want = _join_golden(bk, bv, pk, pv)
    c = int(count)
    assert c == len(want)
    got = list(zip(np.asarray(k)[:c].tolist(), np.asarray(v)[:c].tolist(),
                   np.asarray(b)[:c].tolist()))
    assert got == want


@pytest.mark.parametrize("nset", [64, 1500])
def test_filter_in_set(rng, nset):
    sk = _unique_keys(rng, nset)
    n = 50_000  # non-power-of-2, forces pad handling
    keys = rng.choice(np.concatenate([sk, _unique_keys(rng, nset)]),
                      n).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    count, fk, fv = filter_in_set(jnp.asarray(keys), jnp.asarray(sk),
                                  jnp.asarray(vals))
    mask = np.isin(keys, sk)
    c = int(count)
    assert c == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(fk)[:c], keys[mask])
    np.testing.assert_array_equal(np.asarray(fv)[:c], vals[mask])


def test_filter_in_set_overflow_fallback(rng):
    sk = _colliding_keys(40)
    n = 8192
    keys = rng.choice(np.concatenate([sk, sk ^ np.uint32(0x400000)]),
                      n).astype(np.uint32)
    count, fk = filter_in_set(jnp.asarray(keys), jnp.asarray(sk))
    mask = np.isin(keys, sk)
    assert int(count) == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(fk)[:int(count)], keys[mask])


def test_filter_not_in_set(rng):
    from lsdradixsort.ops.filter import filter_not_in_set
    sk = _unique_keys(rng, 300)
    n = 50_000
    keys = rng.choice(np.concatenate([sk, _unique_keys(rng, 300)]),
                      n).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    count, fk, fv = filter_not_in_set(jnp.asarray(keys), jnp.asarray(sk),
                                      jnp.asarray(vals))
    mask = ~np.isin(keys, sk)
    c = int(count)
    assert c == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(fk)[:c], keys[mask])
    np.testing.assert_array_equal(np.asarray(fv)[:c], vals[mask])


@pytest.mark.parametrize("nb", [1, 1000, 5000])
def test_probe_lookup(rng, nb):
    from lsdradixsort.ops.join import probe_lookup
    npr = 1 << 14
    bk = _unique_keys(rng, nb)
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.choice(np.concatenate([bk, _unique_keys(rng, nb)]),
                    npr).astype(np.uint32)
    m, v = probe_lookup(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk))
    lut = dict(zip(bk.tolist(), bv.tolist()))
    want_m = np.array([k in lut for k in pk.tolist()], dtype=np.uint32)
    want_v = np.array([lut.get(k, 0) for k in pk.tolist()], dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(m), want_m)
    np.testing.assert_array_equal(np.asarray(v), want_v)


def test_probe_lookup_vmem_overflow_fallback(rng):
    from lsdradixsort.ops.join import probe_lookup
    bk = _colliding_keys(ROWS + 3)
    nb = bk.size
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    pk = rng.choice(np.concatenate([bk, bk + np.uint32(1)]),
                    4096).astype(np.uint32)
    m, v = probe_lookup(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk))
    lut = dict(zip(bk.tolist(), bv.tolist()))
    want_m = np.array([k in lut for k in pk.tolist()], dtype=np.uint32)
    want_v = np.array([lut.get(k, 0) for k in pk.tolist()], dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(m), want_m)
    np.testing.assert_array_equal(np.asarray(v), want_v)


def test_probe_lookup64_and_join64(rng):
    from lsdradixsort.ops.join import hash_join64, probe_lookup64
    nb, npr = 700, 1 << 13
    # unique 64-bit build keys with COLLIDING hi planes (hi has 16 values)
    bhi = rng.integers(0, 16, nb, dtype=np.uint64).astype(np.uint32)
    blo = rng.permutation(1 << 20)[:nb].astype(np.uint32)
    bv = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    # probes: half hits, half misses that SHARE a plane with a build key
    # (same hi+different lo, or same lo+different hi — both-plane check)
    pick = rng.integers(0, nb, npr)
    phi, plo = bhi[pick].copy(), blo[pick].copy()
    kind = rng.integers(0, 4, npr)
    phi[kind == 1] ^= np.uint32(0x20)          # miss: hi off, lo matches
    plo[kind == 2] ^= np.uint32(1 << 21)       # miss: lo off, hi matches
    pv = np.arange(npr, dtype=np.uint32)
    lut = {(h, l): v for h, l, v in
           zip(bhi.tolist(), blo.tolist(), bv.tolist())}
    want_m = np.array([(h, l) in lut
                       for h, l in zip(phi.tolist(), plo.tolist())],
                      dtype=np.uint32)
    want_v = np.array([lut.get((h, l), 0)
                       for h, l in zip(phi.tolist(), plo.tolist())],
                      dtype=np.uint32)
    m, v = probe_lookup64(*map(jnp.asarray, (bhi, blo, bv, phi, plo)))
    np.testing.assert_array_equal(np.asarray(m), want_m)
    np.testing.assert_array_equal(np.asarray(v), want_v)
    cnt, jh, jl, jpv, jbv = hash_join64(
        *map(jnp.asarray, (bhi, blo, bv, phi, plo, pv)))
    c = int(cnt)
    keep = want_m == 1
    assert c == int(keep.sum())
    np.testing.assert_array_equal(np.asarray(jh)[:c], phi[keep])
    np.testing.assert_array_equal(np.asarray(jl)[:c], plo[keep])
    np.testing.assert_array_equal(np.asarray(jpv)[:c], pv[keep])
    np.testing.assert_array_equal(np.asarray(jbv)[:c], want_v[keep])
