"""Order-preserving key codecs (core/keycodec.py) and the dtype/descending
surface of the sort ops: every codec must be a bijection whose u32 order
equals the requested order on the source dtype, and the ops must match
numpy goldens bit-exactly through it."""
import numpy as np
import pytest
import jax.numpy as jnp

from lsdradixsort.core.keycodec import decode, encode
from lsdradixsort.ops.sort import argsort, sort, sort_kv, sort_with_ranks


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _i32(rng, n):
    return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32)


def _f32(rng, n):
    # finite floats spanning magnitudes, both zeros included
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    x[: min(8, n)] = [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 1e-38,
                      -1e-38][: min(8, n)]
    return x


def test_encode_decode_roundtrip_u32(rng):
    k = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    for desc in (False, True):
        c = encode(jnp.asarray(k), desc)
        np.testing.assert_array_equal(
            np.asarray(decode(c, jnp.uint32, desc)), k)


@pytest.mark.parametrize("desc", [False, True])
def test_encode_order_i32(rng, desc):
    k = _i32(rng, 4096)
    k[:4] = [np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max]
    c = np.asarray(encode(jnp.asarray(k), desc)).astype(np.uint64)
    got_order = np.argsort(c, kind="stable")
    want = np.sort(k) if not desc else np.sort(k)[::-1]
    np.testing.assert_array_equal(want, k[got_order])
    np.testing.assert_array_equal(
        np.asarray(decode(encode(jnp.asarray(k), desc), jnp.int32, desc)), k)


@pytest.mark.parametrize("desc", [False, True])
def test_encode_order_f32(rng, desc):
    k = _f32(rng, 4096)
    c = np.asarray(encode(jnp.asarray(k), desc))
    got = k[np.argsort(c, kind="stable")]
    want = np.sort(k)  # no NaNs here: IEEE total order == numpy order
    if desc:
        want = want[::-1]
        # -0.0/+0.0: total order distinguishes them, numpy does not;
        # compare bit patterns only up to float equality
    np.testing.assert_array_equal(got == want, np.full(k.shape, True))
    rt = np.asarray(decode(encode(jnp.asarray(k), desc), jnp.float32, desc))
    np.testing.assert_array_equal(rt.view(np.uint32), k.view(np.uint32))


def test_f32_total_order_specials():
    # IEEE total order: -NaN < -inf < -0.0 < +0.0 < +inf < +NaN
    k = np.array([np.float32(np.nan), -np.float32(np.nan), np.inf, -np.inf,
                  0.0, -0.0], dtype=np.float32)
    c = np.asarray(encode(jnp.asarray(k)))
    ranks = np.argsort(np.argsort(c))
    # order: -nan, -inf, -0.0, +0.0, +inf, +nan
    assert ranks[1] < ranks[3] < ranks[5] < ranks[4] < ranks[2] < ranks[0]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("strategy", ["composed", "xla"])
def test_sort_dtypes(rng, dtype, desc, strategy):
    n = 1 << 12
    k = _i32(rng, n) if dtype == np.int32 else _f32(rng, n)
    got = np.asarray(sort(jnp.asarray(k), strategy=strategy,
                          block_size=1 << 10, descending=desc))
    want = np.sort(k)
    if desc:
        want = want[::-1]
    np.testing.assert_array_equal(got == want, np.full(n, True))


@pytest.mark.parametrize("desc", [False, True])
def test_sort_kv_i32_stable(rng, desc):
    n = 1 << 12
    k = (rng.integers(-50, 50, n)).astype(np.int32)  # many duplicates
    v = np.arange(n, dtype=np.uint32)
    sk, sv = sort_kv(jnp.asarray(k), jnp.asarray(v), descending=desc)
    sk, sv = np.asarray(sk), np.asarray(sv)
    want_perm = np.argsort(-k if desc else k, kind="stable")
    np.testing.assert_array_equal(sk, k[want_perm])
    np.testing.assert_array_equal(sv, want_perm.astype(np.uint32))


@pytest.mark.parametrize("desc", [False, True])
def test_sort_kv_merge_engine_i32(rng, desc):
    n = 1 << 12
    k = (rng.integers(-50, 50, n)).astype(np.int32)
    v = np.arange(n, dtype=np.uint32)
    sk, sv = sort_kv(jnp.asarray(k), jnp.asarray(v), strategy="composed",
                     block_size=1 << 10, descending=desc)
    want_perm = np.argsort(-k if desc else k, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), k[want_perm])
    np.testing.assert_array_equal(np.asarray(sv), want_perm.astype(np.uint32))


def test_argsort_and_ranks_f32(rng):
    n = 1 << 12
    k = _f32(rng, n)
    perm = np.asarray(argsort(jnp.asarray(k)))
    # golden = stable argsort of the codes: IEEE total order, which
    # (documented) splits the -0.0/+0.0 tie that numpy's float argsort
    # keeps in input order
    codes = np.asarray(encode(jnp.asarray(k)))
    np.testing.assert_array_equal(perm, np.argsort(codes, kind="stable"))
    sk, perm2 = sort_with_ranks(jnp.asarray(k), descending=True)
    np.testing.assert_array_equal(np.asarray(sk), k[np.asarray(perm2)])
    assert np.all(np.diff(np.asarray(sk)) <= 0)


def test_unsupported_dtype_raises():
    with pytest.raises(TypeError):
        sort(jnp.arange(8, dtype=jnp.uint16))


# --- 64-bit keys (hi, lo u32 planes) ---------------------------------------

def _planes(k64_bits: np.ndarray):
    return ((k64_bits >> 32).astype(np.uint32),
            (k64_bits & 0xFFFFFFFF).astype(np.uint32))


@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("n", [1 << 12, 1000, 4097])
def test_sort64_with_ranks(rng, dtype, desc, n):
    from lsdradixsort.ops.sort import sort64_with_ranks
    if dtype == "uint64":
        logical = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        # low-entropy hi plane: exercises ties across the second pass
        logical[n // 2:] &= np.uint64(0xFFFFFFFF)
        bits = logical
    elif dtype == "int64":
        logical = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        logical[:4] = [np.iinfo(np.int64).min, -1, 0,
                       np.iinfo(np.int64).max]
        bits = logical.view(np.uint64)
    else:
        logical = (rng.standard_normal(n)
                   * 10.0 ** rng.integers(-200, 200, n))
        logical[:4] = [0.0, -0.0, np.inf, -np.inf]
        logical = logical.astype(np.float64)
        bits = logical.view(np.uint64)
    hi, lo = _planes(bits)
    hi_s, lo_s, perm = sort64_with_ranks(
        jnp.asarray(hi), jnp.asarray(lo), dtype=dtype, descending=desc)
    hi_s, lo_s, perm = map(np.asarray, (hi_s, lo_s, perm))
    # golden: host mirror of the 64-bit codec, stable-argsorted — gives
    # the exact expected permutation for every dtype (incl. the total
    # order on -0.0/+0.0) and both directions
    codes = bits.copy()
    if dtype == "int64":
        codes ^= np.uint64(1) << np.uint64(63)
    elif dtype == "float64":
        neg = bits >> np.uint64(63) != 0
        codes = np.where(neg, ~bits, bits | (np.uint64(1) << np.uint64(63)))
    if desc:
        codes = ~codes
    order = np.argsort(codes, kind="stable")
    got_bits = hi_s.astype(np.uint64) << np.uint64(32) | lo_s
    np.testing.assert_array_equal(got_bits, bits[order])
    np.testing.assert_array_equal(perm, order.astype(np.uint32))


# --- multi-column lexicographic sort ---------------------------------------

def _lex_golden(cols, descs):
    codes = [np.asarray(encode(jnp.asarray(c), d))
             for c, d in zip(cols, descs)]
    return np.lexsort(tuple(reversed(codes)))  # np.lexsort: primary LAST


@pytest.mark.parametrize("n", [1 << 12, 1001])
@pytest.mark.parametrize("desc", [False, (False, True), (True, False)])
def test_sort_lex_two_columns(rng, n, desc):
    from lsdradixsort.ops.sort import sort_lex
    c0 = rng.integers(0, 50, n, dtype=np.int64).astype(np.int32) - 25
    c1 = (rng.standard_normal(n) * 100).astype(np.float32)
    descs = (desc, desc) if isinstance(desc, bool) else desc
    (s0, s1), perm = sort_lex([jnp.asarray(c0), jnp.asarray(c1)],
                              descending=desc)
    order = _lex_golden([c0, c1], descs)
    np.testing.assert_array_equal(np.asarray(perm), order.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(s0), c0[order])
    np.testing.assert_array_equal(
        np.asarray(s1).view(np.uint32), c1[order].view(np.uint32))


def test_sort_lex_three_columns_stability(rng):
    from lsdradixsort.ops.sort import sort_lex
    n = 1 << 12
    cols = [rng.integers(0, 4, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]  # tiny domains: massive tie groups
    (s0, s1, s2), perm = sort_lex([jnp.asarray(c) for c in cols])
    order = _lex_golden(cols, (False,) * 3)
    np.testing.assert_array_equal(np.asarray(perm), order.astype(np.uint32))
    for s, c in zip((s0, s1, s2), cols):
        np.testing.assert_array_equal(np.asarray(s), c[order])


def test_sort_lex_as_segmented_sort(rng):
    # segmented sort = sort_lex([segment_id, key]): keys sorted within
    # each segment run, segments in id order, ties by input position
    from lsdradixsort.ops.sort import sort_lex
    n = 1 << 12
    seg = rng.integers(0, 16, n, dtype=np.uint64).astype(np.uint32)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    (sseg, skey), perm = sort_lex([jnp.asarray(seg), jnp.asarray(key)])
    order = np.lexsort((key, seg))
    np.testing.assert_array_equal(np.asarray(perm), order.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(sseg), seg[order])
    np.testing.assert_array_equal(np.asarray(skey), key[order])
