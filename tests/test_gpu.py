"""Checks that need the card: what XLA makes of the default paths.

Marked `gpu`; they skip off the card. Run them there with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""
import jax
import jax.numpy as jnp
import pytest

from lsdradixsort import ops, parallel

N = 1 << 20


def _hlo(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["sort", "sort_kv", "sort_with_ranks"])
def test_default_sorts_lower_to_cub_radix_sort(gpu_devices, op):
    k = jnp.arange(N, dtype=jnp.uint32)[::-1]
    args = (k, k) if op == "sort_kv" else (k,)
    txt = _hlo(getattr(ops, op), *args)
    assert "cub" in txt.lower(), f"{op}: no CUB radix sort in optimized HLO"


@pytest.mark.gpu
def test_ragged_exchange_compiles(gpu_devices):
    if len(gpu_devices) < 2:
        pytest.skip("needs at least two cards")
    mesh = parallel.make_mesh(len(gpu_devices))
    n = len(gpu_devices) * N
    k = parallel.shard_1d(jnp.arange(n, dtype=jnp.uint32)[::-1], mesh)
    txt = _hlo(lambda a, b: parallel.dist_sort_kv(a, b, mesh), k, k)
    assert "ragged-all-to-all" in txt
