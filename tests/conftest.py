"""Test configuration: a CPU backend with 8 virtual devices by default.

Must run before jax is imported anywhere: selects the CPU platform unless
JAX_PLATFORMS says otherwise (the tests never depend on a card) and
exposes 8 virtual devices so the shard_map/collective paths — the
multi-card design — execute end-to-end (SURVEY.md §4). Tests marked
`gpu` need the card and skip elsewhere; run them there with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""
import os
import threading

# XLA:CPU's LLVM pipeline C-stack-overflows (flaky segfault in
# backend_compile_and_load) when compiling big unrolled graphs such as
# the composed LSD pipeline. Two distinct stacks are involved:
#
#  1. The thread calling jit: runs part of the pipeline inline. Raising
#     RLIMIT_STACK mid-process does NOT reliably grow the MAIN thread
#     (its growth room was laid out at exec time from the limit then in
#     force — seen 2026-08-17 in test_composed_sort_digit_widths), so
#     every test body runs on a worker thread whose 512 MB stack is
#     mmap'd whole at pthread_create (pytest_pyfunc_call below).
#  2. XLA's own compilation pool: the thunk runtime parallelizes LLVM
#     codegen onto pthreads created LATER in this process, which size
#     their stacks from the RLIMIT_STACK soft limit *at creation time*
#     (default 8 MB — crashed late in the suite on a big-stack worker,
#     i.e. inside a pool thread the worker fix cannot reach). Raising
#     the soft limit here IS reliable for those: no exec-time race for
#     threads not yet created.
threading.stack_size(512 * 1024 * 1024)

import resource  # noqa: E402

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = 512 * 1024 * 1024  # NOT infinity: glibc maps infinity to 8 MB
if _soft != resource.RLIM_INFINITY and _soft < _want:
    new = _want if _hard == resource.RLIM_INFINITY else min(_want, _hard)
    resource.setrlimit(resource.RLIMIT_STACK, (new, _hard))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported when this file runs, which makes the env
# vars above too late; jax.config works until a backend initializes.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: cached executables survive across runs.
# JAX reads JAX_COMPILATION_CACHE_DIR itself where it is set; otherwise
# the tests keep their own directory in the checkout (.gitignore).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = os.path.join(os.path.dirname(__file__), os.pardir,
                              ".jax_test_cache")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.abspath(_cache_dir))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    """Run the test body on a big-stack worker thread (see header)."""
    kwargs = {name: pyfuncitem.funcargs[name]
              for name in pyfuncitem._fixtureinfo.argnames}
    box = {}

    def runner():
        try:
            box["ret"] = pyfuncitem.obj(**kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            box["exc"] = e

    t = threading.Thread(target=runner, name=f"test:{pyfuncitem.name}")
    t.start()
    t.join()
    if "exc" in box:
        raise box["exc"]
    return True


@pytest.fixture(autouse=True, scope="module")
def _release_jit_code_between_modules():
    """Unload accumulated JIT'd executables after each test module.

    The flaky late-suite segfaults land inside jaxlib's CPU pipeline on
    BOTH the compile path and the cache-deserialize path, on threads with
    512 MB stacks — i.e. not (only) stack depth but accumulated state:
    every compiled executable keeps ORC-JIT'd code resident, and the
    suite compiles hundreds of programs into one process. Dropping the
    jit caches releases the executables (and their JIT memory) at module
    boundaries; the persistent on-disk cache keeps the recompile cost
    near zero.
    """
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_devices():
    """The JAX devices, when they are GPUs; skips the test otherwise.
    Decided here, at run time, never while modules are imported."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
    return devs
