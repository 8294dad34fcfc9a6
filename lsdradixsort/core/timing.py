"""Device timing harness.

The equivalent of the reference's timer pair utilities: wall-clock
timestamps (Utils.cpp:24-60, QueryPerformanceCounter) and CUDA event pairs
bracketing only device work (CudaUtils.cpp:24-29, e.g. LSDRadixSort.cu:998-1009).

JAX dispatch is asynchronous, so every timed call ends in
block_until_ready: the host clock then brackets the device work, not the
enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import numpy as np


@dataclass
class Timing:
    seconds: float          # median per-call time
    iters: int

    @property
    def ms(self) -> float:
        return self.seconds * 1e3

    def gelems_per_s(self, n: int) -> float:
        return n / self.seconds / 1e9

    def gbytes_per_s(self, nbytes: int) -> float:
        return nbytes / self.seconds / 1e9


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> Timing:
    """Time a jitted function on device: the median of `iters` calls, each
    waited for with block_until_ready, after `warmup` calls (the first
    compiles; reference pattern: kernels timed after the H2D copy,
    LSDRadixSort.cu:1001-1006)."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return Timing(seconds=float(np.median(times)), iters=iters)


def time_host(fn, *args, iters: int = 3) -> Timing:
    """Time a host (numpy / native) function — the CPU-golden baseline
    (reference pattern: LSDRadixSort.cu:984-990)."""
    fn(*args)  # warm caches
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return Timing(seconds=best, iters=iters)
