"""Profiling/tracing integration — the counterpart of the reference's
observability stack (SURVEY.md §5): cudaEvent pairs + offline Nsight
Compute `.ncu-rep` captures become `jax.profiler` traces viewable in
xprof/TensorBoard, plus a light wall-clock annotation helper.

Usage:

    from lsdradixsort.core.profiling import trace, annotate

    with trace("/tmp/lsd_trace"):          # xprof capture directory
        with annotate("sort_pass_0"):
            out = sort_kv(keys, vals)
        jax.block_until_ready(out)
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a device trace (xprof) for the enclosed computation.

    The Nsight-Compute analog: open the written directory with
    `tensorboard --logdir <log_dir>` (Profile tab) or pass
    create_perfetto_link=True for a perfetto UI link.
    """
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def stopwatch(name: str, sink=print):
    """Wall-clock bracket with forced device completion — the cudaEvent-pair
    analog (CudaUtils.cpp:24-29) for quick ad-hoc timing."""
    t0 = time.perf_counter()
    yield
    # caller must block on its own results for exact numbers; this is a
    # coarse host-side bracket
    sink(f"[stopwatch] {name}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
