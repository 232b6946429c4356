"""Profiling / tracing utilities (SURVEY.md §5: the reference's observability
was triton do_bench microbenches + one INFO log per graph capture).

  * ``bench_fn`` — steady-state seconds per call, each timed window ending in
    ``block_until_ready`` (JAX returns before the device finishes).
  * ``trace`` — jax.profiler wrapper producing a TensorBoard-loadable trace.
  * module logger — pipeline/compile layers emit one INFO per new jitted
    signature (the analog of the reference's per-capture log line,
    ``optimizers/cuda/graphs.py:25-27``).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable

logger = logging.getLogger("stabletriton_jax")


def bench_fn(fn: Callable, *args, iters: int = 10, reps: int = 3,
             warmup: int = 2, **kwargs) -> float:
    """Steady-state seconds per call: ``iters`` back-to-back calls, fenced
    by ``block_until_ready`` on the last output, best of ``reps`` windows.
    The first ``warmup`` calls (compilation included) are not timed."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace around the with-block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", log_dir)
