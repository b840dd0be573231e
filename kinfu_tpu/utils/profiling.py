"""Profiling helpers: jax.profiler traces + device-time stage probes.

The reference's only instrumentation is a wall-clock cout per frame
(kinectfusion.cpp:122-123). Here:

  - `trace(logdir)`: context manager around jax.profiler.trace — produces
    an XProf/Perfetto trace of the device timeline viewable in
    TensorBoard.
  - `device_time(fn, *args)`: best-of-reps wall-clock of one call, ended
    by `jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Tuple


@contextlib.contextmanager
def trace(logdir: str):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(fn: Callable, *args, reps: int = 3) -> Tuple[float, Any]:
    """Best-of-reps wall seconds for fn(*args), each ended by
    `jax.block_until_ready`. Returns (seconds, last_result)."""
    import jax

    out = jax.block_until_ready(fn(*args))  # warmup / compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out
