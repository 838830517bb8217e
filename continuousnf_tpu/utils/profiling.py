"""Timing and tracing helpers."""

from __future__ import annotations

import time
from typing import Callable

import jax


def time_chained(fn: Callable, make_input, iters: int = 50) -> float:
    """Wall time per call of `fn`, chaining each call's input on the previous
    call's output (defeats async-dispatch overlap).  The timed region closes
    with `block_until_ready`, so it covers the device work, not the enqueue."""
    x = make_input(None)
    out = jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _i in range(iters):
        out = fn(make_input(out))
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


class trace:
    """Context manager around `jax.profiler` for TensorBoard-viewable traces:

        with profiling.trace("traces/step"):
            train_step(...)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        jax.profiler.stop_trace()
        return False


__all__ = ["time_chained", "trace"]
