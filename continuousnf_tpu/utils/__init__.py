"""Utilities: timing/tracing helpers, debug guards, the compile cache."""

from .profiling import time_chained, trace
from .debug import enable_nan_debugging, assert_finite
from .cache import enable_compile_cache

__all__ = [
    "time_chained",
    "trace",
    "enable_nan_debugging",
    "assert_finite",
    "enable_compile_cache",
]
