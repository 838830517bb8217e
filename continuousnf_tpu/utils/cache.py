"""Persistent XLA compilation cache at one fixed place.

The cache key includes the cache directory, so the directory must not move
between runs: it is `$JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads
the variable itself) and `<repo>/.jax_cache` otherwise.
"""

from __future__ import annotations

import os

import jax

#: The cache directory used when JAX_COMPILATION_CACHE_DIR is not set.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Sets nothing when `JAX_COMPILATION_CACHE_DIR` is set.  Otherwise points
    JAX at `DEFAULT_CACHE_DIR` and caches every program that took at least
    0.2 s to compile (the test suite's cost is hundreds of short compiles).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return DEFAULT_CACHE_DIR


__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]
