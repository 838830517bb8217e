"""Debug & quality guards — the JAX analog of the reference's static quality
gates (SURVEY §5: Aqua ambiguity/piracy checks and JET type-stability become,
in a traced/jit world: retrace-count guards, NaN debugging, and shape/dtype
assertions on the public entry points).
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp


class RetraceError(RuntimeError):
    """Raised by `jit_with_retrace_guard` when a function re-traces more than
    its budget — the jit analog of a JET type-instability report (every
    retrace is a recompile: shape churn, dtype churn, or unhashable statics).
    """


def jit_with_retrace_guard(fn=None, *, max_traces: int = 2, name: Optional[str] = None, **jit_kwargs):
    """`jax.jit` wrapper that raises `RetraceError` past `max_traces` traces.

    The counter increments inside the traced body, so it fires exactly when
    XLA recompiles (cache hits don't count).  The guarded callable exposes
    `.trace_count` for tests/telemetry.  Usable as a decorator or a call:

        step = jit_with_retrace_guard(step_fn, max_traces=1)
    """
    if fn is None:
        return functools.partial(
            jit_with_retrace_guard, max_traces=max_traces, name=name, **jit_kwargs
        )
    label = name or getattr(fn, "__name__", "<fn>")
    counter = {"n": 0}

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        counter["n"] += 1
        if counter["n"] > max_traces:
            raise RetraceError(
                f"{label} traced {counter['n']} times (budget {max_traces}); "
                "look for changing shapes/dtypes, python scalars that should "
                "be arrays, or non-hashable static arguments"
            )
        return fn(*args, **kwargs)

    jitted = jax.jit(counted, **jit_kwargs)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return jitted(*args, **kwargs)

    wrapper.trace_count = lambda: counter["n"]
    return wrapper


def check_array(
    name: str,
    x: Any,
    *,
    rank: Optional[Tuple[int, ...]] = None,
    last_dim: Optional[int] = None,
    dtype: Any = None,
) -> None:
    """Entry-point shape/dtype assertion with actionable messages.

    Used by `inference`/`generate`/`fit` input validation; cheap (host-side
    metadata only, no device sync) and trace-safe (shapes/dtypes are static
    under tracing).
    """
    shape = getattr(x, "shape", None)
    if shape is None:
        raise TypeError(f"{name} must be an array-like with .shape, got {type(x).__name__}")
    if rank is not None and len(shape) not in rank:
        raise ValueError(f"{name} must have rank in {rank}, got shape {shape}")
    if last_dim is not None and shape[-1] != last_dim:
        raise ValueError(f"{name} must have trailing dim {last_dim}, got shape {shape}")
    if dtype is not None:
        got = getattr(x, "dtype", None)
        if got is not None and jnp.dtype(got) != jnp.dtype(dtype):
            raise ValueError(f"{name} must have dtype {jnp.dtype(dtype)}, got {got}")


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn on jax_debug_nans: any NaN produced under jit raises with a
    de-optimized re-run pinpointing the op."""
    jax.config.update("jax_debug_nans", enable)


def assert_finite(tree, name: str = "value") -> None:
    """Eager finiteness check over a pytree (host-side; for tests/debug)."""
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        if not bool(jnp.all(jnp.isfinite(leaf))):
            raise FloatingPointError(f"{name}: non-finite values in leaf {i}")


__all__ = [
    "RetraceError",
    "jit_with_retrace_guard",
    "check_array",
    "enable_nan_debugging",
    "assert_finite",
]
