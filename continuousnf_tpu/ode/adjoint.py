"""Continuous adjoint (backsolve) differentiation of the ODE solve.

Optimize-then-discretize: the backward pass re-integrates the state together
with the adjoint ODE

    dy/dt  = f(t, y, p)
    da/dt  = -(df/dy)^T a
    dg/dt  = -(df/dp)^T a

from t1 down to t0 with the same adaptive solver, giving O(1) memory in the
number of forward steps.  This replaces the adjoint machinery the reference
gets from SciMLSensitivity (`/root/reference/Project.toml:31`) and is the
BASELINE north-star gradient path for CNF training.

`jax.closure_convert` hoists any tracers captured by the user's vector field
into explicit differentiable residuals, so closures over e.g. fixed
Hutchinson probes are handled correctly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..types import Adjoint, SolverOptions


def _forward_opts(opts: SolverOptions) -> SolverOptions:
    return dataclasses.replace(opts, adjoint=Adjoint.NONE)


def odeint_backsolve_flat(func_flat, opts: SolverOptions, y0f, t0, t1, args):
    """Entry point used by `solve.odeint_with_stats` for Adjoint.BACKSOLVE.

    `func_flat(yf, t, args) -> dyf` operates on the flat state.  Closed-over
    tracers are converted to explicit arguments before the custom_vjp wrapper
    so they receive gradients.
    """
    converted, consts = jax.closure_convert(func_flat, y0f, t0, args)
    return _odeint_backsolve(converted, opts, y0f, t0, t1, args, tuple(consts))


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _odeint_backsolve(func, opts, y0f, t0, t1, args, consts):
    from .solve import _solve_forward_flat

    def ff(yf, t, pk):
        a, c = pk
        return func(yf, t, a, *c)

    return _solve_forward_flat(ff, _forward_opts(opts), y0f, t0, t1, (args, consts))


def _odeint_backsolve_fwd(func, opts, y0f, t0, t1, args, consts):
    yf, stats = _odeint_backsolve(func, opts, y0f, t0, t1, args, consts)
    return (yf, stats), (yf, t0, t1, args, consts)


def _backward_integrate(func, opts, yT, t0, t1, args, consts, g_y):
    """The BACKSOLVE backward integration, shared by the custom_vjp rule and
    the observability probe `backward_stats_flat`.

    Returns (a_y0, dt0, dt1, g_args, g_consts, stats) — the custom_vjp rule
    drops `stats` (a VJP cannot return extra outputs), the probe keeps them.
    """
    from .solve import _solve_forward_flat

    def f_of(t, y, args_, consts_):
        return func(y, t, args_, *consts_)

    # dL/dt1 = <g, f(y(t1), t1)>  (gradient of the solution w.r.t. the end time)
    f_T = f_of(t1, yT, args, consts)
    dt1 = jnp.sum(g_y * f_T).astype(t1.dtype)

    # The Hutchinson probes are Monte-Carlo constants, not parameters: their
    # cotangent would be integrated at full (K, B, zdim) width through every
    # backward stage and then discarded into `random.normal`'s zero VJP.
    # BACKSOLVE therefore treats `eps` as non-differentiable (zeros returned);
    # DIRECT still differentiates through everything.
    eps_const = args.get("eps") if isinstance(args, dict) else None
    args_d = (
        {k: v for k, v in args.items() if k != "eps"}
        if eps_const is not None
        else args
    )
    with_eps = (
        (lambda a: dict(a, eps=eps_const)) if eps_const is not None else (lambda a: a)
    )

    zeros_args = jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x)), args_d)
    zeros_consts = jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x)), consts)

    def aug_dyn(t, aug, pk):
        y, a_y, _, _ = aug
        args_, consts_ = pk
        _, vjp_fn = jax.vjp(
            lambda y_, a_, c_: f_of(t, y_, with_eps(a_), c_), y, args_, consts_
        )
        ay_bar, args_bar, consts_bar = vjp_fn(a_y)
        neg = lambda x: -x
        return (
            f_of(t, y, with_eps(args_), consts_),
            jax.tree.map(neg, ay_bar),
            jax.tree.map(neg, args_bar),
            jax.tree.map(neg, consts_bar),
        )

    aug0 = (yT, g_y, zeros_args, zeros_consts)
    aug0f, unravel = ravel_pytree(aug0)

    def aug_flat(augf, t, pk):
        daug = aug_dyn(t, unravel(augf), pk)
        daugf, _ = ravel_pytree(daug)
        return daugf

    augTf, stats = _solve_forward_flat(
        aug_flat, _forward_opts(opts), aug0f, t1, t0, (args_d, consts)
    )
    y0_rec, a_y0, g_args, g_consts = unravel(augTf)
    if eps_const is not None:
        g_args = dict(g_args, eps=jnp.zeros_like(eps_const))

    # dL/dt0 = -<a(t0), f(y(t0), t0)>
    f_0 = f_of(t0, y0_rec, args, consts)
    dt0 = (-jnp.sum(a_y0 * f_0)).astype(t0.dtype)

    return a_y0, dt0, dt1, g_args, g_consts, stats


def _odeint_backsolve_bwd(func, opts, residuals, cotangents):
    yT, t0, t1, args, consts = residuals
    g_y, _g_stats = cotangents
    a_y0, dt0, dt1, g_args, g_consts, _stats = _backward_integrate(
        func, opts, yT, t0, t1, args, consts, g_y
    )
    return (a_y0, dt0, dt1, g_args, g_consts)


def backward_stats_flat(func_flat, opts: SolverOptions, yTf, t0, t1, args, g_yf):
    """Measured SolveStats of the BACKSOLVE backward integration for the
    given final state and cotangent — exactly the integration the custom_vjp
    runs but with its statistics kept.  The analog of the NFE accounting the
    reference gets for free from `SciMLBase.solve` return values; here the
    VJP protocol cannot return them, so observability comes from re-running
    the backward solve standalone (same inputs => same adaptive grid).
    """
    converted, consts = jax.closure_convert(func_flat, yTf, t0, args)
    *_, stats = _backward_integrate(
        converted, opts, yTf, t0, t1, args, tuple(consts), g_yf
    )
    return stats


_odeint_backsolve.defvjp(_odeint_backsolve_fwd, _odeint_backsolve_bwd)

__all__ = ["odeint_backsolve_flat", "backward_stats_flat"]
