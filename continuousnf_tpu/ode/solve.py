"""Adaptive / fixed-step explicit RK integration under jit.

Everything operates on a single flat state vector (pytree states are raveled
once at the boundary), so the controller math is a handful of fused
vector ops — the per-step cost is dominated by the user's vector field, which
is where the matmul work lives.

Semantics mirror the reference's use of `SciMLBase.solve`
(`/root/reference/src/base_icnf.jl:137-143`): one solve advances the *entire*
batch with a single error-controlled time grid (batch-global step control,
the "MatrixMode" behavior), only the final state is kept
(`save_everystep=false`), and tolerances default to the README-recommended
values (`/root/reference/README.md:61-67`).

Differentiation strategies (`Adjoint`):
  * BACKSOLVE — continuous adjoint via `jax.custom_vjp`: re-integrate the
    state backward together with the adjoint ODE (O(1) memory;
    optimize-then-discretize).  See `adjoint.py`.
  * DIRECT — bounded `lax.scan` over solver steps with masked updates and
    per-step rematerialization (discretize-then-optimize; exact gradients of
    the discrete solution).
  * NONE — `lax.while_loop` forward only (inference / inside backward).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..types import Adjoint, SolverOptions
from .implicit import ESDIRKTableau, esdirk_step
from .tableaus import TABLEAUS, ButcherTableau, get_tableau

# Step-size controller constants (standard Hairer/OrdinaryDiffEq-style values).
_SAFETY = 0.9
_QMIN = 0.2
_QMAX = 10.0
_EEST_FLOOR = 1.0e-4  # floor on stored error estimate for the PI history term


class StepState(NamedTuple):
    """Carry of the adaptive loop (all arrays, while_loop/scan compatible)."""

    t: jax.Array
    y: jax.Array
    dt: jax.Array
    k1: jax.Array  # f(t, y) — FSAL register
    eest_prev: jax.Array
    steps: jax.Array
    accepted: jax.Array


class SolveStats(NamedTuple):
    steps: jax.Array  # total attempted steps
    accepted: jax.Array  # accepted steps
    nfe: jax.Array  # vector-field evaluations


def _rms_norm(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.mean(jnp.square(x)))


def _error_estimate(err: jax.Array, y: jax.Array, y_new: jax.Array, rtol, atol) -> jax.Array:
    """Hairer scaled error norm: sqrt(mean((err / (atol + rtol*max(|y|,|y_new|)))^2))."""
    sc = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
    return _rms_norm(err / sc)


def _rk_step(
    f: Callable[[jax.Array, jax.Array], jax.Array],
    tab: ButcherTableau,
    t: jax.Array,
    dt: jax.Array,
    y: jax.Array,
    k1: jax.Array,
) -> Tuple[jax.Array, Tuple[jax.Array, Optional[jax.Array]], jax.Array]:
    """One explicit RK step.  Returns (y_new, (err, err3), k_last).

    The stage loop is unrolled at trace time (<= 13 stages); XLA fuses the
    axpy chains.  For FSAL tableaus `k_last` is f at the new point.  `err3`
    is the secondary error vector for 8(5,3)-style stretched estimates
    (None unless the tableau defines btilde3).
    """
    dtype = y.dtype

    def weighted(ws):
        acc = jnp.zeros_like(y)
        for i, wi in enumerate(ws):
            if wi != 0.0:
                acc = acc + (dt * jnp.asarray(wi, dtype)) * ks[i]
        return acc

    ks = [k1]
    for i in range(1, tab.num_stages):
        yi = y
        for j, aij in enumerate(tab.a[i]):
            if aij != 0.0:
                yi = yi + (dt * jnp.asarray(aij, dtype)) * ks[j]
        ks.append(f(t + jnp.asarray(tab.c[i], dtype) * dt, yi))
    y_new = y
    for i, bi in enumerate(tab.b):
        if bi != 0.0:
            y_new = y_new + (dt * jnp.asarray(bi, dtype)) * ks[i]
    err = weighted(tab.btilde) if tab.btilde is not None else jnp.zeros_like(y)
    err3 = weighted(tab.btilde3) if tab.btilde3 is not None else None
    return y_new, (err, err3), ks[-1]


def _step(f, tab, t, dt, y, k1):
    """Dispatch one attempted step: explicit RK or implicit ESDIRK."""
    if isinstance(tab, ESDIRKTableau):
        return esdirk_step(f, tab, t, dt, y, k1)
    return _rk_step(f, tab, t, dt, y, k1)


def _nfe_per_attempt(tab) -> int:
    """f/JVP evaluations inside one attempted step (stage-1 FSAL reuse
    excluded; the non-FSAL refresh eval is accounted by the caller)."""
    if isinstance(tab, ESDIRKTableau):
        return tab.nfe_per_attempt
    return tab.num_stages - 1


def _initial_step_size(
    f, t0, y0, f0, tdir, order: int, rtol, atol, t_span_len
) -> jax.Array:
    """Hairer's automatic initial step selection (Hairer, Norsett, Wanner II.4)."""
    dtype = y0.dtype
    sc = atol + rtol * jnp.abs(y0)
    d0 = _rms_norm(y0 / sc)
    d1 = _rms_norm(f0 / sc)
    small = jnp.asarray(1e-6, dtype)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), small, 0.01 * d0 / d1)
    h0 = jnp.minimum(h0, t_span_len)
    y1 = y0 + tdir * h0 * f0
    f1 = f(t0 + tdir * h0, y1)
    d2 = _rms_norm((f1 - f0) / sc) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(
        dmax <= 1e-15,
        jnp.maximum(small, h0 * 1e-3),
        (0.01 / dmax) ** (1.0 / (order + 1)),
    )
    h = jnp.minimum(jnp.minimum(100.0 * h0, h1), t_span_len)
    return (tdir * h).astype(dtype)


def _controller_factors(order: int):
    """PI controller exponents (OrdinaryDiffEq-style defaults for explicit RK)."""
    beta1 = 7.0 / (10.0 * order)
    beta2 = 2.0 / (5.0 * order)
    return beta1, beta2


def _attempt_step(f, tab: ButcherTableau, state: StepState, t1, tdir, rtol, atol):
    """Shared accept/reject + PI-controller logic for one attempted step."""
    t, y, dt, k1, eest_prev, steps, accepted = state
    dtype = y.dtype
    beta1, beta2 = _controller_factors(tab.order)

    remaining = jnp.abs(t1 - t)
    is_last = jnp.abs(dt) >= remaining
    dt_use = tdir * jnp.minimum(jnp.abs(dt), remaining)

    y_new, (err, err3), k_last = _step(f, tab, t, dt_use, y, k1)
    # The error estimate only drives control flow (accept + step size); it must
    # not carry gradients — in the DIRECT (scan) path a masked no-op step has
    # dt=0 => err=0, and d/dx sqrt(x)|_0 = inf would poison the cotangents.
    eest = jax.lax.stop_gradient(_error_estimate(err, y, y_new, rtol, atol))
    if err3 is not None:
        # Hairer's stretched 8(5,3) estimate (dop853.f): combine the 5th- and
        # 3rd-order embedded errors as e5^2 / sqrt(e5^2 + 0.01 e3^2).
        e3 = jax.lax.stop_gradient(_error_estimate(err3, y, y_new, rtol, atol))
        denom = jnp.sqrt(jnp.square(eest) + 0.01 * jnp.square(e3))
        eest = jnp.where(denom > 0.0, jnp.square(eest) / jnp.maximum(denom, 1e-30), eest)
    finite = jnp.isfinite(eest) & jnp.all(jnp.isfinite(y_new))
    accept = (eest <= 1.0) & finite

    # PI controller: growth factor on accept, plain shrink on reject.
    eest_c = jnp.maximum(eest, jnp.asarray(_EEST_FLOOR, dtype))
    q_acc = _SAFETY * eest_c ** (-beta1) * eest_prev ** (beta2)
    q_acc = jnp.where(jnp.isfinite(q_acc), q_acc, _QMIN)
    q_rej = _SAFETY * eest_c ** (-1.0 / tab.order)
    q_rej = jnp.where(jnp.isfinite(q_rej), q_rej, _QMIN)
    q_rej = jnp.where(finite, q_rej, jnp.asarray(_QMIN, dtype))
    dt_next = jnp.where(
        accept,
        dt_use * jnp.clip(q_acc, _QMIN, _QMAX),
        dt_use * jnp.clip(q_rej, _QMIN, 1.0),
    )

    t_next = jnp.where(accept, jnp.where(is_last, t1, t + dt_use), t)
    y_next = jnp.where(accept, y_new, y)
    if tab.fsal:
        k1_next = jnp.where(accept, k_last, k1)
        extra_nfe = 0
    else:
        # Non-FSAL: recompute f at the (possibly new) point for the next step.
        k1_next = jnp.where(accept, f(t_next, y_next), k1)
        extra_nfe = 1

    new_state = StepState(
        t=t_next,
        y=y_next,
        dt=dt_next,
        k1=k1_next,
        eest_prev=jnp.where(accept, eest_c, eest_prev),
        steps=steps + 1,
        accepted=accepted + accept.astype(steps.dtype),
    )
    nfe_per_attempt = _nfe_per_attempt(tab) + extra_nfe
    return new_state, nfe_per_attempt


def _solve_adaptive_while(f, tab, y0, t0, t1, rtol, atol, max_steps, dt0):
    """Forward adaptive solve in a `lax.while_loop` (not reverse-differentiable)."""
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    tdir = jnp.sign(t1 - t0)
    span = jnp.abs(t1 - t0)

    f0 = f(t0, y0)
    if dt0 is None:
        dt_init = _initial_step_size(f, t0, y0, f0, tdir, tab.order, rtol, atol, span)
    else:
        dt_init = tdir * jnp.abs(jnp.asarray(dt0, dtype))

    init = StepState(
        t=t0,
        y=y0,
        dt=dt_init,
        k1=f0,
        eest_prev=jnp.asarray(1.0, dtype),
        steps=jnp.asarray(0, jnp.int32),
        accepted=jnp.asarray(0, jnp.int32),
    )

    def cond(state: StepState):
        unfinished = (state.t - t1) * tdir < 0
        return unfinished & (state.steps < max_steps)

    def body(state: StepState):
        new_state, _ = _attempt_step(f, tab, state, t1, tdir, rtol, atol)
        return new_state

    final = jax.lax.while_loop(cond, body, init)
    nfe_per = _nfe_per_attempt(tab) + (0 if tab.fsal else 1)
    stats = SolveStats(
        steps=final.steps,
        accepted=final.accepted,
        nfe=final.steps * nfe_per + (2 if dt0 is None else 1),
    )
    return final.y, stats


def _solve_adaptive_scan(f, tab, y0, t0, t1, rtol, atol, max_steps, dt0):
    """Adaptive solve over a bounded, reverse-differentiable `lax.scan`.

    Every iteration runs one attempted step; once the integration reaches t1
    the carry passes through unchanged (the step compute is wasted but the
    shape stays static — the price of discretize-then-optimize under XLA).
    Each step is rematerialized (`jax.checkpoint`) so backprop memory is
    O(max_steps) small carries rather than O(max_steps) stage stacks.
    """
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    tdir = jnp.sign(t1 - t0)
    span = jnp.abs(t1 - t0)

    f0 = f(t0, y0)
    if dt0 is None:
        dt_init = _initial_step_size(f, t0, y0, f0, tdir, tab.order, rtol, atol, span)
    else:
        dt_init = tdir * jnp.abs(jnp.asarray(dt0, dtype))

    init = StepState(
        t=t0,
        y=y0,
        dt=dt_init,
        k1=f0,
        eest_prev=jnp.asarray(1.0, dtype),
        steps=jnp.asarray(0, jnp.int32),
        accepted=jnp.asarray(0, jnp.int32),
    )

    @jax.checkpoint
    def scan_body(state: StepState, _):
        done = (state.t - t1) * tdir >= 0
        new_state, _ = _attempt_step(f, tab, state, t1, tdir, rtol, atol)
        out = jax.tree.map(lambda a, b: jnp.where(done, a, b), state, new_state)
        return out, None

    final, _ = jax.lax.scan(scan_body, init, None, length=max_steps)
    nfe_per = _nfe_per_attempt(tab) + (0 if tab.fsal else 1)
    stats = SolveStats(
        steps=final.steps,
        accepted=final.accepted,
        nfe=final.steps * nfe_per + (2 if dt0 is None else 1),
    )
    return final.y, stats


def _solve_fixed_scan(f, tab, y0, t0, t1, num_steps: int):
    """Fixed-step integration via `lax.scan` (reverse-differentiable, remat'd)."""
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    dt = (t1 - t0) / num_steps

    @jax.checkpoint
    def scan_body(carry, i):
        t, y = carry
        k1 = f(t, y)
        y_new, _, _ = _rk_step(f, tab, t, dt, y, k1)
        return (t0 + dt * (i.astype(dtype) + 1.0), y_new), None

    (tf, yf), _ = jax.lax.scan(scan_body, (t0, y0), jnp.arange(num_steps))
    stats = SolveStats(
        steps=jnp.asarray(num_steps, jnp.int32),
        accepted=jnp.asarray(num_steps, jnp.int32),
        nfe=jnp.asarray(num_steps * tab.num_stages, jnp.int32),
    )
    return yf, stats


def _solve_forward_flat(func_flat, opts: SolverOptions, y0f, t0, t1, args):
    """Dispatch the non-custom-vjp solve paths on the flat state.

    The field is traced under the resolved `stage_precision` matmul
    precision (`types.resolve_stage_precision`): matmul rounding near the
    solver's rtol would make the embedded error estimate measure rounding
    noise instead of truncation error, and the controller would shrink the
    step to a noise floor.
    """
    tab = get_tableau(opts.method, opts.rtol)
    from ..types import resolve_stage_precision

    prec = resolve_stage_precision(opts)

    if prec == "default":
        def f(t, yf):
            return func_flat(yf, t, args)
    else:
        def f(t, yf):
            with jax.default_matmul_precision(prec):
                return func_flat(yf, t, args)

    if opts.fixed_num_steps is not None:
        return _solve_fixed_scan(f, tab, y0f, t0, t1, opts.fixed_num_steps)
    if tab.btilde is None:
        raise ValueError(
            f"method {opts.method!r} has no embedded error estimate; "
            "set SolverOptions.fixed_num_steps for fixed-step integration"
        )
    if opts.adjoint == Adjoint.DIRECT:
        return _solve_adaptive_scan(
            f, tab, y0f, t0, t1, opts.rtol, opts.atol, opts.direct_max_steps, opts.dt0
        )
    return _solve_adaptive_while(
        f, tab, y0f, t0, t1, opts.rtol, opts.atol, opts.max_steps, opts.dt0
    )


def _make_func_flat(func, unravel, opts: SolverOptions):
    """Flatten a pytree field to the flat-state signature under the solver's
    matmul precision.

    The precision context MUST live inside func_flat, not around the solver
    loops: the BACKSOLVE path bakes the field into a jaxpr via
    `jax.closure_convert` (adjoint.py) at wrapper-construction time, so any
    context applied later (around the while_loop/scan body) never reaches
    the already-traced dot ops.  Wrapping here puts every trace of the
    field — forward solve, adjoint re-integration, DIRECT scan — under the
    requested precision, and the VJP of ops created here inherits it.
    """
    from ..types import resolve_stage_precision

    prec = resolve_stage_precision(opts)

    if prec == "default":
        def func_flat(yf, t, args_):
            dy = func(t, unravel(yf), args_)
            dyf, _ = ravel_pytree(dy)
            return dyf
    else:
        def func_flat(yf, t, args_):
            with jax.default_matmul_precision(prec):
                dy = func(t, unravel(yf), args_)
            dyf, _ = ravel_pytree(dy)
            return dyf

    return func_flat


def odeint_with_stats(
    func: Callable[[jax.Array, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
) -> Tuple[Any, SolveStats]:
    """Integrate `dy/dt = func(t, y, args)` from t0 to t1 (t1 < t0 runs backward).

    `y0` and `args` are arbitrary (all-float) pytrees.  Returns the final
    state and solve statistics (attempted/accepted steps, NFE).  Gradient
    behavior is selected by `opts.adjoint`; for BACKSOLVE the stats carry no
    gradients.
    """
    y0f, unravel = ravel_pytree(y0)
    t0 = jnp.asarray(t0, y0f.dtype)
    t1 = jnp.asarray(t1, y0f.dtype)
    func_flat = _make_func_flat(func, unravel, opts)

    if getattr(opts, "tstops", None):
        # Forced stepping points: chain segment solves split at the tstops.
        # t0/t1 may be traced (steering), so no dynamic sort/filter happens
        # here — the caller provides interior points ordered in integration
        # direction and strictly inside the span (reference `tstops`
        # semantics; a steered endpoint landing short of the last tstop just
        # makes the final segment integrate the short way back, which is
        # well-defined for an ODE).
        grid = [t0] + [jnp.asarray(t, y0f.dtype) for t in opts.tstops] + [t1]
        seg_opts = dataclasses.replace(opts, tstops=None)
        yT = y0
        stats = None
        for i in range(len(grid) - 1):
            yT, st = odeint_with_stats(func, yT, grid[i], grid[i + 1], args, seg_opts)
            stats = st if stats is None else SolveStats(
                steps=stats.steps + st.steps,
                accepted=stats.accepted + st.accepted,
                nfe=stats.nfe + st.nfe,
            )
        return yT, stats

    if opts.adjoint == Adjoint.BACKSOLVE and opts.fixed_num_steps is None:
        from .adjoint import odeint_backsolve_flat

        yf, stats = odeint_backsolve_flat(func_flat, opts, y0f, t0, t1, args)
    else:
        yf, stats = _solve_forward_flat(func_flat, opts, y0f, t0, t1, args)
    return unravel(yf), stats


def backsolve_stats(
    func: Callable[[jax.Array, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any,
    cotangent_fn: Callable[[Any], jax.Array],
    opts: SolverOptions = SolverOptions(),
) -> Tuple[Any, "SolveStats", "SolveStats"]:
    """Forward solve + MEASURED backward-integration statistics.

    Runs the forward solve exactly as `odeint_with_stats` would, evaluates
    `cotangent_fn(yT_state) -> scalar` to seed the adjoint (its gradient
    w.r.t. the final state is the cotangent the real loss backward passes
    in), then runs the SAME backward integration the BACKSOLVE custom_vjp
    runs — but keeps its SolveStats, which the VJP protocol cannot return.
    Returns (yT_state, fwd_stats, bwd_stats).
    """
    y0f, unravel = ravel_pytree(y0)
    t0 = jnp.asarray(t0, y0f.dtype)
    t1 = jnp.asarray(t1, y0f.dtype)
    func_flat = _make_func_flat(func, unravel, opts)
    yTf, fwd_stats = _solve_forward_flat(
        func_flat, dataclasses.replace(opts, adjoint=Adjoint.NONE),
        y0f, t0, t1, args,
    )
    g_yf = jax.grad(lambda yf: cotangent_fn(unravel(yf)))(yTf)
    from .adjoint import backward_stats_flat

    bwd_stats = backward_stats_flat(func_flat, opts, yTf, t0, t1, args, g_yf)
    return unravel(yTf), fwd_stats, bwd_stats


def odeint_saveat(
    func: Callable[[jax.Array, Any, Any], Any],
    y0: Any,
    t_grid,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
) -> Tuple[Any, "SolveStats"]:
    """Integrate with intermediate saves: sequential adaptive segment solves
    over the fixed time grid `t_grid` (length T+1, including both endpoints).

    Returns (states, stats) where every leaf of `states` gains a leading
    time axis of length T+1 (states[0] == y0) and `stats` sums the segment
    solves.  The analog of the reference's `sol_kwargs` passthrough of
    `saveat`/`save_everystep` to `SciMLBase.solve`
    (`/root/reference/src/base_icnf.jl:137-143`) — the repo's solver
    normally keeps only the final state (the CNF hot path); this entry
    point recovers the transport trajectory for diagnostics/visualization.
    The step controller restarts per segment (fresh Hairer initial-dt pick),
    a valid — if slightly more conservative — error control.
    """
    import jax.numpy as _jnp

    states = [y0]
    stats = None
    y = y0
    for i in range(len(t_grid) - 1):
        y, st = odeint_with_stats(func, y, t_grid[i], t_grid[i + 1], args, opts)
        states.append(y)
        stats = st if stats is None else SolveStats(
            steps=stats.steps + st.steps,
            accepted=stats.accepted + st.accepted,
            nfe=stats.nfe + st.nfe,
        )
    stacked = jax.tree.map(lambda *xs: _jnp.stack(xs, axis=0), *states)
    return stacked, stats


def odeint(
    func: Callable[[jax.Array, Any, Any], Any],
    y0: Any,
    t0,
    t1,
    args: Any = None,
    opts: SolverOptions = SolverOptions(),
) -> Any:
    """Like :func:`odeint_with_stats` but returns only the final state."""
    yT, _ = odeint_with_stats(func, y0, t0, t1, args, opts)
    return yT


__all__ = ["odeint", "odeint_with_stats", "odeint_saveat", "backsolve_stats", "SolveStats"]
