"""ESDIRK stiff fallback: TR-BDF2 with matrix-free Newton-Krylov stages.

The reference inherits a stiff fallback from Julia's `DefaultODEAlgorithm`
(`/root/reference/src/base_icnf.jl:141`: Tsit5/Vern7 with an automatic
switch to a stiff method on its heuristic).  CNF fields are smooth bounded
nets and measured non-stiff at the reference's tolerances
(docs/SOLVER_PARITY.md), so the explicit family is the right default — but
"fallback exists" is a capability, not an assertion, so this module provides
one designed for XLA rather than translated:

* **TR-BDF2** (Hosea & Shampine 1996): a 3-stage stiffly-accurate ESDIRK,
  L-stable, order 2 with an order-3 embedded error estimate — the classic
  one-step stiff workhorse (it is what SciPy's `solve_ivp` exposes as
  "Radau"'s cheap sibling and MATLAB's `ode23tb`).
* **Matrix-free Newton**: each implicit stage solves
  `z = rhs + h*d*f(t_c, z)` with a fixed, trace-time-static number of
  Newton iterations; the inner linear system `(I - h*d*J)dz = res` is
  solved by a fixed-iteration GMRES whose Arnoldi loop is UNROLLED at
  trace time (static shapes, reverse-differentiable — `lax.while_loop`
  based Krylov solvers are not) with J applied via `jax.jvp`.  No Jacobian
  is ever materialized: the CNF state is the raveled batch, whose true
  Jacobian is block-diagonal across samples, exactly the structure Krylov
  methods exploit.

Select with `SolverOptions(method="trbdf2")`.  Fixed iteration counts keep
every shape static under `jit`; a non-converged Newton inflates the
embedded error estimate and the PI controller rejects the step, so
robustness degrades to smaller steps rather than to wrong answers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ESDIRKTableau:
    """Diagonally-implicit tableau with explicit first stage.

    `a` rows include the diagonal: row i (i >= 1) has i+1 entries and
    a[i][i] == d.  Stiffly accurate (b equals the last row of a), so the
    last stage derivative is f at the accepted point — the FSAL register
    stays valid and `_attempt_step` needs no extra evaluation.
    """

    name: str
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    btilde: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    d: float
    fsal: bool = True
    newton_iters: int = 4
    gmres_iters: int = 8
    btilde3: Optional[Tuple[float, ...]] = None

    @property
    def num_stages(self) -> int:
        return len(self.b)

    @property
    def nfe_per_attempt(self) -> int:
        """f/JVP evaluations per attempted step (JVP ~ one f evaluation):
        per implicit stage, each Newton iteration costs 1 residual f plus
        `gmres_iters` JVPs."""
        n_implicit = self.num_stages - 1
        return n_implicit * self.newton_iters * (1 + self.gmres_iters)


_SQRT2 = math.sqrt(2.0)
_GAMMA = 2.0 - _SQRT2        # c of the trapezoidal sub-step
_D = _GAMMA / 2.0            # diagonal coefficient
_W = _SQRT2 / 4.0

TRBDF2 = ESDIRKTableau(
    name="trbdf2",
    a=(
        (),
        (_D, _D),
        (_W, _W, _D),
    ),
    b=(_W, _W, _D),
    # b - bhat with bhat the 3rd-order weights ((1-w)/3, (3w+1)/3, d/3)
    # of Hosea & Shampine's embedded estimator.
    btilde=((_SQRT2 - 1.0) / 3.0, -1.0 / 3.0, (2.0 - _SQRT2) / 3.0),
    c=(0.0, _GAMMA, 1.0),
    order=2,
    d=_D,
)


def _l2(x: jax.Array) -> jax.Array:
    """Gradient-safe L2 norm: the floor max() sits *inside* the sqrt, so at
    x == 0 the derivative routes through the constant branch (zero) instead
    of d/ds sqrt(s)|_0 = inf — which would otherwise turn the DIRECT scan's
    masked no-op steps (residual exactly 0) into inf * 0 = NaN cotangents."""
    sq = jnp.vdot(x, x).real.astype(x.dtype)
    return jnp.sqrt(jnp.maximum(sq, jnp.asarray(1e-30, x.dtype)))


def _gmres_fixed(mv: Callable[[jax.Array], jax.Array], b: jax.Array,
                 m: int) -> jax.Array:
    """m-step GMRES (single Arnoldi cycle, unrolled; no restarts).

    Returns the least-squares minimizer of ||b - A x|| over the Krylov
    space span{b, Ab, ..., A^{m-1} b}.  All shapes static; differentiable.
    """
    dtype = b.dtype
    safe_norm = _l2
    bnorm = safe_norm(b)
    q0 = b / bnorm
    vs = [q0]
    h = [[jnp.zeros((), dtype) for _ in range(m)] for _ in range(m + 1)]
    for j in range(m):
        w = mv(vs[j])
        wnorm0 = safe_norm(w)
        for i in range(j + 1):  # modified Gram-Schmidt
            hij = jnp.vdot(vs[i], w).real.astype(dtype)
            h[i][j] = hij
            w = w - hij * vs[i]
        hn = safe_norm(w)
        # Happy-breakdown mask: when the Krylov space saturates (e.g. J is a
        # multiple of I — dimension 1), the post-orthogonalization residual is
        # pure roundoff.  Normalizing that noise would inject a garbage basis
        # vector that poisons the least-squares solve, so kill the direction
        # instead: zeroed vectors propagate zeros through mv() and the
        # Tikhonov-floored solve ignores their columns.  The division stays in
        # the live branch only (jnp.where AFTER a safe divisor) so reverse-mode
        # never sees d(w/eps) = inf * 0 = NaN.
        alive = jax.lax.stop_gradient(hn > 1e-5 * wnorm0)
        hn_div = jnp.where(alive, hn, jnp.ones((), dtype))
        h[j + 1][j] = jnp.where(alive, hn, jnp.zeros((), dtype))
        vs.append(jnp.where(alive, w, jnp.zeros_like(w)) / hn_div)
    H = jnp.stack([jnp.stack(row) for row in h])          # (m+1, m)
    e1 = jnp.zeros((m + 1,), dtype).at[0].set(bnorm)
    # Tiny dense LS solve via normal equations (H is (m+1)xm with m <= 8).
    # The Tikhonov term must be RELATIVE to the Gram matrix's scale: at Krylov
    # saturation (m exceeds the reachable dimension, routine when the state is
    # small or J has few distinct eigenvalues) a late Hessenberg column is
    # linearly dependent on earlier ones, G is singular to f32 precision
    # (~1e-7 relative), and an absolute 1e-12 floor leaves LU emitting inf.
    # lam ~ 1e-5 * mean-column-energy keeps the solve s.p.d. and bounded; the
    # ~1e-5 relative bias in the Newton direction is far below the step
    # controller's truncation-error scale, and the damped Newton absorbs it.
    G = H.T @ H
    lam = 1e-5 * (jnp.trace(G) / m) + jnp.asarray(1e-12, dtype)
    A = G + lam * jnp.eye(m, dtype=dtype)
    y = jnp.linalg.solve(A, H.T @ e1)
    x = jnp.zeros_like(b)
    for j in range(m):
        x = x + y[j] * vs[j]
    return x


def _newton_stage(fi: Callable[[jax.Array], jax.Array], rhs: jax.Array,
                  z0: jax.Array, dtd: jax.Array, newton_iters: int,
                  gmres_iters: int) -> jax.Array:
    """Solve z = rhs + dtd * fi(z) with fixed damped Newton/GMRES iterations.

    The update is capped at 100x the predictor's scale (a trust region).  On
    an over-ambitious dt the undamped iteration can overflow (inf - inf =
    NaN); the controller would reject that attempt anyway, but NaN *forward*
    intermediates poison reverse-mode through the rejected branch (0 * NaN)
    in the DIRECT scan path.  Damping keeps every intermediate finite for
    polynomially-bounded fields (CNF nets are tanh/planar — bounded), so a
    diverging attempt surfaces as a large-but-finite error estimate and a
    clean rejection.  Near the solution the cap is inactive and plain Newton
    convergence is untouched.
    """
    dtype = z0.dtype
    cap = 100.0 * (1.0 + _l2(z0))
    z = z0
    for _ in range(newton_iters):
        fz = fi(z)
        res = z - rhs - dtd * fz

        def mv(v, z=z):
            return v - dtd * jax.jvp(fi, (z,), (v,))[1]

        dz = _gmres_fixed(mv, res, gmres_iters)
        # Denominator floored at 1e-6 (damping is inactive there anyway,
        # cap >= 100): an unfloored 1e-15 norm makes the backward pass's
        # d(cap/n)/dn ~ cap/n^2 overflow f32 to inf, and the zero cotangent
        # of the unselected minimum() branch times inf is NaN.
        dznorm = jnp.maximum(_l2(dz), jnp.asarray(1e-6, dtype))
        dz = dz * jnp.minimum(jnp.asarray(1.0, dtype), cap / dznorm)
        z = z - dz
    return z


def esdirk_step(
    f: Callable[[jax.Array, jax.Array], jax.Array],
    tab: ESDIRKTableau,
    t: jax.Array,
    dt: jax.Array,
    y: jax.Array,
    k1: jax.Array,
) -> Tuple[jax.Array, Tuple[jax.Array, None], jax.Array]:
    """One ESDIRK step; same contract as `_rk_step` (y_new, (err, None), k_last).

    Stage derivatives are recovered algebraically, k_i = (z_i - rhs_i)/(h d)
    — exact at the Newton solution, free of extra f evaluations, and safe at
    the masked dt=0 no-op steps of the DIRECT scan path (z == rhs there, so
    k_i == 0 and the step is the identity, matching the explicit path).
    """
    # The Newton/GMRES internals (vdots, the tiny dense solve) must run at
    # full f32: reduced-precision matmul rounding would sit above the Newton
    # residuals being resolved, inflate the embedded error estimate and
    # collapse dt — the same noise-floor failure
    # `SolverOptions.stage_precision` guards against for the field itself.
    with jax.default_matmul_precision("highest"):
        return _esdirk_step_impl(f, tab, t, dt, y, k1)


def _esdirk_step_impl(f, tab, t, dt, y, k1):
    dtype = y.dtype
    dtd = dt * jnp.asarray(tab.d, dtype)
    dtd_safe = jnp.where(dtd == 0.0, jnp.ones((), dtype), dtd)

    ks = [k1]
    for i in range(1, tab.num_stages):
        rhs = y
        for j in range(i):
            aij = tab.a[i][j]
            if aij != 0.0:
                rhs = rhs + (dt * jnp.asarray(aij, dtype)) * ks[j]
        ti = t + jnp.asarray(tab.c[i], dtype) * dt

        def fi(z, ti=ti):
            return f(ti, z)

        z0 = rhs + dtd * ks[i - 1]  # predictor from the previous stage slope
        z = _newton_stage(fi, rhs, z0, dtd, tab.newton_iters, tab.gmres_iters)
        ks.append((z - rhs) / dtd_safe)

    y_new = y
    for i, bi in enumerate(tab.b):
        if bi != 0.0:
            y_new = y_new + (dt * jnp.asarray(bi, dtype)) * ks[i]
    err = jnp.zeros_like(y)
    for i, wi in enumerate(tab.btilde):
        if wi != 0.0:
            err = err + (dt * jnp.asarray(wi, dtype)) * ks[i]
    return y_new, (err, None), ks[-1]


__all__ = ["ESDIRKTableau", "TRBDF2", "esdirk_step"]
