"""Stiff fallback (TR-BDF2 ESDIRK, `ode/implicit.py`): accuracy, L-stability
payoff on a stiff problem, and gradients through the DIRECT scan path.

The reference inherits its stiff fallback from Julia's `DefaultODEAlgorithm`
(`/root/reference/src/base_icnf.jl:141`); here it is an explicit opt-in
(`SolverOptions(method="trbdf2")`) because CNF fields are measured non-stiff
(docs/SOLVER_PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from continuousnf_tpu.ode import odeint, odeint_with_stats
from continuousnf_tpu.ode.implicit import TRBDF2
from continuousnf_tpu.types import Adjoint, SolverOptions

E1 = float(np.exp(-1.0))
DECAY = lambda t, y, args: -y * args["rate"]


def test_trbdf2_accuracy_nonstiff():
    opts = SolverOptions(method="trbdf2", adjoint=Adjoint.NONE, rtol=1e-4, atol=1e-7)
    yT, stats = odeint_with_stats(
        DECAY, jnp.ones((4,)), 0.0, 1.0, {"rate": jnp.asarray(1.0)}, opts
    )
    np.testing.assert_allclose(np.asarray(yT), E1, rtol=1e-3)
    assert int(stats.accepted) > 0


def test_trbdf2_tableau_consistency():
    # Row sums of a equal c, and b is the last row of a (stiffly accurate,
    # so the FSAL register holds f at the accepted point).
    for i, row in enumerate(TRBDF2.a):
        np.testing.assert_allclose(sum(row), TRBDF2.c[i], atol=1e-15)
    np.testing.assert_allclose(TRBDF2.a[-1], TRBDF2.b, atol=1e-15)
    # btilde sums to 0 (both weight vectors are consistent quadratures).
    np.testing.assert_allclose(sum(TRBDF2.btilde), 0.0, atol=1e-15)


def test_trbdf2_beats_explicit_on_stiff_problem():
    """y' = -lam*(y - cos t) - sin t, y(0)=2: fast transient onto the slow
    manifold y=cos t.  An explicit method's stable dt is ~2.8/lam forever;
    TR-BDF2 (L-stable) steps at accuracy-limited sizes once the transient
    resolves."""
    lam = 2000.0

    def f(t, y, args):
        return -lam * (y - jnp.cos(t)) - jnp.sin(t)

    y0 = jnp.asarray([2.0])
    kw = dict(rtol=1e-3, atol=1e-6)
    o_imp = SolverOptions(method="trbdf2", adjoint=Adjoint.NONE, **kw)
    o_exp = SolverOptions(method="tsit5", adjoint=Adjoint.NONE, max_steps=20_000, **kw)
    y_imp, s_imp = odeint_with_stats(f, y0, 0.0, 2.0, None, o_imp)
    y_exp, s_exp = odeint_with_stats(f, y0, 0.0, 2.0, None, o_exp)
    exact = float(np.cos(2.0) + np.exp(-lam * 2.0))
    np.testing.assert_allclose(float(y_imp[0]), exact, atol=5e-3)
    np.testing.assert_allclose(float(y_exp[0]), exact, atol=5e-3)
    # The stability-limited explicit method needs ~ lam*span/2.8 ~ 1400 steps;
    # the implicit one should use far fewer ACCEPTED steps.
    assert int(s_imp.accepted) * 5 < int(s_exp.accepted), (
        int(s_imp.accepted),
        int(s_exp.accepted),
    )


@pytest.mark.slow
def test_trbdf2_gradient_direct_matches_fd():
    def f(t, y, args):
        return -(y ** 3) + jnp.sin(t) * args

    opts = SolverOptions(
        method="trbdf2", adjoint=Adjoint.DIRECT, rtol=1e-5, atol=1e-8,
        direct_max_steps=64,
    )

    def loss(y0, a):
        yT = odeint(f, y0, 0.0, 1.0, a, opts)
        return jnp.sum(yT)

    y0 = jnp.asarray([0.7, 1.3])
    a = jnp.asarray(0.5)
    g_y0, g_a = jax.grad(loss, argnums=(0, 1))(y0, a)
    assert np.all(np.isfinite(np.asarray(g_y0))) and np.isfinite(float(g_a))
    h = 1e-3
    for i in range(2):
        e = jnp.zeros_like(y0).at[i].set(h)
        fd = (loss(y0 + e, a) - loss(y0 - e, a)) / (2 * h)
        np.testing.assert_allclose(float(g_y0[i]), float(fd), rtol=2e-2, atol=1e-4)
    fd_a = (loss(y0, a + h) - loss(y0, a - h)) / (2 * h)
    np.testing.assert_allclose(float(g_a), float(fd_a), rtol=2e-2, atol=1e-4)


@pytest.mark.slow
def test_trbdf2_backsolve_gradient_finite():
    opts = SolverOptions(method="trbdf2", adjoint=Adjoint.BACKSOLVE, rtol=1e-4, atol=1e-7)

    def loss(y0):
        return jnp.sum(odeint(DECAY, y0, 0.0, 1.0, {"rate": jnp.asarray(1.0)}, opts))

    g = jax.grad(loss)(jnp.ones((3,)))
    # d/dy0 sum(y0 * e^-1) = e^-1 per coordinate.
    np.testing.assert_allclose(np.asarray(g), E1, rtol=5e-3)
