"""BACKSOLVE (continuous adjoint) gradients of the CNF loss against DIRECT
(backprop through the discrete solve) on the same model, inputs and probes.

The two differentiate the same ODE solution — optimize-then-discretize vs
discretize-then-optimize — so at a tight solver tolerance their gradients
agree to about the tolerance's effect on the trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnf_tpu as cnf
from continuousnf_tpu import Adjoint, Mode

_SOLVER = cnf.SolverOptions(rtol=1e-6, atol=1e-8, direct_max_steps=64)

# name -> (variant, net, nvars, naug, n_cond)
_NETS = {
    "mlp2_16_48_16": (cnf.RNODE, cnf.MLP((16, 48, 16)), 8, 8, 0),
    "chain3": (cnf.RNODE, cnf.MLP((6, 16, 16, 6)), 6, 0, 0),
    "chain_dz1": (cnf.RNODE, cnf.MLP((1, 8, 8, 1)), 1, 0, 0),
    "cond": (cnf.CondRNODE, cnf.MLP((5, 12, 2)), 2, 0, 3),
}

# name -> (mode, compute_mode)
_MODES = {
    "vjp_k1": (Mode.TRAIN, cnf.VecJacMode(1)),
    "vjp_k3": (Mode.TRAIN, cnf.VecJacMode(3)),
    "jvp_k1": (Mode.TRAIN, cnf.JacVecMode(1)),
    "jvp_k3": (Mode.TRAIN, cnf.JacVecMode(3)),
    "exact": (Mode.TRAIN, cnf.VecJacMode(exact_trace=True)),
    "test_logpdf": (Mode.TEST, cnf.VecJacMode()),
}


@pytest.mark.parametrize("mode_name", list(_MODES))
@pytest.mark.parametrize("net_name", list(_NETS))
def test_backsolve_matches_direct(net_name, mode_name):
    variant, nn, nvars, naug, n_cond = _NETS[net_name]
    mode, cm = _MODES[mode_name]
    icnf = cnf.construct(
        variant, nn, nvars, naug, tspan=(0.0, 1.0), lam3=1e-2 if naug else 0.0,
        compute_mode=cm, solver=_SOLVER,
    )
    direct = dataclasses.replace(
        icnf, solver=dataclasses.replace(_SOLVER, adjoint=Adjoint.DIRECT)
    )
    B = 8
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (B, nvars))
    ys = jax.random.normal(jax.random.PRNGKey(4), (B, n_cond)) if n_cond else None
    key = jax.random.PRNGKey(3) if mode == Mode.TRAIN else None
    eps = None
    if mode == Mode.TRAIN and not cm.exact_trace:
        eps = icnf.draw_eps(jax.random.PRNGKey(2), B)

    def grad_of(model):
        return jax.jit(
            jax.grad(lambda p: cnf.loss(model, mode, xs, p, ys=ys, key=key, eps=eps))
        )(ps)

    g_b, g_d = grad_of(icnf), grad_of(direct)
    for a, b in zip(jax.tree.leaves(g_b), jax.tree.leaves(g_d)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.all(np.isfinite(a))
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)
        assert err < 2e-3, err
    assert any(float(jnp.max(jnp.abs(x))) > 0 for x in jax.tree.leaves(g_b))
