"""The XLA solve path against an analytic reference: a linear flow.

A single identity-activation Dense layer without bias gives the affine field
z' = z A + c, with c = ys B for conditional models (the layer sees
[z, ys] and W = [A; B]).  Its solution and log-density are closed-form:

    z(t) = (z0 + c A^-1) expm(A t) - c A^-1
    log p(x) = log N(z(T)) + T tr(A)                       (TEST)
    log p(x) = log N(z(T)) + T eps A eps^T                  (TRAIN, 1 probe)

so every tableau, trajectory grid, forced stepping point and steered
endpoint can be checked against exact numbers instead of another solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

import continuousnf_tpu as cnf
from continuousnf_tpu import Mode
from continuousnf_tpu.core.icnf import _steer_tspan

NVARS, NCOND, B = 3, 2, 16
_TIGHT = dict(rtol=1e-6, atol=1e-8)


def _model(cond: bool, solver=cnf.SolverOptions(**_TIGHT), steer_rate: float = 0.0):
    n_in = NVARS + (NCOND if cond else 0)
    nn = cnf.MLP((n_in, NVARS), activation=None, final_activation=None)
    icnf = cnf.construct(
        cnf.CondFFJORD if cond else cnf.FFJORD, nn, NVARS, 0,
        tspan=(0.0, 1.0), steer_rate=steer_rate, solver=solver,
    )
    rng = np.random.default_rng(0)
    w = 0.4 * rng.standard_normal((n_in, NVARS)) - 0.3 * np.eye(n_in, NVARS)
    ps = ({"w": jnp.asarray(w, jnp.float32), "b": jnp.zeros((NVARS,), jnp.float32)},)
    xs = jnp.asarray(rng.uniform(-1.0, 1.0, (B, NVARS)), jnp.float32)
    ys = jnp.asarray(rng.standard_normal((B, NCOND)), jnp.float32) if cond else None
    eps = jnp.asarray(rng.standard_normal((1, B, NVARS)), jnp.float32)
    return icnf, ps, xs, ys, eps, w


def _z_at(w, xs, ys, t):
    a = w[:NVARS].astype(np.float64)
    z0 = np.asarray(xs, np.float64)
    if ys is None:
        return z0 @ expm(a * t)
    c = np.asarray(ys, np.float64) @ w[NVARS:].astype(np.float64)
    shift = np.linalg.solve(a.T, c.T).T  # c A^-1
    return (z0 + shift) @ expm(a * t) - shift


def _logp(w, xs, ys, t, eps=None):
    z = _z_at(w, xs, ys, t)
    log_n = -0.5 * np.sum(z * z, axis=-1) - 0.5 * NVARS * np.log(2 * np.pi)
    a = w[:NVARS].astype(np.float64)
    if eps is None:
        return log_n + t * np.trace(a)
    e = np.asarray(eps[0], np.float64)
    return log_n + t * np.einsum("bi,ij,bj->b", e, a, e)


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond"])
@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST], ids=["train", "test"])
@pytest.mark.parametrize("method", ["tsit5", "dopri5", "bosh3", "verner65", "dop853"])
def test_tableau_matches_linear_flow(method, mode, cond):
    icnf, ps, xs, ys, eps, w = _model(cond, cnf.SolverOptions(method=method, **_TIGHT))
    if mode == Mode.TRAIN:
        lp, _, st = cnf.inference(icnf, mode, xs, ps, ys=ys, key=jax.random.PRNGKey(0), eps=eps)
        want = _logp(w, xs, ys, 1.0, eps)
    else:
        lp, _, st = cnf.inference(icnf, mode, xs, ps, ys=ys)
        want = _logp(w, xs, ys, 1.0)
    np.testing.assert_allclose(np.asarray(lp), want, rtol=1e-4, atol=1e-4)
    assert 0 < int(st.accepted) <= int(st.steps) < icnf.solver.max_steps


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond"])
def test_saveat_trajectory_matches_linear_flow(cond):
    grid = (0.0, 0.25, 0.5, 0.75, 1.0)
    icnf, ps, xs, ys, _, w = _model(cond, cnf.SolverOptions(saveat=grid, **_TIGHT))
    lp, _, _, (ts, zs) = cnf.inference(icnf, Mode.TEST, xs, ps, ys=ys, trajectory=True)
    np.testing.assert_allclose(np.asarray(ts), grid, atol=1e-7)
    assert zs.shape == (len(grid), B, NVARS)
    for k, t in enumerate(grid):
        np.testing.assert_allclose(np.asarray(zs[k]), _z_at(w, xs, ys, t), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lp), _logp(w, xs, ys, 1.0), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond"])
def test_tstops_match_linear_flow(cond):
    icnf, ps, xs, ys, _, w = _model(cond, cnf.SolverOptions(tstops=(0.3, 0.7), **_TIGHT))
    lp, _, st = cnf.inference(icnf, Mode.TEST, xs, ps, ys=ys)
    np.testing.assert_allclose(np.asarray(lp), _logp(w, xs, ys, 1.0), rtol=1e-4, atol=1e-4)
    assert int(st.steps) >= 3  # at least one step per segment


def test_steered_endpoint_matches_linear_flow():
    """TRAIN steering jitters t1 by Delta_t * U(-rate, rate); the solve must
    land exactly on the jittered endpoint."""
    icnf, ps, xs, _, eps, w = _model(False, steer_rate=0.2)
    key = jax.random.PRNGKey(5)
    _, t1 = _steer_tspan(icnf, Mode.TRAIN, jax.random.split(key)[1])
    t1 = float(t1)
    assert t1 != 1.0 and 0.8 <= t1 <= 1.2
    lp, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps)
    np.testing.assert_allclose(np.asarray(lp), _logp(w, xs, None, t1, eps), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST], ids=["train", "test"])
def test_max_steps_caps_the_solve(mode):
    icnf, ps, xs, _, eps, w = _model(False, cnf.SolverOptions(max_steps=3, **_TIGHT))
    kw = {"key": jax.random.PRNGKey(0), "eps": eps} if mode == Mode.TRAIN else {}
    lp, _, st = cnf.inference(icnf, mode, xs, ps, **kw)
    assert int(st.steps) == 3 and int(st.accepted) <= 3
    # Three steps at rtol 1e-6 cannot reach t1: the result is not the flow's.
    want = _logp(w, xs, None, 1.0, eps if mode == Mode.TRAIN else None)
    assert np.max(np.abs(np.asarray(lp) - want)) > 1e-3


def test_default_tolerances_match_linear_flow():
    icnf, ps, xs, _, _, w = _model(False, cnf.SolverOptions())
    lp, _, st = cnf.inference(icnf, Mode.TEST, xs, ps)
    # Default tolerances (rtol 1e-3, atol 1e-6): agreement at that level.
    np.testing.assert_allclose(np.asarray(lp), _logp(w, xs, None, 1.0), rtol=5e-3, atol=5e-3)
    assert int(st.steps) < 100
