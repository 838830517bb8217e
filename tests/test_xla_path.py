"""XLA-path coverage on the CPU: solver counters, sampling round trips,
the lambda3 term, probe variance and stage-precision resolution — each
against an exact identity or a tight-tolerance reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnf_tpu as cnf
from continuousnf_tpu import Mode
from continuousnf_tpu.core.dynamics import TrainState, make_augmented_dynamics
from continuousnf_tpu.types import resolve_stage_precision

_TIGHT = cnf.SolverOptions(rtol=1e-6, atol=1e-8)


def _model(cond: bool, solver=cnf.SolverOptions(), **kw):
    if cond:
        return cnf.construct(cnf.CondRNODE, cnf.MLP((4, 12, 2)), 2, 0, tspan=(0.0, 1.0),
                             solver=solver, **kw)
    return cnf.construct(cnf.RNODE, cnf.MLP((4, 12, 4)), 2, 2, tspan=(0.0, 1.0),
                         solver=solver, **kw)


def _inputs(icnf, B):
    xs = jax.random.uniform(jax.random.PRNGKey(1), (B, icnf.nvars))
    ys = jax.random.normal(jax.random.PRNGKey(4), (B, 2)) if icnf.cond else None
    return xs, ys


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond"])
def test_adjoint_stats_counters(cond):
    """Forward stats equal the inference solve's; backward NFE follows the
    tsit5 accounting (6 per attempt + 2 for the initial-step pick)."""
    icnf = _model(cond)
    ps = icnf.init(jax.random.PRNGKey(0))
    xs, ys = _inputs(icnf, 16)
    key = jax.random.PRNGKey(3)
    eps = icnf.draw_eps(jax.random.PRNGKey(2), 16)
    _, _, st = cnf.inference(icnf, Mode.TRAIN, xs, ps, ys=ys, key=key, eps=eps)
    fwd, bwd = cnf.adjoint_stats(icnf, Mode.TRAIN, xs, ps, ys=ys, key=key, eps=eps)
    assert (int(fwd.steps), int(fwd.accepted), int(fwd.nfe)) == (
        int(st.steps), int(st.accepted), int(st.nfe))
    assert int(fwd.nfe) == 6 * int(fwd.steps) + 2
    assert 0 < int(bwd.accepted) <= int(bwd.steps)
    assert int(bwd.nfe) == 6 * int(bwd.steps) + 2


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond"])
@pytest.mark.parametrize("n", [None, 64], ids=["B1", "B64"])
def test_generate_round_trip(n, cond):
    """Samples transported forward in TEST mode land on the base draws they
    were generated from."""
    icnf = _model(True, _TIGHT) if cond else cnf.construct(
        cnf.RNODE, cnf.MLP((2, 12, 2)), 2, 0, tspan=(0.0, 1.0), solver=_TIGHT)
    ps = icnf.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(7)
    B = 1 if n is None else n
    ys = jax.random.normal(jax.random.PRNGKey(4), (B, 2)) if cond else None
    samples = cnf.generate(icnf, Mode.TEST, ps, n, ys=ys, key=key)
    assert samples.shape == ((icnf.nvars,) if n is None else (n, icnf.nvars))
    z1 = icnf.base_sample(jax.random.split(key, 3)[0], (B,))
    _, _, _, (_, zs) = cnf.inference(icnf, Mode.TEST, samples, ps, ys=ys, trajectory=True)
    zT = np.asarray(zs[-1]).reshape(B, -1)
    np.testing.assert_allclose(zT, np.asarray(z1), rtol=1e-3, atol=1e-4)


def test_lam3_adds_mean_augmented_norm():
    """loss(lam3) - loss(0) == lam3 * mean ||z_aug(T)|| (same key, probes)."""
    icnf = _model(False, lam3=0.5)
    icnf0 = dataclasses.replace(icnf, lam3=0.0)
    ps = icnf.init(jax.random.PRNGKey(0))
    xs, _ = _inputs(icnf, 16)
    key = jax.random.PRNGKey(3)
    eps = icnf.draw_eps(jax.random.PRNGKey(2), 16)
    _, regs, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps)
    _, _, _, (_, zs) = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps, trajectory=True)
    np.testing.assert_allclose(
        np.asarray(regs.a), np.linalg.norm(np.asarray(zs[-1])[:, 2:], axis=-1), rtol=1e-2, atol=1e-4
    )
    l3 = cnf.loss(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps)
    l0 = cnf.loss(icnf0, Mode.TRAIN, xs, ps, key=key, eps=eps)
    np.testing.assert_allclose(float(l3 - l0), 0.5 * float(jnp.mean(regs.a)), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ad", [cnf.ADMode.VJP, cnf.ADMode.JVP], ids=["vjp", "jvp"])
def test_k_probe_variance_scales_as_inverse_k(ad):
    """The K-probe Hutchinson estimate is unbiased for the exact trace and
    its variance falls as 1/K."""
    nn = cnf.MLP((4, 12, 4))
    ps = nn.init(jax.random.PRNGKey(0), jnp.float32)
    N = 4000
    z = jnp.broadcast_to(jax.random.normal(jax.random.PRNGKey(1), (1, 4)), (N, 4))
    zero = jnp.zeros((N,))
    state = TrainState(z=z, dlogp=zero, reg_e=zero, reg_n=zero)
    exact = make_augmented_dynamics(nn, Mode.TEST, cnf.ComputeMode(ad=ad), False, False)
    tr = -float(exact(0.0, cnf.core.dynamics.TestState(z=z[:1], dlogp=zero[:1]), {"ps": ps}).dlogp[0])

    def estimates(K, seed):
        cm = cnf.ComputeMode(ad=ad, num_probes=K)
        f = make_augmented_dynamics(nn, Mode.TRAIN, cm, False, False)
        eps = jax.random.normal(jax.random.PRNGKey(seed), (K, N, 4))
        return -np.asarray(f(0.0, state, {"ps": ps, "eps": eps}).dlogp, np.float64)

    e1, e4 = estimates(1, 10), estimates(4, 11)
    for e in (e1, e4):
        assert abs(e.mean() - tr) < 4 * e.std() / np.sqrt(N)
    ratio = e4.var() / e1.var()
    assert 0.18 < ratio < 0.34, ratio


def test_auto_stage_precision_resolves_to_highest():
    for rtol in (1e-2, 1e-3, 1e-6):
        assert resolve_stage_precision(cnf.SolverOptions(rtol=rtol)) == "highest"
    for p in ("default", "high", "highest", "float32"):
        assert resolve_stage_precision(cnf.SolverOptions(stage_precision=p)) == p


def test_auto_stage_precision_solve_equals_highest():
    icnf = _model(False)
    hi = dataclasses.replace(icnf, solver=dataclasses.replace(icnf.solver, stage_precision="highest"))
    ps = icnf.init(jax.random.PRNGKey(0))
    xs, _ = _inputs(icnf, 16)
    a = cnf.inference(icnf, Mode.TEST, xs, ps)
    b = cnf.inference(hi, Mode.TEST, xs, ps)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert int(a[2].steps) == int(b[2].steps)
