"""ICNF core tests.

The parameterized matrix mirrors the reference's call-test suite
(`/root/reference/test/call_tests.jl`): {6 variants} x {Train, Test} x
{reverse, forward AD} x {plain, augmented+steered}, nvars=2, batch=4 — every
public op returns finite values and gradients w.r.t. both params and inputs
exist.  The numerics tests (density normalization, Hutchinson->exact
convergence) are stronger than anything in the reference suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnf_tpu as cnf
from continuousnf_tpu import Mode

NVARS = 2
BATCH = 4
N_COND = 2
FAST_SOLVER = cnf.SolverOptions(rtol=1e-3, atol=1e-5)

VARIANTS = [
    cnf.RNODE,
    cnf.FFJORD,
    cnf.Planar,
    cnf.CondRNODE,
    cnf.CondFFJORD,
    cnf.CondPlanar,
]


def _build(variant, compute_mode, augmented, steered):
    naug = NVARS if augmented else 0
    n_in = NVARS + naug
    is_cond = variant in (cnf.CondRNODE, cnf.CondFFJORD, cnf.CondPlanar)
    n_cond = N_COND if is_cond else 0
    if variant in (cnf.Planar, cnf.CondPlanar):
        nn = cnf.PlanarLayer(n_in, jnp.tanh, n_cond=n_cond)
    else:
        nn = cnf.MLP((n_in + n_cond, 2 * n_in, n_in))
    icnf = cnf.construct(
        variant,
        nn,
        NVARS,
        naug,
        steer_rate=0.1 if steered else 0.0,
        lam3=1e-2 if augmented else 0.0,
        solver=FAST_SOLVER,
    )
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (BATCH, NVARS))
    ys = jax.random.normal(jax.random.PRNGKey(2), (BATCH, N_COND)) if is_cond else None
    return icnf, ps, xs, ys


def _all_finite(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "aug+steer"])
@pytest.mark.parametrize("ad", ["vjp", "jvp"])
@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST], ids=["train", "test"])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.__name__)
def test_call_matrix(variant, mode, ad, augmented):
    compute_mode = cnf.VecJacMode() if ad == "vjp" else cnf.JacVecMode()
    icnf, ps, xs, ys = _build(variant, compute_mode, augmented, steered=augmented)
    key = jax.random.PRNGKey(7)

    logpx, regs, stats = cnf.inference(icnf, mode, xs, ps, ys=ys, key=key)
    assert logpx.shape == (BATCH,)
    assert _all_finite((logpx, regs))
    assert int(stats.accepted) > 0

    samples = cnf.generate(icnf, mode, ps, BATCH, ys=ys, key=key)
    assert samples.shape == (BATCH, NVARS)
    assert _all_finite(samples)

    l = cnf.loss(icnf, mode, xs, ps, ys=ys, key=key)
    assert np.isfinite(float(l))


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST], ids=["train", "test"])
@pytest.mark.parametrize("variant", [cnf.RNODE, cnf.CondFFJORD], ids=lambda v: v.__name__)
def test_gradients_exist(variant, mode):
    # Reference asserts grads w.r.t. ps and xs exist under both AD modes
    # (`test/call_tests.jl:239-252`); we check finiteness and nonzeroness.
    icnf, ps, xs, ys = _build(variant, cnf.VecJacMode(), augmented=True, steered=True)
    key = jax.random.PRNGKey(7)

    g_ps = jax.grad(lambda p: cnf.loss(icnf, mode, xs, p, ys=ys, key=key))(ps)
    assert _all_finite(g_ps)
    total = sum(float(jnp.sum(jnp.abs(l))) for l in jax.tree_util.tree_leaves(g_ps))
    assert total > 0

    g_xs = jax.grad(lambda x: cnf.loss(icnf, mode, x, ps, ys=ys, key=key))(xs)
    assert _all_finite(g_xs)
    assert float(jnp.sum(jnp.abs(g_xs))) > 0


def test_vector_mode_parity():
    # Rank-1 input behaves like a batch of one (reference VectorMode).
    icnf, ps, xs, _ = _build(cnf.FFJORD, cnf.VecJacMode(), False, False)
    lp_b, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    lp_1, _, _ = cnf.inference(icnf, Mode.TEST, xs[0], ps)
    assert lp_1.shape == ()
    np.testing.assert_allclose(float(lp_1), float(lp_b[0]), rtol=1e-4, atol=1e-5)


def test_density_normalizes_1d():
    # Exact-trace log-density must integrate to 1 — validates the
    # instantaneous change-of-variables end to end (untrained net).
    nn = cnf.MLP((1, 8, 1))
    icnf = cnf.construct(cnf.FFJORD, nn, 1, 0)
    ps = icnf.init(jax.random.PRNGKey(3))
    xs = jnp.linspace(-8, 8, 2001)[:, None]
    logpx, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    integral = float(jnp.trapezoid(jnp.exp(logpx), xs[:, 0]))
    np.testing.assert_allclose(integral, 1.0, atol=2e-3)


def test_density_normalizes_2d():
    nn = cnf.MLP((2, 12, 2))
    icnf = cnf.construct(cnf.FFJORD, nn, 2, 0)
    ps = icnf.init(jax.random.PRNGKey(5))
    g = jnp.linspace(-6, 6, 121)
    X, Y = jnp.meshgrid(g, g)
    pts = jnp.stack([X.ravel(), Y.ravel()], -1)
    lp, _, _ = cnf.inference(icnf, Mode.TEST, pts, ps)
    integral = float(jnp.sum(jnp.exp(lp)) * (g[1] - g[0]) ** 2)
    np.testing.assert_allclose(integral, 1.0, atol=5e-3)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
def test_hutchinson_converges_to_exact(ad):
    nn = cnf.MLP((2, 12, 2))
    make = cnf.VecJacMode if ad == "vjp" else cnf.JacVecMode
    icnf_ex = cnf.construct(cnf.FFJORD, nn, 2, 0)
    icnf_k = cnf.construct(
        cnf.FFJORD, nn, 2, 0,
        compute_mode=make(num_probes=256, eps_dist=cnf.EpsDist.RADEMACHER),
    )
    ps = icnf_ex.init(jax.random.PRNGKey(5))
    xs = jax.random.normal(jax.random.PRNGKey(8), (8, 2))
    lp_ex, _, _ = cnf.inference(icnf_ex, Mode.TEST, xs, ps)
    lp_h, _, _ = cnf.inference(icnf_k, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(9))
    np.testing.assert_allclose(np.asarray(lp_h), np.asarray(lp_ex), atol=0.05)


def test_train_inference_deterministic_given_key():
    icnf, ps, xs, _ = _build(cnf.RNODE, cnf.VecJacMode(), True, True)
    key = jax.random.PRNGKey(11)
    lp1, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key)
    lp2, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key)
    np.testing.assert_array_equal(np.asarray(lp1), np.asarray(lp2))
    lp3, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(12))
    assert not np.allclose(np.asarray(lp1), np.asarray(lp3))


def test_steering_jitters_only_train_mode():
    icnf, ps, xs, _ = _build(cnf.RNODE, cnf.VecJacMode(), True, True)
    # TEST mode ignores the steering (reference steer_tspan Mode fallback)
    lp1, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    lp2, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    np.testing.assert_array_equal(np.asarray(lp1), np.asarray(lp2))


def test_construct_defaults_match_reference():
    nn = cnf.MLP((2, 4, 2))
    r = cnf.construct(cnf.RNODE, nn, 2)
    f = cnf.construct(cnf.FFJORD, nn, 2)
    assert r.lam1 == pytest.approx(1e-2) and r.lam2 == pytest.approx(1e-2)
    assert f.lam1 == 0.0 and f.lam2 == 0.0
    assert r.tspan == (0.0, 1.0) and not r.cond
    c = cnf.construct(cnf.CondRNODE, cnf.MLP((4, 4, 2)), 2)
    assert c.cond


def test_callable_is_train_logpx():
    icnf, ps, xs, _ = _build(cnf.RNODE, cnf.VecJacMode(), False, False)
    key = jax.random.PRNGKey(3)
    via_call = icnf(xs, ps, key=key)
    via_inf, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key)
    np.testing.assert_array_equal(np.asarray(via_call), np.asarray(via_inf))


def test_jit_loss():
    icnf, ps, xs, _ = _build(cnf.RNODE, cnf.VecJacMode(), True, True)
    key = jax.random.PRNGKey(5)
    l_eager = cnf.loss(icnf, Mode.TRAIN, xs, ps, key=key)
    l_jit = jax.jit(lambda x, p, k: cnf.loss(icnf, Mode.TRAIN, x, p, key=k))(xs, ps, key)
    np.testing.assert_allclose(float(l_eager), float(l_jit), rtol=1e-5)


def test_calibrated_aug_noise_train_only():
    """aug_noise draws TRAIN aug inputs from N(0, sigma^2) (objective becomes
    the proper joint MLE); TEST keeps the reference's zero-filled slice, and
    the calibrated sigma makes the per-dim Gaussian density at 0 equal 1."""
    import math

    import jax
    import jax.numpy as jnp

    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode

    sigma = cnf.CALIBRATED_AUG_SIGMA
    assert abs(1.0 / math.sqrt(2.0 * math.pi * sigma**2) - 1.0) < 1e-6

    nn = cnf.MLP((2, 4, 2))
    lit = cnf.construct(cnf.RNODE, nn, 1, 1, tspan=(0.0, 0.5))
    cal = cnf.construct(cnf.RNODE, nn, 1, 1, tspan=(0.0, 0.5), aug_noise="calibrated")
    assert lit.aug_noise == 0.0 and abs(cal.aug_noise - sigma) < 1e-7

    key = jax.random.PRNGKey(0)
    ps = lit.init(key)
    xs = jnp.full((64, 1), 0.3, jnp.float32)

    # TEST mode identical (zero slice) regardless of aug_noise.
    lp_lit, _, _ = cnf.inference(lit, Mode.TEST, xs, ps)
    lp_cal, _, _ = cnf.inference(cal, Mode.TEST, xs, ps)
    assert jnp.allclose(lp_lit, lp_cal)

    # TRAIN mode: noise makes per-sample logp vary across the (identical-x)
    # batch beyond the shared-probe effect; literal zeros keep them closer.
    k = jax.random.PRNGKey(1)
    lp_t_lit, _, _ = cnf.inference(lit, Mode.TRAIN, xs, ps, key=k)
    lp_t_cal, _, _ = cnf.inference(cal, Mode.TRAIN, xs, ps, key=k)
    assert not jnp.allclose(lp_t_lit, lp_t_cal)


@pytest.mark.slow
def test_pluggable_basedist_logistic():
    """With a zero vector field the flow is the identity, so inference logp
    must equal basedist.logpdf([x, 0]) exactly and generate must return raw
    basedist draws — wiring parity with reference construct(basedist=...)
    (`/root/reference/src/base_icnf.jl:16-19`)."""
    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode
    from continuousnf_tpu.distributions import MvLogistic

    nvars, naug = 2, 1
    base = MvLogistic(dim=nvars + naug, loc=0.5, scale=2.0)
    nn = cnf.MLP((3, 4, 3))
    icnf = cnf.construct(cnf.FFJORD, nn, nvars, naug, basedist=base, tspan=(0.0, 1.0))
    ps = jax.tree.map(jnp.zeros_like, icnf.init(jax.random.PRNGKey(0)))

    xs = jax.random.normal(jax.random.PRNGKey(1), (16, nvars))
    logpx, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    z = jnp.concatenate([xs, jnp.zeros((16, naug))], axis=-1)
    np.testing.assert_allclose(
        np.asarray(logpx), np.asarray(base.logpdf(z)), rtol=1e-4, atol=1e-5
    )

    # TRAIN mode flows the same zero field; logp identical up to solver eps.
    lp_train, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(lp_train), np.asarray(logpx), rtol=1e-4, atol=1e-5)

    # generate: identity flow returns the first nvars dims of basedist draws.
    samples = cnf.generate(icnf, Mode.TEST, ps, 2048, key=jax.random.PRNGKey(3))
    assert samples.shape == (2048, nvars)
    # Logistic(0.5, 2) has mean 0.5 and std 2*pi/sqrt(3) ~ 3.63 — far from the
    # std-normal default; check the sample stats land on the logistic.
    assert abs(float(jnp.mean(samples)) - 0.5) < 0.3
    assert abs(float(jnp.std(samples)) - 3.6276) < 0.4


def test_basedist_dim_validation():
    import continuousnf_tpu as cnf
    from continuousnf_tpu.distributions import MvDiagNormal

    nn = cnf.MLP((3, 4, 3))
    with pytest.raises(ValueError, match="basedist.dim"):
        cnf.construct(cnf.FFJORD, nn, 2, 1, basedist=MvDiagNormal(dim=2))


def test_pluggable_epsdist():
    """epsdist=MvDiagNormal(scale=0) makes every Hutchinson probe zero, so
    the TRAIN dlogp/ndot estimates vanish identically — proof the probes are
    drawn from the plugged distribution (reference epsdist,
    `src/base_icnf.jl:22-25`)."""
    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode
    from continuousnf_tpu.distributions import MvDiagNormal

    nvars = 2
    nn = cnf.MLP((2, 6, 2))
    icnf = cnf.construct(
        cnf.RNODE, nn, nvars, epsdist=MvDiagNormal(dim=nvars, scale=0.0)
    )
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.normal(jax.random.PRNGKey(1), (8, nvars))
    logpx, regs, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(2))
    # zero probes => eps^T J eps = 0 => dlogp == 0 => logpx == base logpdf(zT)
    # and ndot == 0; the flow itself (and Edot) is unaffected.
    assert float(jnp.max(jnp.abs(regs.n))) == 0.0
    assert np.isfinite(np.asarray(logpx)).all()
    # Compare against the exact-trace TEST logp: TRAIN-with-zero-probes must
    # differ by exactly the (nonzero) true -int tr(J): i.e. NOT equal.
    lp_test, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    assert not np.allclose(np.asarray(logpx), np.asarray(lp_test), atol=1e-3)


def test_generate_with_stats():
    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode

    icnf = cnf.construct(cnf.FFJORD, cnf.MLP((2, 4, 2)), 2)
    ps = icnf.init(jax.random.PRNGKey(0))
    s, stats = cnf.generate(icnf, Mode.TEST, ps, 8, key=jax.random.PRNGKey(1), with_stats=True)
    assert s.shape == (8, 2)
    assert int(stats.nfe) > 0
    s2 = cnf.generate(icnf, Mode.TEST, ps, 8, key=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(s2))


def test_exact_trace_train_matches_test_logp():
    """TRAIN with exact_trace computes the exact divergence: logp must equal
    the TEST-mode exact-trace density (steering off, aug_noise 0)."""
    nn = cnf.MLP((2, 12, 2))
    icnf = cnf.construct(
        cnf.FFJORD, nn, 2, 0, compute_mode=cnf.ComputeMode(exact_trace=True),
    )
    ps = icnf.init(jax.random.PRNGKey(5))
    xs = jax.random.normal(jax.random.PRNGKey(8), (8, 2))
    lp_tr, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(9))
    lp_te, _, _ = cnf.inference(icnf, Mode.TEST, xs, ps)
    np.testing.assert_allclose(np.asarray(lp_tr), np.asarray(lp_te), atol=2e-4)


@pytest.mark.parametrize("ad", ["vjp", "jvp"])
def test_exact_trace_frobenius_rate(ad):
    """reg_n under exact_trace integrates ||J||_F; the K-probe Hutchinson
    sqrt(E||eps^T J||^2) converges to it (Rademacher, K large).  Also checks
    the closed-form tanh-MLP path against the generic AD path via a
    non-fusable 3-layer net."""
    make = cnf.VecJacMode if ad == "vjp" else cnf.JacVecMode
    nn = cnf.MLP((2, 12, 2))
    icnf_ex = cnf.construct(
        cnf.RNODE, nn, 2, 0, compute_mode=make(exact_trace=True),
    )
    icnf_k = cnf.construct(
        cnf.RNODE, nn, 2, 0,
        compute_mode=make(num_probes=512, eps_dist=cnf.EpsDist.RADEMACHER),
    )
    ps = icnf_ex.init(jax.random.PRNGKey(3))
    xs = jax.random.normal(jax.random.PRNGKey(4), (6, 2)) * 0.5
    _, regs_ex, _ = cnf.inference(icnf_ex, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(6))
    _, regs_k, _ = cnf.inference(icnf_k, Mode.TRAIN, xs, ps, key=jax.random.PRNGKey(7))
    # E||eps^T J|| <= sqrt(E||eps^T J||^2) = ||J||_F (Jensen), within ~10%
    # at K=512 for a 2x2 Jacobian: compare loosely.
    np.testing.assert_allclose(
        np.asarray(regs_k.n), np.asarray(regs_ex.n), rtol=0.15)


def test_exact_trace_closed_form_matches_generic():
    """The tanh-MLP closed-form (trace, ||J||_F) equals the AD identity-basis
    path on the same params/points."""
    from continuousnf_tpu.core.dynamics import (
        _exact_train_field, exact_tanh_mlp_trace_fro)

    nn = cnf.MLP((3, 8, 3))
    ps = nn.init(jax.random.PRNGKey(0), jnp.float32)
    z = jax.random.normal(jax.random.PRNGKey(1), (5, 3))
    dz_c, tr_c, fro_c = exact_tanh_mlp_trace_fro(ps, z)
    field = _exact_train_field(nn.apply, cnf.ComputeMode(exact_trace=True))
    dz_g, tr_g, fro_g = field(ps, z, None)
    np.testing.assert_allclose(np.asarray(dz_c), np.asarray(dz_g), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tr_c), np.asarray(tr_g), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fro_c), np.asarray(fro_g), atol=1e-5)


@pytest.mark.slow
def test_exact_trace_gradients_flow():
    nn = cnf.MLP((4, 12, 4))
    icnf = cnf.construct(
        cnf.RNODE, nn, 2, 2, tspan=(0.0, 1.0), steer_rate=0.1,
        aug_noise="calibrated",
        compute_mode=cnf.ComputeMode(exact_trace=True),
    )
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.normal(jax.random.PRNGKey(1), (4, 2)) * 0.3
    g = jax.grad(
        lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=jax.random.PRNGKey(2))
    )(ps)
    assert _all_finite(g)
    assert any(
        float(jnp.max(jnp.abs(leaf))) > 0 for leaf in jax.tree.leaves(g)
    )


def test_explicit_eps_shape_validation():
    # Explicit probes are (K, B, zdim); (B, zdim) is K=1 shorthand; anything
    # else must raise clearly instead of dying inside the field.
    nn = cnf.MLP((4, 8, 4))
    icnf = cnf.construct(cnf.RNODE, nn, 2, 2, compute_mode=cnf.VecJacMode())
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (8, 2))
    key = jax.random.PRNGKey(2)
    eps3 = jax.random.normal(key, (1, 8, 4))
    lp3, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps3)
    lp2, _, _ = cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps3[0])
    np.testing.assert_allclose(np.asarray(lp3), np.asarray(lp2), rtol=1e-6)
    with pytest.raises(ValueError, match="num_probes"):
        cnf.inference(icnf, Mode.TRAIN, xs, ps, key=key,
                      eps=jax.random.normal(key, (4, 8)))
    with pytest.raises(ValueError, match="num_probes"):
        icnf2 = cnf.construct(
            cnf.RNODE, nn, 2, 2, compute_mode=cnf.VecJacMode(num_probes=2))
        cnf.inference(icnf2, Mode.TRAIN, xs, ps, key=key,
                      eps=jax.random.normal(key, (8, 4)))
