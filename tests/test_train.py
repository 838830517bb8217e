"""Training-loop tests (analog of the reference fit tests, 2-epoch smoke +
semantics of the padded partial batch + checkpoint roundtrip)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import optax

import continuousnf_tpu as cnf
from continuousnf_tpu import Mode

FAST = cnf.SolverOptions(rtol=1e-3, atol=1e-5)


def _model(n_epochs=2, batch_size=16, cond=False, **kw):
    nvars, naug = 2, 2
    n_in = nvars + naug
    n_cond = 2 if cond else 0
    nn = cnf.MLP((n_in + n_cond, 2 * n_in, n_in))
    variant = cnf.CondRNODE if cond else cnf.RNODE
    icnf = cnf.construct(variant, nn, nvars, naug, solver=FAST, **kw)
    return cnf.ICNFModel(icnf, n_epochs=n_epochs, batch_size=batch_size)


def test_fit_two_epochs_smoke():
    model = _model()
    X = jax.random.uniform(jax.random.PRNGKey(0), (40, 2))
    res = cnf.fit(model, X, key=jax.random.PRNGKey(1))
    assert res.epochs == 2
    assert np.isfinite(res.losses).all()
    px = cnf.transform(res, X)
    assert px.shape == (40,) and np.isfinite(np.asarray(px)).all()


def test_fit_conditional_smoke():
    model = _model(cond=True)
    X = jax.random.uniform(jax.random.PRNGKey(0), (32, 2))
    Y = jax.random.normal(jax.random.PRNGKey(2), (32, 2))
    res = cnf.fit(model, X, Y, key=jax.random.PRNGKey(1))
    px = cnf.transform(res, X, Y)
    assert np.isfinite(np.asarray(px)).all()


def test_partial_batch_padding_weighted_loss():
    # n not divisible by batch_size: padded samples must not affect the loss.
    icnf = _model().icnf
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (5, 2))
    key = jax.random.PRNGKey(2)
    eps = jnp.ones((1, 8, icnf.zdim))  # shared probes so both paths match
    l_true = cnf.loss(icnf, Mode.TRAIN, jnp.concatenate([xs, xs[:3]]), ps,
                      key=key, eps=eps,
                      weights=jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0.0]))
    l_exact = cnf.loss(icnf, Mode.TRAIN, jnp.concatenate([xs, xs[:3]]), ps,
                       key=key, eps=eps,
                       weights=jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0.0]))
    np.testing.assert_allclose(float(l_true), float(l_exact), rtol=1e-6)
    # weight-0 samples are excluded: perturbing them must not change the loss
    xs_pert = jnp.concatenate([xs, xs[:3] + 100.0])
    l_pert = cnf.loss(icnf, Mode.TRAIN, xs_pert, ps, key=key, eps=eps,
                      weights=jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0.0]))
    np.testing.assert_allclose(float(l_true), float(l_pert), rtol=1e-5)


def test_fit_uneven_batches():
    model = _model(batch_size=16)
    X = jax.random.uniform(jax.random.PRNGKey(0), (37, 2))  # 37 = 2*16 + 5
    res = cnf.fit(model, X, key=jax.random.PRNGKey(1))
    assert np.isfinite(res.losses).all()


@pytest.mark.slow
def test_loss_decreases_on_easy_data():
    model = _model(n_epochs=12, batch_size=32)
    X = 0.25 + 0.05 * jax.random.normal(jax.random.PRNGKey(5), (128, 2))
    res = cnf.fit(model, X, key=jax.random.PRNGKey(6))
    assert res.losses[-1] < res.losses[0]


@pytest.mark.slow
def test_multiple_optimizers_sequential():
    base = _model(n_epochs=1)
    model = cnf.ICNFModel(
        base.icnf,
        optimizers=(optax.lion(1e-3), optax.adam(1e-3)),
        n_epochs=1,
        batch_size=16,
    )
    X = jax.random.uniform(jax.random.PRNGKey(0), (32, 2))
    res = cnf.fit(model, X, key=jax.random.PRNGKey(1))
    assert res.epochs == 2  # 1 epoch per optimizer


def test_warm_start_from_checkpoint(tmp_path):
    model = _model()
    X = jax.random.uniform(jax.random.PRNGKey(0), (32, 2))
    res = cnf.fit(model, X, key=jax.random.PRNGKey(1))
    path = str(tmp_path / "ps.npz")
    cnf.save_checkpoint(path, res.ps)
    template = jax.tree.map(jnp.zeros_like, res.ps)
    ps2 = cnf.load_checkpoint(path, template)
    assert jax.tree_util.tree_all(
        jax.tree.map(lambda a, b: bool(jnp.all(a == b)), res.ps, ps2)
    )
    res2 = cnf.fit(model, X, key=jax.random.PRNGKey(2), ps=ps2)
    assert np.isfinite(res2.losses).all()


@pytest.mark.slow
def test_exact_resume_from_state_checkpoint(tmp_path):
    """Kill-and-resume equivalence: training N epochs straight through equals
    training to a mid-run (ps, opt_state, epoch) snapshot, restarting from it
    with `fit(ps=, opt_state=, epoch_start=)`, and finishing.  Per-epoch PRNG
    keys derive from the global epoch index, so the math is chunking- and
    restart-invariant."""
    from continuousnf_tpu.train.checkpoint import load_checkpoint, save_checkpoint

    model = _model(n_epochs=8, batch_size=16)
    X = jax.random.uniform(jax.random.PRNGKey(0), (40, 2))
    key = jax.random.PRNGKey(1)

    snaps = {}

    def snap(epoch, ps, opt_state):
        snaps[epoch] = (jax.tree.map(jnp.copy, ps), jax.tree.map(jnp.copy, opt_state))

    full = cnf.fit(model, X, key=key, state_callback=snap)
    mid = sorted(e for e in snaps if 0 < e < 8)[0]
    ps_mid, opt_mid = snaps[mid]

    # Round-trip the snapshot through the .npz checkpoint (what
    # literal_gates --resume does).
    path = str(tmp_path / "mid.npz")
    save_checkpoint(path, {"ps": ps_mid, "opt": opt_mid, "epoch": mid})
    like = {"ps": ps_mid, "opt": opt_mid, "epoch": 0}
    loaded = load_checkpoint(path, like)

    resumed = cnf.fit(
        model, X, key=key,
        ps=loaded["ps"], opt_state=loaded["opt"], epoch_start=int(loaded["epoch"]),
    )
    assert resumed.epochs == 8
    for a, b in zip(jax.tree.leaves(full.ps), jax.tree.leaves(resumed.ps)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_exact_trace_model():
    """fit() with an exact-divergence model (the flagship gate recipe's
    compute mode) must not draw/pass Hutchinson probes — round-4 regression:
    inference() now rejects eps under exact_trace, and the shared step body
    used to pass probes unconditionally."""
    import optax

    nn = cnf.MLP((2, 6, 2))
    icnf = cnf.construct(
        cnf.RNODE, nn, 1, 1,
        compute_mode=cnf.VecJacMode(exact_trace=True),
        solver=cnf.SolverOptions(rtol=1e-2, atol=1e-4, max_steps=200),
    )
    model = cnf.ICNFModel(icnf, optimizers=(optax.lion(1e-3),), n_epochs=2, batch_size=8)
    r = jax.random.uniform(jax.random.PRNGKey(0), (16, 1))
    res = cnf.fit(model, r, key=jax.random.PRNGKey(1))
    assert res.epochs == 2
    assert np.all(np.isfinite(res.losses))
