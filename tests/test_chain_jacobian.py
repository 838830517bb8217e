"""Closed-form N-layer Dense-chain Jacobian vs AD ground truth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from continuousnf_tpu.nets import MLP
from continuousnf_tpu.core.dynamics import (
    exact_dense_chain_jacobian,
    is_dense_tanh_chain,
)


@pytest.mark.parametrize(
    "dims,final_act",
    [((5, 16, 16, 5), jnp.tanh), ((4, 8, 12, 8, 4), jnp.tanh), ((6, 32, 6), None)],
)
def test_chain_jacobian_matches_ad(dims, final_act):
    nn = MLP(dims, final_activation=final_act)
    assert is_dense_tanh_chain(nn)
    ps = nn.init(jax.random.PRNGKey(0))
    z = jax.random.normal(jax.random.PRNGKey(1), (7, dims[0]))

    y, jac = exact_dense_chain_jacobian(nn, ps, z)
    np.testing.assert_allclose(np.asarray(y), np.asarray(nn.apply(ps, z)), rtol=1e-6)

    jac_ad = jax.vmap(jax.jacfwd(lambda zi: nn.apply(ps, zi)))(z)
    # chain convention: J[b, i, j] = dy_j / dz_i == jacfwd's (out, in) transposed
    np.testing.assert_allclose(
        np.asarray(jac), np.asarray(jnp.swapaxes(jac_ad, -1, -2)), rtol=2e-5, atol=1e-6
    )


def test_three_layer_test_mode_inference_matches_generic():
    """TEST densities of a 3-layer net: closed-form dispatch == generic AD path."""
    import dataclasses as dc

    from continuousnf_tpu.core.icnf import RNODE, construct, inference
    from continuousnf_tpu.types import Mode, VecJacMode

    nn = MLP((6, 24, 24, 6))
    icnf = construct(RNODE, nn, 6, 0, tspan=(0.0, 1.0))
    ps = icnf.init(jax.random.PRNGKey(2))
    xs = jax.random.uniform(jax.random.PRNGKey(3), (9, 6))
    lp_closed, _, _ = inference(icnf, Mode.TEST, xs, ps)

    # Force the generic path by wrapping apply in a Chain-opaque module.
    class Opaque:
        out_dim = 6

        def init(self, key, dtype=jnp.float32):
            return nn.init(key, dtype)

        def apply(self, p, x):
            return nn.apply(p, x)

    icnf_g = dc.replace(icnf, nn=Opaque())
    lp_gen, _, _ = inference(icnf_g, Mode.TEST, xs, ps)
    np.testing.assert_allclose(np.asarray(lp_closed), np.asarray(lp_gen), rtol=1e-4, atol=1e-4)


def test_three_layer_train_exact_trace_matches_generic():
    import dataclasses as dc

    from continuousnf_tpu.core.icnf import RNODE, construct, loss
    from continuousnf_tpu.types import Mode, VecJacMode

    nn = MLP((4, 12, 12, 4))
    icnf = construct(
        RNODE, nn, 4, 0, tspan=(0.0, 1.0),
        compute_mode=VecJacMode(exact_trace=True),
    )
    ps = icnf.init(jax.random.PRNGKey(4))
    xs = jax.random.uniform(jax.random.PRNGKey(5), (8, 4))
    key = jax.random.PRNGKey(6)
    l_closed = loss(icnf, Mode.TRAIN, xs, ps, key=key)

    class Opaque:
        out_dim = 4

        def init(self, k, dtype=jnp.float32):
            return nn.init(k, dtype)

        def apply(self, p, x):
            return nn.apply(p, x)

    icnf_g = dc.replace(icnf, nn=Opaque())
    l_gen = loss(icnf_g, Mode.TRAIN, xs, ps, key=key)
    np.testing.assert_allclose(float(l_closed), float(l_gen), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "dims,final_act",
    [((5, 16, 16, 5), jnp.tanh), ((4, 8, 12, 8, 4), jnp.tanh), ((6, 32, 6), None), ((3, 3), jnp.tanh)],
)
def test_chain_trace_matches_jacobian(dims, final_act):
    """Trace-only chain path (TEST-mode fast path) == trace of the full J."""
    from continuousnf_tpu.core.dynamics import exact_dense_chain_trace

    nn = MLP(dims, final_activation=final_act)
    ps = nn.init(jax.random.PRNGKey(0))
    z = jax.random.normal(jax.random.PRNGKey(1), (7, dims[0]))
    y_t, tr_t = exact_dense_chain_trace(nn, ps, z)
    y_j, jac = exact_dense_chain_jacobian(nn, ps, z)
    np.testing.assert_allclose(np.asarray(y_t), np.asarray(y_j), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(tr_t), np.asarray(jnp.trace(jac, axis1=-2, axis2=-1)),
        rtol=2e-5, atol=1e-6,
    )
