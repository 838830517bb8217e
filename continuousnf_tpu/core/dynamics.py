"""Augmented CNF dynamics: vector field + divergence (trace) + regularizer rates.

Redesign of the reference's `augmented_f` family
(`/root/reference/src/icnf.jl:110-456`, 12 dispatch variants).  The 12
variants collapse to two traced functions:

  * TEST mode  -> exact per-sample trace via batched `jax.linearize` /
    `jax.vjp` over the identity basis (the analog of `jacobian_batched`,
    `/root/reference/src/utils.jl:1-54`);
  * TRAIN mode -> Hutchinson estimator with K probes, reverse
    (eps^T J, analog of `value_and_pullback`, reference `src/icnf.jl:331-333`)
    or forward (J eps, `value_and_pushforward`) AD, plus the RNODE
    regularizer rates  Edot = ||zdot||_2 and  ndot = ||eps^T J||_2 per sample
    (Finlay et al. 2020; reference `src/icnf.jl:334-349`).

The ODE state is a pytree (no manual row packing like the reference's
`vcat(z, l, E, n)` state matrix at `/root/reference/src/base_icnf.jl:275-281`)
— the integrator ravels it once, and XLA keeps the accumulators fused with the
state updates.

Everything is batch-major `(B, dz)`; probes are `(K, B, dz)` so the probe axis
can be sharded across a device mesh alongside the batch axis.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..types import ADMode, ComputeMode, Mode


class TestState(NamedTuple):
    """ODE state in TEST mode: transported sample + log-density delta."""

    z: jax.Array  # (B, dz)
    dlogp: jax.Array  # (B,)


class TrainState(NamedTuple):
    """TRAIN-mode state: adds the two RNODE regularizer accumulators
    (the reference's n_augment(TrainMode)=2 rows, `src/icnf.jl:106-108`)."""

    z: jax.Array  # (B, dz)
    dlogp: jax.Array  # (B,)
    reg_e: jax.Array  # (B,)  integral of ||dz/dt||
    reg_n: jax.Array  # (B,)  integral of ||eps^T J|| (or ||J eps||)


def safe_norm(v: jax.Array, axis: int = -1) -> jax.Array:
    """L2 norm with a well-defined (zero) gradient at v = 0.

    `jnp.linalg.norm` backpropagates v/||v|| — NaN at exactly zero, which
    poisons the adjoint solve (e.g. the lambda3 term on passive augmented
    dims that stay identically 0).  Double-where keeps values exact.
    """
    sq = jnp.sum(v * v, axis=axis)
    pos = sq > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, sq, 1.0)), 0.0)


def _batch_apply(
    nn_apply: Callable[[Any, jax.Array], jax.Array],
    ps: Any,
    z: jax.Array,
    ys: Optional[jax.Array],
) -> jax.Array:
    if ys is None:
        return nn_apply(ps, z)
    ys_b = jnp.broadcast_to(ys, (*z.shape[:-1], ys.shape[-1]))
    return nn_apply(ps, jnp.concatenate([z, ys_b], axis=-1))


def _exact_field(nn_apply, compute_mode: ComputeMode):
    """dz plus exact trace of the per-sample Jacobian.

    Forward (JVP) route: one `jax.linearize` per sample, pushforward of the
    identity basis — dz columns of J (analog of the reference's one-hot
    pushforward loop, `src/utils.jl:19-36`).  Reverse (VJP) route: pullback of
    the identity basis (analog of `src/utils.jl:1-17`).  Both vmap over the
    batch; the basis loop is itself a vmap, so XLA sees one batched matmul per
    layer rather than dz sequential ones.
    """

    def field(ps, z, ys):
        dz_dim = z.shape[-1]
        eye = jnp.eye(dz_dim, dtype=z.dtype)

        def single(zi, ysi):
            def net(zz):
                if ysi is None:
                    return _batch_apply(nn_apply, ps, zz, None)
                return _batch_apply(nn_apply, ps, zz, ysi)

            if compute_mode.ad == ADMode.JVP:
                dzi, lin = jax.linearize(net, zi)
                cols = jax.vmap(lin)(eye)  # row i = J @ e_i
                tr = jnp.trace(cols)
            else:
                dzi, vjp_fn = jax.vjp(net, zi)
                rows = jax.vmap(lambda e: vjp_fn(e)[0])(eye)  # row i = e_i^T J
                tr = jnp.trace(rows)
            return dzi, tr

        if ys is None:
            dz, tr = jax.vmap(lambda zi: single(zi, None))(z)
        else:
            ys_b = jnp.broadcast_to(ys, (*z.shape[:-1], ys.shape[-1]))
            dz, tr = jax.vmap(single)(z, ys_b)
        return dz, tr

    return field


def _exact_train_field(nn_apply, compute_mode: ComputeMode):
    """dz + exact trace + exact Jacobian Frobenius norm, for TRAIN mode with
    `compute_mode.exact_trace=True`.

    Same objective as Hutchinson in expectation — E[eps^T J eps] = tr(J) and
    E[||eps^T J||^2] = ||J||_F^2 — but zero estimator variance, which removes
    the dominant gradient-noise source at small state dims (the reference is
    locked to one stochastic probe, `/root/reference/src/base_icnf.jl:277-278`).
    Costs dz AD passes per stage via the vmapped identity-basis Jacobian; the
    rows are reused for both the trace and the Frobenius norm.
    """

    def field(ps, z, ys):
        dz_dim = z.shape[-1]
        eye = jnp.eye(dz_dim, dtype=z.dtype)

        def single(zi, ysi):
            def net(zz):
                return _batch_apply(nn_apply, ps, zz, ysi)

            if compute_mode.ad == ADMode.JVP:
                dzi, lin = jax.linearize(net, zi)
                rows = jax.vmap(lin)(eye)  # row i = J @ e_i (J^T; same tr/fro)
            else:
                dzi, vjp_fn = jax.vjp(net, zi)
                rows = jax.vmap(lambda e: vjp_fn(e)[0])(eye)  # row i = e_i^T J
            return dzi, jnp.trace(rows), safe_norm(rows.reshape(-1))

        if ys is None:
            dz, tr, fro = jax.vmap(lambda zi: single(zi, None))(z)
        else:
            ys_b = jnp.broadcast_to(ys, (*z.shape[:-1], ys.shape[-1]))
            dz, tr, fro = jax.vmap(single)(z, ys_b)
        return dz, tr, fro

    return field


def exact_tanh_mlp_trace(params, z: jax.Array):
    """Closed-form exact divergence of a 2-layer tanh MLP — one forward pass
    plus an einsum, no Jacobian materialization.

    For f(z) = tanh(tanh(z W1 + b1) W2 + b2):
        J_ij = dy_j * sum_h W2[h, j] * dh_h * W1[i, h]
        tr J = einsum(dy_i, W2[h, i], dh_h, W1[i, h])
    with dh = 1 - h^2, dy = 1 - y^2.  Cost O(B d H) — the same as a single
    Hutchinson probe but exact: TEST-mode densities (the reference's
    `jacobian_batched` path, `/root/reference/src/utils.jl:1-54`, costs d
    AD passes) become as cheap as one probe.

    Returns (y, trace) with shapes ((B, d), (B,)).
    """
    (p1, p2) = params
    w1, b1, w2, b2 = p1["w"], p1["b"], p2["w"], p2["b"]
    h = jnp.tanh(z @ w1 + b1)
    y = jnp.tanh(h @ w2 + b2)
    dh = 1.0 - h * h
    dy = 1.0 - y * y
    tr = jnp.einsum("bi,hi,bh,ih->b", dy, w2, dh, w1)
    return y, tr


def is_dense_tanh_chain(nn) -> bool:
    """True for any Chain of Dense layers with tanh-or-identity activations —
    the family the closed-form N-layer Jacobian (`exact_dense_chain_jacobian`)
    covers (`is_two_layer_tanh_mlp` is the 2-layer, biased subset)."""
    from ..nets.modules import Chain, Dense

    if not isinstance(nn, Chain) or not nn.layers:
        return False
    return all(
        isinstance(l, Dense) and (l.activation is jnp.tanh or l.activation is None)
        for l in nn.layers
    )


def exact_dense_chain_jacobian(nn, params, z: jax.Array):
    """Closed-form (y, J) of an N-layer Dense chain; J has shape (B, d, d).

    Each layer h_k = act(h_{k-1} @ W_k + b_k) contributes the per-sample
    Jacobian factor  d h_k / d h_{k-1} = W_k * act'_k  (column scaling by the
    activation derivative), so J is the batched left-to-right chain product —
    cost O(B * d * sum_k H_k) matmul FLOPs with one (B, d, H) tensor alive,
    vs the d AD passes of the generic identity-basis path (the analog of the
    reference's `jacobian_batched`, `/root/reference/src/utils.jl:1-54`).
    Exact math, no estimator: used for TEST densities and exact-divergence
    TRAIN whenever the architecture matches (e.g. the 3-layer tabular MLPs).
    """
    h = z
    J = None
    for layer, p in zip(nn.layers, params):
        a = h @ p["w"]
        if layer.use_bias:
            a = a + p["b"]
        if layer.activation is jnp.tanh:
            h = jnp.tanh(a)
            d = 1.0 - h * h  # (B, H_k)
        else:
            h = a
            d = None
        if J is None:
            J = jnp.broadcast_to(p["w"], (z.shape[0], *p["w"].shape))
        else:
            J = jnp.einsum("bij,jk->bik", J, p["w"])
        if d is not None:
            J = J * d[:, None, :]
    return h, J


def exact_dense_chain_trace(nn, params, z: jax.Array):
    """Closed-form (y, tr(J)) of an N-layer Dense chain WITHOUT materializing
    the final (B, d, d) Jacobian.

    Same chain product as `exact_dense_chain_jacobian` through layer N-1
    (C = (B, d, H_{N-1})), but the last factor W_N diag(act'_N) enters only
    through the trace contraction  tr = sum_{i,h} C[b,i,h] W_N[h,i] d_N[b,i]
    — an O(B d H) elementwise-reduce instead of the O(B d^2 H) closing
    matmul, the single most expensive factor at tabular dims (d=43, H=128:
    ~1 GFLOP/stage saved).  TEST-mode densities use this; exact-divergence
    TRAIN still needs the full J for the Frobenius rate.
    """
    B = z.shape[0]
    n = len(nn.layers)
    h = z
    C = None
    tr = None
    for idx, (layer, p) in enumerate(zip(nn.layers, params)):
        a = h @ p["w"]
        if layer.use_bias:
            a = a + p["b"]
        if layer.activation is jnp.tanh:
            h = jnp.tanh(a)
            d = 1.0 - h * h
        else:
            h = a
            d = None
        if idx == n - 1:
            if C is None:
                diag = jnp.diagonal(p["w"])
                tr = jnp.sum(diag * d, axis=-1) if d is not None else jnp.sum(diag) * jnp.ones((B,), z.dtype)
            else:
                t = jnp.einsum("bih,hi->bi", C, p["w"])
                tr = jnp.sum(t * d, axis=-1) if d is not None else jnp.sum(t, axis=-1)
        else:
            if C is None:
                C = jnp.broadcast_to(p["w"], (B, *p["w"].shape))
            else:
                C = jnp.einsum("bij,jk->bik", C, p["w"])
            if d is not None:
                C = C * d[:, None, :]
    return h, tr


def is_two_layer_tanh_mlp(nn) -> bool:
    """True when `nn` is a 2-layer tanh-MLP Chain with biases: the shape the
    closed-form 2-layer traces cover."""
    from ..nets.modules import Chain, Dense

    if not isinstance(nn, Chain) or len(nn.layers) != 2:
        return False
    for layer in nn.layers:
        if not isinstance(layer, Dense) or not layer.use_bias:
            return False
        if layer.activation is not jnp.tanh:
            return False
    return True


def exact_tanh_mlp_trace_fro(params, z: jax.Array):
    """Closed-form (dz, trace, ||J||_F) of a 2-layer tanh MLP per sample.

    Extends `exact_tanh_mlp_trace` with the exact Jacobian
    Frobenius norm: J[b] = diag-free form J_ij = dy_j * M_ij with
    M = W1 (dh ⊙ .) W2, so ||J||_F^2 = sum_ij M_ij^2 dy_j^2.  Cost O(B d^2 H)
    — the same order as the dz AD passes of the generic path, but a single
    einsum chain that XLA maps onto one large matmul.
    """
    (p1, p2) = params
    w1, b1, w2, b2 = p1["w"], p1["b"], p2["w"], p2["b"]
    dz = w1.shape[0]
    h = jnp.tanh(z @ w1 + b1)
    y = jnp.tanh(h @ w2 + b2)
    dh = 1.0 - h * h
    dy = 1.0 - y * y
    # All dz^2 Jacobian inner sums in ONE (B, H) @ (H, dz^2) matmul:
    # p2m[h, (i,j)] = w1[i,h] * w2[h,j], m[b,i,j] = sum_h w1[i,h] dh w2[h,j].
    # The naive pairwise einsum lowering ("ih,bh,hj->bij") runs B tiny
    # (dz, H) x (H, dz) matmuls; this form is one large one.
    p2m = (w1.T[:, :, None] * w2[:, None, :]).reshape(w1.shape[1], dz * dz)
    m = (dh @ p2m).reshape(-1, dz, dz)
    tr = jnp.einsum("bii,bi->b", m, dy)
    fro2 = jnp.einsum("bij,bj->b", m * m, dy * dy)
    pos = fro2 > 0
    fro = jnp.where(pos, jnp.sqrt(jnp.where(pos, fro2, 1.0)), 0.0)
    return y, tr, fro


def _hutchinson_field(nn_apply, compute_mode: ComputeMode):
    """dz plus the K-probe Hutchinson trace estimate and regularizer rates.

    eps is fixed per trajectory (drawn once per solve, like the reference at
    `/root/reference/src/base_icnf.jl:277-278`) and has shape (K, B, dz).
    Returns (dz, tr_est, n_rate) with tr_est/n_rate averaged over probes.
    """

    def field(ps, z, ys, eps):
        if compute_mode.ad == ADMode.VJP:
            dz, vjp_fn = jax.vjp(lambda zz: _batch_apply(nn_apply, ps, zz, ys), z)
            eJ = jax.vmap(lambda e: vjp_fn(e)[0])(eps)  # (K, B, dz)
            tr_est = jnp.mean(jnp.sum(eJ * eps, axis=-1), axis=0)  # (B,)
            n_rate = jnp.mean(safe_norm(eJ), axis=0)  # (B,)
        else:
            dz, lin = jax.linearize(lambda zz: _batch_apply(nn_apply, ps, zz, ys), z)
            Je = jax.vmap(lin)(eps)  # (K, B, dz)
            tr_est = jnp.mean(jnp.sum(eps * Je, axis=-1), axis=0)
            n_rate = jnp.mean(safe_norm(Je), axis=0)
        return dz, tr_est, n_rate

    return field


def _planar_exact(nn, ps, z, ys):
    """Closed-form divergence of the planar field f(z) = u * act(<w, z> + b):
    dfi/dzj = u_i * act'(s) * w_j, so  tr(J) = act'(s) * <w[:nvars], u>
    (only the z-block of w for conditional layers — divergence is w.r.t. z).
    One forward pass + one jvp of the scalar activation.
    """
    if ys is not None:
        ys_b = jnp.broadcast_to(ys, (*z.shape[:-1], ys.shape[-1]))
        zin = jnp.concatenate([z, ys_b], axis=-1)
    else:
        zin = z
    s = jnp.einsum("...d,d->...", zin, ps["w"])
    if nn.use_bias:
        s = s + ps["b"][0]
    act_s, dact_s = jax.jvp(nn.activation, (s,), (jnp.ones_like(s),))
    dz = act_s[..., None] * ps["u"]
    wu = jnp.sum(ps["w"][: nn.nvars] * ps["u"])
    tr = dact_s * wu
    return dz, tr


def make_augmented_dynamics(
    nn,
    mode: Mode,
    compute_mode: ComputeMode,
    norm_z: bool,
    norm_j: bool,
    passive_aug_dims: int = 0,
):
    """Build the ODE right-hand side `f(t, state, args)`.

    `args` is a dict with keys "ps" (net params), optionally "ys"
    (conditioning, (B, n_cond) or (n_cond,)) and, in TRAIN mode, "eps"
    (probes, (K, B, dz)).  The field is autonomous (the reference nets never
    see t, `src/icnf.jl:110-456`); t still flows through the integrator for
    steering support.

    norm_z/norm_j correspond to the reference's NORM_Z/NORM_J flags baked in
    at construction (lambda1 != 0 / lambda2 != 0, `src/base_icnf.jl:42-60`) —
    disabled rates cost nothing (XLA DCEs the zero branches).

    passive_aug_dims > 0 zeroes the field on the last `passive_aug_dims`
    state components ("passive augmentation", `construct(aug_passive=True)`):
    augmented dims act as constant input channels and are not transported,
    which keeps the augmented-slice density proper (see recipes.py for why
    the fully-augmented MLE objective is degenerate).
    """
    raw_apply = nn.apply
    if passive_aug_dims > 0:
        k = passive_aug_dims

        def nn_apply(ps, z):
            out = raw_apply(ps, z)
            return jnp.concatenate([out[..., :-k], jnp.zeros_like(out[..., -k:])], axis=-1)

    else:
        nn_apply = raw_apply
    if mode == Mode.TEST:
        # Closed-form exact divergence for 2-layer tanh MLPs: one forward
        # pass + einsum instead of d AD passes.  Exact math, so it is used
        # whenever the architecture matches (not gated behind a flag).
        closed_form = is_two_layer_tanh_mlp(nn) and passive_aug_dims == 0
        # N-layer Dense/tanh chains (e.g. the 3-layer tabular MLPs): exact
        # Jacobian as a batched chain product instead of d AD passes.
        chain_form = (
            not closed_form and is_dense_tanh_chain(nn) and passive_aug_dims == 0
        )
        from ..nets.planar import PlanarLayer

        planar_form = isinstance(nn, PlanarLayer) and passive_aug_dims == 0
        exact = _exact_field(nn_apply, compute_mode)

        def f_test(t, state: TestState, args):
            # Conditioning changes the input dimension (divergence is w.r.t.
            # z only), so the closed forms apply to unconditional calls.
            if closed_form and args.get("ys") is None:
                dz, tr = exact_tanh_mlp_trace(args["ps"], state.z)
            elif chain_form and args.get("ys") is None:
                dz, tr = exact_dense_chain_trace(nn, args["ps"], state.z)
            elif planar_form:
                dz, tr = _planar_exact(nn, args["ps"], state.z, args.get("ys"))
            else:
                dz, tr = exact(args["ps"], state.z, args.get("ys"))
            return TestState(z=dz, dlogp=-tr)

        return f_test

    if compute_mode.exact_trace:
        # TRAIN with the exact divergence + exact ||J||_F rate (zero-variance
        # analog of the Hutchinson estimator; see ComputeMode.exact_trace).
        closed_form = is_two_layer_tanh_mlp(nn) and passive_aug_dims == 0
        chain_form = (
            not closed_form and is_dense_tanh_chain(nn) and passive_aug_dims == 0
        )
        exact_tf = _exact_train_field(nn_apply, compute_mode)

        def f_train_exact(t, state: TrainState, args):
            if closed_form and args.get("ys") is None:
                dz, tr, fro = exact_tanh_mlp_trace_fro(args["ps"], state.z)
            elif chain_form and args.get("ys") is None:
                dz, jac = exact_dense_chain_jacobian(nn, args["ps"], state.z)
                tr = jnp.trace(jac, axis1=-2, axis2=-1)
                fro = safe_norm(jac.reshape(jac.shape[0], -1))
            else:
                dz, tr, fro = exact_tf(args["ps"], state.z, args.get("ys"))
            zero = jnp.zeros_like(tr)
            return TrainState(
                z=dz,
                dlogp=-tr,
                reg_e=safe_norm(dz) if norm_z else zero,
                reg_n=fro if norm_j else zero,
            )

        return f_train_exact

    hutch = _hutchinson_field(nn_apply, compute_mode)

    def f_train(t, state: TrainState, args):
        dz, tr_est, n_rate = hutch(args["ps"], state.z, args.get("ys"), args["eps"])
        zero = jnp.zeros_like(tr_est)
        reg_e = safe_norm(dz) if norm_z else zero
        reg_n = n_rate if norm_j else zero
        return TrainState(z=dz, dlogp=-tr_est, reg_e=reg_e, reg_n=reg_n)

    return f_train


__all__ = [
    "TestState",
    "TrainState",
    "make_augmented_dynamics",
    "exact_tanh_mlp_trace",
    "exact_dense_chain_jacobian",
    "exact_dense_chain_trace",
    "is_dense_tanh_chain",
    "is_two_layer_tanh_mlp",
]
