"""ICNF model: construction, inference (log-density), generation, loss.

Redesign of the reference's core engine
(`/root/reference/src/base_icnf.jl` + `/root/reference/src/icnf.jl:1-104`).
The reference's 9 compile-time type parameters become fields of a frozen
dataclass used as static jit configuration; its `VectorMode`/`MatrixMode`
axis disappears (single samples are rank-1 inputs, auto-batched); its INPLACE
axis disappears (XLA owns buffers); randomness (Hutchinson probes, steering
jitter, base-dist sampling) is explicit-PRNG via `jax.random` keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..distributions import sample_eps, std_normal_logpdf
from ..nets.modules import Module
from ..types import Adjoint, ComputeMode, EpsDist, Mode, SolverOptions
from ..ode.solve import SolveStats, odeint_with_stats
from .dynamics import TestState, TrainState, make_augmented_dynamics


class _VariantTag:
    """Base for the six model-variant tags (reference `src/icnf.jl:1-56`).

    All variants share the `ICNF` implementation; they differ only in default
    regularization (RNODE family turns on lambda1/lambda2 = 1e-2,
    `src/base_icnf.jl:28-38`) and conditionality.  The Planar variants are a
    convention where the user passes a `PlanarLayer` net (reference tests
    `test/call_tests.jl:94-134`).
    """


class RNODE(_VariantTag):
    pass


class CondRNODE(_VariantTag):
    pass


class FFJORD(_VariantTag):
    pass


class CondFFJORD(_VariantTag):
    pass


class Planar(_VariantTag):
    pass


class CondPlanar(_VariantTag):
    pass


_COND_VARIANTS = (CondRNODE, CondFFJORD, CondPlanar)
_RNODE_VARIANTS = (RNODE, CondRNODE)

#: Aug-input noise std that calibrates the augmented slice: the per-dim
#: Gaussian density at 0 is (2*pi*sigma^2)^{-1/2} = 1 at this sigma, so the
#: proper-MLE optimum has p_hat(x, 0) = p(x).  See `ICNF.aug_noise`.
CALIBRATED_AUG_SIGMA = 1.0 / math.sqrt(2.0 * math.pi)


class Regs(NamedTuple):
    """Per-sample regularizer integrals returned alongside log-density.

    e: flow kinetic energy integral Edot (zero in TEST mode)
    n: Jacobian-norm integral ndot     (zero in TEST mode)
    a: ||z_aug|| of the final augmented dims (the reference's Adot,
       `src/base_icnf.jl:157-164`)
    """

    e: jax.Array
    n: jax.Array
    a: jax.Array


@dataclasses.dataclass(frozen=True)
class ICNF:
    """Static model configuration (analog of the reference `ICNF` struct,
    `/root/reference/src/icnf.jl:69-104`).  Hashable: safe as a jit static."""

    nn: Module
    nvars: int
    naugmented: int = 0
    cond: bool = False
    compute_mode: ComputeMode = ComputeMode()
    tspan: Tuple[float, float] = (0.0, 1.0)
    steer_rate: float = 0.0
    lam1: float = 0.0  # flow (kinetic-energy) regularization weight
    lam2: float = 0.0  # volume-change (Jacobian-norm) regularization weight
    lam3: float = 0.0  # augmented-dims norm regularization weight
    solver: SolverOptions = SolverOptions()
    dtype: Any = jnp.float32
    # Passive augmentation: augmented dims are inputs to the network but are
    # not transported (zero field components).  Keeps the augmented-slice
    # density proper — the fully-transported variant's MLE objective is
    # degenerate (see recipes.py).  Off by default (reference parity).
    aug_passive: bool = False
    # Pluggable base distribution over the zdim-dimensional transported state
    # (reference `basedist`, `/root/reference/src/base_icnf.jl:16-19`): any
    # hashable object with `logpdf(z (..,zdim)) -> (..,)` and
    # `sample(key, batch_shape, dtype) -> (*batch_shape, zdim)`, e.g.
    # `distributions.MvDiagNormal` / `MvLogistic`.  None = standard normal
    # (the reference's default, and the fast path).
    basedist: Any = None
    # Pluggable Hutchinson-probe distribution (reference `epsdist`,
    # `src/base_icnf.jl:22-25`): any hashable object with
    # `sample(key, batch_shape, dtype) -> (*batch_shape, zdim)`.  None uses
    # `compute_mode.eps_dist` (gaussian/rademacher enum — the kernel-friendly
    # path).  Correct trace estimates need E[eps eps^T] = I.
    epsdist: Any = None
    # TRAIN-mode augmented-input noise std.  The reference zero-fills the
    # augmented inputs in training (`/root/reference/src/base_icnf.jl:275-281`),
    # which makes MLE of the slice density p_hat(x, 0) unbounded (the slice
    # mass z = ∫p_hat(x,0)dx random-walks without an optimum at z=1 — see
    # REGRESSION.md).  With aug_noise = sigma > 0 the TRAIN objective becomes
    # the proper joint MLE  E_{x~data, a~N(0,sigma^2 I)}[log p_hat(x, a)]
    # whose optimum is p_hat(x, a) = p(x) N(a; 0, sigma^2 I); choosing
    # sigma = (2*pi)^{-1/2} (CALIBRATED_AUG_SIGMA) makes the per-dim density
    # N(0; 0, sigma^2) = 1, so the optimum satisfies p_hat(x, 0) = p(x)
    # exactly and the reference's TestMode slice evaluation is calibrated by
    # construction.  0 = reference-literal zeros.  Augmentation stays fully
    # transported either way.
    aug_noise: float = 0.0
    # TRAIN-mode data-input jitter std ("smoothed MLE"): with x_jitter = h > 0
    # the TRAIN objective targets the kernel-smoothed data distribution
    # (data * N(0, h^2 I)) instead of the raw empirical measure — the CNF
    # analog of KDE bandwidth, trading a small O(h^2) bias for lower
    # estimation variance at small n.  0 (default) trains on the data
    # verbatim like the reference.  TEST mode never jitters.
    x_jitter: float = 0.0
    # Fixed elementwise input bijector composed with the flow ("logit" or
    # None).  With "logit" the CNF transports t = logit(x) (unbounded
    # support, Gaussian-friendly tails) and densities/samples are corrected
    # through the analytic change of variables:
    #     log p(x) = log p_flow(logit(x)) - sum_i [log x_i + log(1 - x_i)]
    #     sample   = sigmoid(flow sample)
    # The standard preprocessing for compactly-supported data: a smooth
    # Gaussian-base flow on raw [0,1]^d support leaks mass past the boundary
    # (measured in REGRESSION.md); in logit space the target is light-tailed
    # on R^d.  Applies to the `nvars` data dims only — augmented dims live in
    # flow space.  None (default) = reference-literal raw coordinates.
    input_bijector: Optional[str] = None

    @property
    def augmented(self) -> bool:
        return self.naugmented > 0

    @property
    def steered(self) -> bool:
        return self.steer_rate > 0.0

    @property
    def n_aug_input(self) -> int:
        """Augmented input dims (reference `n_augment_input`,
        `src/base_icnf.jl:98-106`)."""
        return self.naugmented

    @property
    def zdim(self) -> int:
        """Dimensionality of the transported state (nvars + augmented dims)."""
        return self.nvars + self.naugmented

    # ---- convenience wrappers over the module-level functions ----

    def init(self, key: jax.Array) -> Any:
        return init_params(self, key)

    def base_logpdf(self, z: jax.Array) -> jax.Array:
        """Base-dist log-density of the transported state (`basedist` if set,
        else standard normal — reference `src/base_icnf.jl:155-156`)."""
        if self.basedist is not None:
            return self.basedist.logpdf(z)
        return std_normal_logpdf(z)

    def base_sample(self, key: jax.Array, batch_shape: Tuple[int, ...]) -> jax.Array:
        """Draw (*batch_shape, zdim) base-dist samples (reference
        `src/base_icnf.jl:329`)."""
        if self.basedist is not None:
            return self.basedist.sample(key, batch_shape, self.dtype)
        return jax.random.normal(key, (*batch_shape, self.zdim), self.dtype)

    def draw_eps(self, key: jax.Array, batch: int) -> jax.Array:
        """Draw the (num_probes, batch, zdim) Hutchinson probes from
        `epsdist` if set, else from the `compute_mode.eps_dist` enum."""
        shape = (self.compute_mode.num_probes, batch)
        if self.epsdist is not None:
            return self.epsdist.sample(key, shape, self.dtype)
        return sample_eps(key, (*shape, self.zdim), self.compute_mode.eps_dist, self.dtype)

    def __call__(self, xs, ps, *, ys=None, key=None):
        """Lux-style callable: TRAIN-mode log-density (reference
        `(icnf)(xs, ps, st)`, `src/base_icnf.jl:528-543`)."""
        logpx, _, _ = inference(self, Mode.TRAIN, xs, ps, ys=ys, key=key)
        return logpx

    def __repr__(self) -> str:
        """One-screen model summary (analog of the reference's `Base.show`,
        `/root/reference/src/base_icnf.jl:83-96`)."""
        cm = self.compute_mode
        trace = (
            "exact"
            if cm.exact_trace
            else f"hutchinson[{cm.ad.value}, K={cm.num_probes}, {cm.eps_dist.value}]"
        )
        flags = [
            name
            for name, on in (
                ("cond", self.cond),
                ("augmented", self.augmented),
                ("aug_passive", self.aug_passive),
                ("steered", self.steered),
            )
            if on
        ]
        lines = [
            f"ICNF {{ nvars = {self.nvars}, naugmented = {self.naugmented}"
            + (f", flags = {'+'.join(flags)}" if flags else "")
            + " }",
            f"  nn:      {self.nn!r}",
            f"  trace:   {trace} (TRAIN); exact (TEST)",
            f"  tspan:   {self.tspan}"
            + (f", steer_rate = {self.steer_rate}" if self.steered else ""),
            f"  lambdas: l1 = {self.lam1}, l2 = {self.lam2}, l3 = {self.lam3}",
            f"  solver:  {self.solver.method} rtol={self.solver.rtol} "
            f"atol={self.solver.atol} adjoint={self.solver.adjoint.value}",
            f"  base:    {self.basedist!r}"
            if self.basedist is not None
            else "  base:    MvStdNormal",
        ]
        extras = []
        if self.aug_noise:
            extras.append(f"aug_noise = {self.aug_noise:.4g}")
        if self.x_jitter:
            extras.append(f"x_jitter = {self.x_jitter:.4g}")
        if self.input_bijector:
            extras.append(f"input_bijector = {self.input_bijector}")
        if extras:
            lines.append("  extras:  " + ", ".join(extras))
        return "\n".join(lines)


def construct(
    variant,
    nn: Module,
    nvars: int,
    naugmented: int = 0,
    *,
    compute_mode: ComputeMode = ComputeMode(),
    cond: Optional[bool] = None,
    tspan: Tuple[float, float] = (0.0, 1.0),
    steer_rate: float = 0.0,
    lam1: Optional[float] = None,
    lam2: Optional[float] = None,
    lam3: float = 0.0,
    solver: SolverOptions = SolverOptions(),
    dtype: Any = jnp.float32,
    basedist: Any = None,
    epsdist: Any = None,
    aug_passive: bool = False,
    aug_noise: Any = 0.0,
    x_jitter: float = 0.0,
    input_bijector: Optional[str] = None,
) -> ICNF:
    """The single public constructor (reference `construct`,
    `/root/reference/src/base_icnf.jl:1-77`).

    Defaults mirror the reference: lambda1 = lambda2 = 1e-2 for the RNODE
    family and 0 otherwise (`src/base_icnf.jl:28-38`); `cond` defaults to
    True for Cond* variants (`src/base_icnf.jl:14`); tspan = (0, 1);
    steering draws t1 jitter from Uniform(-steer_rate, steer_rate)
    (`src/base_icnf.jl:40`).

    `basedist`/`epsdist` plug in custom distributions over the
    zdim-dimensional state (reference `src/base_icnf.jl:16-25`); see the
    `ICNF` field docs for the protocol.  `aug_noise` may be a float sigma or
    the string "calibrated" (= CALIBRATED_AUG_SIGMA); see `ICNF.aug_noise`.
    """
    zdim = int(nvars) + int(naugmented)
    for name, dist in (("basedist", basedist), ("epsdist", epsdist)):
        if dist is not None and getattr(dist, "dim", zdim) != zdim:
            raise ValueError(
                f"{name}.dim = {dist.dim} must equal nvars + naugmented = {zdim}"
            )
    if aug_noise == "calibrated":
        aug_noise = CALIBRATED_AUG_SIGMA
    if input_bijector not in (None, "logit"):
        raise ValueError(f"unsupported input_bijector: {input_bijector!r}")
    if not (isinstance(variant, type) and issubclass(variant, _VariantTag)):
        raise TypeError(f"variant must be one of the ICNF tags, got {variant!r}")
    is_rnode = issubclass(variant, _RNODE_VARIANTS)
    if lam1 is None:
        lam1 = 1.0e-2 if is_rnode else 0.0
    if lam2 is None:
        lam2 = 1.0e-2 if is_rnode else 0.0
    if cond is None:
        cond = issubclass(variant, _COND_VARIANTS)
    return ICNF(
        nn=nn,
        nvars=int(nvars),
        naugmented=int(naugmented),
        cond=bool(cond),
        compute_mode=compute_mode,
        tspan=(float(tspan[0]), float(tspan[1])),
        steer_rate=float(steer_rate),
        lam1=float(lam1),
        lam2=float(lam2),
        lam3=float(lam3),
        solver=solver,
        dtype=dtype,
        basedist=basedist,
        epsdist=epsdist,
        aug_passive=bool(aug_passive),
        aug_noise=float(aug_noise),
        x_jitter=float(x_jitter),
        input_bijector=input_bijector,
    )


def init_params(icnf: ICNF, key: jax.Array) -> Any:
    """Initialize the wrapped network's parameters (analog of
    `LuxCore.setup(rng, icnf)` used at `src/exts/mlj_ext/core_icnf.jl:37`)."""
    return icnf.nn.init(key, icnf.dtype)


def _steer_tspan(icnf: ICNF, mode: Mode, key: Optional[jax.Array]):
    """TrainMode+steer: jitter t1 by Delta_t * U(-rate, rate) (reference
    `steer_tspan`, `/root/reference/src/base_icnf.jl:108-121`)."""
    t0, t1 = icnf.tspan
    t0 = jnp.asarray(t0, icnf.dtype)
    t1 = jnp.asarray(t1, icnf.dtype)
    if mode == Mode.TRAIN and icnf.steered and key is not None:
        dt = jnp.abs(t1 - t0)
        r = jax.random.uniform(
            key, (), dtype=icnf.dtype, minval=-icnf.steer_rate, maxval=icnf.steer_rate
        )
        t1 = t1 + dt * r
    return t0, t1


def _as_batch(x: jax.Array, name: str) -> Tuple[jax.Array, bool]:
    from ..utils.debug import check_array

    check_array(name, x, rank=(1, 2))
    if x.ndim == 1:
        return x[None, :], True
    return x, False


def _check_cond(icnf: ICNF, ys):
    if icnf.cond and ys is None:
        raise ValueError("conditional ICNF requires ys")
    if not icnf.cond and ys is not None:
        raise ValueError("non-conditional ICNF got ys")


def _solve(icnf: ICNF, mode: Mode, state0, args, t0, t1):
    f = make_augmented_dynamics(
        icnf.nn,
        mode,
        icnf.compute_mode,
        norm_z=icnf.lam1 != 0.0,
        norm_j=icnf.lam2 != 0.0,
        passive_aug_dims=icnf.n_aug_input if icnf.aug_passive else 0,
    )
    return odeint_with_stats(f, state0, t0, t1, args, icnf.solver)


def _solve_saveat(icnf: ICNF, mode: Mode, state0, args, t0, t1):
    """Segmented solve saving intermediate states (see `inference`'s
    trajectory flag).  Returns (final_state, stats, (ts, zs))."""
    from ..ode.solve import odeint_saveat

    f = make_augmented_dynamics(
        icnf.nn,
        mode,
        icnf.compute_mode,
        norm_z=icnf.lam1 != 0.0,
        norm_j=icnf.lam2 != 0.0,
        passive_aug_dims=icnf.n_aug_input if icnf.aug_passive else 0,
    )
    if icnf.solver.saveat is not None:
        grid = [jnp.asarray(t, icnf.dtype) for t in icnf.solver.saveat]
    else:
        n_pts = 17
        grid = [t0 + (t1 - t0) * (i / (n_pts - 1)) for i in range(n_pts)]
    states, stats = odeint_saveat(f, state0, grid, args, icnf.solver)
    stateT = jax.tree.map(lambda x: x[-1], states)
    ts = jnp.stack([jnp.asarray(t, icnf.dtype) for t in grid])
    return stateT, stats, (ts, states.z)


def _final_regs(icnf: ICNF, mode: Mode, stateT) -> Regs:
    B = stateT.z.shape[0]
    zero = jnp.zeros((B,), icnf.dtype)
    if icnf.lam3 != 0.0 and icnf.augmented and not icnf.aug_passive:
        from .dynamics import safe_norm

        z_aug = stateT.z[:, icnf.zdim - icnf.n_aug_input :]
        a = safe_norm(z_aug)
    else:
        # Passive augmentation: z_aug is identically 0, so Adot == 0 — no
        # gradient path needed (and ||0|| has no well-defined one).
        a = zero
    if mode == Mode.TRAIN:
        return Regs(e=stateT.reg_e, n=stateT.reg_n, a=a)
    return Regs(e=zero, n=zero, a=a)


def _prepare_inference(icnf, mode, xs, ps, ys, key, eps):
    """Shared setup of `inference`: input validation/batching, the logit
    bijector change of variables, augmented-state assembly, probe/steering
    randomness.  Returns (state0, args, t0, t1, ldj, squeeze)."""
    _check_cond(icnf, ys)
    xs = jnp.asarray(xs, icnf.dtype)
    xs, squeeze = _as_batch(xs, "xs")
    if ys is not None:
        ys = jnp.asarray(ys, icnf.dtype)
        if squeeze and ys.ndim == 1:
            ys = ys[None, :]
    B = xs.shape[0]
    from ..utils.debug import check_array

    check_array("xs", xs, last_dim=icnf.nvars, dtype=icnf.dtype)

    ldj = None
    if icnf.input_bijector == "logit":
        # Flow works on t = logit(x); log p(x) = log p_flow(t) + sum log|t'|.
        tiny = jnp.asarray(1e-6, icnf.dtype)
        xc = jnp.clip(xs, tiny, 1.0 - tiny)
        ldj = -jnp.sum(jnp.log(xc) + jnp.log1p(-xc), axis=-1)
        xs = jnp.log(xc) - jnp.log1p(-xc)

    z0 = xs
    if icnf.n_aug_input:
        z0 = jnp.concatenate([xs, jnp.zeros((B, icnf.n_aug_input), icnf.dtype)], axis=-1)
    zeros_b = jnp.zeros((B,), icnf.dtype)

    if mode == Mode.TRAIN:
        if key is None:
            raise ValueError("TRAIN-mode inference requires a PRNG key")
        if icnf.x_jitter > 0.0:
            # Smoothed MLE: target the kernel-smoothed data distribution
            # (see `ICNF.x_jitter`).  Fresh draw per call, like aug_noise.
            key, jit_key = jax.random.split(key)
            xs = xs + icnf.x_jitter * jax.random.normal(
                jit_key, xs.shape, icnf.dtype)
            z0 = xs
            if icnf.n_aug_input:
                z0 = jnp.concatenate(
                    [xs, jnp.zeros((B, icnf.n_aug_input), icnf.dtype)], axis=-1)
        if icnf.aug_noise > 0.0 and icnf.n_aug_input:
            # Calibrated transported augmentation: draw the aug inputs from
            # N(0, aug_noise^2) so the TRAIN objective is a proper joint MLE
            # (see `ICNF.aug_noise`).  TEST keeps the reference's zeros.
            key, aug_key = jax.random.split(key)
            a0 = icnf.aug_noise * jax.random.normal(
                aug_key, (B, icnf.n_aug_input), icnf.dtype
            )
            z0 = jnp.concatenate([xs, a0], axis=-1)
        eps_key, steer_key = jax.random.split(key)
        if eps is not None:
            if icnf.compute_mode.exact_trace:
                # The exact-divergence field never reads probes; silently
                # accepting (and ignoring) them would hide a config mistake.
                raise ValueError(
                    "eps= was given but compute_mode.exact_trace=True uses no "
                    "Hutchinson probes; drop eps or use a stochastic mode"
                )
            # Explicit probes must be (K, B, zdim); a 2-D (B, zdim) array is
            # accepted as K=1 shorthand.  Anything else would surface as an
            # inscrutable broadcasting error deep in the field.
            eps = jnp.asarray(eps, icnf.dtype)
            K = icnf.compute_mode.num_probes
            if eps.ndim == 2:
                eps = eps[None]
            if eps.shape != (K, B, icnf.zdim):
                raise ValueError(
                    f"eps must have shape (num_probes={K}, B={B}, "
                    f"zdim={icnf.zdim}) or (B, zdim) for K=1; got {eps.shape}"
                )
        if eps is None and not icnf.compute_mode.exact_trace:
            # One probe draw per call, fixed across the trajectory (reference
            # `src/base_icnf.jl:277-278`).  Callers may pre-sample eps to
            # control its device sharding (probe-axis parallelism).  With
            # exact_trace the field needs no probes — eps stays None, which
            # also keeps the (K, B, dz) block out of the adjoint state.
            eps = icnf.draw_eps(eps_key, B)
            if icnf.aug_passive and icnf.n_aug_input:
                # Passive dims have a zero field row/column: probing them only
                # adds variance to the trace estimate.  Restrict probes to the
                # active subspace (same expectation, lower variance).
                eps = eps.at[..., icnf.zdim - icnf.n_aug_input :].set(0.0)
        state0 = TrainState(z=z0, dlogp=zeros_b, reg_e=zeros_b, reg_n=zeros_b)
        args = {"ps": ps, "eps": eps, "ys": ys}
        t0, t1 = _steer_tspan(icnf, mode, steer_key)
    else:
        state0 = TestState(z=z0, dlogp=zeros_b)
        args = {"ps": ps, "ys": ys}
        t0, t1 = _steer_tspan(icnf, mode, None)

    return state0, args, t0, t1, ldj, squeeze


def inference(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    ps: Any,
    *,
    ys: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    eps: Optional[jax.Array] = None,
    trajectory: bool = False,
):
    """Transport data to the base distribution and return log-density.

    Analog of the reference `inference` (`/root/reference/src/base_icnf.jl:407-426`):
    state0 = [xs | zeros(aug)] with zeroed accumulators, one probe draw per
    call fixed across the trajectory, integrate t0 -> t1 (steered in TRAIN
    mode), then  logp(x) = logp_base(z(t1)) - Delta_logp  (`:155-156`).

    Returns (logpx (B,), regs: Regs, stats: SolveStats).  Rank-1 `xs` is
    treated as a single sample and squeezed back (the reference's VectorMode).

    `eps` (TRAIN only): explicit Hutchinson probes, (K, B, zdim) or (B, zdim)
    for K=1.  Note on differentiation: under the default BACKSOLVE adjoint the
    probes are treated as Monte-Carlo *constants* — differentiating the result
    w.r.t. an explicitly passed `eps` yields zero gradients (the continuous
    adjoint does not integrate an eps-cotangent block; see `ode/adjoint.py`).
    Use `SolverOptions(adjoint=Adjoint.DIRECT)` if you genuinely need
    gradients w.r.t. the probes.

    `trajectory=True` additionally returns `(ts, zs)` — the transported
    states on the fixed save grid `icnf.solver.saveat` (default: 17 evenly
    spaced points over the integration span), `ts` (T,), `zs` (T, B, zdim)
    with zs[0] = the initial state and zs[-1] = the final state.  The analog
    of the reference's `save_everystep`/`saveat` sol_kwargs passthrough
    (`/root/reference/src/base_icnf.jl:137-143`); the plain final-state-only
    solve remains the hot path.
    """
    state0, args, t0, t1, ldj, squeeze = _prepare_inference(
        icnf, mode, xs, ps, ys, key, eps
    )
    traj = None
    if trajectory:
        stateT, stats, traj = _solve_saveat(icnf, mode, state0, args, t0, t1)
    else:
        stateT, stats = _solve(icnf, mode, state0, args, t0, t1)
    logpz = icnf.base_logpdf(stateT.z)
    logpx = logpz - stateT.dlogp
    if ldj is not None:
        logpx = logpx + ldj
    regs = _final_regs(icnf, mode, stateT)

    if squeeze:
        logpx = logpx[0]
        regs = Regs(e=regs.e[0], n=regs.n[0], a=regs.a[0])
        if traj is not None:
            traj = (traj[0], traj[1][:, 0])
    if trajectory:
        return logpx, regs, stats, traj
    return logpx, regs, stats


def generate(
    icnf: ICNF,
    mode: Mode,
    ps: Any,
    n: Optional[int] = None,
    *,
    ys: Optional[jax.Array] = None,
    key: jax.Array,
    with_stats: bool = False,
):
    """Sample by integrating base-dist draws backward in time.

    Analog of the reference `generate` (`/root/reference/src/base_icnf.jl:428-466`):
    z(t1) ~ basedist (default N(0, I_{zdim})), integrate over reversed
    (steered) tspan, keep the
    first `nvars` dims (`:191-211`).  `n=None` returns a single sample
    (VectorMode parity).  `with_stats=True` returns (samples, SolveStats).
    """
    _check_cond(icnf, ys)
    squeeze = n is None
    B = 1 if squeeze else int(n)
    if ys is not None:
        ys = jnp.asarray(ys, icnf.dtype)
        if ys.ndim == 1:
            ys = ys[None, :]

    z_key, eps_key, steer_key = jax.random.split(key, 3)
    z1 = icnf.base_sample(z_key, (B,))
    zeros_b = jnp.zeros((B,), icnf.dtype)

    if mode == Mode.TRAIN:
        eps = None if icnf.compute_mode.exact_trace else icnf.draw_eps(eps_key, B)
        state1 = TrainState(z=z1, dlogp=zeros_b, reg_e=zeros_b, reg_n=zeros_b)
        args = {"ps": ps, "eps": eps, "ys": ys}
        t0, t1 = _steer_tspan(icnf, mode, steer_key)
    else:
        state1 = TestState(z=z1, dlogp=zeros_b)
        args = {"ps": ps, "ys": ys}
        t0, t1 = _steer_tspan(icnf, mode, None)

    # Reverse-time integration (reference `reverse(steer_tspan(...))`,
    # `src/base_icnf.jl:329`).
    state0, stats = _solve(icnf, mode, state1, args, t1, t0)
    samples = state0.z[:, : icnf.nvars]
    if icnf.input_bijector == "logit":
        samples = jax.nn.sigmoid(samples)
    if squeeze:
        samples = samples[0]
    if with_stats:
        return samples, stats
    return samples


def loss(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    ps: Any,
    *,
    ys: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    weights: Optional[jax.Array] = None,
    eps: Optional[jax.Array] = None,
) -> jax.Array:
    """Scalar training/eval loss.

    TRAIN: mean(-logpx + lam1*E + lam2*N + lam3*A) over the batch (reference
    `src/icnf.jl:458-502`); TEST: mean(-logpx) (reference
    `src/base_icnf.jl:468-508`).

    `weights` (B,) computes a weighted mean — used by the trainer to keep
    static batch shapes while preserving the reference's partial-batch
    semantics (padded samples get weight 0).
    """
    return loss_and_metrics(
        icnf, mode, xs, ps, ys=ys, key=key, weights=weights, eps=eps
    )[0]


def loss_and_metrics(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    ps: Any,
    *,
    ys: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    weights: Optional[jax.Array] = None,
    eps: Optional[jax.Array] = None,
):
    """`loss` plus the per-step observability dict (SURVEY §5): loss, mean
    Edot (kinetic energy), mean ndot (Jacobian norm), and the forward solve's
    NFE.  The metrics are aux outputs — differentiate with `has_aux=True`."""
    logpx, regs, stats = inference(icnf, mode, xs, ps, ys=ys, key=key, eps=eps)
    if mode == Mode.TRAIN:
        per_sample = -logpx + icnf.lam1 * regs.e + icnf.lam2 * regs.n + icnf.lam3 * regs.a
    else:
        per_sample = -logpx
    if weights is None:
        l = jnp.mean(per_sample)
        e_mean = jnp.mean(regs.e)
        n_mean = jnp.mean(regs.n)
    else:
        weights = jnp.asarray(weights, per_sample.dtype)
        denom = jnp.maximum(jnp.sum(weights), 1e-12)
        l = jnp.sum(per_sample * weights) / denom
        e_mean = jnp.sum(regs.e * weights) / denom
        n_mean = jnp.sum(regs.n * weights) / denom
    metrics = {
        "loss": l,
        "e": jax.lax.stop_gradient(e_mean),
        "n": jax.lax.stop_gradient(n_mean),
        "nfe": stats.nfe,
    }
    return l, metrics


def adjoint_stats(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    ps: Any,
    *,
    ys: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    eps: Optional[jax.Array] = None,
    weights: Optional[jax.Array] = None,
) -> Tuple[SolveStats, SolveStats]:
    """Measured SolveStats of the forward AND backward (BACKSOLVE) solves
    for the gradient of `loss` at these inputs.

    The custom_vjp protocol cannot return the backward integration's
    statistics, so the backward solve's attempt/NFE counts were previously
    unobservable — per-NFE adjoint cost could only be inferred by wall-clock
    slope fitting (round-4 verdict item 4).  This helper re-runs the
    IDENTICAL backward integration standalone (same final state and loss
    cotangent => same adaptive grid and counts) and keeps its stats.
    Analog of the NFE accounting the reference reads off `SciMLBase.solve`
    return values.  Returns (fwd_stats, bwd_stats).
    """
    _check_cond(icnf, ys)
    state0, args, t0, t1, ldj, squeeze = _prepare_inference(
        icnf, mode, xs, ps, ys, key, eps
    )
    f = make_augmented_dynamics(
        icnf.nn,
        mode,
        icnf.compute_mode,
        norm_z=icnf.lam1 != 0.0,
        norm_j=icnf.lam2 != 0.0,
        passive_aug_dims=icnf.n_aug_input if icnf.aug_passive else 0,
    )
    def cotangent_fn(stateT):
        logpx = icnf.base_logpdf(stateT.z) - stateT.dlogp
        if ldj is not None:
            logpx = logpx + ldj
        if mode == Mode.TRAIN:
            regs = _final_regs(icnf, mode, stateT)
            per = (
                -logpx
                + icnf.lam1 * regs.e
                + icnf.lam2 * regs.n
                + icnf.lam3 * regs.a
            )
        else:
            per = -logpx
        if weights is None:
            return jnp.mean(per)
        w = jnp.asarray(weights, per.dtype)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1e-12)

    from ..ode.solve import backsolve_stats

    _, fwd_stats, bwd_stats = backsolve_stats(
        f, state0, t0, t1, args, cotangent_fn, icnf.solver
    )
    return fwd_stats, bwd_stats


__all__ = [
    "ICNF",
    "RNODE",
    "FFJORD",
    "Planar",
    "CondRNODE",
    "CondFFJORD",
    "CondPlanar",
    "Regs",
    "CALIBRATED_AUG_SIGMA",
    "construct",
    "init_params",
    "inference",
    "generate",
    "loss",
    "loss_and_metrics",
    "adjoint_stats",
]
