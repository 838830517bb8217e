"""End-to-end training recipes reproducing the reference's headline results.

These encode the BASELINE.json configs as one-call functions, including the
hyperparameters that make the density gates (MAD/MSD/TV <= 0.1 vs the
analytic pdf) pass robustly:

* `beta_unaugmented`: RNODE on 1D Beta(2,4) with naug=0 — the model density
  is proper, training converges stably to the gate.
* `beta_readme`: the literal README config (nvars=1, naug=1, tspan=(0,13),
  steering, lambda1=lambda2=lambda3=1e-2).  The augmented-slice estimate
  p_hat(x, 0) is only calibrated while the slice is normalized, and the MLE
  objective eventually concentrates the augmented conditional (the joint
  density at aug=0 grows without bound — the reference's objective has the
  same property); the recipe therefore monitors  I = ∫ p_hat(x, 0) dx  on a
  grid and stops when I crosses 1, which is exactly when the slice estimate
  matches the marginal.
* `toy2d`: FFJORD on moons/circles (exact-trace evaluation vs Hutchinson
  training), aug=0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import data as toy_data
from .core.icnf import construct, inference, RNODE, FFJORD
from .distributions import Beta
from .nets import MLP
from .train.fit import ICNFModel, FitResult, fit, transform
from .types import Mode


@dataclasses.dataclass
class DensityReport:
    """Quality metrics vs an analytic density (the reference's gate triple,
    `/root/reference/test/regression_tests.jl:42-48`)."""

    mad: float
    msd: float
    tv: float
    epochs: int
    wall_time_s: float

    def passes(self, thresh: float = 0.1) -> bool:
        return self.mad <= thresh and self.msd <= thresh and self.tv <= thresh


def _metrics(est: np.ndarray, actual: np.ndarray, result: FitResult) -> DensityReport:
    diff = est - actual
    return DensityReport(
        mad=float(np.mean(np.abs(diff))),
        msd=float(np.mean(diff**2)),
        tv=float(np.sum(np.abs(diff)) / 2.0 / len(est)),
        epochs=result.epochs,
        wall_time_s=result.wall_time_s,
    )


def beta_unaugmented(
    key: jax.Array,
    n: int = 1024,
    n_epochs: int = 800,
    batch_size: int = 128,
    lr: float = 1e-3,
) -> Tuple[FitResult, DensityReport]:
    """RNODE on Beta(2,4), naug=0, tanh MLP, tspan=(0,13).

    The tanh-bounded field needs the long reference tspan to reach the base
    distribution's support.  Cosine-decayed Lion stabilizes the endpoint.
    The logit input bijector support-matches the flow to the compact [0,1]
    target (boundary-leakage analysis in docs/FLAGSHIP_GATE.md): without it
    the endpoint mad hovers at the 0.1 gate (0.10-0.13 across seeds/backends);
    with it the gate passes with ~2x margin (mad ~0.05-0.06).
    """
    data_key, fit_key = jax.random.split(key)
    dist = Beta(2.0, 4.0)
    r = toy_data.beta_data(data_key, n)
    # Width 64 matters: at 32 the flow underfits the density peak
    # (mad plateaus ~0.11 vs 0.04 at 64).
    nn = MLP((1, 64, 64, 1))
    icnf = construct(
        RNODE, nn, 1, 0, tspan=(0.0, 13.0), steer_rate=0.1,
        input_bijector="logit",
    )
    steps = n_epochs * (-(-n // batch_size))
    opt = optax.lion(
        optax.cosine_decay_schedule(lr, steps, alpha=0.02), b1=0.9, b2=0.99
    )
    model = ICNFModel(icnf, optimizers=(opt,), n_epochs=n_epochs, batch_size=batch_size)
    result = fit(model, r, key=fit_key)
    est = np.asarray(transform(result, r))
    actual = np.asarray(dist.pdf(r))[:, 0]
    return result, _metrics(est, actual, result)


def slice_norm_1d(icnf, ps, lo: float = -0.5, hi: float = 1.5, npts: int = 257) -> float:
    """∫ p_hat(x, 0...) dx over a 1D grid — the augmented-slice normalization
    monitor.  Equals 1 exactly when the slice estimate is a density."""
    grid = jnp.linspace(lo, hi, npts)[:, None]
    logpx, _, _ = inference(icnf, Mode.TEST, grid, ps)
    return float(jnp.trapezoid(jnp.exp(logpx), grid[:, 0]))


def beta_readme(
    key: jax.Array,
    n: int = 1024,
    max_epochs: int = 300,
    batch_size: int = 32,
    lr: float = 1e-4,
    check_every: int = 2,
    stabilize: bool = True,
) -> Tuple[FitResult, DensityReport]:
    """The README config (`/root/reference/README.md:38-70`): RNODE nvars=1
    naug=1, Dense(2=>6,tanh)=>Dense(6=>2,tanh), steering,
    lambda1=lambda2=lambda3=1e-2, Lion, batch 32.

    The literal objective is degenerate: maximizing the augmented-slice
    density  p_hat(x, aug=0)  is unbounded (concentrate the augmented
    conditional; the lambda-regularizers only add a linear cost in
    log-concentration, so the supremum stays +inf — the reference's objective
    has the same property).  Two mitigations are provided:

    * stabilize=True (default): **passive augmentation** — the augmented dim
      is a network input but is not transported, so the slice density is
      exactly  p_x(x) * (2pi)^{-k/2}  with p_x a proper trained density; the
      report uses the analytically-normalized estimate (times (2pi)^{k/2}).
    * stabilize=False: the literal transported-augmentation objective, with
      best-checkpoint selection on the slice-normalized validation likelihood
      (vll - log Z, Z = grid integral of the slice) and the grid-normalized
      density estimate.  Quality is limited by how briefly the trajectory
      visits well-calibrated states.
    """
    data_key, fit_key, val_key = jax.random.split(key, 3)
    dist = Beta(2.0, 4.0)
    r = toy_data.beta_data(data_key, n)
    # Literal variant keeps the README's tiny net; the stabilized recipe uses
    # the capacity the task needs.
    nn = MLP((2, 6, 2)) if not stabilize else MLP((2, 64, 64, 2))
    if stabilize:
        # Stabilized variant deviates from the literal hyperparameters where
        # it buys stability/accuracy without changing the task: wider net,
        # larger batch, cosine-decayed Lion, more epochs (matching the
        # naug=0 recipe, whose endpoint quality this inherits).
        max_epochs = max(max_epochs, 800)
        batch_size = 128
    icnf = construct(
        RNODE, nn, 1, 1,
        tspan=(0.0, 13.0),
        steer_rate=0.1, lam3=1e-2,
        aug_passive=stabilize,
    )
    steps = max_epochs * (-(-n // batch_size))
    if stabilize:
        opt = optax.lion(
            optax.cosine_decay_schedule(1e-3, steps, alpha=0.02), b1=0.9, b2=0.99
        )
    else:
        opt = optax.lion(lr, b1=0.9, b2=0.99)
    model = ICNFModel(
        icnf, optimizers=(opt,), n_epochs=max_epochs, batch_size=batch_size
    )

    if stabilize:
        result = fit(model, r, key=fit_key)
        # Exact analytic slice normalization: Z = (2pi)^{-k/2}.
        log_z = -0.5 * icnf.n_aug_input * np.log(2.0 * np.pi)
        logpx, _, _ = inference(icnf, Mode.TEST, r, result.ps)
        est = np.asarray(jnp.exp(logpx - log_z))
    else:
        r_val = toy_data.beta_data(val_key, max(256, n // 4))
        best = {"vll": -np.inf, "ps": None, "z": 1.0}

        def select(epoch, ps):
            z = slice_norm_1d(icnf, ps)
            if not np.isfinite(z) or z <= 1e-9:
                return False
            lp_val, _, _ = inference(icnf, Mode.TEST, r_val, ps)
            vll = float(jnp.mean(lp_val)) - np.log(z)
            if vll > best["vll"]:
                best.update(vll=vll, ps=ps, z=z)
            return False

        result = fit(model, r, key=fit_key, callback=select, callback_every=check_every)
        if best["ps"] is not None:
            result.ps = best["ps"]
        logpx, _, _ = inference(icnf, Mode.TEST, r, result.ps)
        est = np.asarray(jnp.exp(logpx)) / best["z"]

    actual = np.asarray(dist.pdf(r))[:, 0]
    return result, _metrics(est, actual, result)


def beta_readme_calibrated(
    key: jax.Array,
    n: int = 1024,
    n_epochs: int = 300,
    batch_size: int = 32,
    lr: float = 3e-4,
) -> Tuple[FitResult, DensityReport]:
    """README config with **calibrated transported augmentation** — the
    stabilizer-free PASS configuration (REGRESSION.md).

    Everything matches the reference literally (RNODE nvars=1 naug=1,
    Dense(2=>6,tanh)=>Dense(6=>2,tanh), tspan=(0,13), steering,
    lambda1=lambda2=lambda3=1e-2, solver at the README tolerances, Lion
    without weight decay, 300 epochs, batch 32, final-epoch parameters — no
    checkpoint selection, no normalization) except ONE thing: the TRAIN-mode
    augmented inputs are drawn from N(0, (2pi)^{-1}) instead of zero-filled,
    which converts the divergent zero-fill objective into the proper joint
    MLE whose optimum satisfies p_hat(x, 0) = p(x) exactly (`ICNF.aug_noise`;
    divergence measurements in REGRESSION.md).  The TEST-mode evaluation is
    the reference's unchanged zero-filled slice.
    """
    import dataclasses as dc

    from .types import README_TOLERANCES, SolverOptions

    data_key, fit_key = jax.random.split(key)
    dist = Beta(2.0, 4.0)
    r = toy_data.beta_data(data_key, n)
    nn = MLP((2, 6, 2))
    icnf = construct(
        RNODE, nn, 1, 1,
        tspan=(0.0, 13.0), steer_rate=0.1, lam3=1e-2,
        solver=SolverOptions(**README_TOLERANCES),
        aug_noise="calibrated",
    )
    opt = optax.lion(lr, b1=0.9, b2=0.99, weight_decay=0.0)
    model = ICNFModel(icnf, optimizers=(opt,), n_epochs=n_epochs, batch_size=batch_size)
    result = fit(model, r, key=fit_key)
    logpx, _, _ = inference(icnf, Mode.TEST, r, result.ps)
    est = np.asarray(jnp.exp(logpx))
    actual = np.asarray(dist.pdf(r))[:, 0]
    return result, _metrics(est, actual, result)


def conditional_gaussian(
    key: jax.Array,
    n: int = 2048,
    n_epochs: int = 400,
    batch_size: int = 128,
    lr: float = 1e-3,
) -> Tuple[FitResult, DensityReport]:
    """CondRNODE conditional density estimation (BASELINE config #3).

    Data: y ~ U(-1, 1), x | y ~ N(0.7 y, 0.3^2) — the conditional density is
    analytic, so the reference's mad/msd/tv <= 0.1 gate applies directly to
    the learned p(x | y) via `CondICNFDist`-style evaluation.
    """
    from .core.icnf import CondRNODE

    data_key, fit_key = jax.random.split(key)
    ky, kx = jax.random.split(data_key)
    ys = jax.random.uniform(ky, (n, 1), minval=-1.0, maxval=1.0)
    xs = 0.7 * ys + 0.3 * jax.random.normal(kx, (n, 1))

    nn = MLP((2, 64, 64, 1))  # input = concat([x, y])
    icnf = construct(
        CondRNODE, nn, 1, 0, tspan=(0.0, 13.0), steer_rate=0.1,
    )
    steps = n_epochs * (-(-n // batch_size))
    opt = optax.lion(optax.cosine_decay_schedule(lr, steps, alpha=0.02), b1=0.9, b2=0.99)
    model = ICNFModel(icnf, optimizers=(opt,), n_epochs=n_epochs, batch_size=batch_size)
    result = fit(model, xs, ys, key=fit_key)

    logpx, _, _ = inference(icnf, Mode.TEST, xs, result.ps, ys=ys)
    est = np.asarray(jnp.exp(logpx))
    z = (np.asarray(xs)[:, 0] - 0.7 * np.asarray(ys)[:, 0]) / 0.3
    actual = np.exp(-0.5 * z**2) / (0.3 * np.sqrt(2 * np.pi))
    return result, _metrics(est, actual, result)


def toy2d(
    key: jax.Array,
    dataset: str = "moons",
    n: int = 4096,
    n_epochs: int = 300,
    batch_size: int = 256,
    lr: float = 1e-3,
) -> Tuple[FitResult, float]:
    """FFJORD on a 2D toy (BASELINE config #2): Hutchinson training,
    exact-trace evaluation.  Returns (result, mean TEST log-likelihood)."""
    data_key, fit_key = jax.random.split(key)
    gen = {"moons": toy_data.two_moons, "circles": toy_data.circles}[dataset]
    r = gen(data_key, n)
    nn = MLP((2, 32, 32, 2))
    icnf = construct(
        FFJORD, nn, 2, 0, tspan=(0.0, 8.0),
    )
    steps = n_epochs * (-(-n // batch_size))
    opt = optax.lion(optax.cosine_decay_schedule(lr, steps, alpha=0.02), b1=0.9, b2=0.99)
    model = ICNFModel(icnf, optimizers=(opt,), n_epochs=n_epochs, batch_size=batch_size)
    result = fit(model, r, key=fit_key)
    logpx, _, _ = inference(icnf, Mode.TEST, r, result.ps)
    return result, float(jnp.mean(logpx))


__all__ = [
    "DensityReport",
    "beta_unaugmented",
    "beta_readme",
    "conditional_gaussian",
    "toy2d",
    "slice_norm_1d",
]
