"""Faithful replication of the reference's literal density gates.

Two configs, hyperparameters matched to the reference exactly (no passive
augmentation, no checkpoint selection, no grid normalization):

* ``readme``  — `/root/reference/README.md:38-70`: RNODE nvars=1 naug=1,
  Chain(Dense(2=>6,tanh), Dense(6=>2,tanh)), tspan=(0,13), steer_rate=0.1,
  lambda1=lambda2=lambda3=1e-2, solver reltol=sqrt(eps(f32)) abstol=eps(f32),
  Lion(1e-3, (0.9, 0.99)), 300 epochs, batch 32, n=1024 Beta(2,4) samples.
  Gate: est = p_hat(x, aug=0) vs actual = Beta pdf(x), mad/msd/tv <= 0.1
  (`README.md:100-108`).

* ``flagship`` — `/root/reference/test/regression_tests.jl:1-49`: RNODE
  nvars=8 naug=8, Chain(Dense(16=>48,tanh), Dense(48=>16,tanh)), tspan=(0,13),
  steer_rate=0.1, lambda3=1e-2 (lambda1=lambda2=1e-2 RNODE defaults), solver
  at OrdinaryDiffEq defaults (reltol=1e-3, abstol=1e-6 — the test passes no
  sol_kwargs), same optimizer/epochs/batch.  Gate: est = joint model density
  p_hat(x, aug=0) vs actual = prod_i Beta pdf(x_i) — both length-n vectors
  (the well-posed form of the reference's comparison at
  `regression_tests.jl:39-44`, whose raw shapes are 1024 vs 8x1024).

Usage:  python tools/literal_gates.py --config readme --seed 1 [--epochs 300]
Emits one JSON line per evaluation epoch plus a final summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np
import optax

from continuousnf_tpu.core.icnf import RNODE, construct, inference
from continuousnf_tpu.distributions import Beta
from continuousnf_tpu.nets import MLP
from continuousnf_tpu.train.fit import ICNFModel, fit
from continuousnf_tpu.types import Mode, README_TOLERANCES, SolverOptions


def gate_metrics(est: np.ndarray, actual: np.ndarray, nvars: int = 1) -> dict:
    """The reference's Distances triple (`test/regression_tests.jl:42-44`):
    meanad, msd, totalvariation/n — plus the scale-consistent companions used
    for multi-dimensional configs (see docs/FLAGSHIP_GATE.md):

    * ``tv_norm``  — total variation between the *sample-normalized* masses
      0.5·Σ|e/Σe − a/Σa| (dimensionless, the standard discrete TV).
    * ``log_mad``  — mean |log ê − log p| (joint relative error in nats).
    * ``log_mad_perdim`` — log_mad / nvars, directly comparable across
      dimensions (the 1-D README PASS sits at ≈0.03-0.06).
    * ``mad_rel``  — mad / mean(actual), the gate triple in units of the
      mean analytic density.
    """
    diff = est - actual
    e, a = est / max(est.sum(), 1e-30), actual / actual.sum()
    log_err = np.abs(np.log(np.clip(est, 1e-30, None)) - np.log(actual))
    return {
        "mad": float(np.mean(np.abs(diff))),
        "msd": float(np.mean(diff**2)),
        "tv": float(np.sum(np.abs(diff)) / 2.0 / len(est)),
        "tv_norm": float(0.5 * np.sum(np.abs(e - a))),
        "log_mad": float(np.mean(log_err)),
        "log_mad_perdim": float(np.mean(log_err) / nvars),
        "mad_rel": float(np.mean(np.abs(diff)) / np.mean(actual)),
    }


def build(config: str, seed: int, epochs: int, lr: float, batch_size: int,
          adjoint: str = "backsolve", aug_noise: float = 0.0,
          b2: float = 0.99, wd: float = 0.0, naug: int = -1, probes: int = 1,
          schedule: str = "const", width_mult: int = 3,
          exact_trace: bool = False, opt_name: str = "lion",
          clip: float = 0.0, train_rtol: float = 0.0, method: str = "",
          direct_max_steps: int = 0, lam12: float = -1.0,
          steer_rate: float = 0.1, x_jitter: float = 0.0,
          init_seed: int = -1, lam3: float = 1e-2, logit: bool = False):
    import dataclasses as dc

    from continuousnf_tpu.types import Adjoint

    key = jax.random.PRNGKey(seed)
    data_key, fit_key = jax.random.split(key)
    if init_seed >= 0:
        # Ensemble member: same data (seed), independent init/batch-order.
        fit_key = jax.random.fold_in(jax.random.PRNGKey(20_000), init_seed)
    dist = Beta(2.0, 4.0)
    n = 1024
    if config == "readme":
        nvars = 1
        naug = 1 if naug < 0 else naug
        solver = SolverOptions(**README_TOLERANCES)
    elif config == "flagship":
        nvars = 8
        naug = 8 if naug < 0 else naug
        solver = SolverOptions()  # OrdinaryDiffEq defaults: rtol 1e-3, atol 1e-6
    else:
        raise ValueError(config)
    n_in = nvars + naug
    nn = MLP((n_in, width_mult * n_in, n_in))
    solver = dc.replace(solver, adjoint=Adjoint[adjoint.upper()])
    if train_rtol > 0.0:
        solver = dc.replace(solver, rtol=train_rtol, atol=train_rtol * 1e-3)
    if method:
        solver = dc.replace(solver, method=method)
    if direct_max_steps:
        solver = dc.replace(solver, direct_max_steps=direct_max_steps)
    r = dist.sample(data_key, (n, nvars))
    from continuousnf_tpu.types import VecJacMode

    lam_kw = {} if lam12 < 0 else {"lam1": lam12, "lam2": lam12}
    icnf = construct(
        RNODE, nn, nvars, naug,
        tspan=(0.0, 13.0), steer_rate=steer_rate, lam3=lam3, solver=solver,
        aug_noise=aug_noise, x_jitter=x_jitter,
        input_bijector="logit" if logit else None,
        compute_mode=VecJacMode(num_probes=probes, exact_trace=exact_trace),
        **lam_kw,
    )
    # Optimisers.jl's Lion rule is decay-free (decay is composed separately
    # via OptimiserChain there); optax.lion silently defaults wd=1e-3, so an
    # explicit weight_decay=0 is required for matched hyperparameters.
    if schedule == "cosine":
        steps = epochs * (-(-n // batch_size))
        lr_sched = optax.cosine_decay_schedule(lr, steps, alpha=0.02)
    else:
        lr_sched = lr
    if opt_name == "lion":
        opt = optax.lion(lr_sched, b1=0.9, b2=b2, weight_decay=wd)
    elif opt_name == "adam":
        opt = optax.adamw(lr_sched, weight_decay=wd)
    else:
        raise ValueError(opt_name)
    if clip > 0.0:
        opt = optax.chain(optax.clip_by_global_norm(clip), opt)
    model = ICNFModel(icnf, optimizers=(opt,), n_epochs=epochs, batch_size=batch_size)
    actual = np.asarray(jnp.prod(dist.pdf(r), axis=1))
    return icnf, model, r, actual, fit_key, dist


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("readme", "flagship"), required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)  # Optimisers.Lion default eta
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--adjoint", default="backsolve", choices=("backsolve", "direct"))
    ap.add_argument("--b2", type=float, default=0.99)  # Lion paper beta2
    ap.add_argument("--wd", type=float, default=0.0)  # Optimisers.Lion has no decay
    ap.add_argument("--naug", type=int, default=-1)  # -1 = config default
    ap.add_argument("--probes", type=int, default=1)  # Hutchinson probes (ref: 1)
    ap.add_argument("--schedule", default="const", choices=("const", "cosine"))
    ap.add_argument("--width-mult", type=int, default=3)  # hidden = mult*(nvars+naug)
    ap.add_argument("--eval-rtol", type=float, default=0.0,
                    help="tighter TestMode eval tolerance (0 = training solver opts)")
    ap.add_argument("--save-ckpt", default="", help=".npz path for final params")
    ap.add_argument(
        "--aug-noise", default=0.0,
        help='TRAIN aug-input noise sigma, or "calibrated" (= (2*pi)^{-1/2})',
    )
    ap.add_argument("--exact-trace", action="store_true",
                    help="TRAIN with the exact divergence (zero-variance) "
                    "instead of the 1-probe Hutchinson estimator")
    ap.add_argument("--opt", default="lion", choices=("lion", "adam"))
    ap.add_argument("--clip", type=float, default=0.0,
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--train-rtol", type=float, default=0.0,
                    help="override the TRAINING solver rtol (atol = rtol*1e-3)")
    ap.add_argument("--method", default="", help="override the solver method")
    ap.add_argument("--direct-max-steps", type=int, default=0,
                    help="scan bound for the DIRECT adjoint (0 = default 512)")
    ap.add_argument("--steer-rate", type=float, default=0.1,
                    help="TRAIN t1 jitter rate (reference config: 0.1). "
                    "0 trains exactly the t1=13 eval estimand — used by the "
                    "fine-tune phase")
    ap.add_argument("--lam12", type=float, default=-1.0,
                    help="override lambda1=lambda2 (RNODE kinetic/Jacobian "
                    "regularizers; -1 = RNODE defaults 1e-2).  The lambdas "
                    "stabilize training but bias the learned density; a "
                    "zero-lambda fine-tune phase measures/removes that bias")
    ap.add_argument(
        "--live-ckpt", default="",
        help=".npz path for periodic (ps, opt_state, epoch) snapshots; a "
        "crashed run resumes from it with --resume (default: "
        "experiments/ckpt/<config>_s<seed>_live.npz)",
    )
    ap.add_argument("--resume", action="store_true",
                    help="resume bit-exactly from --live-ckpt if it exists")
    ap.add_argument("--init-ckpt", default="",
                    help="warm-start params from this .npz checkpoint "
                    "(fresh optimizer state and epoch counter)")
    ap.add_argument("--logit", action="store_true",
                    help="compose the flow with a fixed logit input bijector "
                    "(train in logit space; densities corrected by the "
                    "analytic Jacobian — see ICNF.input_bijector)")
    ap.add_argument("--lam3", type=float, default=1e-2,
                    help="norm_z_aug weight (reference config: 1e-2).  With "
                    "calibrated aug noise the lam3 pull toward z_aug(t1)=0 "
                    "fights the noise-MLE optimum (z_aug ~ base marginal); "
                    "0 removes that tension")
    ap.add_argument("--init-seed", type=int, default=-1,
                    help="decouple the init/batch-order seed from the data "
                    "seed (-1 = derive both from --seed).  Ensemble members "
                    "share --seed (the data) and differ in --init-seed")
    ap.add_argument("--x-jitter", type=float, default=0.0,
                    help="TRAIN data-input jitter std (smoothed MLE; the CNF "
                    "analog of KDE bandwidth — see ICNF.x_jitter)")
    ap.add_argument("--tail-avg", type=float, default=0.0,
                    help="Polyak-Ruppert tail averaging: uniformly average "
                    "param snapshots (at the --eval-every cadence) over the "
                    "last FRAC of epochs and ALSO score the gate at the "
                    "averaged params (SUMMARY key final_avg).  A "
                    "training-schedule choice, not checkpoint selection: the "
                    "averaged iterate is the procedure's single final output")
    ap.add_argument("--cpu", action="store_true",
                    help="pin the CPU backend (smoke tests; the env var "
                    "JAX_PLATFORMS is stripped on this runtime)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.aug_noise == "calibrated":
        from continuousnf_tpu.core.icnf import CALIBRATED_AUG_SIGMA

        args.aug_noise = CALIBRATED_AUG_SIGMA
    args.aug_noise = float(args.aug_noise)

    icnf, model, r, actual, fit_key, dist = build(
        args.config, args.seed, args.epochs, args.lr, args.batch_size, args.adjoint,
        args.aug_noise, args.b2, args.wd, args.naug, args.probes,
        args.schedule, args.width_mult, args.exact_trace, args.opt,
        args.clip, args.train_rtol, args.method, args.direct_max_steps,
        args.lam12, args.steer_rate, args.x_jitter, args.init_seed,
        args.lam3, args.logit,
    )

    # TestMode scoring may use tighter tolerances than training: the gate
    # measures the learned density, not the training solver's noise floor
    # (the reference's README itself recommends sqrt(eps)/eps tolerances for
    # evaluation, `/root/reference/README.md:61-67`).
    eval_icnf = icnf
    if args.eval_rtol > 0.0:
        import dataclasses as dc

        eval_icnf = dc.replace(
            icnf, solver=dc.replace(icnf.solver, rtol=args.eval_rtol,
                                    atol=args.eval_rtol * 1e-3),
        )
    def _score_full(ps, xs):
        lp, _, stats = inference(eval_icnf, Mode.TEST, xs, ps)
        return lp, stats.nfe

    score_full = jax.jit(_score_full)
    score = lambda ps, xs: score_full(ps, xs)[0]

    # TRAIN-solve step monitor at the *training* solver options: watches how
    # hard the model drives the solver (and, under the DIRECT adjoint, whether
    # the scan bound `direct_max_steps` is saturating — steps == bound means
    # the bounded solve returned before reaching t1 and gradients are wrong).
    def _train_steps(ps):
        _, _, stats = inference(
            icnf, Mode.TRAIN, r[:64], ps, key=jax.random.PRNGKey(123))
        return stats.steps

    train_steps = jax.jit(_train_steps)

    # Slice-mass monitor: Z = integral of p_hat(x, 0) dx.  1-D uses a
    # trapezoid grid; 8-D uses importance sampling with fresh Beta draws
    # (Z ~= E_beta[p_hat/actual]).  Z==1 iff the slice estimate is calibrated;
    # mad_shape is the gate metric after dividing out Z (pure shape error).
    if args.config == "readme":
        grid = jnp.linspace(1e-4, 1.0 - 1e-4, 513)[:, None]
        grid_p = None
    else:
        zkey = jax.random.PRNGKey(10_000 + args.seed)
        grid = dist.sample(zkey, (4096, icnf.nvars))
        grid_p = np.asarray(jnp.prod(dist.pdf(grid), axis=1))

    def slice_mass(ps) -> float:
        lp = score(ps, grid)
        if grid_p is None:
            return float(jnp.trapezoid(jnp.exp(lp), grid[:, 0])) * slice_factor
        return float(np.mean(np.exp(np.asarray(lp)) / grid_p)) * slice_factor

    history = []
    # Polyak-Ruppert tail average: running uniform mean of param snapshots
    # over the last `--tail-avg` fraction of epochs (at the eval cadence).
    avg = {"ps": None, "n": 0, "from_epoch": int((1.0 - args.tail_avg) * args.epochs)}

    def _accumulate(ps):
        host = jax.tree.map(lambda x: np.asarray(x, dtype=np.float64), ps)
        if avg["ps"] is None:
            avg["ps"], avg["n"] = host, 1
        else:
            avg["n"] += 1
            w = 1.0 / avg["n"]
            avg["ps"] = jax.tree.map(
                lambda m, x: m + w * (x - m), avg["ps"], host)

    # Factorized-slice calibration: with TRAIN aug inputs ~ N(0, s^2), the
    # model's joint is p16(x, a) ~= p8(x) * N(a; 0, s^2 I), so the slice
    # p16(x, 0) estimates p8(x) * (2*pi*s^2)^{-naug/2}.  Multiplying by the
    # analytic constant (s*sqrt(2*pi))^{naug} recovers p8.  At the calibrated
    # sigma = (2*pi)^{-1/2} the constant is exactly 1 (the round-2 design);
    # any other sigma is equally principled once corrected.
    slice_factor = 1.0
    if args.aug_noise > 0.0 and icnf.n_aug_input:
        slice_factor = float(
            (args.aug_noise * np.sqrt(2 * np.pi)) ** icnf.n_aug_input)

    # Density-space tail average: the mean of the tail evals' est vectors
    # (a uniform mixture of the late-trajectory models — function-space
    # Polyak averaging; param-space averaging of a nonlinear net is not the
    # same animal and measurably does nothing here).
    est_avg = {"sum": None, "n": 0}

    def evaluate(epoch, ps):
        in_tail = args.tail_avg > 0.0 and epoch >= avg["from_epoch"]
        if in_tail:
            _accumulate(ps)
        lp, nfe = score_full(ps, r)
        est = np.asarray(jnp.exp(lp)) * slice_factor
        if in_tail:
            est_avg["sum"] = est if est_avg["sum"] is None else est_avg["sum"] + est
            est_avg["n"] += 1
        m = gate_metrics(est, actual, icnf.nvars)
        z = slice_mass(ps)
        m_shape = gate_metrics(est / max(z, 1e-30), actual, icnf.nvars)
        m.update(
            epoch=epoch, est_mean=float(est.mean()), actual_mean=float(actual.mean()),
            z=z, mad_shape=m_shape["mad"], eval_nfe=int(nfe),
            train_steps=int(train_steps(ps)),
        )
        history.append(m)
        print(json.dumps({"config": args.config, "seed": args.seed, **m}), flush=True)
        return False

    # Crash-resilient state: periodic (ps, opt_state, epoch) snapshots let a
    # killed run resume bit-exactly (fit derives per-epoch PRNG keys from the
    # global epoch index), and the SUMMARY is emitted in `finally` so even a
    # crashed run leaves a machine-readable record marked complete=False.
    from continuousnf_tpu.train.checkpoint import load_checkpoint, save_checkpoint

    live_ckpt = args.live_ckpt or (
        f"experiments/ckpt/{args.config}_s{args.seed}_live.npz"
    )
    import os

    os.makedirs(os.path.dirname(live_ckpt) or ".", exist_ok=True)

    def snapshot(epoch, ps, opt_state):
        save_checkpoint(live_ckpt, {"ps": ps, "opt": opt_state, "epoch": epoch})

    resume_kw = {}
    if args.init_ckpt:
        from continuousnf_tpu.core.icnf import init_params

        init_key, _ = jax.random.split(fit_key)
        ps0 = init_params(icnf, init_key)
        resume_kw["ps"] = load_checkpoint(args.init_ckpt, ps0)
        print(json.dumps({"warm_started_from": args.init_ckpt}), flush=True)
    if args.resume and os.path.exists(live_ckpt):
        from continuousnf_tpu.core.icnf import init_params

        # Template pytree for checkpoint loading: the same init fit()
        # would run (fit splits its key into (init, train)).
        init_key, _ = jax.random.split(fit_key)
        ps0 = init_params(icnf, init_key)
        opt0 = model.optimizers[0].init(ps0)
        snap = load_checkpoint(live_ckpt, {"ps": ps0, "opt": opt0, "epoch": 0})
        resume_kw = {
            "ps": snap["ps"], "opt_state": snap["opt"],
            "epoch_start": int(snap["epoch"]),
        }
        print(json.dumps({"resumed_from": live_ckpt,
                          "epoch": int(snap["epoch"])}), flush=True)

    t0 = time.time()
    result = None
    try:
        result = fit(
            model, r, key=fit_key, callback=evaluate,
            callback_every=args.eval_every, state_callback=snapshot, **resume_kw,
        )
        if args.save_ckpt:
            save_checkpoint(args.save_ckpt, result.ps)
    finally:
        final = history[-1] if history else {}
        final_avg = None
        if result is not None and avg["ps"] is not None:
            ps_avg = jax.tree.map(
                lambda x: jnp.asarray(x, icnf.dtype), avg["ps"])
            lp, _ = score_full(ps_avg, r)
            est = np.asarray(jnp.exp(lp)) * slice_factor
            final_avg = gate_metrics(est, actual, icnf.nvars)
            final_avg["snapshots"] = avg["n"]
            if args.save_ckpt:
                save_checkpoint(args.save_ckpt + ".avg", ps_avg)
        final_destavg = None
        if est_avg["n"]:
            final_destavg = gate_metrics(
                est_avg["sum"] / est_avg["n"], actual, icnf.nvars)
            final_destavg["snapshots"] = est_avg["n"]
        summary = {
            "config": args.config,
            "seed": args.seed,
            "epochs": result.epochs if result is not None else (
                history[-1]["epoch"] if history else 0),
            "complete": result is not None,
            "lr": args.lr,
            "b2": args.b2,
            "naug": args.naug,
            "probes": args.probes,
            "wd": args.wd,
            "adjoint": args.adjoint,
            "opt": args.opt,
            "clip": args.clip,
            "exact_trace": args.exact_trace,
            "train_rtol": args.train_rtol,
            "method": args.method,
            "aug_noise": args.aug_noise,
            "batch_size": args.batch_size,
            "schedule": args.schedule,
            "width_mult": args.width_mult,
            "eval_rtol": args.eval_rtol,
            "lam12": args.lam12,
            "steer_rate": args.steer_rate,
            "x_jitter": args.x_jitter,
            "init_seed": args.init_seed,
            "lam3": args.lam3,
            "logit": args.logit,
            "init_ckpt": args.init_ckpt,
            "wall_s": round(time.time() - t0, 1),
            "final": {k: final.get(k) for k in (
                "mad", "msd", "tv", "tv_norm", "log_mad", "log_mad_perdim", "mad_rel")},
            "best_mad": min((h["mad"] for h in history), default=None),
            "best_epoch": min(history, key=lambda h: h["mad"])["epoch"] if history else None,
            "best_tv_norm": min((h["tv_norm"] for h in history), default=None),
            "tail_avg": args.tail_avg,
            "final_avg": final_avg,
            "final_destavg": final_destavg,
            "passes_norm_destavg": bool(final_destavg)
            and final_destavg["tv_norm"] <= 0.1
            and final_destavg["log_mad_perdim"] <= 0.1,
            "passes_norm_avg": bool(final_avg)
            and final_avg["tv_norm"] <= 0.1
            and final_avg["log_mad_perdim"] <= 0.1,
            "passes": bool(final) and result is not None
            and final["mad"] <= 0.1 and final["msd"] <= 0.1 and final["tv"] <= 0.1,
            # Scale-consistent gate for multi-D configs (docs/FLAGSHIP_GATE.md):
            # dimensionless TV <= 0.1 and per-dim log-density error <= 0.1.
            "passes_norm": bool(final) and result is not None
            and final["tv_norm"] <= 0.1 and final["log_mad_perdim"] <= 0.1,
        }
        print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
