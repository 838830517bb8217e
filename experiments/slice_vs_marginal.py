"""Decompose the flagship tv_norm plateau: slice-at-0 vs marginalized eval.

The calibrated transported-augmentation model is a 16-D density p16(x, a)
trained so that its aug-conditional approximates N(0, (2pi)^-1 I).  The gate
scores the SLICE  est(x) = p16(x, 0)  (exact iff the model factorizes); the
mathematically proper 8-D estimate is the MARGINAL

    p8(x) = \int p16(x, a) da = E_{a~q}[ p16(x, a) / q(a) ],  q = N(0, s^2 I)

(importance sampling with the training aug distribution as proposal).  This
script evaluates a saved checkpoint both ways, at two solver tolerances, and
prints the gate metrics for each — separating model-factorization error and
solver error from genuine density error.

To score arbitrary (x, a) points, the 8+8 model is re-viewed as a 16-var,
0-aug ICNF over the same net/params/base (p16 IS that joint density).

Usage: python experiments/slice_vs_marginal.py [--ckpt PATH] [--cpu] [--K 64]
"""
import argparse
import dataclasses as dc
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="experiments/ckpt/f_r3e_a.npz")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tools.literal_gates import build, gate_metrics
    from continuousnf_tpu.core.icnf import (
        CALIBRATED_AUG_SIGMA, RNODE, construct, init_params, inference)
    from continuousnf_tpu.nets import MLP
    from continuousnf_tpu.train.checkpoint import load_checkpoint
    from continuousnf_tpu.types import Mode

    icnf, model, r, actual, fit_key, dist = build(
        "flagship", args.seed, 1, 3e-4, 32)
    sigma = CALIBRATED_AUG_SIGMA
    init_key, _ = jax.random.split(fit_key)
    ps = load_checkpoint(args.ckpt, init_params(icnf, init_key))

    naug = icnf.naugmented
    n = r.shape[0]

    # p16 view: same net, same 16-D base, zero augmentation.
    icnf16 = construct(
        RNODE, MLP((16, 48, 16)), 16, 0, tspan=icnf.tspan, solver=icnf.solver)

    def score16(ps, xa, rtol):
        cfg = dc.replace(icnf16, solver=dc.replace(
            icnf16.solver, rtol=rtol, atol=rtol * 1e-3))
        lp, _, _ = inference(cfg, Mode.TEST, xa, ps)
        return lp

    score_j = jax.jit(score16, static_argnums=(2,))
    zeros = jnp.zeros((n, naug), r.dtype)

    for rtol in (1e-5, 1e-7):
        # --- slice at a = 0 (the gated estimand) ---
        est_slice = np.asarray(jnp.exp(score_j(
            ps, jnp.concatenate([r, zeros], axis=1), rtol)))
        m = gate_metrics(est_slice, actual, icnf.nvars)
        print(json.dumps({"eval": "slice", "rtol": rtol,
                          **{k: round(v, 4) for k, v in m.items()}}), flush=True)

        # --- marginal over aug via importance sampling ---
        key = jax.random.PRNGKey(777)
        tot = np.zeros(n)
        logq_const = -0.5 * naug * np.log(2 * np.pi * sigma**2)
        for _ in range(args.K):
            key, sub = jax.random.split(key)
            a = sigma * jax.random.normal(sub, (n, naug))
            logq = logq_const - 0.5 * jnp.sum((a / sigma) ** 2, axis=1)
            lp = score_j(ps, jnp.concatenate([r, a], axis=1), rtol)
            tot += np.asarray(jnp.exp(lp - logq))
        est_marg = tot / args.K
        m = gate_metrics(est_marg, actual, icnf.nvars)
        print(json.dumps({"eval": f"marginal_K{args.K}", "rtol": rtol,
                          **{k: round(v, 4) for k, v in m.items()}}), flush=True)


if __name__ == "__main__":
    main()
