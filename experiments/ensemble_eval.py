"""Evaluate the deep-ensemble flagship estimator: est = mean_m p_hat_m(x).

Loads the sweep_r3j member checkpoints (same data seed, independent inits),
scores each member and every ensemble prefix on the gate sample at tight
tolerance, and prints gate metrics per size.  Run on a GPU or the CPU.

Usage: python experiments/ensemble_eval.py [--members 8] [--cpu]
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
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ckpt-tpl", default="experiments/ckpt/f_ens_m{m}.npz")
    ap.add_argument("--rtol", type=float, default=1e-5)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tools.literal_gates import build, gate_metrics
    from continuousnf_tpu.core.icnf import init_params, inference
    from continuousnf_tpu.train.checkpoint import load_checkpoint
    from continuousnf_tpu.types import Mode

    icnf, model, r, actual, fit_key, dist = build(
        "flagship", 1, 2000, 3e-4, 32, aug_noise=0.3989422804014327,
        schedule="cosine", exact_trace=True)
    cfg = dc.replace(icnf, solver=dc.replace(
        icnf.solver, rtol=args.rtol, atol=args.rtol * 1e-3))
    score = jax.jit(lambda p, x: inference(cfg, Mode.TEST, x, p)[0])
    init_key, _ = jax.random.split(fit_key)
    ps0 = init_params(icnf, init_key)

    ests = []
    for m in range(1, args.members + 1):
        try:
            ps = load_checkpoint(args.ckpt_tpl.format(m=m), ps0)
        except OSError:
            print(json.dumps({"member": m, "missing": True}))
            continue
        est = np.asarray(jnp.exp(score(ps, r)))
        ests.append(est)
        mm = gate_metrics(est, actual, icnf.nvars)
        print(json.dumps({"member": m, **{k: round(v, 4) for k, v in mm.items()}}),
              flush=True)
    for k in range(2, len(ests) + 1):
        mm = gate_metrics(np.mean(ests[:k], axis=0), actual, icnf.nvars)
        print(json.dumps({"ensemble": k, **{k2: round(v, 4) for k2, v in mm.items()}}),
              flush=True)
    if ests:
        D = np.array([np.log(np.clip(e, 1e-30, None)) - np.log(actual) for e in ests])
        C = np.corrcoef(D)
        off = C[np.triu_indices(len(ests), 1)]
        print(json.dumps({"mean_pairwise_log_err_corr": round(float(off.mean()), 4)}))


if __name__ == "__main__":
    main()
