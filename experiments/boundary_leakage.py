"""Measure boundary mass leakage of the raw-space flagship model.

The flagship target Beta(2,4)^8 is compactly supported on [0,1]^8; a smooth
Gaussian-base CNF fitted in RAW coordinates necessarily places some mass
outside the box (the map is a diffeomorphism of R^16).  This script loads a
trained raw-space checkpoint, draws N model samples (TEST mode, reverse
solve), and reports the fraction with any coordinate outside [0,1] — the
measured support-mismatch cost cited in docs/FLAGSHIP_GATE.md §4.

Usage: python experiments/boundary_leakage.py [--ckpt ...] [--n 8192] [--cpu]
"""
import argparse
import dataclasses as dc
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="experiments/ckpt/f_r3e_a.npz")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tools.literal_gates import build
    from continuousnf_tpu.core.icnf import init_params, generate
    from continuousnf_tpu.train.checkpoint import load_checkpoint
    from continuousnf_tpu.types import Mode

    icnf, *_ , fit_key, _ = build(
        "flagship", 1, 2000, 3e-4, 32, aug_noise=0.3989422804014327,
        schedule="cosine", exact_trace=True)
    cfg = dc.replace(icnf, solver=dc.replace(
        icnf.solver, rtol=args.rtol, atol=args.rtol * 1e-3))
    init_key, _ = jax.random.split(fit_key)
    ps = load_checkpoint(args.ckpt, init_params(icnf, init_key))

    xs = np.asarray(generate(cfg, Mode.TEST, ps, args.n,
                             key=jax.random.PRNGKey(7)))
    outside = ((xs < 0.0) | (xs > 1.0)).any(axis=-1)
    per_dim = ((xs < 0.0) | (xs > 1.0)).mean(axis=0)
    print(json.dumps({
        "ckpt": args.ckpt,
        "n": args.n,
        "frac_any_coord_outside": float(outside.mean()),
        "frac_outside_per_dim": [float(v) for v in per_dim],
        "min": float(xs.min()), "max": float(xs.max()),
    }))


if __name__ == "__main__":
    main()
