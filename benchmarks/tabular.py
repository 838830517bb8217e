"""Tabular-scale benchmark: POWER (6D) and MINIBOONE (43D) shapes.

BASELINE config #5: UCI tabular density estimation — reports TRAIN-mode step
throughput (Hutchinson VJP through a 3-layer MLP) and TEST-mode exact-trace
log-prob throughput (the N-layer chain-product Jacobian path, SURVEY §7
"hard parts"), WITH per-config solver diagnostics (NFE, steps) so
throughput differences are attributable.

Synthetic data with the right shapes (zero-egress environment); swap in the
real CSVs via `continuousnf_tpu.io.load_csv` when available.

Timing: repetition happens on the device in one `lax.scan`, timed by the
wall clock around it and closed by `block_until_ready` (`bench.time_scanned`).

Run: python benchmarks/tabular.py [--out tabular.json]
"""

import argparse
import json
import os
import sys

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax.numpy as jnp
    import numpy as np
    import optax

    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    import continuousnf_tpu as cnf
    from bench import device_record, time_scanned
    from continuousnf_tpu import Mode
    from continuousnf_tpu.data import synthetic_tabular

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--csv", default="", help="train on a real CSV (native "
                    "mmap loader, standardized) instead of synthetic data; "
                    "e.g. a generated POWER-scale file from tools/loader_bench"
                    ".py --keep-csv")
    args = ap.parse_args()

    results = {}
    configs = [("power6", 6, 64, 4096), ("miniboone43", 43, 128, 2048)]
    csv_data = None
    if args.csv:
        from continuousnf_tpu.io.native_loader import load_csv

        csv_data, _, _ = load_csv(args.csv, has_header=True, standardize=True)
        d_csv = csv_data.shape[1]
        configs.append(
            ("csv" + str(d_csv), d_csv, 64 if d_csv <= 10 else 128, 4096)
        )
    for name, d, hidden, batch in configs:
        nn = cnf.MLP((d, hidden, hidden, d))
        icnf = cnf.construct(cnf.RNODE, nn, d, 0, tspan=(0.0, 1.0))
        ps = icnf.init(jax.random.PRNGKey(0))
        if name.startswith("csv"):
            xs = jnp.asarray(csv_data[:batch])
        else:
            xs = synthetic_tabular(jax.random.PRNGKey(1), batch, d)
        opt = optax.lion(1e-3)
        opt_state = opt.init(ps)
        key = jax.random.PRNGKey(2)

        def train_step(carry, i, icnf=icnf, opt=opt, xs=xs):
            ps_, os_ = carry
            _, g = jax.value_and_grad(
                lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=jax.random.fold_in(key, i))
            )(ps_)
            u, os_ = opt.update(g, os_, ps_)
            return optax.apply_updates(ps_, u), os_

        train_dt = time_scanned(train_step, (ps, opt_state), length=8)

        def eval_step(x, i, icnf=icnf):
            lp, _, _ = cnf.inference(icnf, Mode.TEST, x, ps)
            return x + 1e-7 * jnp.tanh(lp)[:, None]  # chain the solves

        eval_dt = time_scanned(eval_step, xs, length=8)

        # Solver diagnostics per config: NFE makes a slow config
        # attributable to solver behavior vs per-evaluation cost.
        @jax.jit
        def stats_of(x, icnf=icnf):
            _, _, st_tr = cnf.inference(icnf, Mode.TRAIN, x, ps, key=key)
            _, _, st_te = cnf.inference(icnf, Mode.TEST, x, ps)
            return st_tr, st_te

        st_tr, st_te = stats_of(xs)
        results[name] = {
            "d": d,
            "data": "csv:" + args.csv if name.startswith("csv") else "synthetic",
            "hidden": hidden,
            "batch": batch,
            "train_samples_per_sec": round(batch / train_dt, 1),
            "train_step_ms": round(train_dt * 1e3, 2),
            "train_nfe": int(st_tr.nfe),
            "train_steps": int(st_tr.steps),
            "train_accepted": int(st_tr.accepted),
            "exact_logprob_per_sec": round(batch / eval_dt, 1),
            "exact_logprob_ms": round(eval_dt * 1e3, 2),
            "test_nfe": int(st_te.nfe),
            "test_steps": int(st_te.steps),
            "train_us_per_nfe": round(train_dt / max(int(st_tr.nfe), 1) * 1e6, 2),
            "test_us_per_nfe": round(eval_dt / max(int(st_te.nfe), 1) * 1e6, 2),
        }
        print(f"{name}: {results[name]}", flush=True)

    out = {
        "tabular": results,
        **device_record(),
        "methodology": "on-device lax.scan repetition, wall clock closed by "
        "block_until_ready (bench.time_scanned)",
        "notes": {
            "test_path": "TEST uses the trace-only chain product "
            "(exact_dense_chain_trace) — no (B, d, d) Jacobian "
            "materialization",
        },
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
