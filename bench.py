"""Benchmark: CNF training throughput on the flagship (regression-config) model.

Prints ONE JSON line: {"metric", "value", "unit", "extras"}.  The reference
publishes no absolute numbers (BASELINE.md), so there is no baseline ratio;
compare runs of this script on the same card.

The config mirrors the reference benchmark/regression configs, including
tspan=(0,13) (`/root/reference/benchmark/benchmarks.jl:43`,
`/root/reference/test/regression_tests.jl:20`): RNODE nvars=8 naug=8, tanh
MLP 16->48->16, TrainMode loss+gradient at the reference's effective solver
tolerances (rtol=1e-3/atol=1e-6 — its tests pass no sol_kwargs), B=4096,
plain XLA.  It reports the Hutchinson train step, the exact-trace train step
and TEST log-prob.  The NFE-normalized companion metric
`field_evals_per_sec` (= samples/s x NFE per solve) is transport-length-
invariant and is the number to compare across configs with different tspans.

Timing: each measurement runs `length` data-dependent iterations inside one
jitted `lax.scan` and takes the host wall time around it, closed by
`block_until_ready`; the minimum over repeats is reported.
"""

import json
import os
import time

import jax
import jax.numpy as jnp


def time_scanned(step_fn, carry, length: int, reps: int = 3) -> float:
    """Per-iteration wall time of `carry = step_fn(carry, i)`, run `length`
    times inside one jitted `lax.scan` (one dispatch); min over `reps`."""

    @jax.jit
    def run(c):
        return jax.lax.scan(lambda c, i: (step_fn(c, i), None), c, jnp.arange(length))[0]

    c = jax.block_until_ready(run(carry))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(c))
        ts.append(time.perf_counter() - t0)
    return min(ts) / length


def device_record() -> dict:
    """What the numbers were measured on."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def main():
    import optax

    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode

    nvars, naug = 8, 8
    n_in = nvars + naug
    batch = 4096
    nn = cnf.MLP((n_in, 3 * n_in, n_in))

    def mk(exact=False):
        return cnf.construct(
            cnf.RNODE,
            nn,
            nvars,
            naug,
            # Reference tspan — both its benchmark and regression configs
            # integrate 0 -> 13 (`benchmark/benchmarks.jl:43`,
            # `test/regression_tests.jl:20`).
            tspan=(0.0, 13.0),
            steer_rate=0.1,
            lam3=1e-2,
            compute_mode=cnf.VecJacMode(exact_trace=exact),
        )

    icnf = mk()
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (batch, nvars), dtype=jnp.float32)
    opt = optax.lion(1e-3)
    opt_state = opt.init(ps)
    key = jax.random.PRNGKey(2)

    def train_step_of(model):
        def train_step(carry, i):
            ps_, opt_state_ = carry
            _, g = jax.value_and_grad(
                lambda p: cnf.loss(model, Mode.TRAIN, xs, p, key=jax.random.fold_in(key, i))
            )(ps_)
            updates, opt_state_ = opt.update(g, opt_state_, ps_)
            return optax.apply_updates(ps_, updates), opt_state_

        return train_step

    def nfe_of(model):
        @jax.jit
        def f(x):
            _, _, stats = cnf.inference(model, Mode.TRAIN, x, ps, key=key)
            return stats.nfe

        return int(f(xs))

    train_dt = time_scanned(train_step_of(icnf), (ps, opt_state), length=12)
    train_sps = batch / train_dt
    # Forward-solve NFE at this config (field evaluations per TRAIN solve):
    # the transport-length-invariant normalizer for cross-config comparison.
    train_nfe = nfe_of(icnf)

    def eval_step(x, i):
        lp, _, _ = cnf.inference(icnf, Mode.TEST, x, ps)
        return x + 1e-6 * lp[:, None]  # data dependence chains the solves

    eval_dt = time_scanned(eval_step, xs, length=24)

    @jax.jit
    def test_stats(x):
        _, _, stats = cnf.inference(icnf, Mode.TEST, x, ps)
        return stats

    test_nfe = int(test_stats(xs).nfe)

    # The exact-divergence config (the recipe that passes the density gate).
    icnf_e = mk(exact=True)
    exact_dt = time_scanned(train_step_of(icnf_e), (ps, opt_state), length=8)
    fwd_st, bwd_st = jax.jit(lambda x: cnf.adjoint_stats(icnf, Mode.TRAIN, x, ps, key=key))(xs)

    print(
        json.dumps(
            {
                "metric": "train_samples_per_sec_per_chip",
                "value": round(train_sps, 1),
                "unit": "samples/s",
                "extras": {
                    "field_evals_per_sec": round(train_sps * train_nfe, 1),
                    "train_nfe_per_solve": train_nfe,
                    "train_fwd_attempts": int(fwd_st.steps),
                    "train_bwd_attempts": int(bwd_st.steps),
                    "logprob_evals_per_sec": round(batch / eval_dt, 1),
                    "batch": batch,
                    "train_step_ms": round(train_dt * 1e3, 3),
                    "logprob_ms": round(eval_dt * 1e3, 3),
                    "test_nfe": test_nfe,
                    "exact_trace_config": {
                        "train_samples_per_sec": round(batch / exact_dt, 1),
                        "train_step_ms": round(exact_dt * 1e3, 3),
                        "train_nfe_per_solve": nfe_of(icnf_e),
                    },
                    "solver": "tsit5 rtol=1e-3 atol=1e-6 (reference effective default)",
                    "tspan": [0.0, 13.0],
                    **device_record(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
