"""Smoke run of the CNF main path on a GPU, through the public entry points.

    python chip_smoke.py          # one GPU: train, score, sample, parity
    python chip_smoke.py --four   # four GPUs: the data x probe mesh only

The model is the flagship the repo benchmarks, at full width with random
weights from a seed: RNODE nvars=8 naug=8, MLP 16->48->16 tanh, tspan
(0, 13), steer_rate 0.1, lambda3 1e-2, tsit5 at rtol 1e-3 / atol 1e-6,
B = 4096.

The card's name and power limit (nvidia-smi) are printed once and then ride
on every JSON line, one line per phase.  The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.  The script exits
non-zero, without that line, when JAX finds no GPU or any phase fails.
Everything runs in this one process: a second JAX process could not get
the card's memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import continuousnf_tpu as cnf
from continuousnf_tpu import Mode

B = 4096
TIGHT = {"rtol": 1e-5, "atol": 1e-8}  # solver error must not hide precision error


class PhaseFailed(Exception):
    pass


def card_line() -> str:
    """The card's `name, power.limit` line as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def parse_card_line(line: str) -> dict:
    """Split an nvidia-smi `name, power.limit` line, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W' -> {'name': ..., 'power_limit_w': 700.0}."""
    name, _, limit = line.rpartition(",")
    if not name:
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    limit = limit.strip()
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):
        watts = None  # "[N/A]" and similar
    return {"name": name.strip(), "power_limit_w": watts}


def flagship(solver: cnf.SolverOptions = cnf.SolverOptions(), **compute) -> cnf.ICNF:
    return cnf.construct(
        cnf.RNODE, cnf.MLP((16, 48, 16)), 8, 8, tspan=(0.0, 13.0), steer_rate=0.1,
        lam3=1e-2, compute_mode=cnf.VecJacMode(**compute), solver=solver,
    )


def reference(icnf: cnf.ICNF) -> cnf.ICNF:
    """The plain float32 reference: every stage matmul at "highest"; run it
    under `jax.default_matmul_precision("highest")`."""
    return dataclasses.replace(
        icnf, solver=dataclasses.replace(icnf.solver, stage_precision="highest")
    )


def rel_err(a, ref) -> float:
    """max|a - ref| / mean|ref|."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.mean(np.abs(ref)), 1e-30))


def check(name: str, value, tol, ok=None) -> dict:
    return {"check": name, "value": value, "tol": tol, "ok": bool(value <= tol if ok is None else ok)}


def median_wall(fn, n: int) -> float:
    """Median wall time of `n` calls of `fn()`, each closed by
    block_until_ready (after one warm-up call)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def data(n: int, seed: int = 1) -> jax.Array:
    return jax.random.uniform(jax.random.PRNGKey(seed), (n, 8), dtype=jnp.float32)


def phase_train(batch: int = B, n_samples: int = 4 * B, exact_steps: int = 10) -> dict:
    """`fit` for 2 epochs (Hutchinson TRAIN, backsolve adjoint), then
    `exact_steps` exact-trace TRAIN steps, each synced."""
    icnf = flagship()
    xs = data(n_samples)
    result = cnf.fit(cnf.ICNFModel(icnf, n_epochs=2, batch_size=batch), xs, key=jax.random.PRNGKey(0))
    steps_per_epoch = -(-n_samples // batch)
    # The last epoch ran in a call of its own after the compiling one.
    fit_ms = batch / result.metrics["samples_per_s"][-1] * 1e3
    fwd, bwd = jax.jit(
        lambda x, p: cnf.adjoint_stats(icnf, Mode.TRAIN, x, p, key=jax.random.PRNGKey(3))
    )(xs[:batch], result.ps)

    icnf_e = flagship(exact_trace=True)
    opt = optax.lion(1e-3)
    ps, xb = result.ps, xs[:batch]

    @jax.jit
    def exact_step(ps, opt_state, key):
        l, g = jax.value_and_grad(lambda p: cnf.loss(icnf_e, Mode.TRAIN, xb, p, key=key))(ps)
        upd, opt_state = opt.update(g, opt_state, ps)
        return optax.apply_updates(ps, upd), opt_state, l

    opt_state = opt.init(ps)
    t0 = time.perf_counter()
    ps_e, opt_state, l_e = jax.block_until_ready(exact_step(ps, opt_state, jax.random.PRNGKey(10)))
    compile_s = time.perf_counter() - t0
    walls, losses = [], []
    for i in range(exact_steps):
        t0 = time.perf_counter()
        ps_e, opt_state, l_e = jax.block_until_ready(
            exact_step(ps_e, opt_state, jax.random.PRNGKey(11 + i))
        )
        walls.append(time.perf_counter() - t0)
        losses.append(float(l_e))
    efwd, ebwd = jax.jit(
        lambda x, p: cnf.adjoint_stats(icnf_e, Mode.TRAIN, x, p, key=jax.random.PRNGKey(3))
    )(xb, ps_e)
    rec = {
        "fit": {
            "steps": 2 * steps_per_epoch,
            "loss": [float(v) for v in result.losses],
            "ms_per_step": fit_ms,
            "fwd_nfe_per_solve": float(result.metrics["nfe"][-1]),
            "bwd_attempts": int(bwd.steps),
            "fwd_attempts": int(fwd.steps),
            "wall_s_with_compile": result.wall_time_s,
        },
        "exact_trace": {
            "steps": exact_steps,
            "loss_last": losses[-1],
            "ms_per_step_median": statistics.median(walls) * 1e3,
            "compile_s": compile_s,
            "fwd_nfe_per_solve": int(efwd.nfe),
            "fwd_attempts": int(efwd.steps),
            "bwd_attempts": int(ebwd.steps),
        },
    }
    finite = np.all(np.isfinite(result.losses)) and np.all(np.isfinite(losses))
    if not finite:
        raise PhaseFailed(f"non-finite loss: {rec}")
    rec["_ps"] = ps_e
    return rec


def phase_score_sample(ps, batch: int = B) -> dict:
    """TEST log-density through `ICNFDist`, then `generate` at n=batch and
    at n=None (one sample)."""
    icnf = flagship()
    dist = cnf.ICNFDist(icnf, Mode.TEST, ps)
    xs = data(batch, seed=4)
    logpdf = jax.jit(dist.logpdf)
    lp = logpdf(xs)
    t_lp = median_wall(lambda: logpdf(xs), 5)
    _, _, st = jax.jit(lambda x: cnf.inference(icnf, Mode.TEST, x, ps))(xs)
    gen = jax.jit(lambda k: cnf.generate(icnf, Mode.TEST, ps, batch, key=k, with_stats=True))
    gen1 = jax.jit(lambda k: cnf.generate(icnf, Mode.TEST, ps, key=k, with_stats=True))
    key = jax.random.PRNGKey(7)
    samples, gst = gen(key)
    one, gst1 = gen1(key)
    t_gen = median_wall(lambda: gen(key), 5)
    t_gen1 = median_wall(lambda: gen1(key), 5)
    rec = {
        "logpdf": {"B": batch, "evals_per_s": batch / t_lp, "ms": t_lp * 1e3, "steps": int(st.steps),
                   "nfe": int(st.nfe), "mean_logp": float(jnp.mean(lp))},
        "generate": {"n": batch, "samples_per_s": batch / t_gen, "ms": t_gen * 1e3, "steps": int(gst.steps)},
        "generate_one": {"ms": t_gen1 * 1e3, "steps": int(gst1.steps)},
    }
    ok = (
        lp.shape == (batch,) and bool(jnp.all(jnp.isfinite(lp)))
        and samples.shape == (batch, 8) and bool(jnp.all(jnp.isfinite(samples)))
        and one.shape == (8,) and bool(jnp.all(jnp.isfinite(one)))
    )
    if not ok:
        raise PhaseFailed(f"bad score/sample output: {rec}")
    return rec


def tight_parity(batch: int = B) -> list:
    """The default path against the float32 reference at rtol 1e-5 /
    atol 1e-8: TRAIN and TEST logp, per-leaf gradients and step counts,
    with the same probes and key."""
    icnf = flagship(cnf.SolverOptions(**TIGHT))
    ref = reference(icnf)
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = data(batch)
    key = jax.random.PRNGKey(3)
    eps = icnf.draw_eps(jax.random.PRNGKey(2), batch)

    def run(model):
        train = jax.jit(lambda p: cnf.inference(model, Mode.TRAIN, xs, p, key=key, eps=eps))(ps)
        test = jax.jit(lambda p: cnf.inference(model, Mode.TEST, xs, p))(ps)
        grads = jax.jit(jax.grad(lambda p: cnf.loss(model, Mode.TRAIN, xs, p, key=key, eps=eps)))(ps)
        return train, test, grads

    (lp, _, st), (tp, _, tst), g = run(icnf)
    with jax.default_matmul_precision("highest"):
        (lp_r, _, st_r), (tp_r, _, tst_r), g_r = run(ref)
    tag = "default"
    out = [
        check(f"{tag}_train_logp_rel", rel_err(lp, lp_r), 2e-3),
        check(f"{tag}_test_logp_rel", rel_err(tp, tp_r), 2e-3),
        check(
            f"{tag}_grad_rel_worst_leaf",
            max(rel_err(a, b) for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_r))),
            5e-2,
        ),
    ]
    for name, s, s_r in (("train", st, st_r), ("test", tst, tst_r)):
        tol = max(5, int(0.05 * int(s_r.steps)))
        diff = abs(int(s.steps) - int(s_r.steps))
        out.append(check(f"{tag}_{name}_steps_diff(ref={int(s_r.steps)})", diff, tol))
    return out


def auto_steps_parity(batch: int = B) -> list:
    """At rtol 1e-3 the resolved "auto" stage precision must not inflate
    the step count: steps <= 1.2x the float32 reference's."""
    icnf = flagship()
    ref = reference(icnf)
    ps = icnf.init(jax.random.PRNGKey(0))
    xs = data(batch)
    key = jax.random.PRNGKey(3)

    def steps(model):
        tr = jax.jit(lambda: cnf.inference(model, Mode.TRAIN, xs, ps, key=key)[2].steps)()
        te = jax.jit(lambda: cnf.inference(model, Mode.TEST, xs, ps)[2].steps)()
        return int(tr), int(te)

    got = steps(icnf)
    with jax.default_matmul_precision("highest"):
        want = steps(ref)
    prec = cnf.types.resolve_stage_precision(icnf.solver)
    return [
        check(f"auto({prec})_{name}_steps_ratio(ref={w})", g / w, 1.2)
        for name, g, w in zip(("train", "test"), got, want)
    ]


def phase_parity(batch: int = B) -> dict:
    checks = tight_parity(batch) + auto_steps_parity(batch)
    rec = {"checks": checks}
    if not all(c["ok"] for c in checks):
        raise PhaseFailed(json.dumps(rec))
    return rec


def four_card(devices=None, batch: int = B) -> dict:
    """The data x probe mesh against one card: `make_sharded_train_step` on
    MeshConfig(data=2, probe=2) with 2 probes, compared with the unsharded
    step body on the same key; then `make_sharded_logprob` on
    MeshConfig(data=4) against the single-card log-prob."""
    from continuousnf_tpu.parallel import (
        MeshConfig, data_sharding, make_mesh, make_sharded_logprob,
        make_sharded_train_step, probe_sharding, shard_params,
    )
    from continuousnf_tpu.parallel.sharding import make_train_step_body

    devices = list(jax.devices()[:4] if devices is None else devices)
    if len(devices) != 4:
        raise PhaseFailed(f"--four needs 4 devices, found {len(devices)}")
    # At rtol 1e-5 a step accepted on one layout and rejected on the other
    # (the batch-global error norm sums in another order) moves the result
    # by far less than the 1e-4 tolerance.
    icnf = flagship(cnf.SolverOptions(**TIGHT), num_probes=2)
    # Plain SGD: the first Lion/Adam update is the sign of the gradient,
    # which flips on near-zero components when the psums add in another
    # order; an SGD update is the gradient itself, scaled.
    opt = optax.sgd(1e-3)
    ps = icnf.init(jax.random.PRNGKey(0))
    opt_state = opt.init(ps)
    xs = data(batch)
    key = jax.random.PRNGKey(2)
    one = jax.device_put((ps, opt_state, xs, key), devices[0])

    body = make_train_step_body(icnf, opt)
    ps1, _, m1 = jax.jit(lambda p, o, x, k: body(p, o, x, k))(*one)

    mesh = make_mesh(MeshConfig(data=2, probe=2), devices=devices)
    step = make_sharded_train_step(icnf, opt, mesh)
    xs_s = jax.device_put(xs, data_sharding(mesh))
    ps_s = shard_params(mesh, ps)
    ps4, _, l4 = step(ps_s, shard_params(mesh, opt_state), xs_s, key)

    # Forward attempts on both layouts, with the probes the step draws.
    eps_key, loss_key = jax.random.split(key)
    eps = icnf.draw_eps(eps_key, batch)

    def fwd_steps(p, x, e):
        return cnf.inference(icnf, Mode.TRAIN, x, p, key=loss_key, eps=e)[2].steps

    steps1 = int(jax.jit(fwd_steps)(*jax.device_put((ps, xs, eps), devices[0])))
    eps_s = jax.device_put(eps, probe_sharding(mesh))
    steps4 = int(jax.jit(fwd_steps)(ps_s, xs_s, eps_s))

    def shards(a):
        return sorted((str(s.device), tuple(s.data.shape)) for s in a.addressable_shards)

    leaves = lambda t: [np.asarray(x, np.float64) for x in jax.tree.leaves(jax.device_get(t))]
    param_rel = max(
        float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
        for a, b in zip(leaves(ps4), leaves(ps1))
    )
    loss_rel = abs(float(l4) - float(m1["loss"])) / max(abs(float(m1["loss"])), 1e-30)

    mesh4 = make_mesh(MeshConfig(data=4), devices=devices)
    lp4 = make_sharded_logprob(icnf, mesh4)(shard_params(mesh4, ps), jax.device_put(xs, data_sharding(mesh4)))
    lp1 = jax.jit(lambda p, x: cnf.inference(icnf, Mode.TEST, x, p)[0])(*jax.device_put((ps, xs), devices[0]))

    xs_shards = shards(xs_s)
    eps_shards = shards(eps_s)
    lp_shards = shards(lp4)
    layout_ok = (
        len({d for d, _ in xs_shards}) == 4 and all(s == (batch // 2, 8) for _, s in xs_shards)
        and len({d for d, _ in eps_shards}) == 4 and all(s == (1, batch // 2, 16) for _, s in eps_shards)
        and len({d for d, _ in lp_shards}) == 4 and all(s == (batch // 4,) for _, s in lp_shards)
    )
    checks = [
        check("sharded_loss_rel", loss_rel, 1e-4),
        # The adjoint's parameter cotangent is a batch reduction integrated
        # over every step: with equal step counts the two layouts' gradients
        # still differ by ~1e-4 of the largest element from f32 summation
        # order alone (CPU 4-device mesh, B=64), hence 1e-3 after the step.
        check("sharded_params_rel", param_rel, 1e-3),
        check(f"sharded_fwd_steps_diff(one={steps1})", abs(steps4 - steps1), 1),
        check("sharded_logprob_rel", rel_err(lp4, lp1), 1e-4),
        check("every_device_holds_its_shard", 0, 0, ok=layout_ok),
    ]
    rec = {
        "checks": checks,
        "loss": {"sharded": float(l4), "one_card": float(m1["loss"])},
        "shards": {"xs(data)": xs_shards, "eps(probe,data)": eps_shards, "logprob(data=4)": lp_shards},
    }
    if not all(c["ok"] for c in checks):
        raise PhaseFailed(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-GPU mesh check")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU backend (JAX found {jax.default_backend()!r})", file=sys.stderr)
        return 2
    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(card, flush=True)
    d = jax.devices()[0]

    def emit(phase, **rec):
        print(json.dumps({"phase": phase, "card": card, **rec}, default=str), flush=True)

    emit("device", platform=d.platform, kind=d.device_kind, count=len(jax.devices()),
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""))

    if args.four:
        phases = [("four_card", four_card)]
    else:
        state = {}

        def train():
            rec = phase_train()
            state["ps"] = rec.pop("_ps")
            rec["peak_bytes_in_use"] = (d.memory_stats() or {}).get("peak_bytes_in_use")
            return rec

        phases = [
            ("train", train),
            ("score_sample", lambda: phase_score_sample(state["ps"])),
            ("parity", phase_parity),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception as exc:  # a failed phase is reported, then the run fails
            failed.append(name)
            emit(name, ok=False, error=f"{type(exc).__name__}: {exc}"[:4000])
            continue
        emit(name, ok=True, wall_s=time.perf_counter() - t0, **rec)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
