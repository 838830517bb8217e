"""Probe-axis parallelism: correctness + cost of sharding the Hutchinson
probe axis (the CNF analog of context parallelism, SURVEY §5).

Two measurements:

A. Virtual mesh (CPU, 8 fake devices): K=8 Hutchinson train step on a
   1-device mesh vs probe-sharded over ("data"=1, "probe"=8).  Reports
   max|loss delta| (must be ~f32 epsilon — same math, psum over probes) and
   the step-time ratio.  CPU devices share one host's cores, so the timing
   is a *structure* check (does the sharded program parallelize the probe
   loop), not an interconnect-speedup claim.

B. One accelerator: per-NFE cost of the K-probe TRAIN forward solve for
   K in {1,2,4,8}.  cost(K) is ~affine in K; its slope is what an N-way
   probe-sharded mesh divides (each device runs K/N probes + one (1,B)
   psum per stage).

Run: python benchmarks/probe_scaling.py --part a   (CPU virtual mesh)
     python benchmarks/probe_scaling.py --part b   (one accelerator)
Writes/merges probe sections into a JSON file with --out.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def part_a(devices: int = 8):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import time

    import jax.numpy as jnp
    import numpy as np
    import optax

    import continuousnf_tpu as cnf
    from continuousnf_tpu.parallel import (
        MeshConfig,
        make_mesh,
        make_sharded_train_step,
        shard_params,
    )

    K = devices
    nvars, naug = 8, 8
    nn = cnf.MLP((16, 48, 16))
    icnf = cnf.construct(
        cnf.RNODE, nn, nvars, naug, lam3=1e-2,
        compute_mode=cnf.VecJacMode(num_probes=K),
        solver=cnf.SolverOptions(rtol=1e-2, atol=1e-4, max_steps=300),
    )
    B = 256
    xs = jax.random.uniform(jax.random.PRNGKey(1), (B, nvars))
    opt = optax.lion(1e-3)
    key = jax.random.PRNGKey(2)

    def run(mesh):
        ps = shard_params(mesh, icnf.init(jax.random.PRNGKey(0)))
        step = make_sharded_train_step(icnf, opt, mesh)
        o = opt.init(ps)
        ps2, o, l = step(ps, o, xs, key)  # compile
        float(np.asarray(l))
        t0 = time.perf_counter()
        iters = 6
        for _ in range(iters):
            ps2, o, l = step(ps2, o, xs, key)
        lv = float(np.asarray(l))
        dt = (time.perf_counter() - t0) / iters
        chk = float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(ps2)))
        return lv, chk, dt

    mesh1 = make_mesh(MeshConfig(data=1, probe=1), devices=jax.devices()[:1])
    meshP = make_mesh(MeshConfig(data=1, probe=devices))
    l1, c1, t1 = run(mesh1)
    lP, cP, tP = run(meshP)
    out = {
        "what": f"K={K} Hutchinson train step, 1 device vs probe-sharded over "
        f"{devices} virtual CPU devices (data=1, probe={devices})",
        "loss_1dev": l1,
        "loss_probe_sharded": lP,
        "abs_loss_delta": abs(l1 - lP),
        "param_checksum_rel_delta": abs(c1 - cP) / max(abs(c1), 1e-12),
        "step_ms_1dev": round(t1 * 1e3, 2),
        "step_ms_probe_sharded": round(tP * 1e3, 2),
        "speedup": round(t1 / tP, 3),
        "note": "identical math (probe mean -> psum over the probe axis); "
        "CPU virtual devices share host cores, so speedup is a lower bound "
        "— the structural claim is correctness + a parallelized probe loop",
    }
    print(json.dumps({"probe_sharding_virtual_mesh": out}))
    return {"probe_sharding_virtual_mesh": out}


def part_b():
    import jax
    import jax.numpy as jnp

    import continuousnf_tpu as cnf
    from bench import device_record, time_scanned
    from continuousnf_tpu import Mode

    nvars, naug = 8, 8
    nn = cnf.MLP((16, 48, 16))
    xs = jax.random.uniform(jax.random.PRNGKey(1), (4096, nvars))
    key = jax.random.PRNGKey(2)
    curve = {}
    for K in (1, 2, 4, 8):
        icnf = cnf.construct(
            cnf.RNODE, nn, nvars, naug, tspan=(0.0, 13.0), lam3=1e-2,
            compute_mode=cnf.VecJacMode(num_probes=K),
        )
        ps = icnf.init(jax.random.PRNGKey(0))

        def step(c, i, icnf=icnf, ps=ps):
            lp, _, st = cnf.inference(icnf, Mode.TRAIN, c[0], ps, key=key)
            return (c[0] + 1e-7 * jnp.tanh(lp)[:, None], c[1] + st.nfe)

        dt = time_scanned(step, (xs, 0), length=8)

        @jax.jit
        def nfe_of(x, icnf=icnf, ps=ps):
            return cnf.inference(icnf, Mode.TRAIN, x, ps, key=key)[2].nfe

        nfe = int(nfe_of(xs))
        curve[K] = {
            "solve_ms": round(dt * 1e3, 3),
            "nfe": nfe,
            "us_per_nfe": round(dt / max(nfe, 1) * 1e6, 3),
        }
        print(f"K={K}: {curve[K]}", flush=True)
    ks = sorted(curve)
    base = curve[ks[0]]["us_per_nfe"]
    slope = (curve[ks[-1]]["us_per_nfe"] - base) / (ks[-1] - ks[0])
    out = {
        "what": "per-NFE cost of the K-probe TRAIN forward solve on ONE "
        "device, batch 4096 (the curve an N-way probe-sharded mesh divides)",
        **device_record(),
        "curve": curve,
        "us_per_nfe_probe_slope": round(slope, 3),
        "k1_base_us": base,
        # Sharding K=8 probes over 8 devices leaves K/N = 1 probe per device:
        # cost(K/N) = base + slope*(K/N - 1) = base (the per-stage (1, B) psum
        # cost is NOT modeled here; benchmarks/scaling.py --collective-bench
        # measures it separately).
        "implied_8probe_8dev_us_per_nfe": round(base + slope * (8 / 8 - 1), 3),
        "note": "cost(K) ~ base + slope*(K-1); probe-sharding K=8 over 8 "
        "devices runs 1 probe/device + a (1,B) psum per stage (psum cost "
        "excluded here) — variance of a K=8 estimate at ~K=1 latency",
    }
    print(json.dumps({"k_probe_cost_curve": out}))
    return {"k_probe_cost_curve": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["a", "b"], required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()
    res = part_a(args.devices) if args.part == "a" else part_b()
    if args.out:
        merged = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                merged = json.load(f)
        merged.update(res)
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)


if __name__ == "__main__":
    main()
