"""Scaling-efficiency benchmark: samples/s vs number of devices.

BASELINE target: >=80% linear samples/s scaling at N>=2 workers.  This
script exercises the multi-device path on a faked N-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count), which validates the
sharding/collective structure and measures parallel efficiency of the
compiled program (CPU devices share host memory bandwidth, so treat CPU
efficiency numbers as a lower bound).  Scaling across real GPUs is not
measured here.

Run: python benchmarks/scaling.py [--devices 8] [--batch-per-device 512]
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--fixed-budget", action="store_true",
        help="pin the whole process to ONE physical core so the total "
        "compute budget is constant across N: per-unit-compute throughput "
        "then isolates partition + collective overhead from core contention "
        "(the round-2 confound).  Perfect partitioning = flat samples/s.")
    ap.add_argument(
        "--collective-bench", action="store_true",
        help="time psum on the virtual mesh across message sizes, fit the "
        "latency-bandwidth (alpha-beta) model, and report the implied "
        "gradient all-reduce cost on the virtual mesh.")
    args = ap.parse_args()

    if args.fixed_budget:
        os.sched_setaffinity(0, {0})  # before jax import: XLA threads inherit
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import continuousnf_tpu as cnf
    from continuousnf_tpu.parallel import (
        MeshConfig,
        make_mesh,
        make_sharded_train_step,
        shard_params,
        data_sharding,
    )

    nvars, naug = 8, 8
    n_in = nvars + naug
    nn = cnf.MLP((n_in, 3 * n_in, n_in))
    key = jax.random.PRNGKey(0)

    def throughput(n_dev: int) -> float:
        icnf = cnf.construct(
            cnf.RNODE, nn, nvars, naug, tspan=(0.0, 1.0), steer_rate=0.1, lam3=1e-2
        )
        mesh = make_mesh(MeshConfig(data=n_dev), devices=jax.devices()[:n_dev])
        # --fixed-budget holds TOTAL batch (and the single pinned core)
        # constant across N, so slowdown vs N=1 is pure partition +
        # collective overhead; default mode weak-scales per device.
        B = args.batch_per_device * (args.devices if args.fixed_budget
                                     else n_dev)
        xs = jax.device_put(
            jax.random.uniform(jax.random.PRNGKey(1), (B, nvars)), data_sharding(mesh)
        )
        opt = optax.lion(1e-3)
        ps = shard_params(mesh, icnf.init(key))
        opt_state = opt.init(ps)
        step = make_sharded_train_step(icnf, opt, mesh)
        c = step(ps, opt_state, xs, key)
        float(np.asarray(c[2]))
        t0 = time.perf_counter()
        cc = (c[0], c[1])
        for i in range(args.iters):
            out = step(cc[0], cc[1], xs, jax.random.fold_in(key, i))
            cc = (out[0], out[1])
        float(np.asarray(out[2]))
        dt = (time.perf_counter() - t0) / args.iters
        return B / dt

    if args.collective_bench:
        # alpha-beta fit of psum on the virtual mesh.  CPU-mesh constants are
        # not an interconnect's constants — the point is validating that
        # collective time is affine in bytes (t = alpha + bytes/beta).
        from functools import partial
        from jax.experimental.shard_map import shard_map
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[: args.devices]), ("d",))
        sizes = [2 ** k for k in range(8, 23, 2)]  # 1KiB..16MiB of f32
        rows = []
        for nel in sizes:
            x = jnp.zeros((args.devices, nel), jnp.float32)
            f = jax.jit(shard_map(partial(jax.lax.psum, axis_name="d"),
                                  mesh=mesh, in_specs=P("d", None),
                                  out_specs=P()))
            float(np.asarray(f(x)).ravel()[0])  # compile
            reps = 20 if nel <= 2 ** 16 else 5
            t0 = time.perf_counter()
            for _ in range(reps):
                r = f(x)
            float(np.asarray(r).ravel()[0])
            dt = (time.perf_counter() - t0) / reps
            rows.append((nel * 4, dt))
            print(f"psum {nel*4:>10} B: {dt*1e6:10.1f} us", flush=True)
        bts = np.array([r[0] for r in rows], dtype=np.float64)
        ts = np.array([r[1] for r in rows])
        beta_inv, alpha = np.polyfit(bts, ts, 1)
        resid = float(np.sqrt(np.mean((alpha + beta_inv * bts - ts) ** 2))
                      / np.mean(ts))
        out = {
            "collective": "psum",
            "devices": args.devices,
            "alpha_us": round(float(alpha) * 1e6, 2),
            "beta_GBps": round(1e-9 / float(beta_inv), 3),
            "affine_fit_rel_rmse": round(resid, 4),
            "points": [{"bytes": int(b), "t_us": round(t * 1e6, 1)}
                       for b, t in rows],
        }
        print(json.dumps(out))
        return

    results = {}
    base = None
    n = 1
    while n <= args.devices:
        sps = throughput(n)
        if base is None:
            base = sps
        # --fixed-budget: constant total compute, so perfect partitioning is
        # FLAT samples/s (efficiency = sps/sps_1); default mode divides by N
        # (core-bound upper bound min(cores/N, 1) on this host).
        eff = sps / base if args.fixed_budget else sps / (base * n)
        results[n] = {"samples_per_sec": round(sps, 1), "efficiency": round(eff, 3)}
        print(f"devices={n}: {sps:,.0f} samples/s  efficiency={eff:.1%}", flush=True)
        n *= 2

    # Wall-clock on a faked CPU mesh is bounded by physical cores, not by the
    # program: with C cores, N forced devices time-share and the measurable
    # ceiling is min(C/N, 1).
    out = {
        "mode": "fixed_total_core_budget" if args.fixed_budget else "free",
        "scaling_measured_cpu": results,
        "host_physical_cores": os.cpu_count(),
        "note": "CPU-mesh wall clock is core-bound (ceiling min(cores/N,1))",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
