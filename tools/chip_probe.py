"""GPU measurements of the flagship model's train step, one JSON line each.

Run on a machine with one GPU:  python tools/chip_probe.py [--out DIR]

Phases:
  precision  steps per solve and wall time of Hutchinson TRAIN, exact-trace
             TRAIN and TEST log-prob under stage_precision default / high /
             highest (rtol 1e-3);
  trace      a profiler trace of 3 Hutchinson TRAIN steps (value_and_grad
             + Lion) at the default precision, reduced to device kernels
             per solver attempt, the gap between kernels and the device
             idle share.

The flagship is RNODE nvars=8 naug=8, MLP 16->48->16 tanh, tspan (0, 13),
steer_rate 0.1, lambda3 1e-2, tsit5 at rtol 1e-3 / atol 1e-6, B = 4096.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import optax

import continuousnf_tpu as cnf
from chip_smoke import B, card_line, data, flagship, median_wall
from continuousnf_tpu import Mode


def reduce_trace(trace_dir):
    """Device kernel events in a trace: count, busy union, idle share and
    inter-kernel gaps over the window from the first to the last event."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    ivs = []
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("Stream"):
                ivs += [(e.start_ns, e.end_ns) for e in evs]
    if not ivs:
        return {"lines": lines, "error": "no device Stream lines in the trace"}
    ivs.sort()
    busy, gaps = 0.0, []
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = ivs[-1][1] - ivs[0][0]
    return {
        "lines": lines,
        "kernels": len(ivs),
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "gap_median_us": statistics.median(gaps) / 1e3 if gaps else 0.0,
        "gap_mean_us": statistics.mean(gaps) / 1e3 if gaps else 0.0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/probe")
    ap.add_argument("--phases", default="precision,trace")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if jax.default_backend() != "gpu":
        sys.exit("chip_probe: no GPU backend")
    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    d = jax.devices()[0]

    def emit(**rec):
        print(json.dumps({"card": card, **rec}), flush=True)

    emit(phase="device", platform=d.platform, kind=d.device_kind, count=len(jax.devices()),
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""))

    base = flagship()
    ps = base.init(jax.random.PRNGKey(0))
    xs = data(B)
    key = jax.random.PRNGKey(2)
    opt = optax.lion(1e-3)
    opt_state = opt.init(ps)

    def make_step(icnf):
        @jax.jit
        def step(ps, opt_state, k):
            eps = None if icnf.compute_mode.exact_trace else icnf.draw_eps(jax.random.fold_in(k, 1), B)
            l, g = jax.value_and_grad(lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=k, eps=eps))(ps)
            upd, opt_state = opt.update(g, opt_state, ps)
            return optax.apply_updates(ps, upd), opt_state, l

        return step

    def steps_of(icnf):
        eps = None if icnf.compute_mode.exact_trace else icnf.draw_eps(jax.random.fold_in(key, 1), B)
        fst, bst = jax.jit(lambda: cnf.adjoint_stats(icnf, Mode.TRAIN, xs, ps, key=key, eps=eps))()
        return {"fwd_attempts": int(fst.steps), "bwd_attempts": int(bst.steps),
                "fwd_nfe": int(fst.nfe), "bwd_nfe": int(bst.nfe)}

    if "precision" in phases:
        for prec in ("default", "high", "highest"):
            for mode in ("hutchinson", "exact", "test"):
                icnf = flagship(cnf.SolverOptions(stage_precision=prec), exact_trace=(mode == "exact"))
                if mode == "test":
                    f = jax.jit(lambda x: cnf.inference(icnf, Mode.TEST, x, ps))
                    st = f(xs)[2]
                    counts = {"steps": int(st.steps), "nfe": int(st.nfe)}
                    med = median_wall(lambda: f(xs), 10)
                else:
                    step = make_step(icnf)
                    med = median_wall(lambda: step(ps, opt_state, key), 10)
                    counts = steps_of(icnf)
                emit(phase="precision", precision=prec, mode=mode, wall_ms_median=med * 1e3, **counts)

    if "trace" in phases:
        step = make_step(base)
        jax.block_until_ready(step(ps, opt_state, key))
        tdir = os.path.join(args.out, "trace_train_step")
        jax.profiler.start_trace(tdir)
        for i in range(3):
            jax.block_until_ready(step(ps, opt_state, jax.random.fold_in(key, i)))
        jax.profiler.stop_trace()
        red = reduce_trace(tdir)
        counts = steps_of(base)
        red["kernels_per_step"] = red.get("kernels", 0) / 3
        red["kernels_per_attempt"] = red.get("kernels", 0) / (
            3 * (counts["fwd_attempts"] + counts["bwd_attempts"]))
        emit(phase="trace", **counts, **red)

    emit(phase="memory", peak_bytes_in_use=(d.memory_stats() or {}).get("peak_bytes_in_use"))


if __name__ == "__main__":
    main()
