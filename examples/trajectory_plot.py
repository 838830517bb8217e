"""Transport-trajectory visualization.

Trains a tiny FFJORD on the two-moons toy, extracts the transport paths of a
handful of samples with `inference(..., trajectory=True)`, and plots data ->
base-distribution paths.  The reference exposes this through the
`sol_kwargs` passthrough (`save_everystep`/`saveat` to `SciMLBase.solve`,
`/root/reference/src/base_icnf.jl:137-143`); here it is a fixed-grid
segmented solve.

Usage:  python examples/trajectory_plot.py [--epochs 60] [--out traj.png]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--out", default="trajectories.png")
    args = ap.parse_args()

    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode
    from continuousnf_tpu import data as toy
    from continuousnf_tpu.train.fit import ICNFModel, fit

    import optax

    key = jax.random.PRNGKey(0)
    dkey, fkey = jax.random.split(key)
    r = toy.two_moons(dkey, args.n)
    icnf = cnf.construct(
        cnf.FFJORD, cnf.MLP((2, 32, 32, 2)), 2, 0, tspan=(0.0, 8.0),
    )
    model = ICNFModel(
        icnf, optimizers=(optax.lion(1e-3),), n_epochs=args.epochs, batch_size=256
    )
    result = fit(model, r, key=fkey)

    # 64 sample paths, 33-point grid.
    import dataclasses as dc

    icnf_t = dc.replace(
        icnf, solver=dc.replace(icnf.solver, saveat=tuple(np.linspace(0, 8, 33)))
    )
    _, _, _, (ts, zs) = cnf.inference(
        icnf_t, Mode.TEST, r[:64], result.ps, trajectory=True
    )
    zs = np.asarray(zs)  # (T, 64, 2)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; trajectory array:", zs.shape)
        return

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(*np.asarray(r[:512]).T, s=4, alpha=0.3, label="data (t=0)")
    for b in range(zs.shape[1]):
        ax.plot(zs[:, b, 0], zs[:, b, 1], lw=0.5, alpha=0.5, color="C1")
    ax.scatter(zs[-1, :, 0], zs[-1, :, 1], s=6, color="C2", label="base (t=T)")
    ax.legend()
    ax.set_title("CNF transport trajectories (two moons -> N(0, I))")
    fig.savefig(args.out, dpi=120)
    print("wrote", args.out, "| trajectory tensor", zs.shape)


if __name__ == "__main__":
    main()
