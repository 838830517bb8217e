"""End-to-end example mirroring the reference README workflow
(`/root/reference/README.md:28-123`): construct an augmented RNODE, fit it to
Beta(2,4) data, checkpoint, evaluate the density against the analytic pdf,
and sample new data.

Run: python examples/readme_example.py [--epochs N] [--cpu]
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

# Importable regardless of cwd (the package lives next to examples/).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from continuousnf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    import continuousnf_tpu as cnf
    from continuousnf_tpu import Mode

    # Parameters (reference README: nvars=1, naugs=nvars, n=1024)
    nvars, naugs, n = 1, 1, 1024
    n_in = nvars + naugs

    # Model: Chain(Dense(2=>6,tanh), Dense(6=>2,tanh)) equivalent.
    # aug_noise="calibrated" draws the TRAIN-mode augmented inputs from
    # N(0, (2*pi)^{-1}) instead of the reference's zeros — the proper joint
    # MLE whose optimum has p_hat(x, 0) = p(x); the literal zero-fill
    # objective diverges (see REGRESSION.md).
    nn = cnf.MLP((n_in, 3 * n_in, n_in))
    icnf = cnf.construct(
        cnf.RNODE,
        nn,
        nvars,
        naugs,
        tspan=(0.0, 13.0),
        steer_rate=1.0e-1,
        lam1=1.0e-2,
        lam2=1.0e-2,
        lam3=1.0e-2,
        solver=cnf.SolverOptions(**cnf.README_TOLERANCES),
        aug_noise="calibrated",
    )

    # Data
    data_dist = cnf.distributions.Beta(2.0, 4.0)
    key = jax.random.PRNGKey(0)
    data_key, fit_key, sample_key = jax.random.split(key, 3)
    r = data_dist.sample(data_key, (n, nvars))

    # Fit it — stabilizer-free: final-epoch params, no callbacks (Lion
    # without optax's silent default weight decay, matching Optimisers.jl).
    import optax

    model = cnf.ICNFModel(
        icnf, optimizers=(optax.lion(3e-4, b1=0.9, b2=0.99, weight_decay=0.0),),
        n_epochs=args.epochs, batch_size=32,
    )
    result = cnf.fit(model, r, key=fit_key, verbosity=1)

    # Store it / reload it
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fitted.npz")
    cnf.save_checkpoint(ckpt, result.ps)
    ps = cnf.load_checkpoint(ckpt, jax.tree.map(jnp.zeros_like, result.ps))

    # Use it
    d = cnf.ICNFDist(icnf, Mode.TEST, ps)
    actual_pdf = np.asarray(data_dist.pdf(r))[:, 0]
    estimated_pdf = np.asarray(d.pdf(r))
    new_data = d.sample(sample_key, n)

    # Evaluate it (reference README's mad/msd/tv metrics)
    diff = estimated_pdf - actual_pdf
    mad = float(np.mean(np.abs(diff)))
    msd = float(np.mean(diff**2))
    tv = float(np.sum(np.abs(diff)) / 2 / n)
    print(f"epochs run: {result.epochs}  mad={mad:.4f} msd={msd:.4f} tv={tv:.4f}")
    print(f"samples: mean={float(new_data.mean()):.3f} (Beta(2,4) mean = {2/6:.3f})")


if __name__ == "__main__":
    main()
