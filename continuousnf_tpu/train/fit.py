"""High-level training wrapper: the analog of the reference's MLJ extension.

`ICNFModel` mirrors the hyperparameter surface of the reference's model
(`/root/reference/src/exts/mlj_ext/core_icnf.jl:14-28`): Lion optimizer,
n_epochs=300, batch_size=32, shuffled minibatches with partial batches
(realized here as zero-weighted padding so every step has a static shape and
one compiled executable covers the whole fit).  `fit` plays the role of
`MLJModelInterface.fit` (`core_icnf.jl:30-92`), `transform` the TestMode
density scoring of `core_icnf.jl:94-122`.

The whole epoch (shuffle -> minibatch -> value_and_grad -> optimizer update)
is one jitted `lax.scan` per optimizer, so the Python loop only runs once per
chunk of epochs and the device does not wait on the host between steps.  Data parallelism: pass `mesh` (see
`continuousnf_tpu.parallel`) and batches are sharded over the data axis with
gradients reduced by XLA collectives.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.icnf import ICNF, inference, init_params, loss
from ..types import Mode


@dataclasses.dataclass(frozen=True)
class ICNFModel:
    """Training configuration wrapping an ICNF (reference `ICNFModel`,
    `/root/reference/src/exts/mlj_ext/core_icnf.jl:1-28`).

    `optimizers` is a sequence of optax gradient transformations applied
    sequentially, each for `n_epochs` (reference runs `solve` per optimizer,
    `core_icnf.jl:65-73`).
    """

    icnf: ICNF
    optimizers: Tuple[Any, ...] = None  # default: (optax.lion(1e-3),)
    n_epochs: int = 300
    batch_size: int = 32
    use_batch: bool = True
    sync_every: int = 0  # host-side metric sync cadence; 0 = only at the end

    def __post_init__(self):
        if self.optimizers is None:
            object.__setattr__(self, "optimizers", (optax.lion(1.0e-3),))
        if not isinstance(self.optimizers, tuple):
            object.__setattr__(self, "optimizers", tuple(self.optimizers))


# Conditional fitting uses the same machinery with ys stacked next to xs
# (reference `CondICNFModel`, `src/exts/mlj_ext/core_cond_icnf.jl`).
CondICNFModel = ICNFModel


@dataclasses.dataclass
class FitResult:
    """Fitted parameters + training diagnostics (the reference's fitresult is
    `(ps, st)`, `core_icnf.jl:88`; states are empty in our functional nets)."""

    icnf: ICNF
    ps: Any
    losses: np.ndarray  # per-epoch mean training loss
    wall_time_s: float
    epochs: int
    # Per-epoch observability (SURVEY §5): arrays keyed "loss", "e" (mean
    # Edot), "n" (mean ndot), "nfe" (mean forward NFE), "samples_per_s".
    metrics: Optional[dict] = None
    # Column names seen at fit time for named-table inputs (None for plain
    # arrays); transform validates/reorders named inputs against these so a
    # reordered DataFrame scores the same densities.
    column_names: Optional[list] = None
    cond_column_names: Optional[list] = None


def _pad_count(n: int, batch_size: int) -> Tuple[int, int]:
    n_batches = -(-n // batch_size)
    return n_batches, n_batches * batch_size - n


def _make_epochs_fn(
    model: ICNFModel,
    n: int,
    has_cond: bool,
    optimizer,
    mesh=None,
    epochs_per_call: int = 1,
):
    """Build the jitted multi-epoch function: for each epoch, permutation ->
    padded batches -> scan of train steps; epochs themselves are scanned so
    one device call covers `epochs_per_call` epochs.  Padded tail samples
    carry weight 0, reproducing the reference DataLoader's `partial=true`
    semantics with static shapes."""
    from ..parallel.sharding import make_train_step_body

    icnf = model.icnf
    batch_size = model.batch_size if model.use_batch else n
    n_batches, pad = _pad_count(n, batch_size)
    step_body = make_train_step_body(icnf, optimizer, mesh)

    def one_epoch(ps, opt_state, xs, ys, key):
        perm_key, step_key = jax.random.split(key)
        perm = jax.random.permutation(perm_key, n)
        if pad:
            perm = jnp.concatenate([perm, perm[:pad]])
            w = jnp.concatenate(
                [jnp.ones((n,), icnf.dtype), jnp.zeros((pad,), icnf.dtype)]
            )
        else:
            w = jnp.ones((n,), icnf.dtype)
        xb = xs[perm].reshape(n_batches, batch_size, -1)
        wb = w.reshape(n_batches, batch_size)
        yb = ys[perm].reshape(n_batches, batch_size, -1) if has_cond else None

        def step(carry, inp):
            ps, opt_state = carry
            if has_cond:
                bx, bw, by, k = inp
            else:
                (bx, bw, k), by = inp, None
            ps, opt_state, metrics = step_body(ps, opt_state, bx, k, weights=bw, ys=by)
            return (ps, opt_state), metrics

        keys = jax.random.split(step_key, n_batches)
        inputs = (xb, wb, yb, keys) if has_cond else (xb, wb, keys)
        (ps, opt_state), ms = jax.lax.scan(step, (ps, opt_state), inputs)
        # Per-epoch metric means (nfe as float mean over the epoch's steps).
        ms = {k: jnp.mean(v.astype(jnp.float32)) for k, v in ms.items()}
        return ps, opt_state, ms

    def epochs(ps, opt_state, xs, ys, train_key, epoch_base):
        def body(carry, idx):
            ps, opt_state = carry
            # Per-epoch keys derive from the GLOBAL epoch index so chunk
            # sizing (which adapts to wall-clock) never changes the math.
            ekey = jax.random.fold_in(train_key, idx)
            ps, opt_state, ms = one_epoch(ps, opt_state, xs, ys, ekey)
            return (ps, opt_state), ms

        idxs = epoch_base + jnp.arange(epochs_per_call)
        (ps, opt_state), ms = jax.lax.scan(body, (ps, opt_state), idxs)
        return ps, opt_state, ms

    return jax.jit(epochs)


def fit(
    model: ICNFModel,
    X: Any,
    Y: Any = None,
    *,
    key: jax.Array,
    ps: Any = None,
    opt_state: Any = None,
    epoch_start: int = 0,
    verbosity: int = 0,
    mesh=None,
    distributed: bool = False,
    callback=None,
    callback_every: int = 0,
    state_callback=None,
    profile_dir: Optional[str] = None,
) -> FitResult:
    """Train the model on data `X` (n, nvars) [and conditioning `Y` (n, n_cond)].

    Mirrors the reference fit flow (`core_icnf.jl:30-92`): init params, build
    shuffled loader, run each optimizer for n_epochs, log wall time.  `ps`
    warm-starts from existing parameters (checkpoint resume).

    Multi-host: with `distributed=True` (requires `mesh` spanning all
    processes' devices), `X`/`Y` are each process's LOCAL shard of the data;
    the shards are assembled into one globally-sharded array
    (`parallel.distributed.global_batch_from_host_shards`) and every process
    runs the identical SPMD fit program — per-epoch permutations and probe
    draws derive from the shared `key`, so the result is bit-identical to a
    single-process fit of the concatenated data on an equal mesh
    (tests/test_multihost.py::test_two_process_fit_matches_single_process).

    `callback(epoch, ps) -> bool` runs every `callback_every` epochs (when
    both are set); returning True stops training early — used e.g. by the
    augmented-slice normalization monitor (recipes.py).

    Exact crash resume (single-optimizer models): pass `ps`, `opt_state` and
    `epoch_start` from a checkpoint written by `state_callback(epoch, ps,
    opt_state)` (same cadence as `callback`) and the run continues bit-exactly
    — per-epoch PRNG keys derive from the *global* epoch index
    (`fold_in(train_key, epoch)`), so the remaining epochs see the same
    permutations/probes/steering draws as an uninterrupted run.

    `verbosity > 0` prints per-chunk progress on host 0 only (multi-host
    safe); `profile_dir` wraps the run in a `jax.profiler` trace (the analog
    of the reference's `@timed`/`progress` instrumentation,
    `src/exts/mlj_ext/core_icnf.jl:65-86`).
    """
    from ..data import table_to_matrix

    icnf = model.icnf
    from ..utils.debug import check_array

    xs, col_names = table_to_matrix(X, icnf.dtype)
    check_array("X", xs, rank=(2,), last_dim=icnf.nvars, dtype=icnf.dtype)
    has_cond = icnf.cond
    if has_cond and Y is None:
        raise ValueError("conditional model requires Y")
    cond_names = None
    if has_cond:
        ys, cond_names = table_to_matrix(Y, icnf.dtype)
    else:
        ys = jnp.zeros((xs.shape[0], 0), icnf.dtype)

    if distributed:
        if mesh is None:
            raise ValueError("distributed=True requires a mesh spanning all processes")
        from ..parallel.distributed import global_batch_from_host_shards

        xs = global_batch_from_host_shards(mesh, np.asarray(xs))
        if has_cond:
            ys = global_batch_from_host_shards(mesh, np.asarray(ys))
        else:
            # zero-width conditioning block stays host-replicated numpy (jit
            # treats consistent host arrays as replicated in multi-process).
            ys = np.zeros((xs.shape[0], 0), np.dtype(icnf.dtype))
    n = xs.shape[0]

    init_key, train_key = jax.random.split(key)
    if ps is None:
        ps = init_params(icnf, init_key)
    if distributed:
        # Params/keys become global replicated arrays: committed
        # single-device arrays cannot feed a multi-host jit.
        from ..parallel.mesh import replicated
        from ..parallel.sharding import shard_params

        ps = shard_params(mesh, ps)
        train_key = jax.device_put(train_key, replicated(mesh))
    if (opt_state is not None or epoch_start) and len(model.optimizers) != 1:
        raise ValueError("opt_state/epoch_start resume requires a single optimizer")

    is_host0 = jax.process_index() == 0

    t_start = time.perf_counter()
    history = []  # list of (metrics-dict-of-device-arrays, samples_per_s)
    epoch_i = int(epoch_start)
    stopped = False
    if profile_dir is not None:
        jax.profiler.start_trace(profile_dir)
    # One device call covers a chunk of epochs; callbacks run between chunks.
    # Chunk size adapts to keep each device call near TARGET_CALL_S, and is
    # quantized to powers of two so re-sizing costs at most log2(max_chunk)
    # compilations.
    TARGET_CALL_S = 15.0
    max_chunk = callback_every if (callback is not None and callback_every) else 32
    max_chunk = max(1, min(max_chunk, model.n_epochs))

    def _quantize(c: float) -> int:
        q = 1
        while q * 2 <= min(c, max_chunk):
            q *= 2
        return q

    for opt in model.optimizers:
        if stopped:
            break
        if opt_state is None:
            opt_state = opt.init(ps)
        fns = {}
        remaining = model.n_epochs - epoch_i if opt is model.optimizers[0] else model.n_epochs
        ci = 0
        chunk = 1  # first call measures per-epoch time
        epoch_cost = None
        while remaining > 0 and not stopped:
            cs = min(chunk, remaining)
            if cs not in fns:
                fns[cs] = _make_epochs_fn(model, n, has_cond, opt, mesh, epochs_per_call=cs)
            t_call = time.perf_counter()
            ps, opt_state, ms = fns[cs](
                ps, opt_state, xs, ys, train_key, np.int32(epoch_i)
            )
            # Close the async-dispatch region so chunk_wall is work time.
            jax.block_until_ready(ms)
            chunk_wall = time.perf_counter() - t_call
            if ci > 0:  # compile-free calls: track the per-epoch cost
                latest = max(chunk_wall / cs, 1e-3)
                # Conservative update: follow slowdowns immediately (a
                # diverging model can hit the solver's max_steps and make
                # epochs much slower), decay speedups gradually.
                epoch_cost = latest if epoch_cost is None else max(
                    latest, 0.5 * epoch_cost + 0.5 * latest
                )
                chunk = _quantize(TARGET_CALL_S / epoch_cost)
            epoch_i += cs
            remaining -= cs
            ci += 1
            # Device arrays; sync'd at the end.  samples/s is chunk-level
            # (includes any compile on the chunk's first use).
            history.append((ms, n * cs / max(chunk_wall, 1e-9)))
            if verbosity and is_host0 and model.sync_every and ci % model.sync_every == 0:
                print(
                    f"[fit] epoch {epoch_i}: loss={float(ms['loss'][-1]):.4f} "
                    f"E={float(ms['e'][-1]):.3f} n={float(ms['n'][-1]):.3f} "
                    f"nfe={float(ms['nfe'][-1]):.0f}"
                )
            if state_callback is not None:
                state_callback(epoch_i, ps, opt_state)
            if callback is not None and callback_every and callback(epoch_i, ps):
                stopped = True
        opt_state = None  # next optimizer re-inits
    if profile_dir is not None:
        jax.profiler.stop_trace()
    metrics: dict = {k: [] for k in ("loss", "e", "n", "nfe")}
    metrics["samples_per_s"] = []
    for ms, sps in history:
        per_epoch = np.asarray(ms["loss"]).shape[0]
        for k in ("loss", "e", "n", "nfe"):
            metrics[k].extend(np.asarray(ms[k], np.float64))
        metrics["samples_per_s"].extend([sps] * per_epoch)
    metrics = {k: np.asarray(v, np.float64) for k, v in metrics.items()}
    losses = metrics["loss"]
    wall = time.perf_counter() - t_start
    if verbosity and is_host0:
        print(f"[fit] {epoch_i} epochs in {wall:.1f}s; final loss {losses[-1]:.4f}")
    return FitResult(
        icnf=icnf, ps=ps, losses=losses, wall_time_s=wall, epochs=epoch_i,
        column_names=col_names, cond_column_names=cond_names, metrics=metrics,
    )


def fitted_params(result: FitResult):
    """(learned_parameters, states) — parity with the reference's
    `fitted_params` (`/root/reference/src/exts/mlj_ext/core.jl:1-4`); states
    are an empty dict in our stateless functional nets."""
    return result.ps, {}


def _align_columns(mat, names, fitted_names, what: str):
    """Reorder a named table's columns to the fit-time order (and error on a
    column-set mismatch).  Plain arrays (names=None) pass through: column
    order is their only contract, as in the reference's MLJ frontend."""
    if names is None or fitted_names is None or names == fitted_names:
        return mat
    if sorted(names) != sorted(fitted_names):
        raise ValueError(
            f"{what} columns {names} do not match the columns seen at fit "
            f"time {fitted_names}"
        )
    order = [names.index(c) for c in fitted_names]
    return mat[:, jnp.asarray(order)]


def transform(
    result: FitResult, X: Any, Y: Any = None, *, batch_size: int = 0,
    as_table: Optional[bool] = None,
):
    """TestMode density scoring: px = exp(logpx) (reference `transform`,
    `core_icnf.jl:94-122`, which returns `DataFrame(px = exp.(logp))`).

    `batch_size > 0` evaluates in fixed-size chunks (one compiled executable,
    zero-padding on the tail) — for datasets too large for one device call.
    The return shape mirrors the input (reference parity): tabular inputs
    (DataFrame/dict) get the reference-shaped px table back, array inputs get
    a plain px array.  Force one or the other with `as_table=True/False`.
    """
    from ..data import matrix_to_table, table_to_matrix

    icnf = result.icnf
    xs, x_names = table_to_matrix(X, icnf.dtype)
    if as_table is None:
        as_table = x_names is not None
    xs = _align_columns(xs, x_names, result.column_names, "X")
    ys = None
    if Y is not None:
        ys, y_names = table_to_matrix(Y, icnf.dtype)
        ys = _align_columns(ys, y_names, result.cond_column_names, "Y")
    if batch_size and xs.shape[0] > batch_size:
        n = xs.shape[0]
        n_chunks, pad = _pad_count(n, batch_size)
        xs_p = jnp.concatenate([xs, jnp.zeros((pad, xs.shape[1]), icnf.dtype)])
        xb = xs_p.reshape(n_chunks, batch_size, -1)
        yb = None
        if ys is not None:
            ys_p = jnp.concatenate([ys, jnp.zeros((pad, ys.shape[1]), icnf.dtype)])
            yb = ys_p.reshape(n_chunks, batch_size, -1)

        @jax.jit
        def score(bx, by):
            lp, _, _ = inference(icnf, Mode.TEST, bx, result.ps, ys=by)
            return lp

        parts = [score(xb[i], None if yb is None else yb[i]) for i in range(n_chunks)]
        logpx = jnp.concatenate(parts)[:n]
    else:
        logpx, _, _ = inference(icnf, Mode.TEST, xs, result.ps, ys=ys)
    px = jnp.exp(logpx)
    return matrix_to_table(px) if as_table else px


__all__ = ["ICNFModel", "CondICNFModel", "FitResult", "fit", "fitted_params", "transform"]
