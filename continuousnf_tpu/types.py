"""Core type system: modes, compute modes, solver options.

Re-design of the reference's type layer
(`/root/reference/src/types.jl:1-36`).  The reference encodes Test/Train as
singleton types and the trace-estimation strategy as a 4-way ComputeMode type
tree (`DIVecJacVectorMode` / `DIJacVecVectorMode` / `DIVecJacMatrixMode` /
`DIJacVecMatrixMode`, each wrapping an AD backend).  Here all of that becomes
hashable frozen dataclasses used as *static* (trace-time) configuration for
jit: JAX resolves every branch at trace time, so there is no runtime dispatch
cost, and the reference's INPLACE axis disappears entirely (XLA owns buffer
reuse).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Mode(enum.Enum):
    """Evaluation mode (reference `src/types.jl:1-3`).

    TEST  -> exact trace (deterministic density), no steering jitter.
    TRAIN -> stochastic Hutchinson trace + regularizer accumulators + steering.
    """

    TEST = "test"
    TRAIN = "train"


#: Convenience aliases mirroring the reference's exported singletons.
TestMode = Mode.TEST
TrainMode = Mode.TRAIN


class ADMode(enum.Enum):
    """AD direction for trace probes (reference VecJac=reverse, JacVec=forward)."""

    VJP = "vjp"  # eps^T J via reverse-mode pullback
    JVP = "jvp"  # J eps via forward-mode pushforward


class EpsDist(enum.Enum):
    """Distribution of Hutchinson probe vectors.

    The reference draws probes from MvNormal(0, I)
    (`/root/reference/src/base_icnf.jl:22-25`); Rademacher probes have lower
    variance for trace estimation and are provided as an extra.
    """

    GAUSSIAN = "gaussian"
    RADEMACHER = "rademacher"


@dataclasses.dataclass(frozen=True)
class ComputeMode:
    """Static trace-computation configuration.

    Collapses the reference's VectorMode/MatrixMode distinction: everything is
    batched; single samples are a batch of one (the reference's
    VectorMode semantics fall out of `vmap`/broadcasting).

    Attributes:
      ad:         AD direction for Hutchinson probes (and exact trace:
                  VJP -> jacrev, JVP -> jacfwd).
      num_probes: number of Hutchinson probes K (reference is hard-wired to 1,
                  `/root/reference/src/base_icnf.jl:277-278`; K>1 reduces the
                  estimator variance as 1/K and gives a shardable probe axis).
      eps_dist:   probe distribution.
    """

    ad: ADMode = ADMode.VJP
    num_probes: int = 1
    eps_dist: EpsDist = EpsDist.GAUSSIAN
    # exact_trace=True replaces the TRAIN-mode Hutchinson estimator with the
    # exact divergence (the TEST-mode math) and the exact Jacobian Frobenius
    # norm for the lambda2 rate.  Same objective in expectation — Hutchinson
    # is unbiased for tr(J) and E||eps^T J||^2 = ||J||_F^2 — but zero
    # estimator variance, which removes the dominant gradient-noise source at
    # small state dims (the reference is locked to 1 stochastic probe,
    # `/root/reference/src/base_icnf.jl:277-278`; exact costs O(dz) probe
    # passes or a closed form for tanh MLPs, cheap for dz <= ~64).
    exact_trace: bool = False

    def __post_init__(self):
        if self.num_probes < 1:
            raise ValueError(f"num_probes must be >= 1, got {self.num_probes}")


def VecJacMode(num_probes: int = 1, **kw) -> ComputeMode:
    """Reverse-mode probes (analog of the reference's `DIVecJacMatrixMode`)."""
    return ComputeMode(ad=ADMode.VJP, num_probes=num_probes, **kw)


def JacVecMode(num_probes: int = 1, **kw) -> ComputeMode:
    """Forward-mode probes (analog of the reference's `DIJacVecMatrixMode`)."""
    return ComputeMode(ad=ADMode.JVP, num_probes=num_probes, **kw)


# Reference-parity aliases (matrix/vector collapse to the same batched impl).
DIVecJacMatrixMode = VecJacMode
DIJacVecMatrixMode = JacVecMode
DIVecJacVectorMode = VecJacMode
DIJacVecVectorMode = JacVecMode


class Adjoint(enum.Enum):
    """How gradients flow through the ODE solve.

    BACKSOLVE: continuous adjoint (optimize-then-discretize) — O(1) memory,
               re-integrates the state backward alongside the adjoint ODE.
    DIRECT:    discretize-then-optimize — backprop through a bounded
               `lax.scan` of solver steps (rematerialized), exact gradients of
               the discrete solution.
    NONE:      forward solve only; not differentiable (fastest for inference).
    """

    BACKSOLVE = "backsolve"
    DIRECT = "direct"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static ODE-solver configuration (analog of the reference's `sol_kwargs`
    NamedTuple passed verbatim to `solve`, `/root/reference/src/base_icnf.jl:141`).

    Defaults match the reference's *effective* behavior: its tests and
    regression gate call `construct` without `sol_kwargs`
    (`/root/reference/test/regression_tests.jl:9-28`), so Julia's `solve` runs
    at OrdinaryDiffEq defaults reltol=1e-3, abstol=1e-6.  The README's
    recommended tight tolerances (`/root/reference/README.md:61-67`) are
    available as :data:`README_TOLERANCES`.
    """

    # "tsit5" (default; what DefaultODEAlgorithm picks for the reference's
    # solves), "dop853" (high-order, for tight tolerances — Vern7's role),
    # "auto" (tsit5/dop853 split by rtol; `ode/tableaus.select_method`),
    # "dopri5", "bosh3", "trbdf2" (L-stable stiff fallback, `ode/implicit.py`),
    # or fixed-step "rk4"/"midpoint"/"euler".
    method: str = "tsit5"
    rtol: float = 1.0e-3
    atol: float = 1.0e-6
    max_steps: int = 10_000
    dt0: Optional[float] = None  # None -> automatic initial step (Hairer)
    fixed_num_steps: Optional[int] = None  # set -> fixed-step integration
    adjoint: Adjoint = Adjoint.BACKSOLVE
    # Bound on solver steps for the DIRECT (scan-based) differentiable path;
    # every iteration costs one step's compute even after convergence, so keep
    # it modest.
    direct_max_steps: int = 512
    # Fixed save grid for trajectory extraction (`inference(...,
    # trajectory=True)` / `ode.solve.odeint_saveat`) — a tuple of times
    # spanning [tspan[0], tspan[1]].  None -> an evenly spaced default grid
    # when a trajectory is requested; ignored by plain (final-state-only)
    # solves, which remain the hot path.  Analog of the reference's
    # `saveat` sol_kwarg (`/root/reference/src/base_icnf.jl:141`).
    saveat: Optional[Tuple[float, ...]] = None
    # Times the integrator must step exactly onto (sorted, within tspan):
    # the solve becomes a chain of adaptive segment solves split at these
    # points.  Analog of the reference's `tstops` sol_kwarg passthrough to
    # `SciMLBase.solve` (`/root/reference/src/base_icnf.jl:141`).  Rarely
    # useful for smooth autonomous CNF fields; provided for parity.  None =
    # single-segment solve (the hot path).
    tstops: Optional[Tuple[float, ...]] = None
    # Matmul precision the vector field is traced at inside the solver
    # ("auto" | "high" | "highest" | "float32" | "default").  Reduced-
    # precision f32 products ("default", "high") round at about the solver's
    # own rtol; that noise floods the embedded error estimate and the
    # controller shrinks the step to a noise floor (on an H100 the flagship
    # Hutchinson TRAIN solve took ~6x the forward attempts of "highest" at
    # rtol 1e-3, and the step ran 2.7-4.3x slower).  "auto" (the default)
    # therefore resolves to "highest" — see `resolve_stage_precision`.
    stage_precision: str = "auto"


def resolve_stage_precision(opts: "SolverOptions") -> str:
    """The effective stage precision for a solve ("auto" -> "highest")."""
    p = getattr(opts, "stage_precision", "auto")
    return "highest" if p == "auto" else p


#: The reference README's recommended tight tolerances
#: (`/root/reference/README.md:61-67`): reltol = sqrt(eps(Float32)),
#: abstol = eps(Float32).
README_TOLERANCES = {"rtol": 3.452669831108329e-4, "atol": 1.1920929e-7}


__all__ = [
    "Mode",
    "README_TOLERANCES",
    "TestMode",
    "TrainMode",
    "ADMode",
    "EpsDist",
    "ComputeMode",
    "VecJacMode",
    "JacVecMode",
    "DIVecJacMatrixMode",
    "DIJacVecMatrixMode",
    "DIVecJacVectorMode",
    "DIJacVecVectorMode",
    "Adjoint",
    "SolverOptions",
    "resolve_stage_precision",
]
