"""continuousnf_tpu — a continuous-normalizing-flow framework in JAX.

Built from scratch in JAX/XLA with the capabilities of
ContinuousNormalizingFlows.jl (reference mounted at /root/reference):
the ICNF family (RNODE / FFJORD / Planar and conditional variants),
augmented dimensions, steering, lambda1/lambda2/lambda3 regularization,
exact and K-probe Hutchinson trace estimation, a differentiable adaptive
RK solver stack, training / distribution APIs, and multi-device mesh
scaling over batch and probe axes.
"""

from .types import (
    ADMode,
    Adjoint,
    ComputeMode,
    DIJacVecMatrixMode,
    DIJacVecVectorMode,
    DIVecJacMatrixMode,
    DIVecJacVectorMode,
    EpsDist,
    JacVecMode,
    Mode,
    README_TOLERANCES,
    SolverOptions,
    TestMode,
    TrainMode,
    VecJacMode,
)
from .core import (
    ICNF,
    RNODE,
    FFJORD,
    Planar,
    CondRNODE,
    CondFFJORD,
    CondPlanar,
    Regs,
    construct,
    CALIBRATED_AUG_SIGMA,
    init_params,
    inference,
    generate,
    loss,
    loss_and_metrics, adjoint_stats,
)
from .nets import Chain, CondLayer, Dense, MLP, PlanarLayer
from .ode import odeint, odeint_with_stats
from .dist import ICNFDist, CondICNFDist
from .train import (
    ICNFModel,
    CondICNFModel,
    FitResult,
    fit,
    fitted_params,
    transform,
    save_checkpoint,
    load_checkpoint,
)
from . import data, distributions, io, parallel, recipes, utils

__version__ = "0.1.0"

__all__ = [
    # types
    "ADMode",
    "Adjoint",
    "ComputeMode",
    "EpsDist",
    "JacVecMode",
    "VecJacMode",
    "DIVecJacMatrixMode",
    "DIJacVecMatrixMode",
    "DIVecJacVectorMode",
    "DIJacVecVectorMode",
    "Mode",
    "README_TOLERANCES",
    "SolverOptions",
    "TestMode",
    "TrainMode",
    # core
    "ICNF",
    "RNODE",
    "FFJORD",
    "Planar",
    "CondRNODE",
    "CondFFJORD",
    "CondPlanar",
    "Regs",
    "construct",
    "CALIBRATED_AUG_SIGMA",
    "init_params",
    "inference",
    "generate",
    "loss",
    "loss_and_metrics",
    "adjoint_stats",
    # nets
    "Chain",
    "CondLayer",
    "Dense",
    "MLP",
    "PlanarLayer",
    # ode
    "odeint",
    "odeint_with_stats",
    # dist
    "ICNFDist",
    "CondICNFDist",
    # train
    "ICNFModel",
    "CondICNFModel",
    "FitResult",
    "fit",
    "fitted_params",
    "transform",
    "save_checkpoint",
    "load_checkpoint",
    # subpackages
    "data",
    "distributions",
    "io",
    "parallel",
    "recipes",
    "utils",
]
