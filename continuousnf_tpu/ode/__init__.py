"""Differentiable, jit-compiled ODE solvers.

The replacement for the reference's delegated solver stack
(OrdinaryDiffEqDefault + SciMLSensitivity, `/root/reference/Project.toml:28-31`,
invoked at `/root/reference/src/base_icnf.jl:141`): embedded explicit
Runge–Kutta methods with a PI step-size controller inside `lax.while_loop`,
`save_everystep=false` semantics (only the final state is materialized), and
two differentiation strategies — continuous adjoint (backsolve, O(1) memory)
and discretize-then-optimize (bounded scan + remat).
"""

from .tableaus import TABLEAUS, ButcherTableau
from .solve import odeint, odeint_with_stats

__all__ = ["odeint", "odeint_with_stats", "TABLEAUS", "ButcherTableau"]
