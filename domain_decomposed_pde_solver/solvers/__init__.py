"""Krylov solvers, eigen utilities, and preconditioners."""

from .bicgstab import BiCGStabResult, bicgstab_solve
from .cg import (
    CGResult,
    cg_solve,
    cg_solve_resumable,
    cg_solve_snapshots,
    cg_solve_with_state,
)
from .gmres import GMRESResult, gmres_solve
from .lanczos import LanczosResult, lanczos_extremes
from .mixed import MixedSolveResult, iterative_refinement_solve
from .power import PowerResult, power_method
from .precond import (
    AMGPreconditioner,
    ILU0Preconditioner,
    chebyshev_preconditioner,
    ilu0_preconditioner,
    ilut_preconditioner,
    estimate_lmax_dinv_a,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)

__all__ = [
    "BiCGStabResult",
    "bicgstab_solve",
    "CGResult",
    "cg_solve",
    "cg_solve_snapshots",
    "cg_solve_resumable",
    "cg_solve_with_state",
    "GMRESResult",
    "LanczosResult",
    "lanczos_extremes",
    "gmres_solve",
    "PowerResult",
    "power_method",
    "MixedSolveResult",
    "iterative_refinement_solve",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "estimate_lmax_dinv_a",
    "AMGPreconditioner",
    "smoothed_aggregation_setup",
    "ILU0Preconditioner",
    "ilu0_preconditioner",
    "ilut_preconditioner",
]
