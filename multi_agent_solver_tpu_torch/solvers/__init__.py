"""Solvers (only iLQR's batched fused path is ported so far)."""

from .base import (
    SolveResult,
    SolverBase,
    available_solver_names,
    canonical_solver_name,
    make_solver,
    make_solver_like,
    register_solver,
)
from .ilqr import ILQR, ILQRConfig, solve_ilqr_batched

__all__ = [
    "SolveResult", "SolverBase", "available_solver_names", "canonical_solver_name",
    "make_solver", "make_solver_like", "register_solver", "ILQR", "ILQRConfig",
    "solve_ilqr_batched",
]
