"""Solvers (only the batched iLQR fused path is ported so far)."""

from .base import SolveResult
from .ilqr import ILQRConfig, solve_ilqr_batched

__all__ = ["SolveResult", "ILQRConfig", "solve_ilqr_batched"]
