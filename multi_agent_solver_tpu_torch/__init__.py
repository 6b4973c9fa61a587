"""PyTorch / CUDA port of ``multi_agent_solver_tpu``.

The JAX package stays the reference; this package keeps its module names
so that each file has a clear counterpart.  Its main path -- the batched
single-track iLQR solve -- runs on an NVIDIA H100 through three kernels
written by hand in CUDA C++ (``csrc/``), each with a plain PyTorch version
beside it that runs on CPU tensors and serves as the reference.
"""

from .ocp import OCP, OCPSpec
from .solvers.base import SolveResult
from .solvers.ilqr import ILQRConfig, solve_ilqr_batched

__all__ = ["OCP", "OCPSpec", "ILQRConfig", "solve_ilqr_batched", "SolveResult"]
