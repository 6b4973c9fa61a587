"""Common solver output (counterpart of ``multi_agent_solver_tpu/solvers/base.py``)."""

from __future__ import annotations

import dataclasses

from ..types import Tensor


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solver output; batched solves give every field a leading ``[B]`` axis.

    ``states``/``controls`` are the accepted best trajectory and ``cost``
    the true (un-augmented) objective value.
    """

    states: Tensor          # [..., T+1, nx]
    controls: Tensor        # [..., T, nu]
    cost: Tensor            # [...]
    iterations: Tensor      # int32: outer iterations executed
    converged: Tensor       # bool
    merit: Tensor = None
    eq_violation: Tensor = None
    ineq_violation: Tensor = None
