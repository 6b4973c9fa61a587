"""Common solver output, the solver protocol and the solver registry.

Counterpart of ``multi_agent_solver_tpu/solvers/base.py``: each solver is a
host class with the reference's ``set_params(dict)`` surface and a batched
functional core, ``_solve_batched_fn(specs, config)``, through which the
strategies run their sweeps.  ``make_solver(name)`` is the registry-based
factory.  ``solve(problem)`` is the reference's mutating single-problem
solve: it runs ``solve_spec`` on the problem's spec (with the opt-in
``state_bounds_al`` transform) and writes the result back.

The reference's ``max_ms`` budget: with ``enforce_max_ms`` the solve hands
the solver a host-clock deadline that it checks once an iteration -- the
counterpart of the JAX package's ``io_callback`` deadline.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, Optional, Type

from ..types import SolverParams, Tensor


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


class SolverBase:
    """Host-side solver shim with the reference's API surface.

    ``device`` (default ``"cuda"``) is where the solver runs; it raises at
    solve time when CUDA is asked for and absent.
    """

    name: str = "base"
    config_cls: Optional[type] = None

    def __init__(self, device="cuda", **params):
        self.device = device
        self.config = self.config_cls() if self.config_cls else None
        if params:
            self.set_params(params)

    def set_params(self, params: SolverParams) -> None:
        """Accept a reference-style ``{name: float}`` map."""
        self.config = self.config_cls.from_params(params)

    def _solve_batched_fn(self, specs, config, structure=None):
        """Solve a spec whose leaves carry a leading batch axis."""
        raise NotImplementedError(f"{self.name}: no batched solve is ported")

    def resolve_structure(self, spec, config):
        """Facts about one problem that the solver would otherwise find on
        every call, found once for a strategy's sweeps (None: nothing)."""
        return None

    def solve_spec(self, spec, deadline=None) -> SolveResult:
        """Solve one problem's frozen spec; ``deadline``: a
        ``time.perf_counter()`` time after which to stop, or None."""
        raise NotImplementedError(f"{self.name}: no single-problem solve is ported")

    def solve(self, problem) -> SolveResult:
        """Solve and write ``best_states`` / ``best_controls`` / ``best_cost``
        back into the problem, like the reference's mutating ``solve(OCP&)``;
        ``state_bounds_al`` folds the finite state bounds into AL
        inequality rows first, and ``enforce_max_ms`` stops the solve once
        ``max_ms`` have passed since the call."""
        deadline = None
        max_ms = getattr(self.config, "max_ms", 0.0)
        if getattr(self.config, "enforce_max_ms", False) and max_ms > 0:
            deadline = time.perf_counter() + max_ms / 1000.0
        spec = problem.spec()
        if getattr(self.config, "state_bounds_al", False):
            from ..ocp import with_state_bound_constraints

            spec = with_state_bound_constraints(spec)
        result = self.solve_spec(spec, deadline)
        problem.set_result(result.states, result.controls, result.cost)
        return result


_SOLVERS: Dict[str, Type[SolverBase]] = {}


def register_solver(cls: Type[SolverBase]) -> Type[SolverBase]:
    _SOLVERS[cls.name] = cls
    return cls


def normalize_key(value: str) -> str:
    """Lowercase and strip non-alphanumerics."""
    return re.sub(r"[^a-z0-9]", "", value.lower())


_SOLVER_ALIASES = {
    "ilqr": "ilqr",
    "primaldualilqr": "ilqr",
    "pdilqr": "ilqr",
    "cgd": "cgd",
    "osqp": "osqp",
    "osqpcollocation": "osqp_collocation",
    "mppi": "mppi",
    "pathintegral": "mppi",
}


def canonical_solver_name(name: str) -> str:
    key = normalize_key(name)
    if key not in _SOLVER_ALIASES:
        raise ValueError(f"Unknown solver '{name}'.")
    return _SOLVER_ALIASES[key]


def available_solver_names():
    return sorted(_SOLVERS.keys())


def make_solver(name: str, params: Optional[SolverParams] = None, device="cuda") -> SolverBase:
    canonical = canonical_solver_name(name)
    if canonical not in _SOLVERS:
        raise NotImplementedError(
            f"solver '{canonical}' is not ported yet (ROADMAP: queue 1, other solvers "
            "and QP stack)")
    solver = _SOLVERS[canonical](device=device)
    if params is not None:
        solver.set_params(params)
    return solver


def make_solver_like(proto: SolverBase) -> SolverBase:
    """Default-construct the same solver type on the same device."""
    return type(proto)(device=proto.device)
