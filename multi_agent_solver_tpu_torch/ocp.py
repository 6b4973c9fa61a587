"""Optimal-control problem definition.

PyTorch counterpart of the solver-facing part of
``multi_agent_solver_tpu/ocp.py``:

* :class:`OCPSpec` -- the frozen spec the solvers consume.  Tensor leaves
  (initial state, warm-start controls, bounds) may carry a leading batch
  axis ``[B, ...]``; functions and dimensions are plain attributes.
* :class:`OCP` -- the mutable problem description with the reference's
  field names, ``initialize_problem`` and ``spec()``.

Trajectories are time-major (``[..., T+1, nx]`` / ``[..., T, nu]``).
Constraints are carried so that the solver can refuse them; the AL
machinery, per-stage context and state-bound transforms are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .derivatives import Derivatives, make_derivatives
from .integrators import integrate_horizon
from .types import Tensor, resolve_device, tag_device_fn


def compute_trajectory_cost(states: Tensor, controls: Tensor, stage_cost, terminal_cost) -> Tensor:
    """Sum of the stage costs at ``(x_t, u_t, t)``, ``t = 0..T-1``, plus the
    terminal cost; not scaled by dt.  Leading batch axes broadcast."""
    T = controls.shape[-2]
    ts = torch.arange(T, device=controls.device)
    stage = stage_cost(states[..., :-1, :], controls, ts)
    stage = torch.broadcast_to(stage, controls.shape[:-1])
    return stage.sum(-1) + terminal_cost(states[..., -1, :])


def zero_stage_cost(x: Tensor, u: Tensor, t) -> Tensor:
    """Default stage cost."""
    return torch.zeros_like(x[..., 0])


def zero_terminal_cost(x: Tensor) -> Tensor:
    """Default terminal cost."""
    return torch.zeros_like(x[..., 0])


tag_device_fn(zero_terminal_cost, "zero")


def diagonal_quadratic_cost(w_x, r_x, w_u, r_u) -> Callable:
    """Stage cost ``sum_i w_x,i (x_i - r_x,i)^2 + sum_i w_u,i (u_i - r_u,i)^2``.

    The callable carries the tag of ``DiagQuadratic`` in
    ``csrc/problems.cuh``, which sums the same terms in the same order.
    """
    w_x, r_x, w_u, r_u = (tuple(float(v) for v in a) for a in (w_x, r_x, w_u, r_u))
    if len(w_x) != len(r_x) or len(w_u) != len(r_u):
        raise ValueError("weights and targets must have matching lengths")

    def stage_cost(x: Tensor, u: Tensor, t) -> Tensor:
        c = w_x[0] * (x[..., 0] - r_x[0]) ** 2
        for i in range(1, len(w_x)):
            c = c + w_x[i] * (x[..., i] - r_x[i]) ** 2
        for i in range(len(w_u)):
            c = c + w_u[i] * (u[..., i] - r_u[i]) ** 2
        return c

    return tag_device_fn(stage_cost, "diag_quadratic", w_x + r_x + w_u + r_u)


@dataclasses.dataclass(frozen=True)
class OCPSpec:
    """Frozen problem spec (the solver-facing counterpart of the JAX pytree)."""

    initial_state: Tensor                        # [nx] or [B, nx]
    initial_controls: Tensor                     # [T, nu] or [B, T, nu]
    input_lower_bounds: Optional[Tensor] = None  # [nu] or [B, nu]
    input_upper_bounds: Optional[Tensor] = None
    # Per-stage cost context; carried so that the solver can refuse it.
    context: Optional[Tensor] = None

    dynamics: Callable = None
    stage_cost: Callable = None
    terminal_cost: Callable = None
    objective_function: Callable = None
    equality_constraints: Optional[Callable] = None
    inequality_constraints: Optional[Callable] = None
    derivs: Derivatives = None
    state_dim: int = 0
    control_dim: int = 0
    horizon_steps: int = 0
    eq_dim: int = 0
    ineq_dim: int = 0
    dt: float = 0.0
    # True when objective_function is the synthesized sum of stage costs
    # plus terminal cost, so kernels may accumulate it inline.
    objective_is_default: bool = True
    derivative_mode: str = "ad"

    def replace(self, **kwargs) -> "OCPSpec":
        return dataclasses.replace(self, **kwargs)

    def rollout(self, controls: Tensor) -> Tensor:
        return integrate_horizon(self.initial_state, controls, self.dt, self.dynamics)

    def cost(self, states: Tensor, controls: Tensor) -> Tensor:
        return self.objective_function(states, controls)

    @property
    def has_input_bounds(self) -> bool:
        """Controls are clamped only when BOTH input bounds are set."""
        return self.input_lower_bounds is not None and self.input_upper_bounds is not None


def synthesized_objective(stage_cost: Callable, terminal_cost: Callable) -> Callable:
    """Default objective: stage costs plus terminal cost."""
    return lambda X, U: compute_trajectory_cost(X, U, stage_cost, terminal_cost)


class OCP:
    """Mutable host-side problem description mirroring the reference API.

    ``device`` (default ``"cuda"``) is where :meth:`initialize_problem`
    puts the tensors; it raises when CUDA is asked for and absent.
    """

    def __init__(self, **kwargs: Any):
        self.state_dim: int = 0
        self.control_dim: int = 0
        self.horizon_steps: int = 0
        self.dt: float = 0.0

        self.dynamics = None
        self.stage_cost = zero_stage_cost
        self.terminal_cost = zero_terminal_cost
        self.objective_function = None

        self.input_lower_bounds = None
        self.input_upper_bounds = None
        self.equality_constraints = None
        self.inequality_constraints = None

        self.dynamics_state_jacobian = None
        self.dynamics_control_jacobian = None

        self.initial_state = None
        self.initial_states = None
        self.initial_controls = None
        self.best_states = None
        self.best_controls = None
        self.best_cost: float = float("inf")

        self.derivative_mode: str = "ad"
        self.device = "cuda"

        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise AttributeError(f"OCP has no field '{key}'")
            setattr(self, key, value)

    def initialize_problem(self) -> None:
        """Move the data to ``device``, shape-fix the controls, roll out and
        cost the warm start."""
        dev = resolve_device(self.device)
        self.initial_state = torch.as_tensor(self.initial_state, device=dev)
        if not self.initial_state.is_floating_point():
            self.initial_state = self.initial_state.to(torch.get_default_dtype())
        dtype = self.initial_state.dtype
        shape = (self.horizon_steps, self.control_dim)
        if self.initial_controls is None or tuple(torch.as_tensor(self.initial_controls).shape) != shape:
            self.initial_controls = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            self.initial_controls = torch.as_tensor(self.initial_controls, dtype=dtype, device=dev)
        for name in ("input_lower_bounds", "input_upper_bounds"):
            value = getattr(self, name)
            if value is not None:
                setattr(self, name, torch.as_tensor(value, dtype=dtype, device=dev))

        spec = self.spec()
        self.initial_states = spec.rollout(spec.initial_controls)
        self.best_states = self.initial_states
        self.best_controls = self.initial_controls
        self.best_cost = float(spec.cost(self.initial_states, self.initial_controls))

    def spec(self) -> OCPSpec:
        """The frozen solver-facing spec of the current fields."""
        derivs = make_derivatives(
            self.dynamics,
            self.stage_cost,
            self.terminal_cost,
            mode=self.derivative_mode,
            fx=self.dynamics_state_jacobian,
            fu=self.dynamics_control_jacobian,
        )
        objective = self.objective_function
        if objective is None:
            objective = synthesized_objective(self.stage_cost, self.terminal_cost)

        x_probe = self.initial_state
        u_probe = torch.zeros(self.control_dim, dtype=x_probe.dtype, device=x_probe.device)
        eq_dim = ineq_dim = 0
        if self.equality_constraints is not None:
            eq_dim = int(self.equality_constraints(x_probe, u_probe).shape[-1])
        if self.inequality_constraints is not None:
            ineq_dim = int(self.inequality_constraints(x_probe, u_probe).shape[-1])

        return OCPSpec(
            initial_state=self.initial_state,
            initial_controls=self.initial_controls,
            input_lower_bounds=self.input_lower_bounds,
            input_upper_bounds=self.input_upper_bounds,
            dynamics=self.dynamics,
            stage_cost=self.stage_cost,
            terminal_cost=self.terminal_cost,
            objective_function=objective,
            equality_constraints=self.equality_constraints,
            inequality_constraints=self.inequality_constraints,
            derivs=derivs,
            state_dim=self.state_dim,
            control_dim=self.control_dim,
            horizon_steps=self.horizon_steps,
            eq_dim=eq_dim,
            ineq_dim=ineq_dim,
            dt=float(self.dt),
            objective_is_default=self.objective_function is None,
            derivative_mode=self.derivative_mode,
        )
