"""Optimal-control problem definition.

PyTorch counterpart of the solver-facing part of
``multi_agent_solver_tpu/ocp.py``:

* :class:`OCPSpec` -- the frozen spec the solvers consume.  Tensor leaves
  (initial state, warm-start controls, bounds) may carry a leading batch
  axis ``[B, ...]``; functions and dimensions are plain attributes.
* :class:`OCP` -- the mutable problem description with the reference's
  field names and lifecycle (``initialize_problem``, ``reset``,
  ``update_initial_with_best``, ``set_result``, ``spec()``).
* :func:`cost_of` -- the objective of a given trajectory;
* :func:`with_context_cost` -- a spec whose stage cost takes a per-stage
  context ``stage_cost(x, u, t, ctx_t)``: how the other agents' plans reach
  one agent's solve in a coupled game.
* :func:`bound_rows` -- path constraints whose rows are components of
  ``x`` or ``u`` against constants, with a CUDA device function, and
  :func:`with_state_bound_constraints` -- the transform that folds finite
  state bounds into inequality rows for the AL machinery (the only way
  iLQR honours state bounds).

Trajectories are time-major (``[..., T+1, nx]`` / ``[..., T, nu]``).
Path constraints ``g(x [..., nx], u [..., nu]) -> [..., m]`` (equalities
``g = 0``, inequalities ``h <= 0``) reach the solver through the spec and
its Jacobian oracles (``derivs.eq_gx`` ...).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
from torch.func import jacfwd

from .derivatives import Derivatives, fd_jacobians, make_derivatives
from .integrators import integrate_horizon, integrate_rk4
from .types import Tensor, resolve_device, tag_device_fn


def compute_trajectory_cost(states: Tensor, controls: Tensor, stage_cost, terminal_cost,
                            context: Optional[Tensor] = None) -> Tensor:
    """Sum of the stage costs at ``(x_t, u_t, t)``, ``t = 0..T-1``, plus the
    terminal cost; not scaled by dt.  Leading batch axes broadcast.  With
    ``context [..., T, ...]`` the stage cost receives its stage's slice as a
    fourth argument."""
    T = controls.shape[-2]
    ts = torch.arange(T, device=controls.device)
    args = (states[..., :-1, :], controls, ts) + (() if context is None else (context,))
    stage = torch.broadcast_to(stage_cost(*args), controls.shape[:-1])
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


def diagonal_quadratic_terminal_cost(w_x, r_x) -> Callable:
    """Terminal cost ``sum_i w_x,i (x_i - r_x,i)^2``.

    The callable carries the tag of ``DiagQuadraticTerminal`` in
    ``csrc/problems.cuh``, which sums the same terms in the same order.
    """
    w_x, r_x = (tuple(float(v) for v in a) for a in (w_x, r_x))
    if len(w_x) != len(r_x):
        raise ValueError("weights and targets must have matching lengths")

    def terminal_cost(x: Tensor) -> Tensor:
        c = w_x[0] * (x[..., 0] - r_x[0]) ** 2
        for i in range(1, len(w_x)):
            c = c + w_x[i] * (x[..., i] - r_x[i]) ** 2
        return c

    return tag_device_fn(terminal_cost, "diag_quadratic_terminal", w_x + r_x)


# Row codes of BoundRows in csrc/problems.cuh: (variable, side) -> code.
_ROW_CODES = {("x", "upper"): 0, ("x", "lower"): 1, ("u", "upper"): 2, ("u", "lower"): 3}


def bound_rows(*rows) -> Callable:
    """Path constraint ``g(x, u) -> [..., M]`` with one row per
    ``(var, i, v, side)`` of ``rows``: ``var[..., i] - v`` for
    ``side="upper"`` (``var_i <= v`` as an inequality) and
    ``v - var[..., i]`` for ``"lower"``, ``var`` being ``"x"`` or ``"u"``.

    The callable carries the tag of ``BoundRows<M>`` in
    ``csrc/problems.cuh``, which evaluates each row with the same
    expression (``v - x_i`` is not computed as ``-(x_i - v)``); ``rows``
    is kept on it as ``fn.rows``.
    """
    rows = tuple((str(var), int(i), float(v), str(side)) for var, i, v, side in rows)
    if not rows:
        raise ValueError("bound_rows needs at least one row")
    for var, i, _, side in rows:
        if (var, side) not in _ROW_CODES or i < 0:
            raise ValueError(f"bad row ({var!r}, {i}, ..., {side!r}): var is 'x' or 'u', "
                             "side 'upper' or 'lower', i >= 0")

    def constraints(x: Tensor, u: Tensor) -> Tensor:
        out = []
        for var, i, v, side in rows:
            c = (x if var == "x" else u)[..., i]
            out.append(c - v if side == "upper" else v - c)
        return torch.stack(torch.broadcast_tensors(*out), -1)

    params = [p for var, i, v, side in rows for p in (_ROW_CODES[var, side], i, v)]
    fn = tag_device_fn(constraints, f"bound_rows{len(rows)}", params)
    fn.rows = rows
    return fn


@dataclasses.dataclass(frozen=True)
class OCPSpec:
    """Frozen problem spec (the solver-facing counterpart of the JAX pytree)."""

    initial_state: Tensor                        # [nx] or [B, nx]
    initial_controls: Tensor                     # [T, nu] or [B, T, nu]
    input_lower_bounds: Optional[Tensor] = None  # [nu] or [B, nu]
    input_upper_bounds: Optional[Tensor] = None
    state_lower_bounds: Optional[Tensor] = None  # [nx]; -inf = no bound
    state_upper_bounds: Optional[Tensor] = None
    # Per-stage cost context [T, ...] (or [B, T, ...]): when present the
    # stage cost is called as stage_cost(x, u, t, context_t).
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
        if self.context is not None:
            # Context costs always use the synthesized objective
            # (with_context_cost checks it).
            return compute_trajectory_cost(states, controls, self.stage_cost,
                                           self.terminal_cost, self.context)
        return self.objective_function(states, controls)

    def stage_cost_at(self, x: Tensor, u: Tensor, t, context_t=None) -> Tensor:
        """The stage cost with or without context, uniformly."""
        if self.context is not None:
            return self.stage_cost(x, u, t, context_t)
        return self.stage_cost(x, u, t)

    @property
    def has_input_bounds(self) -> bool:
        """Controls are clamped only when BOTH input bounds are set."""
        return self.input_lower_bounds is not None and self.input_upper_bounds is not None


def rollout_and_cost(spec: OCPSpec, controls: Tensor):
    """``(states, cost)`` of ``controls`` rolled out from the spec's initial
    state (context-aware through :meth:`OCPSpec.cost`)."""
    xs = spec.rollout(controls)
    return xs, spec.cost(xs, controls)


def cost_of(spec: OCPSpec, states: Tensor, controls: Tensor) -> Tensor:
    """The spec's objective of a given trajectory (context-aware through
    :meth:`OCPSpec.cost`)."""
    return spec.cost(states, controls)


def synthesized_objective(stage_cost: Callable, terminal_cost: Callable) -> Callable:
    """Default objective: stage costs plus terminal cost."""
    return lambda X, U: compute_trajectory_cost(X, U, stage_cost, terminal_cost)


@functools.lru_cache(maxsize=None)
def step_jacobians(dynamics: Callable, dt: float, fd: bool = False):
    """Memoized ``(step_fx, step_fu)``: the Jacobians of one RK4 step of
    ``dynamics`` -- by ``jacfwd`` through the integrator, or with ``fd`` by
    central differences of the step (eps = 1e-6) --, the oracles of the
    discrete Jacobian mode."""
    step = lambda x, u: integrate_rk4(x, u, dt, dynamics)
    if fd:
        return fd_jacobians(step)
    return jacfwd(step, argnums=0), jacfwd(step, argnums=1)


def with_context_cost(spec: OCPSpec, stage_cost_ctx: Callable) -> OCPSpec:
    """A spec whose stage cost ``stage_cost_ctx(x, u, t, ctx_t)`` takes a
    per-stage context; the derivative bundle is rebuilt for the 4-argument
    signature (the context is a constant of the derivatives).  The context
    itself is supplied per solve with ``spec.replace(context=...)``."""
    if not spec.objective_is_default:
        raise ValueError("context costs require the synthesized objective")
    if spec.derivative_mode != "ad":
        raise ValueError("context costs require AD derivative mode")
    derivs = make_derivatives(spec.dynamics, stage_cost_ctx, spec.terminal_cost,
                              spec.equality_constraints, spec.inequality_constraints,
                              fx=spec.derivs.fx, fu=spec.derivs.fu,
                              step_fx=spec.derivs.step_fx, step_fu=spec.derivs.step_fu)
    return spec.replace(stage_cost=stage_cost_ctx, derivs=derivs)


@functools.lru_cache(maxsize=None)
def _state_bound_ineq_fns(base_fn, lb_key, ub_key, mode):
    """Memoized ``(g, gx, gu, extra)``: the constraint stacking the finite
    state-bound rows ``x_i - ub_i <= 0`` (each finite ``ub``), then
    ``lb_i - x_i <= 0`` (each finite ``lb``), under the rows of
    ``base_fn``; its Jacobian oracles (``jacfwd``, or central differences in
    the ``fd`` mode); the number of rows added.  Keys are
    float tuples, so problems that share bounds share the functions.  A
    tagged (``bound_rows``) or absent base gives a tagged ``bound_rows``
    constraint, any other base an untagged one."""
    new = tuple(("x", i, v, "upper") for i, v in enumerate(ub_key or ()) if math.isfinite(v))
    new += tuple(("x", i, v, "lower") for i, v in enumerate(lb_key or ()) if math.isfinite(v))
    if not new:
        return None, None, None, 0
    if base_fn is None or hasattr(base_fn, "rows"):
        g = bound_rows(*(getattr(base_fn, "rows", ()) + new))
    else:
        rows = bound_rows(*new)

        def g(x: Tensor, u: Tensor) -> Tensor:
            b = base_fn(x, u)
            r = rows(x, u)
            return torch.cat([b.expand(r.shape[:-1] + b.shape[-1:]), r], -1)

    if mode == "ad":
        return g, jacfwd(g, argnums=0), jacfwd(g, argnums=1), len(new)
    return (g, *fd_jacobians(g), len(new))


def with_state_bound_constraints(spec: OCPSpec) -> OCPSpec:
    """Fold the spec's finite state bounds into its inequality constraints.

    The reference enforces state bounds only in its QP solvers; its iLQR
    and CGD ignore them.  This transform makes them visible to the AL
    machinery: each finite entry of ``state_upper_bounds`` becomes a row
    ``x_i - ub_i``, then each finite entry of ``state_lower_bounds`` a row
    ``lb_i - x_i``, stacked under the existing inequality rows.  The spec
    comes back unchanged when no bound is finite.
    """
    lb, ub = spec.state_lower_bounds, spec.state_upper_bounds
    if lb is None and ub is None:
        return spec
    key = lambda b: None if b is None else tuple(
        float(v) for v in torch.as_tensor(b).detach().cpu().reshape(-1))
    g, gx, gu, extra = _state_bound_ineq_fns(
        spec.inequality_constraints, key(lb), key(ub), spec.derivative_mode)
    if extra == 0:
        return spec
    return spec.replace(
        inequality_constraints=g,
        ineq_dim=spec.ineq_dim + extra,
        derivs=spec.derivs.replace(ineq_gx=gx, ineq_gu=gu),
    )


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
        self.id: int = 0

        self.dynamics = None
        self.stage_cost = zero_stage_cost
        self.terminal_cost = zero_terminal_cost
        self.objective_function = None

        self.input_lower_bounds = None
        self.input_upper_bounds = None
        self.state_lower_bounds = None
        self.state_upper_bounds = None
        self.equality_constraints = None
        self.inequality_constraints = None

        # Analytic derivative oracles (None: AD), as the reference's OCP
        # takes them.
        self.dynamics_state_jacobian = None
        self.dynamics_control_jacobian = None
        self.cost_state_gradient = None
        self.cost_control_gradient = None
        self.cost_state_hessian = None
        self.cost_control_hessian = None
        self.cost_cross_term = None
        self.terminal_cost_gradient = None
        self.terminal_cost_hessian = None

        self.initial_state = None
        self.initial_states = None
        self.initial_controls = None
        self.best_states = None
        self.best_controls = None
        self.best_cost: float = float("inf")

        self.derivative_mode: str = "ad"
        self.device = "cuda"

        self._derivs: Optional[Derivatives] = None
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise AttributeError(f"OCP has no field '{key}'")
            setattr(self, key, value)

    def reset(self) -> None:
        """Zero the controls and re-roll the trajectory."""
        self.initial_controls = torch.zeros(
            (self.horizon_steps, self.control_dim), dtype=self.initial_state.dtype,
            device=self.initial_state.device)
        self.initial_states, cost = rollout_and_cost(self.spec(), self.initial_controls)
        self.set_result(self.initial_states, self.initial_controls, cost)

    def update_initial_with_best(self) -> None:
        """Warm start from the current best trajectory."""
        self.initial_controls = self.best_controls
        self.initial_states = self.best_states

    def set_result(self, states: Tensor, controls: Tensor, cost) -> None:
        """Store a solver result."""
        self.best_states = states
        self.best_controls = controls
        self.best_cost = float(cost)

    def invalidate(self) -> None:
        """Drop the cached derivative bundle (after changing the problem's
        functions)."""
        self._derivs = None

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
        for name in ("input_lower_bounds", "input_upper_bounds", "state_lower_bounds",
                     "state_upper_bounds"):
            value = getattr(self, name)
            if value is not None:
                setattr(self, name, torch.as_tensor(value, dtype=dtype, device=dev))

        self._derivs = None
        self.initial_states, cost = rollout_and_cost(self.spec(), self.initial_controls)
        self.set_result(self.initial_states, self.initial_controls, cost)

    def verify_problem(self) -> bool:
        """Consistency checks of the fields (the reference's assert-based
        ``verify_problem``)."""
        assert self.state_dim != 0, "No state dimension"
        assert self.control_dim != 0, "No control dimension"
        assert self.horizon_steps != 0, "No horizon dimension"
        assert self.dt != 0.0, "dt is 0.0"
        assert tuple(self.initial_state.shape) == (self.state_dim,), (
            "Initial state size does not match state dimension")
        for name, dim in (("state_lower_bounds", self.state_dim),
                          ("state_upper_bounds", self.state_dim),
                          ("input_lower_bounds", self.control_dim),
                          ("input_upper_bounds", self.control_dim)):
            bound = getattr(self, name)
            if bound is not None:
                assert tuple(bound.shape) == (dim,), f"{name} size mismatch"
        spec = self.spec()
        out = self.dynamics(self.best_states[0], self.best_controls[0])
        assert tuple(out.shape) == (self.state_dim,), "Dynamics output size mismatch"
        spec.objective_function(self.best_states, self.best_controls)
        for constraint in (self.inequality_constraints, self.equality_constraints):
            if constraint is not None:
                c = constraint(self.best_states[0], self.best_controls[0])
                assert c.dim() == 1, "Constraints output invalid shape"
        return True

    def spec(self) -> OCPSpec:
        """The frozen solver-facing spec of the current fields.  The
        derivative bundle is built once and cached; call :meth:`invalidate`
        after changing the problem's functions."""
        if self._derivs is None:
            step_fx, step_fu = step_jacobians(self.dynamics, float(self.dt),
                                              self.derivative_mode == "fd")
            self._derivs = make_derivatives(
                self.dynamics,
                self.stage_cost,
                self.terminal_cost,
                self.equality_constraints,
                self.inequality_constraints,
                mode=self.derivative_mode,
                step_fx=step_fx,
                step_fu=step_fu,
                fx=self.dynamics_state_jacobian,
                fu=self.dynamics_control_jacobian,
                lx=self.cost_state_gradient,
                lu=self.cost_control_gradient,
                lxx=self.cost_state_hessian,
                luu=self.cost_control_hessian,
                lux=self.cost_cross_term,
                phix=self.terminal_cost_gradient,
                phixx=self.terminal_cost_hessian,
            )
        derivs = self._derivs
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
            state_lower_bounds=self.state_lower_bounds,
            state_upper_bounds=self.state_upper_bounds,
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
