"""Heterogeneous-agent stacking by padding and type-indicator states.

Counterpart of ``multi_agent_solver_tpu/strategies/hetero.py``.  A batched
Nash sweep runs every agent as a batch lane of one solve, which needs
uniform shapes and shared problem functions.  Mixed agent types fit that
mold this way:

* **Pad** every lane to ``nx_max`` / ``nu_max`` (zero-padded states and
  controls) and append ``K`` *type-indicator* state components whose
  dynamics are identically zero: each lane's indicator block holds the
  one-hot of its agent type, so the type travels through rollouts and
  linearizations as plain data.
* **Dispatch** functions, one set per *set* of types, compute
  ``sum_k onehot[k] * pad(f_k(x[:nx_k], u[:nu_k]))``: every lane evaluates
  all K branches and keeps its own.  The builders are memoized on the type
  tuple, so problems built from the same mix share the function objects
  and ``solvers/ilqr.py::cached_cost_structure`` finds their structure
  once.
* Padded control components get a ``0.5 u_pad^2`` term in the dispatch
  stage cost.  They start at zero, the dynamics and costs do not read
  them, and the term keeps the control Hessian positive definite, so they
  stay exactly zero and add exactly zero cost.
* Padded equality rows evaluate to ``0`` (satisfied), padded inequality
  rows to ``-1`` (strictly satisfied).  Input bounds are stacked both or
  neither: a lane whose type has none gets +-1e30, padded control
  components ``[0, 0]``.

The dispatch stage cost is an ordinary ``(x, u, t)`` stage cost, so a
coupled game wraps it as it wraps a homogeneous one; the user's
``inter_agent_cost`` then receives padded state vectors and must read only
components every type shares (e.g. the leading position components).

**On the card.**  The dispatch functions carry no device-function tag, so
a padded stack takes the route of untagged problems: the non-fused path
with the vmapped torch linearizer, K4's explicit mode at the padded
``(nx, nu)`` (``(6, 2)`` for single-track cars beside ``(2, 1)`` LQR
agents) and the torch forward pass.  A ``Dispatch<Types...>`` device
function, which would put a mixed stack on the fused kernels, is later
work.

Eligibility: every agent shares ``horizon_steps``, ``dt``,
``derivative_mode`` and the synthesized objective, and has no per-agent
``context``; a mix that fails it runs the strategies' host loop.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..derivatives import make_derivatives
from ..multi_agent import MultiAgentProblem
from ..ocp import OCPSpec, step_jacobians, synthesized_objective
from ..types import resolve_device

_BIG = 1e30  # "unbounded" for lanes whose type has no bound


class PadMeta(NamedTuple):
    """How to slice padded stacked results back to per-agent shapes."""

    state_dims: Tuple[int, ...]    # true nx per lane
    control_dims: Tuple[int, ...]  # true nu per lane
    n_types: int
    nx_max: int                    # padded physical state dim (without the indicators)
    nu_max: int


def _type_signature(spec: OCPSpec) -> tuple:
    """What makes an agent's problem a type of its own."""
    return (spec.dynamics, spec.stage_cost, spec.terminal_cost, spec.equality_constraints,
            spec.inequality_constraints, spec.state_dim, spec.control_dim, spec.eq_dim,
            spec.ineq_dim)


def paddable(specs: Sequence[OCPSpec]) -> bool:
    """True when mixed-type agents can share one padded stacked spec."""
    first = specs[0]
    return all(s.horizon_steps == first.horizon_steps and s.dt == first.dt
               and s.derivative_mode == first.derivative_mode and s.objective_is_default
               and s.context is None for s in specs)


@functools.lru_cache(maxsize=None)
def _dispatch_functions(type_sigs: tuple, nx_max: int, nu_max: int, dt: float, mode: str):
    """The shared dispatch functions of a tuple of type signatures, their
    derivative bundle and objective: ``(dynamics, stage_cost,
    terminal_cost, eq_fn, ineq_fn, eq_max, ineq_max, derivs, objective)``.
    Every function is written on ``x[..., i]``, so batch and time axes
    broadcast."""
    K = len(type_sigs)
    dyns, stages, terms, eqs, ineqs, nxs, nus, eq_dims, ineq_dims = zip(*type_sigs)
    eq_max, ineq_max = max(eq_dims), max(ineq_dims)

    def dynamics(x, u):
        sel = x[..., nx_max:]
        dx = torch.zeros_like(x[..., :nx_max])
        for k in range(K):
            fk = dyns[k](x[..., :nxs[k]], u[..., :nus[k]])
            dx = dx + sel[..., k, None] * F.pad(fk, (0, nx_max - nxs[k]))
        return torch.cat([dx, torch.zeros_like(sel)], -1)

    def stage_cost(x, u, t):
        sel = x[..., nx_max:]
        total = 0.0
        for k in range(K):
            pad_reg = 0.5 * (u[..., nus[k]:] ** 2).sum(-1)
            total = total + sel[..., k] * (stages[k](x[..., :nxs[k]], u[..., :nus[k]], t)
                                           + pad_reg)
        return total

    def terminal_cost(x):
        sel = x[..., nx_max:]
        total = 0.0
        for k in range(K):
            total = total + sel[..., k] * terms[k](x[..., :nxs[k]])
        return total

    def constraint_dispatch(fns, dims, out_dim, pad_value):
        def dispatch(x, u):
            sel = x[..., nx_max:]
            out = torch.zeros(x.shape[:-1] + (out_dim,), dtype=x.dtype, device=x.device)
            for k in range(K):
                if fns[k] is None:
                    gk = torch.full((out_dim,), pad_value, dtype=x.dtype, device=x.device)
                else:
                    gk = F.pad(fns[k](x[..., :nxs[k]], u[..., :nus[k]]),
                               (0, out_dim - dims[k]), value=pad_value)
                out = out + sel[..., k, None] * gk
            return out

        return dispatch

    eq_fn = constraint_dispatch(eqs, eq_dims, eq_max, 0.0) if eq_max > 0 else None
    ineq_fn = constraint_dispatch(ineqs, ineq_dims, ineq_max, -1.0) if ineq_max > 0 else None
    step_fx, step_fu = step_jacobians(dynamics, dt)
    derivs = make_derivatives(dynamics, stage_cost, terminal_cost, eq_fn, ineq_fn, mode=mode,
                              step_fx=step_fx, step_fu=step_fu)
    return (dynamics, stage_cost, terminal_cost, eq_fn, ineq_fn, eq_max, ineq_max, derivs,
            synthesized_objective(stage_cost, terminal_cost))


def stack_agent_specs_padded(
    problem: MultiAgentProblem, device=None,
) -> Tuple[Optional[OCPSpec], Optional[PadMeta]]:
    """Stack heterogeneous agents into one padded spec on ``device``
    (default: the first agent's), or ``(None, None)``.

    ``(None, None)`` when the mix is not paddable or has one type (the
    homogeneous stack serves it).  Lane layout: state ``[nx_max physical |
    K indicators]``, controls ``[nu_max]``; lane i's indicator block is the
    one-hot of its type, carried in ``initial_state``.
    """
    if not problem.blocks:
        problem.compute_offsets()
    specs = [b.agent.ocp.spec() for b in problem.blocks]
    if not specs or not paddable(specs):
        return None, None
    type_list: List[tuple] = []
    lane_types: List[int] = []
    for spec in specs:
        sig = _type_signature(spec)
        if sig not in type_list:
            type_list.append(sig)
        lane_types.append(type_list.index(sig))
    K = len(type_list)
    if K == 1:
        return None, None

    nx_max = max(s.state_dim for s in specs)
    nu_max = max(s.control_dim for s in specs)
    first = specs[0]
    dev = first.initial_state.device if device is None else resolve_device(device)
    dtype = first.initial_state.dtype
    (dyn, stage, term, eq_fn, ineq_fn, eq_max, ineq_max, derivs,
     objective) = _dispatch_functions(tuple(type_list), nx_max, nu_max, float(first.dt),
                                      first.derivative_mode)
    as_t = lambda v: torch.as_tensor(v).to(device=dev, dtype=dtype)

    x0s, u0s = [], []
    for spec, tk in zip(specs, lane_types):
        onehot = torch.zeros(K, dtype=dtype, device=dev)
        onehot[tk] = 1.0
        x0s.append(torch.cat([F.pad(as_t(spec.initial_state), (0, nx_max - spec.state_dim)),
                              onehot]))
        u0s.append(F.pad(as_t(spec.initial_controls), (0, nu_max - spec.control_dim)))

    def stack_bounds(attr: str, dim: int, lo: bool, indicator_dims: int):
        """The bounds leaf stacked iff any lane has it, absent ones +-1e30.
        Padded control components get lb = ub = 0 (an exact pin), padded
        state and indicator components +-1e30 (they are constants)."""
        vals = [getattr(s, attr) for s in specs]
        if all(v is None for v in vals):
            return None
        fill = -_BIG if lo else _BIG
        is_input = attr.startswith("input")
        rows = []
        for spec, v in zip(specs, vals):
            true_dim = spec.control_dim if is_input else spec.state_dim
            base = torch.full((true_dim,), fill, dtype=dtype, device=dev) if v is None else as_t(v)
            row = F.pad(base, (0, dim - true_dim), value=0.0 if is_input else fill)
            if indicator_dims:
                row = torch.cat([row, torch.full((indicator_dims,), fill, dtype=dtype,
                                                 device=dev)])
            rows.append(row)
        return torch.stack(rows)

    # Controls are clamped only when BOTH input bounds exist: both or neither.
    any_input_bounds = any(s.has_input_bounds for s in specs)
    stacked = OCPSpec(
        initial_state=torch.stack(x0s),
        initial_controls=torch.stack(u0s),
        state_lower_bounds=stack_bounds("state_lower_bounds", nx_max, True, K),
        state_upper_bounds=stack_bounds("state_upper_bounds", nx_max, False, K),
        input_lower_bounds=(stack_bounds("input_lower_bounds", nu_max, True, 0)
                            if any_input_bounds else None),
        input_upper_bounds=(stack_bounds("input_upper_bounds", nu_max, False, 0)
                            if any_input_bounds else None),
        dynamics=dyn,
        stage_cost=stage,
        terminal_cost=term,
        objective_function=objective,
        equality_constraints=eq_fn,
        inequality_constraints=ineq_fn,
        derivs=derivs,
        state_dim=nx_max + K,
        control_dim=nu_max,
        horizon_steps=first.horizon_steps,
        eq_dim=eq_max,
        ineq_dim=ineq_max,
        dt=float(first.dt),
        objective_is_default=True,
        derivative_mode=first.derivative_mode,
    )
    meta = PadMeta(state_dims=tuple(s.state_dim for s in specs),
                   control_dims=tuple(s.control_dim for s in specs),
                   n_types=K, nx_max=nx_max, nu_max=nu_max)
    return stacked, meta


def scatter_padded_results(problem: MultiAgentProblem, meta: PadMeta, states, controls,
                           costs) -> None:
    """Slice lane i's padded result back to agent i's true dimensions; each
    stacked tensor is fetched to the host once."""
    states, controls = states.cpu(), controls.cpu()
    costs = costs.cpu().tolist()
    for i, block in enumerate(problem.blocks):
        nx, nu = meta.state_dims[i], meta.control_dims[i]
        block.agent.ocp.set_result(states[i, :, :nx], controls[i, :, :nu], costs[i])
