"""Carry a problem and a solver config across from the JAX package.

There are no model weights: what crosses over is the problem's array data
and the solver configuration.  The caller exports them on the JAX side
(``{name: np.asarray(leaf)}`` of the spec's leaves, ``dataclasses.asdict``
of the config), so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..derivatives import make_derivatives
from ..ocp import OCPSpec, step_jacobians, synthesized_objective
from ..solvers.ilqr import ILQRConfig
from ..types import resolve_device

LEAVES = ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds",
          "context")


def spec_from_numpy(
    leaves: Mapping[str, np.ndarray],
    *,
    dynamics: Callable,
    stage_cost: Callable,
    terminal_cost: Callable,
    dt: float,
    horizon_steps: int,
    equality_constraints: Optional[Callable] = None,
    inequality_constraints: Optional[Callable] = None,
    eq_dim: int = 0,
    ineq_dim: int = 0,
    device="cuda",
) -> OCPSpec:
    """The port's spec from the JAX spec's array leaves exported to numpy.

    ``leaves`` holds ``initial_state`` ``[nx]`` or ``[B, nx]``,
    ``initial_controls`` ``[T, nu]`` or ``[B, T, nu]`` and optionally the
    input bounds and a per-stage ``context`` (``[T, ...]`` or ``[B, T,
    ...]``, for a stage cost ``stage_cost(x, u, t, ctx_t)``); dtypes are
    kept.  The torch callables replace the JAX ones; the constraint
    callables come with their row counts ``eq_dim`` / ``ineq_dim``, as the
    JAX spec carries them.
    """
    unknown = set(leaves) - set(LEAVES)
    if unknown:
        raise ValueError(f"leaves not carried by this port: {sorted(unknown)}")
    dev = resolve_device(device)
    tensors = {
        name: (torch.as_tensor(np.array(leaves[name]), device=dev)
               if leaves.get(name) is not None else None)
        for name in LEAVES
    }
    x0, us = tensors["initial_state"], tensors["initial_controls"]
    step_fx, step_fu = step_jacobians(dynamics, float(dt))
    if us.shape[-2] != horizon_steps:
        raise ValueError(f"initial_controls has {us.shape[-2]} stages, expected {horizon_steps}")
    for fn, m, name in ((equality_constraints, eq_dim, "eq_dim"),
                        (inequality_constraints, ineq_dim, "ineq_dim")):
        if (fn is None) != (m == 0):
            raise ValueError(f"{name}={m}: a constraint callable comes with its row count")
    return OCPSpec(
        **tensors,
        dynamics=dynamics,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        objective_function=synthesized_objective(stage_cost, terminal_cost),
        equality_constraints=equality_constraints,
        inequality_constraints=inequality_constraints,
        derivs=make_derivatives(dynamics, stage_cost, terminal_cost, equality_constraints,
                                inequality_constraints, step_fx=step_fx, step_fu=step_fu),
        state_dim=int(x0.shape[-1]),
        control_dim=int(us.shape[-1]),
        horizon_steps=int(horizon_steps),
        eq_dim=int(eq_dim),
        ineq_dim=int(ineq_dim),
        dt=float(dt),
    )


def config_from_dict(d: Mapping) -> ILQRConfig:
    """The port's ``ILQRConfig`` from ``dataclasses.asdict`` of the JAX one;
    an unknown field raises ``TypeError``."""
    d = dict(d)
    if d.get("alpha_ladder") is not None:
        d["alpha_ladder"] = tuple(float(a) for a in d["alpha_ladder"])
    return ILQRConfig(**d)
