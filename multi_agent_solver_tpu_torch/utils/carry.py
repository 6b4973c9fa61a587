"""Carry a problem and a solver config across from the JAX package.

There are no model weights: what crosses over is the problem's array data
and the solver configuration.  The caller exports them on the JAX side
(``{name: np.asarray(leaf)}`` of the spec's leaves, ``dataclasses.asdict``
of the config), so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from ..derivatives import make_derivatives
from ..ocp import OCPSpec, synthesized_objective
from ..solvers.ilqr import ILQRConfig
from ..types import resolve_device

LEAVES = ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")


def spec_from_numpy(
    leaves: Mapping[str, np.ndarray],
    *,
    dynamics: Callable,
    stage_cost: Callable,
    terminal_cost: Callable,
    dt: float,
    horizon_steps: int,
    device="cuda",
) -> OCPSpec:
    """The port's spec from the JAX spec's array leaves exported to numpy.

    ``leaves`` holds ``initial_state`` ``[nx]`` or ``[B, nx]``,
    ``initial_controls`` ``[T, nu]`` or ``[B, T, nu]`` and optionally the
    input bounds; dtypes are kept.  The torch callables replace the JAX ones.
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
    if us.shape[-2] != horizon_steps:
        raise ValueError(f"initial_controls has {us.shape[-2]} stages, expected {horizon_steps}")
    return OCPSpec(
        **tensors,
        dynamics=dynamics,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        objective_function=synthesized_objective(stage_cost, terminal_cost),
        derivs=make_derivatives(dynamics, stage_cost, terminal_cost),
        state_dim=int(x0.shape[-1]),
        control_dim=int(us.shape[-1]),
        horizon_steps=int(horizon_steps),
        dt=float(dt),
    )


def config_from_dict(d: Mapping) -> ILQRConfig:
    """The port's ``ILQRConfig`` from ``dataclasses.asdict`` of the JAX one;
    an unknown field raises ``TypeError``."""
    d = dict(d)
    if d.get("alpha_ladder") is not None:
        d["alpha_ladder"] = tuple(float(a) for a in d["alpha_ladder"])
    return ILQRConfig(**d)
