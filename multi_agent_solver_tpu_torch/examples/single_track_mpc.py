"""Closed-loop receding-horizon MPC of the single-track lane follow.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/single_track_mpc.py``: the problem of
``single_track_ocp.py`` in closed loop, each step re-solved from the
measured state with the shifted previous plan as warm start and its first
control applied to the plant, with the example's solver parameters
(:data:`PARAMS`).  A fleet of B controllers starts from the lateral offsets
``linspace(0.5, 1.5, B)`` and runs as one batched solve a step
(``run_mpc_batched``: the fused loop's kernels on the card); B = 1 runs the
single problem through ``run_mpc`` and the single solve.
"""

from __future__ import annotations

import torch

from ..mpc import MPCTrace, run_mpc, run_mpc_batched
from ..ocp import OCPSpec
from ..parallel.batching import batch_spec_over
from ..solvers import make_solver
from .single_track_ocp import create_single_track_lane_following_ocp

PARAMS = {"max_iterations": 5, "tolerance": 1e-5, "max_ms": 100}


def fleet_specs(batch: int, dtype=torch.float32, device="cuda") -> OCPSpec:
    """``batch`` controllers: the example's problem with ``y_0`` at
    ``linspace(0.5, 1.5, batch)``."""
    spec = create_single_track_lane_following_ocp(dtype, device).spec()
    x0 = spec.initial_state.expand(batch, -1).clone()
    x0[:, 1] = torch.linspace(0.5, 1.5, batch, dtype=dtype, device=x0.device)
    return batch_spec_over(spec, initial_state=x0)


def run_fleet(batch: int, n_steps: int, dtype=torch.float32, device="cuda") -> MPCTrace:
    """The fleet's closed loop of ``n_steps`` steps with :data:`PARAMS`:
    ``run_mpc_batched`` over :func:`fleet_specs` through the iLQR solver's
    batched solve; for ``batch == 1``, ``run_mpc`` of the example's problem
    through the single solve, whose trace has no batch axis."""
    solver = make_solver("ilqr", PARAMS, device=device)
    if batch == 1:
        spec = create_single_track_lane_following_ocp(dtype, device).spec()
        return run_mpc(spec, solver.solve_spec, n_steps)
    return run_mpc_batched(fleet_specs(batch, dtype, device),
                           lambda s: solver._solve_batched_fn(s, solver.config), n_steps)
