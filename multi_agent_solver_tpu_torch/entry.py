"""The main-path problem: the batched single-track lane-follow iLQR solve.

Counterpart of ``__graft_entry__._single_track_spec`` and of ``bench.py``'s
x0 batch and solver config.  ``chip_smoke.py`` and the tests use it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ocp import OCP, OCPSpec, diagonal_quadratic_cost
from .models import (
    single_track_control_jacobian,
    single_track_model,
    single_track_state_jacobian,
)
from .solvers.ilqr import ILQRConfig

# 10 y^2 + (v - 1)^2 + 0.1 delta^2 + 0.1 a^2 as a diagonal quadratic, so it
# has a CUDA device function (csrc/problems.cuh DiagQuadratic).
LANE_FOLLOW_COST = diagonal_quadratic_cost(
    w_x=(0.0, 10.0, 0.0, 1.0), r_x=(0.0, 0.0, 0.0, 1.0),
    w_u=(0.1, 0.1), r_u=(0.0, 0.0),
)

# bench.py's solver configuration (the 3-rung forward-pass ladder).
BENCH_CONFIG = ILQRConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125))


def single_track_spec(horizon: int = 80, dtype=torch.float32, device="cuda") -> OCPSpec:
    """One single-track lane-follow problem: nx=4, nu=2, dt=0.1, inputs
    bounded to +-0.7 / +-1, x0 = (0, 1, 0, 0)."""
    ocp = OCP(
        state_dim=4,
        control_dim=2,
        horizon_steps=horizon,
        dt=0.1,
        initial_state=torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=dtype),
        dynamics=single_track_model,
        stage_cost=LANE_FOLLOW_COST,
        dynamics_state_jacobian=single_track_state_jacobian,
        dynamics_control_jacobian=single_track_control_jacobian,
        input_lower_bounds=torch.tensor([-0.7, -1.0], dtype=dtype),
        input_upper_bounds=torch.tensor([0.7, 1.0], dtype=dtype),
        device=device,
    )
    ocp.initialize_problem()
    return ocp.spec()


def bench_x0(batch: int, seed: int = 0) -> np.ndarray:
    """``bench.py``'s initial states: lateral offsets U(0.5, 1.5) and
    speeds U(0, 0.5), drawn in that order from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x0 = np.zeros((batch, 4), np.float32)
    x0[:, 1] = rng.uniform(0.5, 1.5, batch)
    x0[:, 3] = rng.uniform(0.0, 0.5, batch)
    return x0


def batch_specs(spec: OCPSpec, x0) -> OCPSpec:
    """``spec`` once per row of ``x0 [B, nx]``: the counterpart of
    ``jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)``."""
    dev = spec.initial_state.device
    x0 = torch.as_tensor(x0, dtype=spec.initial_state.dtype, device=dev)
    B = x0.shape[0]
    bound = lambda b: None if b is None else b.expand(B, -1)
    return spec.replace(
        initial_state=x0,
        initial_controls=spec.initial_controls.expand(B, -1, -1),
        input_lower_bounds=bound(spec.input_lower_bounds),
        input_upper_bounds=bound(spec.input_upper_bounds),
    )


def bench_specs(batch: int, device="cuda", horizon: int = 80) -> OCPSpec:
    """The main-path batch: ``batch`` problems with ``bench_x0`` states."""
    return batch_specs(single_track_spec(horizon, device=device), bench_x0(batch))
