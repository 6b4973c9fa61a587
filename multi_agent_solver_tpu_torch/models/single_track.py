"""Kinematic single-track (bicycle) model.

PyTorch counterpart of ``multi_agent_solver_tpu/models/single_track.py``:
state ``(X, Y, psi, v)``, control ``(delta, a)``, wheelbase L = 2.5:

    X_dot = v cos(psi);  Y_dot = v sin(psi);  psi_dot = v tan(delta)/L;  v_dot = a

``single_track_model`` carries the device tag of ``SingleTrack`` in
``csrc/problems.cuh``, which computes the same expression in CUDA.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn

WHEELBASE = 2.5


def single_track_model(x: Tensor, u: Tensor) -> Tensor:
    psi, v = x[..., 2], x[..., 3]
    delta, a = u[..., 0], u[..., 1]
    return torch.stack(
        [v * torch.cos(psi), v * torch.sin(psi), v * torch.tan(delta) / WHEELBASE, a],
        dim=-1,
    )


tag_device_fn(single_track_model, "single_track", (WHEELBASE,))


def single_track_state_jacobian(x: Tensor, u: Tensor) -> Tensor:
    """Analytic continuous-time A, ``[..., 4, 4]`` (written without in-place
    writes, so ``torch.func.vmap`` maps it)."""
    psi, v = x[..., 2], x[..., 3]
    delta = u[..., 0]
    z = torch.zeros_like(v)
    return torch.stack([
        torch.stack([z, z, -v * torch.sin(psi), torch.cos(psi)], -1),
        torch.stack([z, z, v * torch.cos(psi), torch.sin(psi)], -1),
        torch.stack([z, z, z, torch.tan(delta) / WHEELBASE], -1),
        torch.stack([z, z, z, z], -1),
    ], -2)


def single_track_control_jacobian(x: Tensor, u: Tensor) -> Tensor:
    """Analytic continuous-time B incl. d(psi_dot)/d(delta) = v/(L cos^2 delta)."""
    v = x[..., 3]
    delta = u[..., 0]
    z = torch.zeros_like(v)
    return torch.stack([
        torch.stack([z, z], -1),
        torch.stack([z, z], -1),
        torch.stack([v / (WHEELBASE * torch.cos(delta) ** 2), z], -1),
        torch.stack([z, torch.ones_like(v)], -1),
    ], -2)
