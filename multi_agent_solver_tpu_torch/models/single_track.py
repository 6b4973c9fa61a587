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
    """Analytic continuous-time A, ``[..., 4, 4]``."""
    psi, v = x[..., 2], x[..., 3]
    delta = u[..., 0]
    A = torch.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype, device=x.device)
    A[..., 0, 2] = -v * torch.sin(psi)
    A[..., 0, 3] = torch.cos(psi)
    A[..., 1, 2] = v * torch.cos(psi)
    A[..., 1, 3] = torch.sin(psi)
    A[..., 2, 3] = torch.tan(delta) / WHEELBASE
    return A


def single_track_control_jacobian(x: Tensor, u: Tensor) -> Tensor:
    """Analytic continuous-time B incl. d(psi_dot)/d(delta) = v/(L cos^2 delta)."""
    v = x[..., 3]
    delta = u[..., 0]
    Bm = torch.zeros(x.shape[:-1] + (4, 2), dtype=x.dtype, device=x.device)
    Bm[..., 2, 0] = v / (WHEELBASE * torch.cos(delta) ** 2)
    Bm[..., 3, 1] = 1.0
    return Bm
