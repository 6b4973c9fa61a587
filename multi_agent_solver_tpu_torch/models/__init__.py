"""Dynamics models (torch functions + analytic Jacobians)."""

from .single_track import (
    single_track_control_jacobian,
    single_track_model,
    single_track_state_jacobian,
)

__all__ = [
    "single_track_model",
    "single_track_state_jacobian",
    "single_track_control_jacobian",
]
