"""Batching and multi-start solving (counterparts of
``multi_agent_solver_tpu/parallel``; the device-mesh scale-out of its
``mesh.py`` is not ported yet)."""

from .batching import batch_solve, batch_spec_over, replicate_spec
from .multistart import multistart_solve, multistart_solve_host, random_control_starts

__all__ = [
    "batch_solve",
    "batch_spec_over",
    "replicate_spec",
    "multistart_solve",
    "multistart_solve_host",
    "random_control_starts",
]
