"""Multi-agent solution container (counterpart of ``multi_agent_solver_tpu/solution.py``)."""

from __future__ import annotations

import dataclasses
from typing import List

from .types import Tensor


@dataclasses.dataclass
class Solution:
    """Per-agent trajectories and costs plus the total."""

    states: List[Tensor] = dataclasses.field(default_factory=list)    # each [T+1, nx]
    controls: List[Tensor] = dataclasses.field(default_factory=list)  # each [T, nu]
    costs: List[float] = dataclasses.field(default_factory=list)
    total_cost: float = 0.0
