"""Agent: a thin id + OCP wrapper (counterpart of ``multi_agent_solver_tpu/agent.py``)."""

from __future__ import annotations

from .ocp import OCP


class Agent:
    """Pairs an agent id with its optimal-control problem."""

    def __init__(self, agent_id: int, ocp: OCP):
        self.id = int(agent_id)
        self.ocp = ocp

    def state_dim(self) -> int:
        return self.ocp.state_dim

    def control_dim(self) -> int:
        return self.ocp.control_dim

    def reset(self) -> None:
        self.ocp.reset()

    def update_initial_with_best(self) -> None:
        self.ocp.update_initial_with_best()
