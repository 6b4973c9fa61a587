"""Multi-agent problem container.

Counterpart of ``multi_agent_solver_tpu/multi_agent.py``: agents are
id-sorted into contiguous state / control blocks, and an optional pairwise
``inter_agent_cost`` couples them into a game that the Nash strategies play
(``strategies/nash.py``).  The centralized joint OCP (``build_global_ocp``)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

from .agent import Agent
from .ocp import OCP


@dataclasses.dataclass
class AgentBlockInfo:
    """Offsets of one agent inside the stacked joint problem."""

    agent_id: int
    state_offset: int
    control_offset: int
    state_dim: int
    control_dim: int
    agent: Agent


class MultiAgentProblem:
    """Collection of agents plus block bookkeeping."""

    def __init__(self):
        self.agents: List[Agent] = []
        self.blocks: List[AgentBlockInfo] = []
        self.total_state_dim = 0
        self.total_control_dim = 0
        # Optional pairwise coupling: inter_agent_cost(x_i, x_j, t) is added
        # to agent i's stage cost for every other agent j (every ordered
        # pair i != j).  Requires homogeneous agents.
        self.inter_agent_cost = None
        # Optional sparsification for large games: couple each agent only to
        # its K nearest neighbours (Euclidean distance over
        # coupling_distance_dims of the state) instead of all N-1 others.
        # None = all pairs.
        self.coupling_neighbors = None
        self.coupling_distance_dims = (0, 1)

    def add_agent(self, agent: Agent) -> None:
        self.agents.append(agent)

    def compute_offsets(self) -> None:
        """Sort agents by id and assign contiguous offsets."""
        self.blocks = []
        state_offset = 0
        control_offset = 0
        for agent in sorted(self.agents, key=lambda a: a.id):
            nx, nu = agent.state_dim(), agent.control_dim()
            self.blocks.append(
                AgentBlockInfo(agent.id, state_offset, control_offset, nx, nu, agent)
            )
            state_offset += nx
            control_offset += nu
        self.total_state_dim = state_offset
        self.total_control_dim = control_offset

    def build_global_ocp(self) -> OCP:
        """The centralized block-diagonal joint OCP."""
        raise NotImplementedError(
            "build_global_ocp (the centralized strategy's joint OCP) is not ported yet "
            "(ROADMAP: queue 1, multi-agent -- centralized)")
