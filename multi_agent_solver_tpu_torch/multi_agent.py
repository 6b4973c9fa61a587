"""Multi-agent problem container and the centralized joint-OCP builder.

Counterpart of ``multi_agent_solver_tpu/multi_agent.py``: agents are
id-sorted into contiguous state / control blocks, and an optional pairwise
``inter_agent_cost`` couples them into a game that the Nash strategies play
(``strategies/nash.py``).  :meth:`MultiAgentProblem.build_global_ocp`
stacks the agents into one block-diagonal joint OCP: the dynamics
concatenate each agent's on its slice, the stage and terminal costs sum
theirs, plus the directed pair sum of ``inter_agent_cost``; input bounds
are merged only when every agent has both (the reference's rule), state
bounds likewise, warm starts when every shape lines up.  The joint
functions carry no device-function tag, so on the card the joint OCP takes
the route of untagged problems (``solve(ocp)``'s torch loop).
:meth:`MultiAgentProblem.scatter_global_result` writes the joint result
back to the agents, each cost recomputed with ``ocp.cost_of``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .agent import Agent
from .ocp import OCP, cost_of


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
        # pair i != j).  The Nash strategies need agents stackable by
        # padding (strategies/hetero.py) for it.
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
        """Stack all agents into one block-diagonal joint OCP, initialized on
        the first agent's device (horizon and dt from the first block)."""
        if not self.blocks:
            self.compute_offsets()
        blocks = self.blocks
        if not blocks:
            raise ValueError("MultiAgentProblem has no agents")
        first = blocks[0].agent.ocp
        horizon, dt = first.horizon_steps, first.dt
        slices = [(b.state_offset, b.state_offset + b.state_dim, b.control_offset,
                   b.control_offset + b.control_dim, b.agent.ocp) for b in blocks]

        def global_dynamics(x, u):
            return torch.cat([ocp.dynamics(x[..., xs:xe], u[..., us:ue])
                              for xs, xe, us, ue, ocp in slices], -1)

        inter = self.inter_agent_cost
        n = len(blocks)
        uniform = all(b.state_dim == blocks[0].state_dim and b.control_dim == blocks[0].control_dim
                      for b in blocks)
        # Agent i's others (j != i), [N, N-1]: self-pairs are excluded by
        # indexing, never evaluated -- masking them afterwards would leak NaN
        # gradients through 1 / distance-style couplings.
        others = np.array([[j for j in range(n) if j != i] for i in range(n)],
                          np.int64).reshape(n, n - 1)

        def pair_sum(x, t):
            """The directed pair sum: each agent pays its coupling to every
            other agent, as in the Nash strategies."""
            if uniform and n > 1:
                xa = x.reshape(x.shape[:-1] + (n, -1))                  # [..., N, nx]
                xj = xa[..., torch.as_tensor(others, device=x.device), :]  # [..., N, N-1, nx]
                tk = t[..., None, None] if torch.is_tensor(t) and t.dim() > 0 else t
                return inter(xa[..., :, None, :], xj, tk).sum((-2, -1))
            total = 0.0
            for i, (xs_i, xe_i, *_) in enumerate(slices):
                for j, (xs_j, xe_j, *_) in enumerate(slices):
                    if i != j:
                        total = total + inter(x[..., xs_i:xe_i], x[..., xs_j:xe_j], t)
            return total

        def global_stage_cost(x, u, t):
            total = 0.0
            for xs, xe, us, ue, ocp in slices:
                total = total + ocp.stage_cost(x[..., xs:xe], u[..., us:ue], t)
            if inter is not None:
                total = total + pair_sum(x, t)
            return total

        def global_terminal_cost(x):
            total = 0.0
            for xs, xe, _, _, ocp in slices:
                total = total + ocp.terminal_cost(x[..., xs:xe])
            return total

        dev = first.initial_state.device
        ocps = [b.agent.ocp for b in blocks]
        cat = lambda ts: torch.cat([torch.as_tensor(t).to(dev) for t in ts])

        def merge_bounds(lower: str, upper: str):
            lowers, uppers = [getattr(o, lower) for o in ocps], [getattr(o, upper) for o in ocps]
            if all(v is not None for v in lowers) and all(v is not None for v in uppers):
                return cat(lowers), cat(uppers)
            return None, None

        in_lower, in_upper = merge_bounds("input_lower_bounds", "input_upper_bounds")
        st_lower, st_upper = merge_bounds("state_lower_bounds", "state_upper_bounds")
        warm = None
        if all(o.initial_controls is not None
               and tuple(o.initial_controls.shape) == (horizon, o.control_dim) for o in ocps):
            warm = torch.cat([o.initial_controls.to(dev) for o in ocps], -1)
        global_ocp = OCP(
            state_dim=self.total_state_dim,
            control_dim=self.total_control_dim,
            horizon_steps=horizon,
            dt=dt,
            initial_state=cat([o.initial_state for o in ocps]),
            dynamics=global_dynamics,
            stage_cost=global_stage_cost,
            terminal_cost=global_terminal_cost,
            input_lower_bounds=in_lower,
            input_upper_bounds=in_upper,
            state_lower_bounds=st_lower,
            state_upper_bounds=st_upper,
            initial_controls=warm,
            device=dev,
        )
        global_ocp.initialize_problem()
        global_ocp.verify_problem()
        return global_ocp

    def scatter_global_result(self, global_ocp: OCP) -> None:
        """Write the joint best trajectories back into each agent's OCP, its
        cost recomputed from its slice.  The joint result is fetched to the
        host once."""
        X, U = global_ocp.best_states.cpu(), global_ocp.best_controls.cpu()
        for b in self.blocks:
            states = X[:, b.state_offset:b.state_offset + b.state_dim]
            controls = U[:, b.control_offset:b.control_offset + b.control_dim]
            ocp = b.agent.ocp
            ocp.set_result(states, controls, float(cost_of(ocp.spec(), states, controls)))
