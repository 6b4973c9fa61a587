"""Multi-agent LQR example: N copies of a linear OCP under any strategy.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/multi_agent_lqr.py``: per agent A = B = I
(4 x 4), Q = R = Qf = I, x0 = (1, 0, 0, 0), T = 10, dt = 0.1, the full
analytic derivative set, and the example's solver parameters.  The
dynamics and costs carry the device tags of ``Linear<4, 4>``,
``Quadratic<4, 4>`` and ``QuadraticTerminal<4>``, so a homogeneous sweep
runs the fused loop's kernels on the card (the cost is quadratic and
stationary: the main path's branch, K1).  The CLI and CSV halves are not
ported.
"""

from __future__ import annotations

import torch

from ..agent import Agent
from ..models import make_linear_dynamics, quadratic_stage_cost, quadratic_terminal_cost
from ..multi_agent import MultiAgentProblem
from ..ocp import OCP

N_X, N_U, T_STEPS, DT = 4, 4, 10, 0.1
PARAMS = {"max_iterations": 100, "tolerance": 1e-5, "max_ms": 100}


class _LQRProblemFactory:
    """Builds homogeneous LQR OCPs sharing one set of problem functions.

    The analytic derivatives take one problem (``x [nx]``, ``u [nu]``), as
    every derivative oracle does; they return tensors in ``x``'s dtype and
    on its device."""

    def __init__(self, n_x=N_X, n_u=N_U, dt=DT, horizon=T_STEPS):
        self.n_x, self.n_u, self.dt, self.horizon = n_x, n_u, dt, horizon
        A = torch.eye(n_x, dtype=torch.float64)
        B = torch.eye(n_x, n_u, dtype=torch.float64)
        Q = torch.eye(n_x, dtype=torch.float64)
        R = torch.eye(n_u, dtype=torch.float64)
        self.dynamics = make_linear_dynamics(A, B)
        self.stage_cost = quadratic_stage_cost(Q, R)
        self.terminal_cost = quadratic_terminal_cost(Q)
        Qt, Rt = Q + Q.T, R + R.T
        lux = torch.zeros((n_u, n_x), dtype=torch.float64)
        self.fx = lambda x, u: A.to(x)
        self.fu = lambda x, u: B.to(x)
        self.lx = lambda x, u, t: Qt.to(x) @ x
        self.lu = lambda x, u, t: Rt.to(u) @ u
        self.lxx = lambda x, u, t: Qt.to(x)
        self.luu = lambda x, u, t: Rt.to(x)
        self.lux = lambda x, u, t: lux.to(x)
        self.phix = lambda x: Qt.to(x) @ x
        self.phixx = lambda x: Qt.to(x)

    def build(self, initial_state=None, dtype=torch.float32, device="cuda") -> OCP:
        """One agent's problem from ``initial_state`` (default (1, 0, ...)),
        initialized on ``device``."""
        x0 = torch.zeros(self.n_x, dtype=dtype)
        x0[0] = 1.0
        if initial_state is not None:
            x0 = torch.as_tensor(initial_state, dtype=dtype)
        ocp = OCP(
            state_dim=self.n_x,
            control_dim=self.n_u,
            horizon_steps=self.horizon,
            dt=self.dt,
            initial_state=x0,
            dynamics=self.dynamics,
            stage_cost=self.stage_cost,
            terminal_cost=self.terminal_cost,
            dynamics_state_jacobian=self.fx,
            dynamics_control_jacobian=self.fu,
            cost_state_gradient=self.lx,
            cost_control_gradient=self.lu,
            cost_state_hessian=self.lxx,
            cost_control_hessian=self.luu,
            cost_cross_term=self.lux,
            terminal_cost_gradient=self.phix,
            terminal_cost_hessian=self.phixx,
            device=device,
        )
        ocp.initialize_problem()
        ocp.verify_problem()
        return ocp


def build_problem(n_agents: int, initial_states=None, dtype=torch.float32,
                  device="cuda") -> MultiAgentProblem:
    """``n_agents`` LQR agents of one factory; agent i starts at
    ``initial_states[i]`` (default: the example's (1, 0, 0, 0) for all)."""
    factory = _LQRProblemFactory()
    problem = MultiAgentProblem()
    for i in range(n_agents):
        x0 = None if initial_states is None else initial_states[i]
        problem.add_agent(Agent(i, factory.build(x0, dtype, device)))
    return problem
