"""The problems the port runs end to end.

* The main path, the batched single-track lane-follow iLQR solve:
  counterpart of ``__graft_entry__._single_track_spec`` and of
  ``bench.py``'s x0 batch and solver config.
* The circular-track agent sweep of ``scripts/bench_multi_agent.py``:
  agents spread on the circle, tiled over scenarios, solved as batch lanes.
* The coupled Nash game of ``scripts/bench_multi_agent.py::bench_coupled``:
  the same cars coupled by a collision cost, played by the ``sequential``
  strategy at 64 agents (all pairs), 256 and 1,024 (8 nearest neighbours);
  and the same game with every car's speed capped by one AL inequality
  row (``constrained_game``, :data:`SPEED_CAP`, :data:`CONSTRAINED_PARAMS`).
* The AL-constrained batched solves: the main-path batch with state bounds
  folded into four AL inequality rows (``state_bound_specs``,
  :data:`AL_CONFIG`), and the input-pinning equality problem of
  ``tests/test_constraints.py`` (``equality_specs``, :data:`EQ_CONFIG`).
* The closed-loop fleet of ``examples/single_track_mpc.py``
  (``fleet_specs``: lateral offsets ``linspace(0.5, 1.5, B)``, run by
  ``run_mpc_batched`` with :data:`FLEET_PARAMS`) and the cart-pole swing-up batch
  of ``examples/cartpole_swing_up.py`` (``cartpole_specs``,
  :data:`CARTPOLE_CONFIG`).
* The multi-agent LQR of ``examples/multi_agent_lqr.py`` (``lqr_fleet``:
  agents 0-3 at the example's x0, the rest drawn from a seed; ``lqr_joint``:
  its block-diagonal joint OCP), solved under the four strategies, and the
  mixed fleet of ``tests/test_hetero.py`` (``mixed_fleet``: single-track
  cars beside (2, 1) LQR agents, padded to one stack by
  ``strategies/hetero.py``).
* The single problem of ``examples/single_track_ocp.py``
  (``single_track_ocp``, :data:`SINGLE_PARAMS`), solved through
  ``make_solver("ilqr", ...).solve(ocp)``, and the non-fused path's
  configurations of the main-path batch: :data:`NONFUSED_ROUTES`
  (``fused=False`` with either linearizer), :data:`CONTINUOUS_CONFIG`,
  ``untagged_specs`` (the lane-follow cost as a plain torch callable).
* The model zoo on the kernels: the rocket of
  ``examples/rocket_max_altitude.py`` (``rocket_specs``, drawn initial
  masses; ``derivative_mode="fd"`` for the finite-difference route), the
  dynamic bicycle's lane change (``bicycle_specs``), the quadrotors' hover
  regulation (``quadrotor_specs``, ``quadrotor_rotor_specs``) and the
  pendulum swing-up batch (``pendulum_specs``), with their configs.

``chip_smoke.py`` and the tests use them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .agent import Agent
from .examples.cartpole_swing_up import create_cartpole_swingup_ocp
from .examples.multi_agent_lqr import PARAMS as LQR_PARAMS
from .examples.multi_agent_lqr import build_problem as build_lqr_problem
from .examples.multi_agent_single_track import build_problem, create_single_track_circular_ocp
from .examples.single_track_mpc import PARAMS as FLEET_PARAMS
from .examples.single_track_mpc import fleet_specs
from .examples.pendulum_swing_up import create_pendulum_swingup_ocp
from .examples.rocket_max_altitude import create_max_altitude_rocket_ocp
from .examples.single_track_ocp import PARAMS as SINGLE_PARAMS
from .examples.single_track_ocp import (DESIRED_VELOCITY, LANE_FOLLOW_COST, W_ACC, W_DELTA,
                                        W_LANE, W_SPEED, create_single_track_lane_following_ocp)
from .multi_agent import MultiAgentProblem
from .derivatives import make_derivatives
from .ocp import (OCP, OCPSpec, bound_rows, diagonal_quadratic_cost,
                  diagonal_quadratic_terminal_cost, synthesized_objective,
                  with_state_bound_constraints)
from .models import (
    HOVER_ROTOR_THRUST,
    HOVER_THRUST,
    dynamic_bicycle_model,
    make_linear_dynamics,
    quadratic_stage_cost,
    quadratic_terminal_cost,
    quadrotor_dynamics,
    quadrotor_rotor_dynamics,
    single_track_control_jacobian,
    single_track_model,
    single_track_state_jacobian,
)
from .solvers import make_solver
from .solvers.ilqr import ILQRConfig
from .strategies import make_strategy

# bench.py's solver configuration (the 3-rung forward-pass ladder).
BENCH_CONFIG = ILQRConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125))
# scripts/bench_multi_agent.py's solver configuration (the reference
# 10-rung forward-pass ladder).
SWEEP_CONFIG = ILQRConfig(max_iterations=100, tolerance=1e-5)
# bench_coupled's game: collision weight, sweeps, solver parameters, and
# its rows (agents, nearest neighbours; None = all pairs).
COUPLING, MAX_OUTER = 25.0, 10
COUPLED_PARAMS = {"max_iterations": 100, "tolerance": 1e-5, "max_ms": 1e9}
COUPLED_ROWS = ((64, None), (256, 8), (1024, 8))
# The constrained game: bench_coupled's with one inequality row per car,
# v - 4.5 <= 0.  The track's target speed is 5.0 and the cars start at 4.0,
# so the cap binds.  Every car shares this one constraint object: the
# strategy stacks agents whose problem functions are the same objects.
# Its solver parameters are bench_coupled's with AL_CONFIG's constraint
# tolerance.
SPEED_CAP = bound_rows(("x", 3, 4.5, "upper"))
CONSTRAINED_PARAMS = {**COUPLED_PARAMS, "constraint_tolerance": 1e-3}
# The AL configurations: the main path's state bounds (the speed cap binds,
# the cost pulls v to 1) and solver configuration, and the equality
# problem's configuration.
INF = float("inf")
STATE_LOWER, STATE_UPPER = (-INF, -0.1, -INF, 0.0), (INF, 1.6, INF, 0.8)
AL_CONFIG = ILQRConfig(max_iterations=40, tolerance=1e-5, constraint_tolerance=1e-3,
                       alpha_ladder=(1.0, 0.5, 0.125))
EQ_CONFIG = ILQRConfig(max_iterations=40, tolerance=1e-8, constraint_tolerance=1e-3)
# y^2 + 0.1 delta^2 + 0.1 a^2 with a pinned to 0.3 by the equality row.
EQ_COST = diagonal_quadratic_cost(w_x=(0.0, 1.0, 0.0, 0.0), r_x=(0.0, 0.0, 0.0, 0.0),
                                  w_u=(0.1, 0.1), r_u=(0.0, 0.0))
EQ_ROW = bound_rows(("u", 1, 0.3, "upper"))
# The main path in the continuous Jacobian mode (the reference's
# continuous_jacobians=1).
CONTINUOUS_CONFIG = dataclasses.replace(BENCH_CONFIG, jacobian_mode="continuous")
# The non-fused routes of the main path: solve_ilqr_batched's keyword
# arguments for the vmapped torch linearizer (per iteration K4 explicit and
# K2 select) and for K7 in its place.
NONFUSED_ROUTES = {"xla": dict(fused=False, linearize="xla"),
                   "pallas": dict(fused=False, linearize="pallas")}
# The cart-pole batch's configuration: the example's tolerance, 30
# iterations.
CARTPOLE_CONFIG = ILQRConfig(max_iterations=30, tolerance=1e-7)


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


def circular_sweep_x0(n_agents: int, n_scenarios: int) -> np.ndarray:
    """``scripts/bench_multi_agent.py``'s initial states ``[S * N, 4]``:
    agent i at angle 2 pi i / N on the circle, tangential, v = 4, the
    agents tiled over the scenarios."""
    thetas = 2.0 * np.pi * np.arange(n_agents) / n_agents
    x0 = np.stack([20.0 * np.cos(thetas), 20.0 * np.sin(thetas), 1.57 + thetas,
                   4.0 * np.ones_like(thetas)], axis=-1).astype(np.float32)
    return np.tile(x0, (n_scenarios, 1))


def circular_sweep_specs(n_agents: int, n_scenarios: int, device="cuda") -> OCPSpec:
    """The sweep's batch: ``n_agents * n_scenarios`` circular-track problems."""
    template = create_single_track_circular_ocp(0.0, device=device).spec()
    return batch_specs(template, circular_sweep_x0(n_agents, n_scenarios))


def coupled_game(n_agents: int, neighbors=None, max_outer: int = MAX_OUTER, params=None,
                 dtype=torch.float32, device="cuda"):
    """``(problem, strategy)`` of one ``bench_coupled`` row: ``n_agents``
    cars coupled with weight :data:`COUPLING` (radius 3), each to its
    ``neighbors`` nearest others (None: all), and the ``sequential``
    strategy over iLQR with :data:`COUPLED_PARAMS` (or ``params``)."""
    problem: MultiAgentProblem = build_problem(n_agents, COUPLING, dtype, device)
    problem.coupling_neighbors = neighbors
    solver = make_solver("ilqr", device=device)
    strategy = make_strategy("sequential", solver, COUPLED_PARAMS if params is None else params,
                             max_outer)
    return problem, strategy


def constrained_game(n_agents: int, neighbors=None, max_outer: int = MAX_OUTER, params=None,
                     dtype=torch.float32, device="cuda"):
    """``(problem, strategy)`` of :func:`coupled_game` with :data:`SPEED_CAP`
    on every car and :data:`CONSTRAINED_PARAMS` (or ``params``): a coupled
    game of constrained agents, solved through the AL machinery with the
    context (on the card, the select kernel's AL and context modes at
    once)."""
    problem, strategy = coupled_game(n_agents, neighbors, max_outer,
                                     CONSTRAINED_PARAMS if params is None else params, dtype,
                                     device)
    for agent in problem.agents:
        agent.ocp.inequality_constraints = SPEED_CAP
        agent.ocp.invalidate()
    return problem, strategy


def state_bound_specs(batch: int, device="cuda", horizon: int = 80) -> OCPSpec:
    """The main-path batch (``bench_specs``) with the state bounds
    :data:`STATE_LOWER` / :data:`STATE_UPPER` folded into the inequality
    rows ``y - 1.6``, ``v - 0.8``, ``-0.1 - y`` and ``0 - v``."""
    spec = single_track_spec(horizon, device=device)
    bound = lambda b: torch.tensor(b, dtype=spec.initial_state.dtype, device=spec.initial_state.device)
    spec = spec.replace(state_lower_bounds=bound(STATE_LOWER), state_upper_bounds=bound(STATE_UPPER))
    return batch_specs(with_state_bound_constraints(spec), bench_x0(batch))


def equality_x0(batch: int, seed: int = 1) -> np.ndarray:
    """The equality problem's initial states ``(0, y, 0.3, 0.5)``, ``y``
    drawn U(0.25, 0.75) from ``RandomState(seed)``."""
    x0 = np.tile(np.array([0.0, 0.5, 0.3, 0.5], np.float32), (batch, 1))
    x0[:, 1] = np.random.RandomState(seed).uniform(0.25, 0.75, batch)
    return x0


def equality_specs(batch: int, device="cuda", horizon: int = 30) -> OCPSpec:
    """``tests/test_constraints.py``'s equality problem, batched: cost
    :data:`EQ_COST`, no input bounds, ``u[1] - 0.3 = 0`` at every stage,
    x0 from :func:`equality_x0`."""
    ocp = OCP(state_dim=4, control_dim=2, horizon_steps=horizon, dt=0.1,
              initial_state=torch.tensor([0.0, 0.5, 0.3, 0.5]), dynamics=single_track_model,
              stage_cost=EQ_COST, dynamics_state_jacobian=single_track_state_jacobian,
              dynamics_control_jacobian=single_track_control_jacobian,
              equality_constraints=EQ_ROW, device=device)
    ocp.initialize_problem()
    return batch_specs(ocp.spec(), equality_x0(batch))


# examples/single_track_ocp.py's problem (x0 = (0, 1, 0, 0), T = 80, the
# lane-follow cost with its analytic gradients and Hessians, the model's
# analytic Jacobians), solved through make_solver("ilqr", ...).solve(ocp).
single_track_ocp = create_single_track_lane_following_ocp


def cartpole_x0(batch: int, seed: int = 0) -> np.ndarray:
    """Cart-pole initial states ``(0, theta, 0, 0)``, ``theta`` drawn
    U(0, 0.1) (around the example's 0.05) from ``RandomState(seed)``."""
    x0 = np.zeros((batch, 4), np.float32)
    x0[:, 1] = np.random.RandomState(seed).uniform(0.0, 0.1, batch)
    return x0


def cartpole_specs(batch: int, device="cuda", seed: int = 0) -> OCPSpec:
    """``batch`` cart-pole swing-ups of ``examples/cartpole_swing_up.py``
    (its bounds and sinusoid seed) from :func:`cartpole_x0`; solved with
    :data:`CARTPOLE_CONFIG`, they run the fused loop's general branch."""
    return batch_specs(create_cartpole_swingup_ocp(device=device).spec(),
                       cartpole_x0(batch, seed))


def untagged_specs(batch: int, device="cuda", horizon: int = 80) -> OCPSpec:
    """The main-path batch with its cost written as a plain torch callable
    without a device-function tag: the kernels cannot evaluate it, so on
    the card it takes the non-fused path with the torch rollout and forward
    pass (K4's explicit mode needs no user function)."""
    specs = bench_specs(batch, device=device, horizon=horizon)

    def cost(x, u, t):
        return (W_LANE * x[..., 1] ** 2 + W_SPEED * (x[..., 3] - DESIRED_VELOCITY) ** 2
                + W_DELTA * u[..., 0] ** 2 + W_ACC * u[..., 1] ** 2)

    return specs.replace(stage_cost=cost, objective_function=synthesized_objective(
        cost, specs.terminal_cost), derivs=make_derivatives(
        specs.dynamics, cost, specs.terminal_cost, step_fx=specs.derivs.step_fx,
        step_fu=specs.derivs.step_fu))


def lqr_x0(n_agents: int, seed: int = 0) -> np.ndarray:
    """The LQR fleet's initial states ``[N, 4]``: U(-1, 1) from
    ``RandomState(seed)``, agents 0-3 at the example's (1, 0, 0, 0)."""
    x0 = np.random.RandomState(seed).uniform(-1.0, 1.0, (n_agents, 4)).astype(np.float32)
    x0[:4] = (1.0, 0.0, 0.0, 0.0)
    return x0


def lqr_fleet(n_agents: int, seed: int = 0, dtype=torch.float32,
              device="cuda") -> MultiAgentProblem:
    """``examples/multi_agent_lqr.py``'s problem with ``n_agents`` agents
    from :func:`lqr_x0`: homogeneous and uncoupled, so every strategy
    stacks it (the centralized one by its dispatch) and each agent's
    optimum is its own.  Solve it with :data:`LQR_PARAMS`."""
    return build_lqr_problem(n_agents, lqr_x0(n_agents, seed), dtype, device)


def lqr_joint(n_agents: int, dtype=torch.float32, device="cuda") -> OCP:
    """The example's ``n_agents``-agent problem (every agent at (1, 0, 0,
    0)) as one block-diagonal joint OCP (``build_global_ocp``): untagged
    joint functions, ``4 n_agents`` states and controls."""
    return build_lqr_problem(n_agents, None, dtype, device).build_global_ocp()


# The mixed fleet's solver parameters (tests/test_hetero.py).
MIXED_PARAMS = {"max_iterations": 40, "tolerance": 1e-6, "max_ms": 10000}
MIXED_HORIZON = 20


def _shared_lane_cost(x, u, t):
    return (10.0 * x[..., 1] ** 2 + (x[..., 3] - 1.0) ** 2
            + 0.1 * (u[..., 0] ** 2 + u[..., 1] ** 2))


@functools.lru_cache(maxsize=None)
def _mixed_lqr_functions():
    """The (2, 1) LQR agent's functions: A = I, B = e_1, Q = R = Qf = I."""
    return (make_linear_dynamics(torch.eye(2), torch.eye(2, 1)),
            quadratic_stage_cost(torch.eye(2), torch.eye(1)),
            quadratic_terminal_cost(torch.eye(2)))


def mixed_fleet(n_agents: int, seed: int = 0, dtype=torch.float32,
                device="cuda") -> MultiAgentProblem:
    """Single-track cars (nx = 4, nu = 2, input bounds, the lane cost of
    ``tests/test_hetero.py``) and (2, 1) LQR agents (unbounded): agent i is
    an LQR agent where ``i % 3 == 1``.  The first three agents are
    ``tests/test_hetero.py``'s (cars at (0, 1, 0, 0) and (0, -1, 0, 0.5),
    the LQR agent at (1, 0)); the others start from ``RandomState(seed)``
    draws (cars: y U(-1.5, 1.5), v U(0, 0.5); LQR agents U(-1, 1)).  T = 20,
    dt = 0.1; solve it with :data:`MIXED_PARAMS`."""
    rng = np.random.RandomState(seed)
    n = max(n_agents, 3)
    cars = np.zeros((n, 4), np.float32)
    cars[:, 1] = rng.uniform(-1.5, 1.5, n)
    cars[:, 3] = rng.uniform(0.0, 0.5, n)
    lqrs = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    cars[0], cars[2] = (0.0, 1.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.5)
    lqrs[1] = (1.0, 0.0)
    dyn, stage, term = _mixed_lqr_functions()
    problem = MultiAgentProblem()
    for i in range(n_agents):
        if i % 3 == 1:
            ocp = OCP(state_dim=2, control_dim=1, horizon_steps=MIXED_HORIZON, dt=0.1,
                      initial_state=torch.as_tensor(lqrs[i], dtype=dtype), dynamics=dyn,
                      stage_cost=stage, terminal_cost=term, device=device)
        else:
            ocp = OCP(state_dim=4, control_dim=2, horizon_steps=MIXED_HORIZON, dt=0.1,
                      initial_state=torch.as_tensor(cars[i], dtype=dtype),
                      dynamics=single_track_model, stage_cost=_shared_lane_cost,
                      dynamics_state_jacobian=single_track_state_jacobian,
                      dynamics_control_jacobian=single_track_control_jacobian,
                      input_lower_bounds=torch.tensor([-0.7, -1.0], dtype=dtype),
                      input_upper_bounds=torch.tensor([0.7, 1.0], dtype=dtype), device=device)
        ocp.initialize_problem()
        problem.add_agent(Agent(i, ocp))
    return problem


# The model zoo.  Each problem is the JAX package's (an example, a test or a
# script), its cost written as the tagged device-function callables
# (ocp.diagonal_quadratic_cost for the sums of weighted squares), its x0
# drawn from RandomState(seed); each runs on the kernels by the JAX router.

# examples/rocket_max_altitude.py's solver parameters as a config.
ROCKET_CONFIG = ILQRConfig(max_iterations=25, tolerance=1e-6)
# tests/test_dynamic_bicycle.py's lane change, 10 iterations.
BICYCLE_CONFIG = ILQRConfig(max_iterations=10, tolerance=1e-8)
BICYCLE_HORIZON = 30
# scripts/bench_quadrotor.py's hover regulation: T = 40, dt = 0.05, 10
# iterations, tolerance 1e-6; the rotor-lag quadrotor the same.
QUADROTOR_CONFIG = ILQRConfig(max_iterations=10, tolerance=1e-6)
QUADROTOR_HORIZON = 40
QUADROTOR_W = (4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.1, 0.1, 0.1)
QUADROTOR_RU = (0.1, 1.0, 1.0, 1.0)
# The pendulum swing-up batch: the example's problem (T = 60), 10
# iterations at its tolerance.
PENDULUM_CONFIG = ILQRConfig(max_iterations=10, tolerance=1e-4)


def rocket_x0(batch: int, seed: int = 0) -> np.ndarray:
    """Rocket initial states ``(0, 0, m0)``, ``m0`` drawn U(0.8, 2.0) from
    ``RandomState(seed)``: around the example's 1.0, where the half-thrust
    guess burns the mass down to the floor, and above it, where it lifts
    off."""
    x0 = np.zeros((batch, 3), np.float32)
    x0[:, 2] = np.random.RandomState(seed).uniform(0.8, 2.0, batch)
    return x0


def rocket_specs(batch: int, device="cuda", seed: int = 0, derivative_mode: str = "ad",
                 dtype=torch.float32) -> OCPSpec:
    """``batch`` rockets of ``examples/rocket_max_altitude.py`` (its
    analytic oracles, thrust box and half-thrust guess) from
    :func:`rocket_x0`.  In the ``ad`` mode the fused loop's main-path branch
    runs (K2, K3's hoist, K1); ``derivative_mode="fd"`` takes the non-fused
    path with the finite-difference oracles, K4's explicit mode and K2."""
    ocp = create_max_altitude_rocket_ocp(dtype=dtype, device=device)
    if derivative_mode != "ad":
        ocp.derivative_mode = derivative_mode
        ocp.invalidate()
    return batch_specs(ocp.spec(), rocket_x0(batch, seed))


def bicycle_x0(batch: int, seed: int = 0) -> np.ndarray:
    """Lane-change initial states ``(0, y0, 0, 15, 0, 0)``, ``y0`` drawn
    U(1, 3) (around the test's 2 m) from ``RandomState(seed)``."""
    x0 = np.zeros((batch, 6), np.float32)
    x0[:, 1] = np.random.RandomState(seed).uniform(1.0, 3.0, batch)
    x0[:, 3] = 15.0
    return x0


# tests/test_dynamic_bicycle.py's stage cost, 2 y^2 + 0.5 psi^2 + 0.05 (vx -
# 15)^2 + 2 delta^2 + 0.1 ax^2, as DiagQuadratic<6, 2>.
BICYCLE_COST = diagonal_quadratic_cost(w_x=(0.0, 2.0, 0.5, 0.05, 0.0, 0.0),
                                       r_x=(0.0, 0.0, 0.0, 15.0, 0.0, 0.0),
                                       w_u=(2.0, 0.1), r_u=(0.0, 0.0))


def bicycle_spec(horizon: int = BICYCLE_HORIZON, dtype=torch.float32, device="cuda") -> OCPSpec:
    """``tests/test_dynamic_bicycle.py::lane_change_ocp``: start 2 m off the
    lane at 15 m/s, regulate to y = 0 (:data:`BICYCLE_COST`), input bounds
    (-0.4, -4) .. (0.4, 2), dt = 0.05."""
    ocp = OCP(
        state_dim=6, control_dim=2, horizon_steps=horizon, dt=0.05,
        initial_state=torch.tensor([0.0, 2.0, 0.0, 15.0, 0.0, 0.0], dtype=dtype),
        dynamics=dynamic_bicycle_model,
        stage_cost=BICYCLE_COST,
        input_lower_bounds=torch.tensor([-0.4, -4.0], dtype=dtype),
        input_upper_bounds=torch.tensor([0.4, 2.0], dtype=dtype),
        device=device,
    )
    ocp.initialize_problem()
    return ocp.spec()


def bicycle_specs(batch: int, device="cuda", seed: int = 0,
                  horizon: int = BICYCLE_HORIZON, dtype=torch.float32) -> OCPSpec:
    return batch_specs(bicycle_spec(horizon, dtype, device), bicycle_x0(batch, seed))


def quadrotor_x0(batch: int, seed: int = 0, nx: int = 12) -> np.ndarray:
    """``scripts/bench_quadrotor.py``'s initial states: positions U(-1, 1)
    and roll / pitch U(-0.2, 0.2), drawn in that order from
    ``RandomState(seed)``; at nx = 16 the rotors at hover thrust."""
    rng = np.random.RandomState(seed)
    x0 = np.zeros((batch, nx), np.float32)
    x0[:, :3] = rng.uniform(-1.0, 1.0, (batch, 3))
    x0[:, 6:8] = rng.uniform(-0.2, 0.2, (batch, 2))
    if nx == 16:
        x0[:, 12:] = HOVER_ROTOR_THRUST
    return x0


def quadrotor_spec(horizon: int = QUADROTOR_HORIZON, dtype=torch.float32,
                   device="cuda") -> OCPSpec:
    """``scripts/bench_quadrotor.py``'s hover regulation: stage ``sum w x x +
    sum ru du du`` (``du = u - (mg, 0, 0, 0)``) and terminal ``10 sum w x
    x`` as ``DiagQuadratic<12, 4>`` and ``DiagQuadraticTerminal<12>``, the
    hover thrust as the guess, dt = 0.05, no input bounds."""
    u_hover = (HOVER_THRUST, 0.0, 0.0, 0.0)
    ocp = OCP(
        state_dim=12, control_dim=4, horizon_steps=horizon, dt=0.05,
        initial_state=torch.zeros(12, dtype=dtype).index_fill_(0, torch.tensor([0]), 1.0),
        dynamics=quadrotor_dynamics,
        stage_cost=diagonal_quadratic_cost(QUADROTOR_W, (0.0,) * 12, QUADROTOR_RU, u_hover),
        terminal_cost=diagonal_quadratic_terminal_cost(
            tuple(10.0 * w for w in QUADROTOR_W), (0.0,) * 12),
        initial_controls=torch.tensor(u_hover, dtype=dtype).repeat(horizon, 1),
        device=device,
    )
    ocp.initialize_problem()
    return ocp.spec()


def quadrotor_specs(batch: int, device="cuda", seed: int = 0,
                    horizon: int = QUADROTOR_HORIZON, dtype=torch.float32) -> OCPSpec:
    return batch_specs(quadrotor_spec(horizon, dtype, device), quadrotor_x0(batch, seed))


QUADROTOR_ROTOR_W = QUADROTOR_W + (0.01,) * 4


def quadrotor_rotor_spec(horizon: int = QUADROTOR_HORIZON, dtype=torch.float32,
                         device="cuda") -> OCPSpec:
    """``tests/test_quadrotor_rotor.py::hover_ocp``: the rotors' thrusts
    weighted around hover, stage ``sum W dx dx + 0.1 sum du du`` and
    terminal ``10 sum W dx dx`` as ``DiagQuadratic<16, 4>`` and
    ``DiagQuadraticTerminal<16>``, x0 = (1, -0.5, 0, 0, 0, 0, 0.2, 0 ...,
    hover x 4), hover commands as the guess, dt = 0.05."""
    hover = (HOVER_ROTOR_THRUST,) * 4
    ref = (0.0,) * 12 + hover
    x0 = torch.tensor((1.0, -0.5, 0.0, 0.0, 0.0, 0.0, 0.2) + (0.0,) * 5 + hover, dtype=dtype)
    ocp = OCP(
        state_dim=16, control_dim=4, horizon_steps=horizon, dt=0.05,
        initial_state=x0,
        dynamics=quadrotor_rotor_dynamics,
        stage_cost=diagonal_quadratic_cost(QUADROTOR_ROTOR_W, ref, (0.1,) * 4, hover),
        terminal_cost=diagonal_quadratic_terminal_cost(
            tuple(10.0 * w for w in QUADROTOR_ROTOR_W), ref),
        initial_controls=torch.tensor(hover, dtype=dtype).repeat(horizon, 1),
        device=device,
    )
    ocp.initialize_problem()
    return ocp.spec()


def quadrotor_rotor_specs(batch: int, device="cuda", seed: int = 0,
                          horizon: int = QUADROTOR_HORIZON, dtype=torch.float32) -> OCPSpec:
    return batch_specs(quadrotor_rotor_spec(horizon, dtype, device),
                       quadrotor_x0(batch, seed, nx=16))


def pendulum_x0(batch: int, seed: int = 0) -> np.ndarray:
    """Pendulum initial states ``(theta, 0)``, ``theta`` drawn U(pi - 0.1,
    pi) (around the example's pi - 0.05) from ``RandomState(seed)``."""
    x0 = np.zeros((batch, 2), np.float32)
    x0[:, 0] = np.random.RandomState(seed).uniform(np.pi - 0.1, np.pi, batch)
    return x0


def pendulum_specs(batch: int, device="cuda", seed: int = 0, dtype=torch.float32) -> OCPSpec:
    """``batch`` swing-ups of ``examples/pendulum_swing_up.py`` (its torque
    box and sinusoid guess) from :func:`pendulum_x0`; solved with
    :data:`PENDULUM_CONFIG` they run the fused loop's general branch."""
    return batch_specs(create_pendulum_swingup_ocp(dtype=dtype, device=device).spec(),
                       pendulum_x0(batch, seed))
