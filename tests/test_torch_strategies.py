"""The LQR model, the joint OCP and the four strategies against the JAX
package.

The LQR's functions (``models/lqr.py``) meet JAX's on drawn matrices and
points in float64 at rtol 1e-12.  The strategies run the LQR of
``examples/multi_agent_lqr.py`` with drawn initial states (N = 3, T = 10)
on both sides in float64: every batched sweep on the scan route
(``backward="scan"``; JAX's ``_batched_solve`` -- or the centralized
strategy's ``_solve_batched`` -- is overridden on the test's instance to
pass it, and the port's likewise), so each side runs its float64 non-fused
scan path.  Costs are held to rtol 1e-6 and controls to atol 1e-6.  The
convex LQR's optimum does not depend on the route; the fused routes run
in ``chip_smoke.py`` phase 28 against the reference's 72.523735.

* all four strategies on the uncoupled LQR;
* ``linesearch`` and ``trustregion`` on a weakly coupled LQR
  (``0.01 |x_i - x_j|^2``, as tests/test_strategies.py couples it;
  symmetric single-track games are knife-edge);
* the backtracking path forced by a solver that overshoots its step 2.5x
  (every sweep then raises the total cost), on both sides, and the
  trust-region radius path forced by initial states far from the origin
  (the steps exceed the radius of 1);
* ``build_global_ocp``'s vectorized pair sum against the double loop and
  against JAX's joint cost; the joint OCP's merges; the centralized
  dispatch against the literal joint solve;
* ``run_mpc_nash`` under both new strategies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu import Agent as JAgent
from multi_agent_solver_tpu import MultiAgentProblem as JProblem
from multi_agent_solver_tpu.examples.multi_agent_lqr import _LQRProblemFactory as JFactory
from multi_agent_solver_tpu.models import lqr as j_lqr
from multi_agent_solver_tpu.mpc import run_mpc_nash as j_run_mpc_nash
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve_batched
from multi_agent_solver_tpu.strategies import make_strategy as j_make_strategy

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.agent import Agent
from multi_agent_solver_tpu_torch.examples.multi_agent_lqr import build_problem
from multi_agent_solver_tpu_torch.models import lqr
from multi_agent_solver_tpu_torch.mpc import run_mpc_nash
from multi_agent_solver_tpu_torch.multi_agent import MultiAgentProblem
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import solve_ilqr_batched
from multi_agent_solver_tpu_torch.strategies import (CentralizedStrategy, available_strategy_names,
                                                     make_strategy)

torch.set_num_threads(1)

N, OUTER = 3, 3
PARAMS = entry.LQR_PARAMS
COUPLING = 0.01
RTOL, ATOL = 1e-6, 1e-6


def _x0s(seed, scale=1.0):
    return scale * np.random.RandomState(seed).uniform(-1.0, 1.0, (N, 4))


def _j_problem(x0s, coupled=False):
    factory = JFactory()
    problem = JProblem()
    for i, x0 in enumerate(x0s):
        ocp = factory.build()
        ocp.initial_state = jnp.asarray(x0, jnp.float64)
        ocp.initialize_problem()
        problem.add_agent(JAgent(i, ocp))
    if coupled:
        problem.inter_agent_cost = lambda xi, xj, t: COUPLING * jnp.sum((xi - xj) ** 2)
    return problem


def _t_problem(x0s, coupled=False):
    problem = build_problem(len(x0s), x0s, torch.float64, "cpu")
    if coupled:
        problem.inter_agent_cost = lambda xi, xj, t: COUPLING * ((xi - xj) ** 2).sum(-1)
    return problem


def _overshoot(solve, spec_cost):
    """``solve`` whose candidate overshoots: warm + 2.5 (solution - warm),
    re-rolled and re-costed."""
    def wrapped(specs, *rest):
        r = solve(specs, *rest)
        u = specs.initial_controls + 2.5 * (r.controls - specs.initial_controls)
        xs, cost = spec_cost(specs, u)
        return dataclasses.replace(r, controls=u, states=xs, cost=cost)
    return wrapped


def _j_strategy(name, overshoot=False):
    """A JAX strategy whose batched sweeps run the float64 scan route."""
    strategy = j_make_strategy(name, j_make_solver("ilqr"), PARAMS, OUTER)
    if name == "centralized":
        cfg = strategy.solver.config
        strategy._solve_batched = lambda specs: j_solve_batched(specs, cfg, backward="scan")
        return strategy
    cfg = strategy._config
    solve = lambda specs: j_solve_batched(specs, cfg, backward="scan")
    if overshoot:
        def spec_cost(specs, u):
            xs = jax.vmap(lambda s, uu: s.rollout(uu))(specs, u)
            return xs, jax.vmap(lambda s, x, uu: s.cost(x, uu))(specs, xs, u)
        solve = _overshoot(solve, spec_cost)
    strategy._batched_solve = solve
    return strategy


def _t_strategy(name, overshoot=False):
    """The port's strategy, its batched sweeps on the float64 scan route."""
    strategy = make_strategy(name, make_solver("ilqr", device="cpu"), PARAMS, OUTER)
    scan = lambda specs, config, structure=None: solve_ilqr_batched(
        specs, config, backward="scan", device="cpu", structure=structure)
    if name == "centralized":
        strategy.solver._solve_batched_fn = scan
        return strategy
    solve = lambda specs, structure: scan(specs, strategy._config, structure)
    if overshoot:
        solve = _overshoot(solve, lambda specs, u: (lambda xs: (xs, specs.cost(xs, u)))(
            specs.rollout(u)))
    strategy._batched_solve = solve
    return strategy


def _compare(t_sol, j_sol, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t_sol.costs), np.asarray(j_sol.costs, np.float64),
                               rtol=rtol)
    for a, b in zip(t_sol.controls, j_sol.controls):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("fn", ["dynamics", "stage", "terminal"])
def test_lqr_model_functions_match_jax(fn):
    rng = np.random.RandomState(3)
    A, B, Q, R = (rng.standard_normal(s) for s in ((4, 4), (4, 2), (4, 4), (2, 2)))
    x, u = rng.standard_normal((6, 4)), rng.standard_normal((6, 2))
    j = {"dynamics": lambda: jax.vmap(j_lqr.make_linear_dynamics(A, B))(x, u),
         "stage": lambda: jax.vmap(lambda a, b: j_lqr.quadratic_stage_cost(Q, R)(a, b, 0))(x, u),
         "terminal": lambda: jax.vmap(j_lqr.quadratic_terminal_cost(Q))(x)}[fn]()
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    t = {"dynamics": lambda: lqr.make_linear_dynamics(A, B)(xt, ut),
         "stage": lambda: lqr.quadratic_stage_cost(Q, R)(xt, ut, 0),
         "terminal": lambda: lqr.quadratic_terminal_cost(Q)(xt)}[fn]()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-14)


def test_make_strategy_builds_all_four():
    assert available_strategy_names() == ["centralized", "linesearch", "sequential",
                                          "trustregion"]
    for name in available_strategy_names():
        strategy = make_strategy(name, make_solver("ilqr", device="cpu"), PARAMS, 2)
        assert strategy.name == name


@pytest.mark.parametrize("name", ["sequential", "linesearch", "trustregion", "centralized"])
def test_strategies_on_the_uncoupled_lqr(name):
    x0s = _x0s(0)
    _compare(_t_strategy(name)(_t_problem(x0s)), _j_strategy(name)(_j_problem(x0s)))


@pytest.mark.parametrize("name", ["linesearch", "trustregion"])
def test_strategies_on_the_weakly_coupled_lqr(name):
    x0s = _x0s(1)
    t_sol = _t_strategy(name)(_t_problem(x0s, True))
    _compare(t_sol, _j_strategy(name)(_j_problem(x0s, True)))
    # The coupling moves the optimum: the game is not the uncoupled problem.
    free = _t_strategy(name)(_t_problem(x0s))
    assert abs(t_sol.total_cost - free.total_cost) > 1e-3 * free.total_cost


@pytest.mark.parametrize("coupled", [False, True])
def test_linesearch_backtracks(coupled):
    """A solver that overshoots 2.5x raises the total cost every sweep, so
    every sweep backtracks (alpha 0.5 takes it to 1.25x, which improves)."""
    x0s = _x0s(2)
    t_sol = _t_strategy("linesearch", overshoot=True)(_t_problem(x0s, coupled))
    _compare(t_sol, _j_strategy("linesearch", overshoot=True)(_j_problem(x0s, coupled)))
    plain = _t_strategy("linesearch")(_t_problem(x0s, coupled))
    assert not np.allclose(t_sol.costs, plain.costs, rtol=1e-9)


def test_trustregion_radius_path():
    """Initial states 4x the drawn ones: the first steps are longer than the
    radius of 1, so they are scaled back and costed against the pre-sweep
    plans; the result parts from the unconstrained sweeps'."""
    x0s = _x0s(3, scale=4.0)
    t_sol = _t_strategy("trustregion")(_t_problem(x0s))
    _compare(t_sol, _j_strategy("trustregion")(_j_problem(x0s)))
    seq = _t_strategy("sequential")(_t_problem(x0s))
    assert not np.allclose(t_sol.costs, seq.costs, rtol=1e-6)


def test_joint_pair_sum_is_vectorized_and_correct():
    """The joint stage cost with coupling: the vectorized pair sum equals
    the explicit double loop and JAX's joint cost."""
    n = 5
    x0s = np.random.RandomState(4).uniform(-1.0, 1.0, (n, 4))
    problem = build_problem(n, x0s, torch.float64, "cpu")
    problem.inter_agent_cost = lambda xi, xj, t: COUPLING * ((xi - xj) ** 2).sum(-1)
    problem.compute_offsets()
    g = problem.build_global_ocp()
    assert g.stage_cost.__name__ == "global_stage_cost" and not hasattr(g.stage_cost, "device_fn")
    x = torch.arange(float(g.state_dim), dtype=torch.float64) * 0.1
    u = torch.linspace(-1, 1, g.control_dim, dtype=torch.float64)
    got = float(g.stage_cost(x, u, 0))
    xa = x.numpy().reshape(n, -1)
    want = sum(float(b.agent.ocp.stage_cost(x[b.state_offset:b.state_offset + 4],
                                            u[b.control_offset:b.control_offset + 4], 0))
               for b in problem.blocks)
    want += sum(COUPLING * np.sum((xa[i] - xa[j]) ** 2)
                for i in range(n) for j in range(n) if i != j)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    j_problem = JProblem()
    factory = JFactory()
    for i in range(n):
        j_problem.add_agent(JAgent(i, factory.build()))
    j_problem.inter_agent_cost = lambda xi, xj, t: COUPLING * jnp.sum((xi - xj) ** 2)
    jg = j_problem.build_global_ocp()
    np.testing.assert_allclose(got, float(jg.stage_cost(jnp.asarray(x.numpy()),
                                                        jnp.asarray(u.numpy()), 0)), rtol=1e-12)
    # Batched over stages and problems: [B, T, nx] states, [T] stage indices.
    xb = x.expand(2, 3, -1) + torch.arange(3, dtype=torch.float64)[None, :, None]
    ub = u.expand(2, 3, -1)
    batched = g.stage_cost(xb, ub, torch.arange(3))
    assert batched.shape == (2, 3)
    np.testing.assert_allclose(float(batched[1, 2]), float(g.stage_cost(xb[1, 2], ub[1, 2], 2)),
                               rtol=1e-12)


def test_global_ocp_merges_agents():
    """tests/test_strategies.py's two agents (2 states / 1 control and 1 / 2),
    added out of id order: id-sorted offsets, merged initial state and input
    bounds, block-diagonal dynamics, summed costs, bounds dropped when an
    agent lacks them."""
    f64 = lambda *v: torch.tensor(v, dtype=torch.float64)
    kw = dict(horizon_steps=5, dt=0.1, device="cpu")
    a = OCP(state_dim=2, control_dim=1, initial_state=f64(1.0, 2.0),
            dynamics=lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1),
            stage_cost=lambda x, u, t: (x ** 2).sum(-1) + (u ** 2).sum(-1),
            input_lower_bounds=f64(-1.0), input_upper_bounds=f64(1.0), **kw)
    b = OCP(state_dim=1, control_dim=2, initial_state=f64(3.0),
            dynamics=lambda x, u: (u[..., 0] + u[..., 1])[..., None],
            stage_cost=lambda x, u, t: 2.0 * (x ** 2).sum(-1),
            input_lower_bounds=f64(-2.0, -2.0), input_upper_bounds=f64(2.0, 2.0), **kw)
    a.initialize_problem()
    b.initialize_problem()
    problem = MultiAgentProblem()
    problem.add_agent(Agent(1, b))
    problem.add_agent(Agent(0, a))
    problem.compute_offsets()
    assert [blk.agent_id for blk in problem.blocks] == [0, 1]
    assert (problem.total_state_dim, problem.total_control_dim) == (3, 3)
    g = problem.build_global_ocp()
    assert g.initial_state.tolist() == [1.0, 2.0, 3.0]
    assert g.input_lower_bounds.tolist() == [-1.0, -2.0, -2.0]
    assert g.input_upper_bounds.tolist() == [1.0, 2.0, 2.0]
    x, u = f64(1.0, 2.0, 3.0), f64(0.5, -0.25, 0.75)
    assert g.dynamics(x, u).tolist() == [2.0, 0.5, 0.5]
    want = float(a.stage_cost(x[:2], u[:1], 0) + b.stage_cost(x[2:], u[1:], 0))
    np.testing.assert_allclose(float(g.stage_cost(x, u, 0)), want, rtol=1e-12)
    b.input_lower_bounds = b.input_upper_bounds = None
    g = problem.build_global_ocp()
    assert g.input_lower_bounds is None and g.input_upper_bounds is None


def test_dispatch_matches_the_joint_solve():
    """The centralized dispatch (one batched solve, held to JAX's above)
    against the literal joint solve (build_global_ocp, solve(ocp)), each
    agent's cost recomputed from its slice."""
    x0s = _x0s(5)
    dispatch = _t_strategy("centralized")(_t_problem(x0s))
    solver = make_solver("ilqr", PARAMS, device="cpu")
    joint = CentralizedStrategy(solver, structure_aware=False)(_t_problem(x0s))
    _compare(joint, dispatch, rtol=1e-8, atol=1e-8)
    # entry.lqr_joint: the example's agents (all at (1, 0, 0, 0)) as one
    # joint OCP, N times one agent's optimum.
    g = entry.lqr_joint(2, torch.float64, "cpu")
    assert (g.state_dim, g.control_dim) == (8, 8)
    solver.solve(g)
    one = entry.lqr_joint(1, torch.float64, "cpu")
    solver.solve(one)
    np.testing.assert_allclose(g.best_cost, 2 * one.best_cost, rtol=1e-8)


@pytest.mark.parametrize("name", ["linesearch", "trustregion"])
def test_run_mpc_nash(name):
    """Three closed-loop steps of the weakly coupled LQR, each a full call
    of the strategy's sweeps."""
    x0s = _x0s(6)
    t = run_mpc_nash(_t_problem(x0s, True), _t_strategy(name), 3)
    j = j_run_mpc_nash(_j_problem(x0s, True), _j_strategy(name), 3)
    np.testing.assert_allclose(t.states.numpy(), np.asarray(j.states), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.controls.numpy(), np.asarray(j.controls), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.costs.numpy(), np.asarray(j.costs), rtol=RTOL)


def test_state_bounds_decide_homogeneity_as_in_jax():
    """Agents that differ only in whether they carry state bounds are not
    homogeneous in JAX (their spec trees differ), so they never share one
    stack: an agent's own state bounds reach its solve through the host
    loop (``state_bounds_al``).  The port stacked them, each agent then
    solved with agent 0's bounds."""
    x0s = _x0s(7)
    jp, tp = _j_problem(x0s), _t_problem(x0s)
    for p, lb in ((jp, jnp.full(4, -0.5)), (tp, torch.full((4,), -0.5, dtype=torch.float64))):
        ocp = p.agents[1].ocp
        ocp.state_lower_bounds = lb
        ocp.initialize_problem()
        p.compute_offsets()
    from multi_agent_solver_tpu.strategies.base import agents_are_homogeneous as j_homogeneous
    from multi_agent_solver_tpu_torch.strategies import agents_are_homogeneous
    assert agents_are_homogeneous(tp) is j_homogeneous(jp) is False
