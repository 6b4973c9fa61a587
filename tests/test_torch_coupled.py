"""The coupled Nash game against the JAX package: the context modes of K3
and K2 (K6), the context cost and its derivatives, the strategies' context
builders and the ``sequential`` strategy end to end.

The plain PyTorch versions meet the Pallas kernels in interpret mode at one
1024-lane tile and T = 4 with K = 3 neighbours, on the same float32 inputs
drawn with numpy from a seed.  Both sides run float32 arithmetic in the
same order except two places where the last ulps may differ: XLA:CPU's and
PyTorch's float32 exp (and sin / cos / tan), and the sum over neighbours
(JAX reduces the vmapped pair costs, the port adds them in index order).
The pair costs reach 25 and their Hessian entries ~10, so values are held
to rtol 1e-5 with atol 1e-4, merits to rtol 1e-5.  The derivative oracles
and the context builders run in float64 on both sides and must agree to
1e-12, the builders exactly.

The game runs a ring of 12 cars, 3 nearest neighbours each (T = 10,
coupling 25, 2 sweeps, 5 iterations) through JAX's float32 fused loop
(``"fused": 1``) and the port's fused loop on its plain versions (also
``"fused": 1``: on the CPU both routers send a context solve to the
non-fused path by default), held to the tolerances of
tests/test_fused_loop.py for two float32 implementations of one algorithm:
per-agent cost rtol 1e-5, controls and states atol 2e-4 (measured on
these inputs: 4.4e-9, 1.7e-5, 2.9e-5).  The coupling moves this ring's
cost by 1.8e-3 relative.  Denser rings are knife-edge: the collision
cost's indefinite Hessians let a last-ulp difference change the accepted
steps, and chip_smoke.py measures per-agent costs of the 64-car game
parting by tens of percent between two float32 implementations, so they
cannot be compared agent by agent.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.examples import multi_agent_single_track as j_circ
from multi_agent_solver_tpu.ocp import with_context_cost as j_with_context_cost
from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.ops.linearize_pallas import linearize_pallas_tiled
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.strategies import make_strategy as j_make_strategy
from multi_agent_solver_tpu.strategies.nash import make_coupled_stage as j_coupled_stage

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.agent import Agent
from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as t_circ
from multi_agent_solver_tpu_torch.ocp import with_context_cost
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import probe_cost_structure, solve_ilqr_batched
from multi_agent_solver_tpu_torch.strategies import make_strategy, stack_agent_specs
from multi_agent_solver_tpu_torch.strategies.nash import make_coupled_stage

torch.set_num_threads(1)

B, T, NX, NU, K = 1024, 4, 4, 2, 3
TOL = dict(rtol=1e-5, atol=1e-4)
LADDER = (1.0, 0.5, 0.125)
GAME = dict(agents=12, neighbors=3, sweeps=2,
            params={"max_iterations": 5, "tolerance": 1e-5, "max_ms": 1e9})


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


@pytest.fixture(scope="module")
def specs():
    """(JAX spec, port spec) of one car of the coupled game: the circular
    track plus the collision cost against a context."""
    jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
    jspec = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                      j_circ.make_collision_cost(25.0)))
    tspec = t_circ.create_single_track_circular_ocp(0.0, device="cpu").spec()
    tspec = with_context_cost(tspec, make_coupled_stage(tspec.stage_cost,
                                                       t_circ.make_collision_cost(25.0)))
    return jspec, tspec


def _inputs(seed):
    """States around the track, controls in the box, and K neighbours per
    (stage, problem) within ~3 of the car, where the collision cost bites."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, (T, B))
    r = 20.0 + rng.uniform(-1, 1, (T, B))
    x = np.stack([r * np.cos(th), r * np.sin(th), th + 1.57, rng.uniform(3, 6, (T, B))], 1)
    u = rng.uniform(-0.5, 0.5, (T, NU, B))
    ctx = x[:, None] + np.concatenate(
        [rng.normal(0, 2.0, (T, K, 2, B)), rng.normal(0, 0.5, (T, K, 2, B))], 2)
    return x.astype(np.float32), u.astype(np.float32), ctx.astype(np.float32)


@pytest.mark.parametrize("hessians", [True, False])
def test_linearize_context_mode_matches_pallas(specs, hessians):
    jspec, tspec = specs
    x, u, ctx = _inputs(0)
    want = linearize_pallas_tiled(jspec, _lanes(x), _lanes(u), True, True, ctx_l=_lanes(ctx),
                                  hessians=hessians)
    got = k3.linearize_plain(tspec, torch.as_tensor(x), torch.as_tensor(u), hessians,
                             torch.as_tensor(ctx))
    assert len(got) == len(want) == (7 if hessians else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


def test_forward_select_context_rollout_mode_matches_pallas(specs):
    """alpha = 0, zero gains, bounds stripped, merit +inf, with a context."""
    jspec, tspec = specs
    x, u, ctx = _inputs(1)
    zk, zK = np.zeros((T, NU, B), np.float32), np.zeros((T, NU, NX, B), np.float32)
    zb = np.zeros((NU, B), np.float32)
    plain = jspec.replace(input_lower_bounds=None, input_upper_bounds=None)
    xs_w, _, cost_w, _ = forward_select_pallas_tiled(
        plain, _lanes(np.broadcast_to(x[0], (T, NX, B))), _lanes(u), _lanes(zk), _lanes(zK),
        _lanes(np.full(B, np.inf, np.float32)), _lanes(zb), _lanes(zb), (0.0,), True,
        ctx_l=_lanes(ctx))
    stats = k2.ROLLOUT_STATS
    stats.reset()
    xs_g, cost_g = k2.rollout_cost_plain(tspec, torch.as_tensor(x[0]), torch.as_tensor(u),
                                         torch.as_tensor(ctx))
    assert stats.plain_calls == 1
    np.testing.assert_allclose(xs_g.numpy(), _unlanes(xs_w), **TOL)
    np.testing.assert_allclose(cost_g.numpy(), _unlanes(cost_w), rtol=1e-5)


def test_forward_select_context_stage_out_mode_matches_pallas(specs):
    """Stage-out mode with a context, the bench ladder, bounds and frozen
    problems: trajectories, merit, accept flags and x_T agree."""
    jspec, tspec = specs
    x, u, ctx = _inputs(2)
    rng = np.random.RandomState(3)
    xT = _inputs(4)[0][0]
    k = rng.uniform(-0.3, 0.3, (T, NU, B)).astype(np.float32)
    Kg = rng.uniform(-0.2, 0.2, (T, NU, NX, B)).astype(np.float32)
    _, cost0 = k2.rollout_cost_plain(tspec, torch.as_tensor(x[0]), torch.as_tensor(u),
                                     torch.as_tensor(ctx))
    merit = (cost0.numpy() * rng.uniform(0.8, 1.2, B)).astype(np.float32)
    active = rng.uniform(size=B) < 0.8
    lb = np.full((NU, B), -0.5, np.float32)
    ub = -lb
    xs_w, us_w, merit_w, accept_w, xT_w = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(Kg), _lanes(merit), _lanes(lb),
        _lanes(ub), LADDER, True, ctx_l=_lanes(ctx),
        active_l=_lanes(active.astype(np.float32)), xT_l=_lanes(xT), time_unroll=2)
    bufs = [torch.as_tensor(a.copy()) for a in (x, u, xT)]
    merit_g, accept_g = k2.forward_select_plain(
        tspec, *bufs, torch.as_tensor(k), torch.as_tensor(Kg), torch.as_tensor(merit),
        torch.as_tensor(active), torch.as_tensor(lb), torch.as_tensor(ub), LADDER,
        torch.as_tensor(ctx))
    accept_want = _unlanes(accept_w) > 0.5
    assert 0 < accept_want.sum() < B
    np.testing.assert_array_equal(accept_g.numpy(), accept_want)
    np.testing.assert_allclose(merit_g.numpy(), _unlanes(merit_w), rtol=1e-5)
    for g, w in zip(bufs, (xs_w, us_w, xT_w)):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


def test_context_cost_derivatives_match_jax():
    """with_context_cost rebuilds the derivative bundle for the 4-argument
    cost; the context is a constant of the derivatives (float64)."""
    jspec = j_circ.create_single_track_circular_ocp(0.3).spec()
    jspec = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                      j_circ.make_collision_cost(25.0)))
    tspec = t_circ.create_single_track_circular_ocp(0.3, dtype=torch.float64, device="cpu").spec()
    tspec = with_context_cost(tspec, make_coupled_stage(tspec.stage_cost,
                                                       t_circ.make_collision_cost(25.0)))
    rng = np.random.RandomState(5)
    x = np.array([19.0, 6.0, 1.9, 4.5]) + rng.normal(0, 0.5, 4)
    u = rng.uniform(-0.5, 0.5, 2)
    ctx = x[None] + rng.normal(0, 2.0, (K, 4))
    jargs = (jnp.asarray(x), jnp.asarray(u), jnp.asarray(2), jnp.asarray(ctx))
    targs = (torch.as_tensor(x), torch.as_tensor(u), torch.tensor(2), torch.as_tensor(ctx))
    np.testing.assert_allclose(tspec.stage_cost(*targs).numpy(),
                               np.asarray(jspec.stage_cost(*jargs)), rtol=1e-12)
    for name in ("lx", "lxx", "lux"):           # the oracles the pair cost enters
        np.testing.assert_allclose(getattr(tspec.derivs, name)(*targs).numpy(),
                                   np.asarray(jax.jit(getattr(jspec.derivs, name))(*jargs)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def _quadratic_context_stage(x, u, t, ctx):
    """A context cost quadratic in (x, u): squared distance to the context."""
    return (x[..., 0] - ctx[..., 0]) ** 2 + (x[..., 1] - ctx[..., 1]) ** 2 + 0.1 * u[..., 0] ** 2


def test_probe_with_context(specs):
    """A random context per stage index from the probe's stream: a context
    cost quadratic in (x, u) probes as quadratic but never stationary, the
    collision cost as not quadratic -- JAX's probe's answers for both (its
    eager probe takes 4-8 s a cost on the CPU, so it is not rerun here)."""
    tspec = t_circ.create_single_track_circular_ocp(0.0, device="cpu").spec()
    tquad = with_context_cost(tspec, _quadratic_context_stage).replace(context=torch.zeros(10, 2))
    assert probe_cost_structure(tquad) == (True, False)
    coupled = specs[1].replace(context=torch.zeros(10, K, NX))
    assert probe_cost_structure(coupled) == (False, False)


def _states(kind, n, dtype=np.float64):
    """[n, T+1, nx] joint plans: random, the game's evenly spaced ring (as
    its initial rollout sees it), or a line of unit spacing whose left and
    right neighbours tie exactly."""
    rng = np.random.RandomState(7)
    if kind == "random":
        return rng.normal(0, 10.0, (n, 11, 4)).astype(dtype)
    if kind == "ring":
        th = 2 * np.pi * np.arange(n) / n
        ring = np.stack([20 * np.cos(th), 20 * np.sin(th), th + 1.57, 4 * np.ones(n)], -1)
        return np.broadcast_to(ring[:, None], (n, 11, 4)).astype(dtype).copy()
    line = np.stack([np.arange(n, dtype=float), np.zeros(n), np.zeros(n), np.ones(n)], -1)
    return np.broadcast_to(line[:, None], (n, 11, 4)).astype(dtype).copy()


@pytest.mark.parametrize("kind", ["random", "ring", "line"])
@pytest.mark.parametrize("neighbors", [None, 3])
def test_context_builders_match_jax(kind, neighbors):
    """The all-pairs and k-nearest context of every agent at every stage is
    JAX's, neighbour order included: ties go to the lower index, as
    lax.top_k breaks them."""
    n = 10
    jproblem = j_circ.build_problem(n, coupling=25.0)
    jproblem.coupling_neighbors = neighbors
    jstrat = j_make_strategy("sequential", j_make_solver("ilqr"), GAME["params"], 1)
    from multi_agent_solver_tpu.strategies.base import stack_agent_specs as j_stack
    jproblem.compute_offsets()
    jstrat._prepare(jproblem, j_stack(jproblem))
    tproblem = t_circ.build_problem(n, coupling=25.0, dtype=torch.float64, device="cpu")
    tproblem.coupling_neighbors = neighbors
    tstrat = make_strategy("sequential", make_solver("ilqr", device="cpu"), GAME["params"], 1)
    tproblem.compute_offsets()
    tstrat._prepare(tproblem, stack_agent_specs(tproblem))
    states = _states(kind, n)
    want = np.asarray(jstrat._ctx_for(jnp.asarray(states)))
    got = tstrat._ctx_for(torch.as_tensor(states)).numpy()
    assert got.shape == want.shape == (n, 10, n - 1 if neighbors is None else neighbors, 4)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_game():
    """JAX's sequential strategy on the test ring through its float32 fused
    loop, built once per module."""
    problem = j_circ.build_problem(GAME["agents"], coupling=entry.COUPLING)
    problem.coupling_neighbors = GAME["neighbors"]
    strategy = j_make_strategy("sequential", j_make_solver("ilqr"),
                               {**GAME["params"], "fused": 1}, GAME["sweeps"])
    solution = strategy(problem)
    return np.asarray([float(c) for c in solution.costs]), solution


def test_sequential_coupled_game_matches_jax(jax_game):
    want, jsol = jax_game
    stats = (k2.CTX_STATS, k3.CTX_STATS, k1.BACKWARD_STATS, k2.ROLLOUT_STATS, k2.STATS, k3.STATS,
             k1.STATS)
    for s in stats:
        s.reset()
    problem, strategy = entry.coupled_game(GAME["agents"], GAME["neighbors"], GAME["sweeps"],
                                           {**GAME["params"], "fused": 1}, dtype=torch.float64,
                                           device="cpu")
    solution = strategy(problem)
    got = np.asarray(solution.costs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(solution.total_cost, jsol.total_cost, rtol=1e-5)
    # The coupling moves the cost: the uncoupled circular-track cost is
    # 1.87613844871521 per agent.
    assert got.mean() > 1.877
    for g, w in zip(solution.controls + solution.states, jsol.controls + jsol.states):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
    # Context-mode plain versions only: K2 and K3 with a context, K4, and
    # K2's rollout once a sweep.
    ctx_k2, ctx_k3, k4, rollout = (s.plain_calls for s in stats[:4])
    assert ctx_k3 == k4 == ctx_k2 > 0 and rollout == GAME["sweeps"]
    assert [s.plain_calls for s in stats[4:]] == [0, 0, 0]
    assert all(s.launches == 0 for s in stats)


def test_strategy_probes_once_per_call(monkeypatch):
    """The cost structure is resolved once for all sweeps of a call."""
    from multi_agent_solver_tpu_torch.solvers import ilqr

    calls = []
    real = ilqr.probe_cost_structure
    monkeypatch.setattr(ilqr, "probe_cost_structure", lambda s: calls.append(1) or real(s))
    problem, strategy = entry.coupled_game(4, 2, max_outer=2,
                                           params={"max_iterations": 1, "tolerance": 1e-5},
                                           device="cpu")
    strategy(problem)
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["linesearch", "trustregion", "centralized", "heterogeneous",
                                  "build_global_ocp"])
def test_unported_strategy_routes_raise(case):
    """Named for the routes that raised NotImplementedError before they were
    ported; each now runs on the 3-car coupled game: the line search, the
    trust region, the centralized strategy (coupled: the literal joint
    solve), a mix of agent types (the padded stack, coupled through its
    dispatch stage cost) and the joint OCP (12 states, 6 controls)."""
    problem, _ = entry.coupled_game(3, device="cpu")
    solver = make_solver("ilqr", device="cpu")
    if case == "build_global_ocp":
        g = problem.build_global_ocp()
        assert (g.state_dim, g.control_dim) == (12, 6) and math.isfinite(g.best_cost)
        return
    if case == "heterogeneous":
        other = t_circ.create_single_track_circular_ocp(0.5, device="cpu")
        other.stage_cost = lambda x, u, t: (x[..., 0] ** 2)
        other.invalidate()
        problem.add_agent(Agent(7, other))
        case = "sequential"
    sol = make_strategy(case, solver, GAME["params"], 2)(problem)
    assert len(sol.costs) == len(problem.agents)
    assert all(math.isfinite(c) for c in sol.costs)


def test_al_constrained_context_solve_still_raises():
    """AL constraints with a context solve (the plain versions on the CPU),
    but a constraint without a device-function tag still raises
    NotImplementedError at the CUDA launch of the select kernel's AL and
    context mode, before any device work."""
    problem, strategy = entry.coupled_game(3, device="cpu")
    problem.compute_offsets()
    specs = strategy._prepare(problem, stack_agent_specs(problem))
    untagged = lambda x, u: x[..., :1]
    specs = specs.replace(context=torch.zeros(3, 10, 2, 4), ineq_dim=1,
                          inequality_constraints=untagged,
                          derivs=specs.derivs.replace(ineq_gx=torch.func.jacfwd(untagged, 0),
                                                      ineq_gu=torch.func.jacfwd(untagged, 1)))
    config = dataclasses.replace(strategy._config, max_iterations=2)
    result = solve_ilqr_batched(specs, config, device="cpu")
    assert result.cost.shape == (3,) and bool(torch.isfinite(result.cost).all())
    xs, us, xT = torch.zeros(10, NX, 3), torch.zeros(10, NU, 3), torch.zeros(NX, 3)
    gains = (torch.zeros(10, NU, 3), torch.zeros(10, NU, NX, 3))
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k2.launch_forward_select(specs, xs, us, xT, *gains, torch.zeros(3),
                                 torch.ones(3, dtype=torch.bool), None, None, (1.0,),
                                 torch.zeros(10, 2, NX, 3), None, torch.zeros(10, 1, 3),
                                 torch.ones(3))


def test_coupled_device_function_and_context_checks():
    """The coupled cost names its Coupled<Base, Pair> instantiation with the
    base's parameters then the pair's; an untagged coupling has no device
    function, so the CUDA launch raises NotImplementedError before any
    device work; a context must come exactly with a cost that reads one."""
    tspec = t_circ.create_single_track_circular_ocp(0.0, device="cpu").spec()
    coupled = make_coupled_stage(tspec.stage_cost, t_circ.make_collision_cost(25.0))
    symbol, params = _build.problem_symbol("linearize", NX, NU, tspec.dynamics, coupled)
    assert symbol == "mas_linearize__single_track__coupled_circular_track_gaussian_collision"
    assert params[1] == (20.0, 5.0, 1.0, 1.0, 0.001, 0.001, 25.0, 9.0)
    cspec = with_context_cost(tspec, coupled)
    xs, us = torch.zeros(T, NX, 8), torch.zeros(T, NU, 8)
    ctx = torch.zeros(T, K, NX, 8)
    untagged = with_context_cost(tspec, make_coupled_stage(tspec.stage_cost, lambda a, b, t: a[..., 0]))
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k3.launch_linearize(untagged, xs, us, True, ctx)
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k2.launch_rollout_cost(untagged, xs[0], us, ctx)
    with pytest.raises(ValueError, match="none was passed"):
        k3.launch_linearize(cspec, xs, us, True, None)
    with pytest.raises(ValueError, match="reads none"):
        k3.launch_linearize(tspec, xs, us, True, ctx)


def test_zero_coupling_solves_as_the_uncoupled_track():
    """A context cost whose pair term is zero (weight 0) runs the context
    modes and lands bit for bit on the solve without a context."""
    sweep = entry.circular_sweep_specs(4, 1, device="cpu")
    coupled = make_coupled_stage(sweep.stage_cost, t_circ.make_collision_cost(0.0))
    ctx_specs = with_context_cost(sweep, coupled).replace(
        context=torch.as_tensor(np.random.RandomState(9).normal(0, 20, (4, 10, 2, 4)),
                                dtype=torch.float32))
    config = dataclasses.replace(entry.SWEEP_CONFIG, max_iterations=3)
    for s in (k2.CTX_STATS, k3.CTX_STATS, k2.ROLLOUT_STATS):
        s.reset()
    got = solve_ilqr_batched(ctx_specs, config, fused=True, device="cpu")
    rollouts = k2.ROLLOUT_STATS.plain_calls
    want = solve_ilqr_batched(sweep, config, device="cpu")
    it = int(got.iterations[0])
    assert torch.equal(got.cost, want.cost) and torch.equal(got.controls, want.controls)
    assert (k2.CTX_STATS.plain_calls, k3.CTX_STATS.plain_calls, rollouts) == (it, it, 1)
