"""Constrained agents in the coupled Nash game against the JAX package, on
the CPU, and the router's context checks.

* The select kernel's AL and context modes at once (K6): its plain version
  against the Pallas kernel in interpret mode at one 1024-lane tile, T = 4,
  K = 3 neighbours, one equality and one inequality row and 3 candidates,
  in the fused loop's stage-out mode; float32 on both sides in the same
  order of operations except the last ulps of float32 exp / sin / cos / tan
  and the sum over neighbours, so values are held to rtol 1e-5 with atol
  1e-4 and merits to rtol 1e-5, as tests/test_torch_coupled.py holds the
  context mode alone.
* A small constrained game -- 4 cars, all pairs, T = 6, every car's speed
  capped by ``entry.SPEED_CAP``, 2 sweeps of at most 4 iterations -- through
  the JAX ``sequential`` strategy and the port's, non-fused in float64
  (the select kernel runs float32 on both sides, the glue float64) and
  through the float32 fused loops.
* The routing decisions of contexts: F1 (a context solve with
  ``fused=False, linearize="pallas"`` runs the vmapped linearizer, bit for
  bit) and F2 (a context of more than 512 floats a stage is refused by the
  lane kernels, as the JAX router refuses it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.examples import multi_agent_single_track as j_circ
from multi_agent_solver_tpu.ocp import with_context_cost as j_with_context_cost
from multi_agent_solver_tpu.ops.forward_pallas import (
    spec_supports_lane_forward as j_supports_lane_forward,
)
from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.strategies import make_strategy as j_make_strategy
from multi_agent_solver_tpu.strategies.nash import make_coupled_stage as j_coupled_stage

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as t_circ
from multi_agent_solver_tpu_torch.ocp import bound_rows, with_context_cost
from multi_agent_solver_tpu_torch.ops import forward_pallas, forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.solvers import ilqr
from multi_agent_solver_tpu_torch.strategies import stack_agent_specs
from multi_agent_solver_tpu_torch.strategies.nash import make_coupled_stage
from multi_agent_solver_tpu_torch.utils.carry import spec_from_numpy

torch.set_num_threads(1)

B, T, NX, NU, K = 1024, 4, 4, 2, 3
TOL = dict(rtol=1e-5, atol=1e-4)
LADDER = (1.0, 0.5, 0.125)
ACT_TOL = 1e-6
# The JAX constraints of the port's rows: the speed cap (entry.SPEED_CAP)
# and an equality row pinning the steering, written v - u as BoundRows'
# "lower" form.
J_CAP = lambda x, u: jnp.array([x[3] - 4.5])
J_EQ = lambda x, u: jnp.array([0.1 - u[0]])
T_EQ = bound_rows(("u", 0, 0.1, "lower"))
GAME = dict(agents=4, neighbors=None, sweeps=2, horizon=6,
            params={"max_iterations": 4, "tolerance": 1e-5, "max_ms": 1e9,
                    "constraint_tolerance": 1e-3})


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def _coupled_specs():
    """(JAX spec, port spec) of one car of the coupled game with an equality
    row and the speed cap, the port's built through ``spec_from_numpy``
    from the JAX spec's leaves."""
    jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
    jspec = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                      j_circ.make_collision_cost(25.0)))
    jspec = jspec.replace(equality_constraints=J_EQ, eq_dim=1, inequality_constraints=J_CAP,
                          ineq_dim=1)
    ctx = np.zeros((jspec.horizon_steps, K, NX), np.float32)
    leaves = {name: np.asarray(getattr(jspec, name), np.float32) for name in
              ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")}
    tspec = spec_from_numpy(
        {**leaves, "context": ctx}, dynamics=t_circ.single_track_model,
        stage_cost=make_coupled_stage(t_circ._stage_cost, t_circ.make_collision_cost(25.0)),
        terminal_cost=t_circ._terminal_cost, dt=jspec.dt, horizon_steps=jspec.horizon_steps,
        equality_constraints=T_EQ, eq_dim=1, inequality_constraints=entry.SPEED_CAP, ineq_dim=1,
        device="cpu")
    return jspec, tspec


def _inputs(seed):
    """States around the track at speeds on both sides of the cap, controls
    in the box, and K neighbours per (stage, problem) within ~3 of the car."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, (T, B))
    r = 20.0 + rng.uniform(-1, 1, (T, B))
    x = np.stack([r * np.cos(th), r * np.sin(th), th + 1.57, rng.uniform(3.5, 5.5, (T, B))], 1)
    u = rng.uniform(-0.5, 0.5, (T, NU, B))
    ctx = x[:, None] + np.concatenate(
        [rng.normal(0, 2.0, (T, K, 2, B)), rng.normal(0, 0.5, (T, K, 2, B))], 2)
    return x.astype(np.float32), u.astype(np.float32), ctx.astype(np.float32)


def test_carry_takes_context_and_constraints():
    """``spec_from_numpy`` carries the context leaf and the constraint
    callables with their row counts; the constraint values are JAX's."""
    jspec, tspec = _coupled_specs()
    assert (tspec.eq_dim, tspec.ineq_dim) == (jspec.eq_dim, jspec.ineq_dim) == (1, 1)
    assert tspec.context.shape == (jspec.horizon_steps, K, NX)
    assert tspec.derivs.ineq_gx is not None and tspec.derivs.eq_gu is not None
    x, u = np.array([1.0, 2.0, 0.3, 4.7]), np.array([0.2, -0.1])
    for jfn, tfn in ((J_EQ, tspec.equality_constraints), (J_CAP, tspec.inequality_constraints)):
        np.testing.assert_allclose(tfn(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                                   np.asarray(jfn(jnp.asarray(x), jnp.asarray(u))), rtol=1e-12)
    with pytest.raises(ValueError, match="row count"):
        spec_from_numpy({"initial_state": np.zeros(4), "initial_controls": np.zeros((10, 2))},
                        dynamics=t_circ.single_track_model, stage_cost=t_circ._stage_cost,
                        terminal_cost=t_circ._terminal_cost, dt=0.5, horizon_steps=10,
                        inequality_constraints=entry.SPEED_CAP, device="cpu")


def test_al_context_select_plain_matches_pallas():
    """Stage-out mode with a context and both AL sides, the bench ladder,
    bounds and frozen problems: accept flags, merits, trajectories and x_T
    agree with the Pallas kernel in interpret mode."""
    jspec, tspec = _coupled_specs()
    x, u, ctx = _inputs(20)
    rng = np.random.RandomState(21)
    xT = _inputs(22)[0][0]
    k = rng.uniform(-0.3, 0.3, (T, NU, B)).astype(np.float32)
    Kg = rng.uniform(-0.2, 0.2, (T, NU, NX, B)).astype(np.float32)
    eq_mult = rng.uniform(-2, 2, (T, 1, B)).astype(np.float32)
    ineq_mult = (rng.uniform(0, 3, (T, 1, B)) * (rng.uniform(size=(T, 1, B)) < 0.7)).astype(
        np.float32)
    rho = (10.0 ** rng.uniform(0, 3, B)).astype(np.float32)
    _, cost0 = k2.rollout_cost_plain(tspec, torch.as_tensor(x[0]), torch.as_tensor(u),
                                     torch.as_tensor(ctx))
    merit = (cost0.numpy() * rng.uniform(0.8, 1.3, B)).astype(np.float32)
    active = rng.uniform(size=B) < 0.8
    lb = np.full((NU, B), -0.5, np.float32)
    ub = -lb
    xs_w, us_w, merit_w, accept_w, xT_w = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(Kg), _lanes(merit), _lanes(lb),
        _lanes(ub), LADDER, True, ctx_l=_lanes(ctx), eq_mult_l=_lanes(eq_mult),
        ineq_mult_l=_lanes(ineq_mult), rho_l=_lanes(rho), act_tol=ACT_TOL,
        active_l=_lanes(active.astype(np.float32)), xT_l=_lanes(xT))
    k2.AL_CTX_STATS.reset()
    bufs = [torch.as_tensor(a.copy()) for a in (x, u, xT)]
    merit_g, accept_g = k2.forward_select(
        tspec, *bufs, torch.as_tensor(k), torch.as_tensor(Kg), torch.as_tensor(merit),
        torch.as_tensor(active), torch.as_tensor(lb), torch.as_tensor(ub), LADDER,
        torch.as_tensor(ctx), torch.as_tensor(eq_mult), torch.as_tensor(ineq_mult),
        torch.as_tensor(rho), ACT_TOL)
    assert (k2.AL_CTX_STATS.plain_calls, k2.AL_CTX_STATS.launches) == (1, 0)
    accept_want = _unlanes(accept_w) > 0.5
    assert 0 < accept_want.sum() < active.sum()
    np.testing.assert_array_equal(accept_g.numpy(), accept_want)
    np.testing.assert_allclose(merit_g.numpy(), _unlanes(merit_w), rtol=1e-5)
    for g, w in zip(bufs, (xs_w, us_w, xT_w)):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


def _short_horizon(problem, horizon):
    """Every car's horizon cut to ``horizon`` stages, warm start re-rolled."""
    for agent in problem.agents:
        agent.ocp.horizon_steps = horizon
        agent.ocp.initial_controls = None
        agent.ocp.initialize_problem()
    return problem


def _jax_game(fused):
    problem = j_circ.build_problem(GAME["agents"], coupling=entry.COUPLING)
    problem.coupling_neighbors = GAME["neighbors"]
    for agent in problem.agents:
        agent.ocp.inequality_constraints = J_CAP
    _short_horizon(problem, GAME["horizon"])
    strategy = j_make_strategy("sequential", j_make_solver("ilqr"),
                               {**GAME["params"], "fused": int(fused)}, GAME["sweeps"])
    solution = strategy(problem)
    return np.asarray([float(c) for c in solution.costs]), solution


@pytest.fixture(scope="module")
def jax_games():
    """JAX's constrained game, non-fused (float64 glue) and fused (float32),
    built once per module."""
    return {fused: _jax_game(fused) for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
def test_constrained_game_matches_jax(jax_games, fused):
    """The port's game against JAX's on the same route: non-fused with
    float64 glue to rtol 1e-6 (measured 2.7e-7: both selects score in
    float32), fused in float32 to rtol 1e-4 (measured 1.9e-7), as
    tests/test_fused_loop.py holds two float32 implementations.  The cap
    binds (the fastest constrained stage of any car runs at 4.5 on both
    sides), and the plain versions of the AL and context mode ran (the
    fused loop: every select; non-fused: through the batch-first
    wrapper)."""
    want, jsol = jax_games[fused]
    dtype = torch.float32 if fused else torch.float64
    problem, strategy = entry.constrained_game(
        GAME["agents"], GAME["neighbors"], GAME["sweeps"], {**GAME["params"], "fused": int(fused)},
        dtype=dtype, device="cpu")
    _short_horizon(problem, GAME["horizon"])
    k2.AL_CTX_STATS.reset()
    solution = strategy(problem)
    got = np.asarray(solution.costs)
    np.testing.assert_allclose(got, want, rtol=1e-4 if fused else 1e-6)
    np.testing.assert_allclose(solution.total_cost, jsol.total_cost, rtol=1e-4 if fused else 1e-6)
    assert k2.AL_CTX_STATS.plain_calls > 0 and k2.AL_CTX_STATS.launches == 0
    v_max = max(float(np.asarray(s)[:-1, 3].max()) for s in solution.states)
    j_max = max(float(np.asarray(s)[:-1, 3].max()) for s in jsol.states)
    assert abs(v_max - 4.5) < 1e-3 and abs(j_max - 4.5) < 1e-3


def test_constrained_game_routes():
    """On the card ``fused="auto"`` fuses AL with a context, on the CPU it
    runs the non-fused path, as the JAX router; the agents share one
    constraint object, so they stack."""
    problem, strategy = entry.constrained_game(3, device="cpu")
    problem.compute_offsets()
    assert all(b.agent.ocp.inequality_constraints is entry.SPEED_CAP for b in problem.blocks)
    specs = strategy._prepare(problem, stack_agent_specs(problem))
    specs = strategy._sweep_specs(specs, specs.initial_controls, strategy._initial_states(specs))
    assert specs.ineq_dim == 1 and specs.context is not None
    config = strategy._config
    assert ilqr.route(specs, config, device_type="cuda") == ilqr.Route(fused=True)
    assert ilqr.route(specs, config, device_type="cpu") == ilqr.Route(
        False, "pallas", lane_forward=True)
    assert ilqr.route(specs, config, fused=True, device_type="cpu") == ilqr.Route(fused=True)


def _context_specs(neighbors, batch=2, dtype=torch.float32):
    """``batch`` cars of the coupled game with a zero context of
    ``neighbors`` others a stage."""
    sweep = entry.circular_sweep_specs(batch, 1, device="cpu")
    coupled = make_coupled_stage(sweep.stage_cost, t_circ.make_collision_cost(entry.COUPLING))
    ctx = torch.zeros((batch, sweep.horizon_steps, neighbors, NX), dtype=dtype)
    return with_context_cost(sweep, coupled).replace(context=ctx)


def test_f1_context_linearize_pallas_runs_the_vmapped_linearizer():
    """F1: K7 takes no context, so a context solve with ``fused=False,
    linearize="pallas"`` runs the vmapped linearizer -- the
    ``linearize="xla"`` costs bit for bit (the JAX package raises TypeError
    there instead)."""
    specs = _context_specs(3).replace(
        context=torch.as_tensor(np.random.RandomState(23).normal(0, 20, (2, 10, 3, NX)),
                                dtype=torch.float32))
    config = dataclasses.replace(entry.SWEEP_CONFIG, max_iterations=3)
    decision = ilqr.route(specs, config, linearize="pallas", fused=False, device_type="cpu")
    assert decision == ilqr.Route(False, "pallas", lane_forward=True, lane_linearize=False)
    k3.FLAT_STATS.reset()
    got = ilqr.solve_ilqr_batched(specs, config, linearize="pallas", fused=False, device="cpu")
    want = ilqr.solve_ilqr_batched(specs, config, linearize="xla", fused=False, device="cpu")
    assert k3.FLAT_STATS.plain_calls == 0
    assert torch.equal(got.cost, want.cost) and torch.equal(got.controls, want.controls)


@pytest.mark.parametrize("neighbors, fused", [(128, True), (129, False)])
def test_f2_context_bound_matches_jax_router(neighbors, fused):
    """F2: at ``[T, 128, 4]`` (512 floats a stage) the lane kernels take the
    context and ``fused=True`` fuses; at ``[T, 129, 4]`` they refuse it and
    the solve goes non-fused, with neither K2 nor K7 -- JAX's
    ``spec_supports_lane_forward`` answers the same."""
    specs = _context_specs(neighbors)
    assert forward_pallas.MAX_CONTEXT_FLOATS == 512
    decision = ilqr.route(specs, entry.SWEEP_CONFIG, fused=True, device_type="cuda")
    assert decision.fused is fused
    if not fused:
        assert decision == ilqr.Route(False, "pallas", lane_forward=False)
    jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
    jspec = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                      j_circ.make_collision_cost(25.0)))
    jspec = jspec.replace(context=jnp.zeros((2, 10, neighbors, NX), jnp.float32))
    assert j_supports_lane_forward(jspec, (neighbors, NX)) is fused
