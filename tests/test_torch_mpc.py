"""The port's closed-loop MPC (``mpc.py``) and its probe cache
against the JAX package.

Problems are ``tests/problems.py``'s lane follow at T = 20 and its head-on
fleet, built on both sides from the same constants.  The closed loops of
the float64 routes of both packages (the single solve, the batched scan
route ``fused=False, backward="scan"``) are compared at rtol 1e-8; routes
with float32 parts -- the port's fused loop on the CPU (the plain versions
of its kernels), the ``sequential`` Nash strategy's non-fused route -- at
float32 tolerance (states atol 1e-4, costs rtol 1e-4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.mpc import run_mpc as j_run_mpc
from multi_agent_solver_tpu.mpc import run_mpc_batched as j_run_mpc_batched
from multi_agent_solver_tpu.mpc import run_mpc_nash as j_run_mpc_nash
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr as j_solve_ilqr
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve_batched
from multi_agent_solver_tpu.strategies import make_strategy as j_make_strategy

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.agent import Agent
from multi_agent_solver_tpu_torch.examples import single_track_mpc
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.mpc import (run_mpc, run_mpc_batched, run_mpc_nash,
                                              shift_warm_start)
from multi_agent_solver_tpu_torch.multi_agent import MultiAgentProblem
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.solvers import ilqr, make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, solve_ilqr, solve_ilqr_batched
from multi_agent_solver_tpu_torch.strategies import make_strategy

torch.set_num_threads(1)

T = 20
CFG = dict(max_iterations=5, tolerance=1e-5)
Y0 = (0.5, 1.0, 1.5)
RTOL = 1e-8


def _lane_specs():
    """The lane follow at T = 20: JAX's one spec and three-lane batch, the
    port's in float64."""
    from tests.problems import single_track_lane_ocp

    j_spec = single_track_lane_ocp(horizon_steps=T).spec()
    x0s = np.tile(np.asarray(j_spec.initial_state), (3, 1))
    x0s[:, 1] = Y0
    j_specs = jax.vmap(lambda s0: j_spec.replace(initial_state=s0))(jnp.asarray(x0s))
    t_spec = entry.single_track_spec(T, torch.float64, "cpu")
    return j_spec, j_specs, t_spec, entry.batch_specs(t_spec, x0s)


def _close(got, want, rtol=RTOL, atol=1e-10):
    for name in ("states", "controls", "costs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_shift_warm_start():
    u = torch.arange(12.0).reshape(2, 3, 2)
    shifted = shift_warm_start(u)
    assert torch.equal(shifted[:, :2], u[:, 1:]) and torch.equal(shifted[:, 2], u[:, 2])
    zeroed = shift_warm_start(u[0], fill="zero")
    assert torch.equal(zeroed[:2], u[0, 1:]) and torch.equal(zeroed[2], torch.zeros(2))
    with pytest.raises(ValueError, match="unknown fill"):
        shift_warm_start(u, fill="nope")


def test_run_mpc_matches_jax():
    """One problem's closed loop, 6 steps, through each package's single
    solve: every output at rtol 1e-8, iterations equal."""
    j_spec, _, t_spec, _ = _lane_specs()
    want = j_run_mpc(j_spec, lambda s: j_solve_ilqr(s, JConfig(**CFG)), n_steps=6)
    got = run_mpc(t_spec, lambda s: solve_ilqr(s, ILQRConfig(**CFG)), n_steps=6)
    assert got.states.shape == (7, 4) and got.controls.shape == (6, 2) and got.costs.shape == (6,)
    _close(got, want)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))


def test_run_mpc_batched_matches_jax_scan_route():
    """Three controllers, 6 steps, step-major: the port's scan route at
    rtol 1e-8 and its float32 fused loop (plain versions) at float32
    tolerance against JAX's scan route (as tests/test_mpc.py runs it)."""
    _, j_specs, _, t_specs = _lane_specs()
    want = j_run_mpc_batched(
        j_specs, lambda s: j_solve_batched(s, JConfig(**CFG), backward="scan", fused=False),
        n_steps=6)
    got = run_mpc_batched(
        t_specs, lambda s: solve_ilqr_batched(s, ILQRConfig(**CFG), backward="scan",
                                              fused=False, device="cpu"), n_steps=6)
    assert got.states.shape == (7, 3, 4) and got.costs.shape == (6, 3)
    _close(got, want)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))

    f32 = entry.batch_specs(entry.single_track_spec(T, device="cpu"),
                            t_specs.initial_state.numpy())
    assert ilqr.route(f32, ILQRConfig(**CFG), device_type="cpu").fused
    fused = run_mpc_batched(
        f32, lambda s: solve_ilqr_batched(s, ILQRConfig(**CFG), device="cpu"), n_steps=6)
    np.testing.assert_allclose(fused.states.numpy(), np.asarray(want.states), atol=1e-4)
    np.testing.assert_allclose(fused.costs.numpy(), np.asarray(want.costs), rtol=1e-4)


def test_plant_written_for_one_problem():
    """A plant written for one problem (``tests/test_mpc.py``'s weaker
    acceleration) drives the fleet through ``torch.func.vmap``, as JAX's
    ``vmap`` makes it: the port's scan route against JAX's, 4 steps."""
    _, j_specs, _, t_specs = _lane_specs()

    def j_heavy(x, u):
        base = j_specs.dynamics(x, u)
        return base.at[3].set(0.8 * base[3])

    def t_heavy(x, u):
        base = single_track_model(x, u)
        return torch.cat([base[:3], 0.8 * base[3:]])

    want = j_run_mpc_batched(
        j_specs, lambda s: j_solve_batched(s, JConfig(**CFG), backward="scan", fused=False),
        n_steps=4, plant_dynamics=j_heavy)
    got = run_mpc_batched(
        t_specs, lambda s: solve_ilqr_batched(s, ILQRConfig(**CFG), backward="scan",
                                              fused=False, device="cpu"),
        n_steps=4, plant_dynamics=t_heavy)
    _close(got, want)


def _head_on_fleet(n):
    """``tests/problems.py::head_on_fleet_problem`` in the port, float64."""

    def stage_cost(x, u, t):
        return (1.0 * x[..., 1] ** 2 + (x[..., 3] - 2.0) ** 2
                + 0.05 * (u[..., 0] ** 2 + u[..., 1] ** 2))

    problem = MultiAgentProblem()
    for i in range(n):
        lane = 0.3 * (i // 2)
        x0 = [-8.0, lane, 0.0, 2.0] if i % 2 == 0 else [8.0, lane + 0.15, math.pi, 2.0]
        ocp = OCP(state_dim=4, control_dim=2, horizon_steps=20, dt=0.25,
                  initial_state=torch.tensor(x0, dtype=torch.float64),
                  dynamics=single_track_model, stage_cost=stage_cost,
                  input_lower_bounds=torch.tensor([-0.6, -2.0], dtype=torch.float64),
                  input_upper_bounds=torch.tensor([0.6, 2.0], dtype=torch.float64),
                  device="cpu")
        ocp.initialize_problem()
        problem.add_agent(Agent(i, ocp))

    def collision_cost(x_i, x_j, t):
        d2 = (x_i[..., 0] - x_j[..., 0]) ** 2 + (x_i[..., 1] - x_j[..., 1]) ** 2
        return 30.0 * torch.exp(-d2 / 4.0)

    problem.inter_agent_cost = collision_cost
    return problem


def test_run_mpc_nash_matches_jax():
    """The 4-car head-on fleet in closed loop, 3 steps of the ``sequential``
    strategy (2 sweeps of at most 10 iterations) on both packages'
    non-fused route, whose select and backward kernels run in float32:
    states atol 1e-4, costs rtol 1e-4 (atol 1e-6), iterations zero,
    step-major.  The fleet runs uncoupled here: with the collision cost the
    head-on game is knife-edge -- after one iteration JAX's own fused and
    non-fused routes part by 100 in a car's cost (600.5 against 497.1), as
    do the port's -- so its coupled closed loop is held to its structure
    below."""
    from tests.problems import head_on_fleet_problem

    params = {"max_iterations": 10, "tolerance": 1e-6, "max_ms": 1e9, "fused": 0}
    j_problem, t_problem = head_on_fleet_problem(4), _head_on_fleet(4)
    j_problem.inter_agent_cost = t_problem.inter_agent_cost = None
    want = j_run_mpc_nash(j_problem,
                          j_make_strategy("sequential", j_make_solver("ilqr"), params, 2),
                          n_steps=3)
    got = run_mpc_nash(t_problem,
                       make_strategy("sequential", make_solver("ilqr", device="cpu"), params, 2),
                       n_steps=3)
    assert got.states.shape == (4, 4, 4) and got.controls.shape == (3, 4, 2)
    assert got.costs.shape == (3, 4) and got.iterations.tolist() == [0, 0, 0]
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=1e-4)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), atol=1e-4)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), rtol=1e-4, atol=1e-6)


def test_run_mpc_nash_coupled_refreshes_the_context():
    """The coupled head-on fleet's closed loop: each step's solve sees the
    others' newest plans, so the first controls move off the uncoupled
    ones, and the applied controls and costs are the strategy's."""
    params = {"max_iterations": 3, "tolerance": 1e-6, "max_ms": 1e9}
    strategy = lambda: make_strategy("sequential", make_solver("ilqr", device="cpu"), params, 1)
    coupled = run_mpc_nash(_head_on_fleet(4), strategy(), n_steps=2)
    free = _head_on_fleet(4)
    free.inter_agent_cost = None
    uncoupled = run_mpc_nash(free, strategy(), n_steps=2)
    assert bool(torch.isfinite(coupled.states).all())
    assert float((coupled.controls[0] - uncoupled.controls[0]).abs().max()) > 1e-3
    problem = _head_on_fleet(4)
    sol = strategy()(problem)
    np.testing.assert_allclose(coupled.costs[0].numpy(), np.asarray(sol.costs), rtol=1e-12)
    np.testing.assert_allclose(coupled.controls[0].numpy(),
                               np.stack([c[0].numpy() for c in sol.controls]), rtol=1e-12)


def test_closed_loop_probes_once():
    """An N-step closed loop probes the cost structure once and hits the
    cache N - 1 times; a warm call of the same specs probes none.  An
    asserted structure that the probe contradicts still raises, on a cache
    hit too."""
    specs = entry.bench_specs(4, device="cpu", horizon=8)
    ilqr.PROBE_STATS.reset()
    solve = lambda s: solve_ilqr_batched(s, ILQRConfig(max_iterations=2, tolerance=1e-5),
                                         device="cpu")
    run_mpc_batched(specs, solve, n_steps=4)
    assert (ilqr.PROBE_STATS.probes, ilqr.PROBE_STATS.hits) == (1, 3)
    solve(specs)
    assert (ilqr.PROBE_STATS.probes, ilqr.PROBE_STATS.hits) == (1, 4)

    cart = entry.cartpole_specs(2, device="cpu")
    lying = ILQRConfig(max_iterations=1, tolerance=1e-5, quadratic_cost=True)
    for _ in range(2):
        with pytest.raises(ValueError, match="not quadratic"):
            solve_ilqr_batched(cart, lying, device="cpu")
    assert ilqr.PROBE_STATS.probes == 2 and ilqr.PROBE_STATS.hits == 5


def test_probe_cache_keys_hold_the_callables():
    """The cache keys on the callables themselves (a structure with a new
    derivative bundle probes again) and stays within its bound."""
    spec = entry.single_track_spec(8, device="cpu")
    ilqr._PROBE_CACHE.clear()
    ilqr.PROBE_STATS.reset()
    assert ilqr.resolve_cost_structure(spec, ILQRConfig()) == (True, True)
    rebuilt = entry.single_track_spec(8, device="cpu")
    assert rebuilt.derivs is not spec.derivs
    ilqr.resolve_cost_structure(rebuilt, ILQRConfig())
    assert ilqr.PROBE_STATS.probes == 2
    key = ilqr._structure_key(spec)
    assert key[0] is spec.derivs and key[1] is spec.dynamics and key[-1] is None
    for h in range(ilqr.PROBE_CACHE_SIZE + 3):
        ilqr.resolve_cost_structure(entry.single_track_spec(2 + h, device="cpu"), ILQRConfig())
    assert len(ilqr._PROBE_CACHE) == ilqr.PROBE_CACHE_SIZE


def test_fleet_example():
    """``examples/single_track_mpc.py``: the fleet's offsets and
    parameters, the batched loop at B = 2 and the single loop at B = 1
    through the single solve."""
    specs = entry.fleet_specs(5, device="cpu")
    np.testing.assert_allclose(specs.initial_state[:, 1].numpy(), np.linspace(0.5, 1.5, 5),
                               rtol=1e-7)
    assert entry.FLEET_PARAMS == {"max_iterations": 5, "tolerance": 1e-5, "max_ms": 100}
    fleet = single_track_mpc.run_fleet(2, 2, device="cpu")
    assert fleet.states.shape == (3, 2, 4) and bool(torch.isfinite(fleet.states).all())
    one = single_track_mpc.run_fleet(1, 2, device="cpu")
    assert one.states.shape == (3, 4) and one.iterations.dtype == torch.int32
