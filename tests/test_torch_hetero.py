"""Heterogeneous agents (``strategies/hetero.py``) against the JAX package.

The mixed problem of tests/test_hetero.py -- two single-track cars (nx = 4,
nu = 2, input bounds) and a (2, 1) LQR agent, T = 20 -- is
``entry.mixed_fleet(3)`` in the port.  Both sides build the padded stack
(6 states: 4 physical and 2 type indicators; 2 controls) and its dispatch
functions, which must agree in float64 at rtol 1e-12; the strategies then
run it (``sequential`` on the padded stack, all three Nash strategies on
the forced host loop, and the port's padded stack against its host loop)
in float64 on both sides (the stacked sweeps on the scan route, ``backward="scan"``, overridden
on each test's strategy instance; the host loop's single solves are scan
loops already), held to rtol 1e-6 on costs and atol 1e-6 on controls.  As
tests/test_hetero.py does, the padded controls stay exactly zero, the LQR
agent's cost is its solo optimum, a coupled game of two artificial types
meets the homogeneous game, and a mix that cannot be padded runs the host
loop (uncoupled) or raises (coupled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu import Agent as JAgent
from multi_agent_solver_tpu import MultiAgentProblem as JProblem
from multi_agent_solver_tpu import OCP as JOCP
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve_batched
from multi_agent_solver_tpu.strategies import hetero as j_hetero
from multi_agent_solver_tpu.strategies import make_strategy as j_make_strategy
from multi_agent_solver_tpu.strategies import nash as j_nash

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.agent import Agent
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.multi_agent import MultiAgentProblem
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import solve_ilqr_batched
from multi_agent_solver_tpu_torch.strategies import hetero, make_strategy
from multi_agent_solver_tpu_torch.strategies import nash
from tests.test_hetero import mixed_problem as j_mixed_problem

torch.set_num_threads(1)

PARAMS = entry.MIXED_PARAMS
OUTER = 3
RTOL, ATOL = 1e-6, 1e-6


def _t_mixed():
    return entry.mixed_fleet(3, dtype=torch.float64, device="cpu")


def _j_strategy(name):
    strategy = j_make_strategy(name, j_make_solver("ilqr", PARAMS), PARAMS, OUTER)
    cfg = strategy._config
    strategy._batched_solve = lambda specs: j_solve_batched(specs, cfg, backward="scan")
    return strategy


def _t_strategy(name, params=PARAMS):
    strategy = make_strategy(name, make_solver("ilqr", device="cpu"), params, OUTER)
    strategy._batched_solve = lambda specs, structure: solve_ilqr_batched(
        specs, strategy._config, backward="scan", device="cpu", structure=structure)
    return strategy


def _compare(t_sol, j_sol, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t_sol.costs), np.asarray(j_sol.costs, np.float64),
                               rtol=rtol)
    for a, b in zip(t_sol.controls, j_sol.controls):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def stacks():
    j_spec, j_meta = j_hetero.stack_agent_specs_padded(j_mixed_problem())
    t_spec, t_meta = hetero.stack_agent_specs_padded(_t_mixed())
    return j_spec, j_meta, t_spec, t_meta


def test_padded_stack_matches_jax(stacks):
    j_spec, j_meta, t_spec, t_meta = stacks
    assert tuple(t_meta) == tuple(j_meta)
    assert (t_spec.state_dim, t_spec.control_dim) == (j_spec.state_dim, j_spec.control_dim) == (6, 2)
    for name in ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds"):
        np.testing.assert_array_equal(getattr(t_spec, name).numpy(),
                                      np.asarray(getattr(j_spec, name)), err_msg=name)
    assert t_spec.state_lower_bounds is None and j_spec.state_lower_bounds is None
    # The builders are memoized on the type tuple: a rebuilt mix shares them.
    again, _ = hetero.stack_agent_specs_padded(_t_mixed())
    assert again.dynamics is t_spec.dynamics and again.derivs is t_spec.derivs


@pytest.mark.parametrize("fn", ["dynamics", "stage_cost", "terminal_cost"])
def test_dispatch_functions_match_jax(stacks, fn):
    """At drawn physical states and controls under each lane's type
    indicator, batched over lanes."""
    j_spec, _, t_spec, _ = stacks
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-1, 1, (8, 4)), np.eye(2)[rng.randint(0, 2, 8)]], 1)
    u = rng.uniform(-0.7, 0.7, (8, 2))
    call = {"dynamics": lambda f, a, b: f(a, b), "stage_cost": lambda f, a, b: f(a, b, 3),
            "terminal_cost": lambda f, a, b: f(a)}[fn]
    want = jax.vmap(lambda a, b: call(getattr(j_spec, fn), a, b))(jnp.asarray(x), jnp.asarray(u))
    got = call(getattr(t_spec, fn), torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_constraint_rows_pad_to_zero_and_minus_one():
    """Two types with constraints of different row counts: padded equality
    rows evaluate to 0, padded inequality rows to -1, as JAX's."""
    def j_ocp(nx, nu, eq, ineq):
        o = JOCP(state_dim=nx, control_dim=nu, horizon_steps=4, dt=0.1,
                 initial_state=jnp.linspace(0.1, 0.3, nx), dynamics=lambda x, u: -x,
                 stage_cost=lambda x, u, t: jnp.sum(x ** 2) + jnp.sum(u ** 2),
                 equality_constraints=eq, inequality_constraints=ineq)
        o.initialize_problem()
        return o

    def t_ocp(nx, nu, eq, ineq, dyn, stage):
        o = OCP(state_dim=nx, control_dim=nu, horizon_steps=4, dt=0.1,
                initial_state=torch.linspace(0.1, 0.3, nx, dtype=torch.float64), dynamics=dyn,
                stage_cost=stage, equality_constraints=eq, inequality_constraints=ineq,
                device="cpu")
        o.initialize_problem()
        return o

    jp, tp = JProblem(), MultiAgentProblem()
    jp.add_agent(JAgent(0, j_ocp(2, 1, None, lambda x, u: jnp.stack([u[0] - 1.0]))))
    jp.add_agent(JAgent(1, j_ocp(3, 2, lambda x, u: jnp.stack([x[0] - u[1]]),
                                 lambda x, u: jnp.stack([x[1] - 2.0, u[0] + x[2]]))))
    dyn = lambda x, u: -x
    stage = lambda x, u, t: (x ** 2).sum(-1) + (u ** 2).sum(-1)
    tp.add_agent(Agent(0, t_ocp(2, 1, None, lambda x, u: torch.stack([u[..., 0] - 1.0], -1),
                                dyn, stage)))
    tp.add_agent(Agent(1, t_ocp(3, 2, lambda x, u: torch.stack([x[..., 0] - u[..., 1]], -1),
                                lambda x, u: torch.stack([x[..., 1] - 2.0, u[..., 0] + x[..., 2]],
                                                         -1), dyn, stage)))
    j_spec, _ = j_hetero.stack_agent_specs_padded(jp)
    t_spec, _ = hetero.stack_agent_specs_padded(tp)
    assert (t_spec.eq_dim, t_spec.ineq_dim) == (j_spec.eq_dim, j_spec.ineq_dim) == (1, 2)
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-1, 1, (6, 3)), np.eye(2)[[0, 1, 0, 1, 1, 0]]], 1)
    u = rng.uniform(-1, 1, (6, 2))
    for name in ("equality_constraints", "inequality_constraints"):
        want = jax.vmap(getattr(j_spec, name))(jnp.asarray(x), jnp.asarray(u))
        got = getattr(t_spec, name)(torch.as_tensor(x), torch.as_tensor(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, err_msg=name)
    g = t_spec.equality_constraints(torch.as_tensor(x), torch.as_tensor(u))
    assert torch.all(g[torch.as_tensor(x[:, 3] == 1.0)] == 0.0)
    h = t_spec.inequality_constraints(torch.as_tensor(x), torch.as_tensor(u))
    assert torch.all(h[torch.as_tensor(x[:, 3] == 1.0), 1] == -1.0)


def test_mixed_padded_stack_matches_jax():
    _compare(_t_strategy("sequential")(_t_mixed()), _j_strategy("sequential")(j_mixed_problem()))


@pytest.mark.parametrize("name", ["sequential", "linesearch", "trustregion"])
def test_mixed_host_loop_matches_jax(name, monkeypatch):
    """The padded stack refused on both sides: each strategy's host loop,
    one single-problem solve an agent, against JAX's; and the port's padded
    stack against its host loop (total cost rel 1e-5, as
    tests/test_hetero.py holds JAX's), which holds the padded line search
    and trust region to JAX through the host loop."""
    padded = _t_strategy(name)(_t_mixed())
    monkeypatch.setattr(nash, "stack_agent_specs_padded", lambda problem, device=None: (None, None))
    monkeypatch.setattr(j_nash, "stack_agent_specs_padded", lambda problem: (None, None))
    t_host = _t_strategy(name)(_t_mixed())
    _compare(t_host, _j_strategy(name)(j_mixed_problem()))
    np.testing.assert_allclose(padded.total_cost, t_host.total_cost, rtol=1e-5)


def test_padded_controls_exactly_zero():
    """The LQR agent's padded control stays exactly zero, and its cost is
    its solo optimum (no padding term in it)."""
    problem = _t_mixed()
    strategy = _t_strategy("sequential")
    specs, meta = hetero.stack_agent_specs_padded(problem)
    states, controls, costs = strategy._run_stacked(strategy._prepare(problem, specs))
    assert torch.all(controls[1, :, 1] == 0.0)
    solo = problem.agents[1].ocp
    make_solver("ilqr", PARAMS, device="cpu").solve(solo)
    np.testing.assert_allclose(float(costs[1]), solo.best_cost, rtol=1e-6)


def _coupled_fleet(duplicate_type, n=4):
    """tests/test_hetero.py's convoy on adjacent lanes; with two artificial
    types (identical physics, distinct function objects)."""
    def make_stage():
        return lambda x, u, t: (x[..., 1] ** 2 + (x[..., 3] - 2.0) ** 2
                                + 0.05 * (u[..., 0] ** 2 + u[..., 1] ** 2))
    stage_a = make_stage()
    stage_b = make_stage() if duplicate_type else stage_a
    problem = MultiAgentProblem()
    for i in range(n):
        ocp = OCP(state_dim=4, control_dim=2, horizon_steps=15, dt=0.25,
                  initial_state=torch.tensor([-1.5 * i, 0.25 * i, 0.0, 2.0], dtype=torch.float64),
                  dynamics=single_track_model, stage_cost=stage_a if i % 2 == 0 else stage_b,
                  input_lower_bounds=torch.tensor([-0.6, -2.0], dtype=torch.float64),
                  input_upper_bounds=torch.tensor([0.6, 2.0], dtype=torch.float64),
                  device="cpu")
        ocp.initialize_problem()
        problem.add_agent(Agent(i, ocp))
    problem.inter_agent_cost = lambda xi, xj, t: 5.0 * torch.exp(
        -((xi[..., 0] - xj[..., 0]) ** 2 + (xi[..., 1] - xj[..., 1]) ** 2) / 2.0)
    return problem


def test_coupled_heterogeneous_matches_homogeneous():
    results = []
    for dup in (False, True):
        problem = _coupled_fleet(dup)
        stacked, meta = hetero.stack_agent_specs_padded(problem)
        assert (stacked is not None and meta.n_types == 2) if dup else stacked is None
        results.append(_t_strategy("sequential", {**PARAMS, "max_iterations": 5})(problem))
    hom, het = results
    np.testing.assert_allclose(het.total_cost, hom.total_cost, rtol=1e-5)
    for a, b in zip(hom.controls, het.controls):
        assert float((a - b).abs().max()) < 1e-2


def _lqr(nx, nu, T):
    ocp = OCP(state_dim=nx, control_dim=nu, horizon_steps=T, dt=0.1,
              initial_state=torch.eye(nx, dtype=torch.float64)[0],
              dynamics=lambda x, u: x[..., :nx] * 0.0 + torch.nn.functional.pad(u, (0, nx - nu)),
              stage_cost=lambda x, u, t: (x ** 2).sum(-1) + (u ** 2).sum(-1), device="cpu")
    ocp.initialize_problem()
    return ocp


def test_unpaddable_mix_falls_back_to_host():
    """Different horizons cannot be padded: uncoupled, the host loop solves
    it; coupled, it raises."""
    p = MultiAgentProblem()
    p.add_agent(Agent(0, _lqr(2, 1, 10)))
    p.add_agent(Agent(1, _lqr(3, 2, 12)))
    assert hetero.stack_agent_specs_padded(p) == (None, None)
    sol = make_strategy("sequential", make_solver("ilqr", device="cpu"), PARAMS, 2)(p)
    assert np.isfinite(sol.total_cost)
    p.inter_agent_cost = lambda xi, xj, t: 0.0 * xi[..., 0]
    with pytest.raises(NotImplementedError, match="stackable by padding"):
        make_strategy("sequential", make_solver("ilqr", device="cpu"), PARAMS, 2)(p)
