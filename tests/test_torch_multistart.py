"""The port's batching and multi-start solving (``parallel/``) against the
JAX package.

Starts are drawn with numpy from a seed and handed to both sides; the
solves run the float64 scan routes of both packages (``fused=False,
backward="scan"``), compared at rtol 1e-8.  The pendulum's swing-up is
knife-edge in its backward recursion (after one iteration JAX and the
port part in float64, as JAX does against itself when lxx moves by 1e-13
relative), so the pendulum model is raced here on a balancing cost, where
the recursion is well-conditioned; the swing-up example goes through
``multistart_solve_host`` for its write-back contract.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.models import pendulum as jpd
from multi_agent_solver_tpu.ocp import OCP as JOCP
from multi_agent_solver_tpu.parallel.batching import batch_solve as j_batch_solve
from multi_agent_solver_tpu.parallel.multistart import multistart_solve as j_multistart
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr as j_solve_ilqr
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve_batched

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.examples.pendulum_swing_up import create_pendulum_swingup_ocp
from multi_agent_solver_tpu_torch.models import pendulum as tpd
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.parallel import (batch_solve, batch_spec_over,
                                                   multistart_solve, multistart_solve_host,
                                                   random_control_starts, replicate_spec)
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, solve_ilqr, solve_ilqr_batched

torch.set_num_threads(1)

RTOL = 1e-8


def _scan(config):
    return lambda s: solve_ilqr_batched(s, config, backward="scan", fused=False, device="cpu")


def _j_scan(config):
    return lambda s: j_solve_batched(s, config, backward="scan", fused=False)


def _close(got, want, rtol=RTOL):
    for name in ("states", "controls", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=1e-10, err_msg=name)


def test_random_control_starts():
    """``[n, T, nu]``; lane 0 the spec's warm start; amplitudes within 40%
    of the half-range around the centre; the same generator seed gives the
    same starts, another seed others; ``scale`` without bounds."""
    spec = entry.single_track_spec(30, device="cpu")
    starts = random_control_starts(torch.Generator().manual_seed(0), spec, 8)
    assert starts.shape == (8, 30, 2) and starts.dtype == torch.float32
    assert torch.equal(starts[0], spec.initial_controls)
    assert float(starts[1:, :, 0].abs().max()) <= 0.4 * 0.7 + 1e-6
    assert float(starts[1:, :, 1].abs().max()) <= 0.4 * 1.0 + 1e-6
    again = random_control_starts(torch.Generator().manual_seed(0), spec, 8)
    other = random_control_starts(torch.Generator().manual_seed(1), spec, 8)
    assert torch.equal(starts, again) and not torch.equal(starts[1:], other[1:])
    free = spec.replace(input_lower_bounds=None, input_upper_bounds=None)
    scaled = random_control_starts(torch.Generator().manual_seed(0), free, 4, scale=0.5,
                                   include_warm_start=False)
    assert float(scaled.abs().max()) <= 0.5 and not torch.equal(scaled[0], spec.initial_controls)


def test_random_control_starts_formula():
    """JAX's formula and draw order -- amplitude, frequency, phase -- fed
    the generator's uniform draws: centre + amp U(0.2, 1) sin(2 pi U(0.5, 3)
    t dt + U(0, 2 pi)), in float64."""
    spec = entry.single_track_spec(12, torch.float64, "cpu")
    starts = random_control_starts(torch.Generator().manual_seed(3), spec, 5,
                                   include_warm_start=False)
    g = torch.Generator().manual_seed(3)
    draws = [torch.rand((5, 1, 2), generator=g, dtype=torch.float64).numpy() for _ in range(3)]
    amp = 0.4 * np.array([1.4, 2.0]) / 2.0
    ts = (np.arange(12) * 0.1)[None, :, None]
    want = amp * (0.2 + 0.8 * draws[0]) * np.sin(
        2.0 * math.pi * (0.5 + 2.5 * draws[1]) * ts + 2.0 * math.pi * draws[2])
    np.testing.assert_allclose(starts.numpy(), want, rtol=1e-12, atol=1e-15)


def _lane_pair(T=20):
    from tests.problems import single_track_lane_ocp

    return (single_track_lane_ocp(horizon_steps=T).spec(),
            entry.single_track_spec(T, torch.float64, "cpu"))


def test_multistart_single_track_matches_jax():
    """Six numpy starts on the lane follow at T = 20, 5 iterations: the
    best lane, its trajectory and cost as JAX's."""
    j_spec, t_spec = _lane_pair()
    starts = np.random.RandomState(0).uniform(-0.5, 0.5, (6, 20, 2))
    starts[0] = 0.0
    cfg = dict(max_iterations=5, tolerance=1e-5)
    want = j_multistart(_j_scan(JConfig(**cfg)), j_spec, jnp.asarray(starts))
    got = multistart_solve(_scan(ILQRConfig(**cfg)), t_spec, torch.as_tensor(starts))
    _close(got, want)
    assert got.cost.shape == () and got.states.shape == (21, 4)


def _balance_pendulum():
    """The pendulum model held upright (theta = 0): cost theta^2 + 0.1
    omega^2 + 0.01 u^2, terminal 10 theta^2 + omega^2, T = 20, dt = 0.05,
    torque +-5, from theta = 0.3."""

    def stage(x, u, t):
        return x[..., 0] ** 2 + 0.1 * x[..., 1] ** 2 + 0.01 * u[..., 0] ** 2

    def terminal(x):
        return 10.0 * x[..., 0] ** 2 + x[..., 1] ** 2

    common = dict(state_dim=2, control_dim=1, horizon_steps=20, dt=0.05, stage_cost=stage,
                  terminal_cost=terminal)
    j_ocp = JOCP(dynamics=jpd.pendulum_dynamics, initial_state=jnp.array([0.3, 0.0]),
                 input_lower_bounds=jnp.array([-5.0]), input_upper_bounds=jnp.array([5.0]),
                 **common)
    t_ocp = OCP(dynamics=tpd.pendulum_dynamics,
                initial_state=torch.tensor([0.3, 0.0], dtype=torch.float64),
                input_lower_bounds=torch.tensor([-5.0], dtype=torch.float64),
                input_upper_bounds=torch.tensor([5.0], dtype=torch.float64), device="cpu",
                **common)
    j_ocp.initialize_problem()
    t_ocp.initialize_problem()
    return j_ocp.spec(), t_ocp.spec()


def test_multistart_pendulum_matches_jax():
    """Eight numpy starts on the pendulum model, 3 iterations: the best lane
    as JAX's."""
    j_spec, t_spec = _balance_pendulum()
    starts = np.random.RandomState(1).uniform(-3.0, 3.0, (8, 20, 1))
    cfg = dict(max_iterations=3, tolerance=1e-7)
    want = j_multistart(_j_scan(JConfig(**cfg)), j_spec, jnp.asarray(starts))
    got = multistart_solve(_scan(ILQRConfig(**cfg)), t_spec, torch.as_tensor(starts))
    _close(got, want)


def test_multistart_host_writes_back():
    """``multistart_solve_host`` on the swing-up example: the best of its
    lanes (lane 0 the example's sinusoid) goes back into the problem."""
    problem = create_pendulum_swingup_ocp(torch.float64, "cpu")
    warm = problem.initial_controls.clone()
    solver = make_solver("ilqr", {"max_iterations": 2, "tolerance": 1e-4}, device="cpu")
    result = multistart_solve_host(solver, problem, 4, seed=2)
    assert problem.best_cost == float(result.cost)
    assert torch.equal(problem.best_controls, result.controls)
    starts = random_control_starts(torch.Generator().manual_seed(2), problem.spec(), 4)
    assert torch.equal(starts[0], warm)
    lanes = solver._solve_batched_fn(replicate_spec(problem.spec(), 4).replace(
        initial_controls=starts), solver.config)
    assert float(result.cost) == float(lanes.cost.min())


def test_batch_spec_over():
    spec = entry.single_track_spec(10, device="cpu")
    x0 = torch.zeros(3, 4)
    specs = batch_spec_over(spec, initial_state=x0)
    assert specs.initial_state is x0 and specs.initial_controls.shape == (3, 10, 2)
    assert specs.input_lower_bounds.shape == (3, 2)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        batch_spec_over(spec, initial_state=x0, initial_controls=torch.zeros(2, 10, 2))


def test_batch_solve_matches_jax_and_a_loop():
    """``batch_solve`` of the single solve over three problems: JAX's
    ``jit(vmap(solve_ilqr))`` at rtol 1e-8, and a loop of single solves
    exactly."""
    j_spec, t_spec = _lane_pair(12)
    x0 = np.zeros((3, 4))
    x0[:, 1] = (0.5, 1.0, 1.5)
    cfg = dict(max_iterations=4, tolerance=1e-5)
    want = j_batch_solve(lambda s: j_solve_ilqr(s, JConfig(**cfg)),
                         jax.vmap(lambda s0: j_spec.replace(initial_state=s0))(jnp.asarray(x0)))
    specs = batch_spec_over(t_spec, initial_state=torch.as_tensor(x0))
    got = batch_solve(lambda s: solve_ilqr(s, ILQRConfig(**cfg)), specs)
    _close(got, want)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    for i in range(3):
        one = solve_ilqr(t_spec.replace(initial_state=specs.initial_state[i]), ILQRConfig(**cfg))
        assert torch.equal(got.states[i], one.states) and torch.equal(got.cost[i], one.cost)
