"""The port's AL machinery against the JAX package, on the CPU.

* ``constraints.py``'s helpers against the JAX package's, on float64 inputs
  drawn with numpy from a seed: plain arithmetic on both sides, rtol 1e-12.
* ``ocp.with_state_bound_constraints`` against the JAX transform (values,
  row count, Jacobian oracles, composition, identity), as
  tests/test_state_bounds_al.py checks the JAX one.
* The select kernel's AL mode (K6): its plain version against the Pallas
  kernel in interpret mode at one 1024-lane tile and T = 4, with equality
  and inequality rows, float32 on both sides in the same order of
  operations; XLA:CPU's and PyTorch's float32 sin/cos/tan differ in the
  last ulps, so rtol = atol = 1e-5, as tests/test_torch_kernels.py.
* The fused AL solve against the JAX package's fused loop
  (``solve_ilqr_batched(..., fused=True)`` on both sides: both routers'
  ``fused="auto"`` keep AL solves on the non-fused path on the CPU, which
  tests/test_torch_nonfused.py holds): two float32 implementations of the
  same algorithm over 8
  iterations, to the tolerances tests/test_fused_loop.py holds JAX's own
  fused loop to against its regular path (cost rtol 1e-4, violations atol
  1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu import constraints as jc
from multi_agent_solver_tpu.models import single_track_model as j_single_track
from multi_agent_solver_tpu.ocp import OCP as JOCP
from multi_agent_solver_tpu.ocp import with_state_bound_constraints as j_with_bounds
from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

from multi_agent_solver_tpu_torch import OCP, constraints as tc, entry
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.ocp import bound_rows, with_state_bound_constraints
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, solve_ilqr_batched
from multi_agent_solver_tpu_torch.types import device_fn_of, no_constraint

torch.set_num_threads(1)

INF = float("inf")
RTOL = 1e-12
NX, NU = 4, 2


# -- constraints.py ---------------------------------------------------------

# (JAX constraint, port constraint) of each side: a pinned input (written
# v - u as BoundRows' "lower" form) and the speed cap with a lane bound.
J_EQ = lambda x, u: jnp.stack([0.3 - u[1]])
T_EQ = bound_rows(("u", 1, 0.3, "lower"))
J_IN = lambda x, u: jnp.stack([x[3] - 0.8, -0.2 - x[1]])
T_IN = bound_rows(("x", 3, 0.8, "upper"), ("x", 1, -0.2, "lower"))
SIDES = {"eq": (True, False), "ineq": (False, True), "both": (True, True)}


def _lane_cost_j(x, u, t):
    return 10.0 * x[1] ** 2 + (x[3] - 1.0) ** 2 + 0.1 * u[0] ** 2 + 0.1 * u[1] ** 2


def _ocps(eq, ineq, T=10):
    """The JAX and the port's float64 lane-follow problem with the sides'
    constraints."""
    common = dict(state_dim=4, control_dim=2, horizon_steps=T, dt=0.1)
    j = JOCP(**common, initial_state=jnp.array([0.0, 1.0, 0.0, 0.5]),
             dynamics=j_single_track, stage_cost=_lane_cost_j, equality_constraints=J_EQ if eq else None,
             inequality_constraints=J_IN if ineq else None)
    j.initialize_problem()
    t = OCP(**common, initial_state=torch.tensor([0.0, 1.0, 0.0, 0.5], dtype=torch.float64),
            dynamics=single_track_model, stage_cost=entry.LANE_FOLLOW_COST,
            equality_constraints=T_EQ if eq else None, inequality_constraints=T_IN if ineq else None,
            device="cpu")
    t.initialize_problem()
    return j.spec(), t.spec()


@pytest.mark.parametrize("sides", sorted(SIDES))
def test_constraint_helpers_match_jax(sides):
    eq, ineq = SIDES[sides]
    jspec, tspec = _ocps(eq, ineq)
    assert (tspec.eq_dim, tspec.ineq_dim) == (jspec.eq_dim, jspec.ineq_dim) == (int(eq), 2 * ineq)
    rng = np.random.RandomState(11)
    T = 10
    xs = np.stack([rng.uniform(0, 5, T + 1), rng.uniform(-1.5, 1.5, T + 1),
                   rng.uniform(-0.6, 0.6, T + 1), rng.uniform(0, 2, T + 1)], -1)
    us = rng.uniform(-1, 1, (T, 2))
    lam_eq = rng.uniform(-1, 1, (T, jspec.eq_dim)) if eq else None
    lam_in = rng.uniform(0, 1, (T, jspec.ineq_dim)) if ineq else None
    J = lambda a: None if a is None else jnp.asarray(a)
    P = lambda a: None if a is None else torch.as_tensor(a)
    close = lambda got, want: np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-14)

    for on, jfn, tfn in ((eq, jspec.equality_constraints, tspec.equality_constraints),
                         (ineq, jspec.inequality_constraints, tspec.inequality_constraints)):
        if on:
            g_j = jc.eval_constraints_horizon(jfn, J(xs), J(us))
            close(tc.eval_constraints_horizon(tfn, P(xs), P(us)), g_j)
            lam = rng.uniform(-1, 1, g_j.shape)
            close(tc.equality_al_term(P(np.asarray(g_j)), P(lam), 4.0),
                  jc.equality_al_term(g_j, J(lam), jnp.asarray(4.0)))
            close(tc.inequality_phr_term(P(np.asarray(g_j)), P(lam), 4.0),
                  jc.inequality_phr_term(g_j, J(lam), jnp.asarray(4.0)))
    rho = jnp.asarray(4.0)
    close(tc.compute_augmented_cost(tspec, P(xs), P(us), P(lam_eq), P(lam_in), 4.0),
          jc.compute_augmented_cost(jspec, J(xs), J(us), J(lam_eq), J(lam_in), rho))
    for got, want in zip(tc.update_lagrange_multipliers(tspec, P(xs), P(us), P(lam_eq), P(lam_in), 4.0),
                         jc.update_lagrange_multipliers(jspec, J(xs), J(us), J(lam_eq), J(lam_in), rho)):
        assert (got is None) == (want is None)
        if got is not None:
            close(got, want)
    for got, want in zip(tc.violation_norms(tspec, P(xs), P(us)),
                         jc.violation_norms(jspec, J(xs), J(us))):
        close(got, want)
    for tol in (1e-3, 1e3):
        close(tc.increase_penalty_parameter(4.0, tspec, P(xs), P(us), tol),
              jc.increase_penalty_parameter(rho, jspec, J(xs), J(us), tol))
    lo, hi = np.array([-0.5, -0.2]), np.array([0.5, 0.2])
    close(tc.clamp_controls(P(us), P(lo), P(hi)), jc.clamp_controls(J(us), J(lo), J(hi)))


# -- the state-bound transform ---------------------------------------------

def _double_integrators(lb, ub, j_base=None, t_base=None):
    """tests/test_state_bounds_al.py's 1-D double integrator, JAX and port."""
    common = dict(state_dim=2, control_dim=1, horizon_steps=30, dt=0.1)
    j = JOCP(**common, initial_state=jnp.array([0.0, 0.0]),
             dynamics=lambda x, u: jnp.array([x[1], u[0]]),
             stage_cost=lambda x, u, t: (x[0] - 2.0) ** 2 + 1e-3 * u[0] ** 2,
             state_lower_bounds=jnp.array(lb), state_upper_bounds=jnp.array(ub),
             inequality_constraints=j_base)
    j.initialize_problem()
    t = OCP(**common, initial_state=torch.zeros(2, dtype=torch.float64),
            dynamics=lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1),
            stage_cost=lambda x, u, t: (x[..., 0] - 2.0) ** 2 + 1e-3 * u[..., 0] ** 2,
            state_lower_bounds=torch.tensor(lb, dtype=torch.float64),
            state_upper_bounds=torch.tensor(ub, dtype=torch.float64),
            inequality_constraints=t_base, device="cpu")
    t.initialize_problem()
    return j_with_bounds(j.spec()), with_state_bound_constraints(t.spec())


def _points(seed, n=6):
    rng = np.random.RandomState(seed)
    return rng.uniform(-3, 3, (n, 2)), rng.uniform(-8, 8, (n, 1))


@pytest.mark.parametrize("case", ["upper", "both"])
def test_state_bound_transform_matches_jax(case):
    """Rows ``x_i - ub_i`` for each finite ub, then ``lb_i - x_i`` for each
    finite lb; values and the Jacobian oracles agree with JAX's at random
    points, and the constraint carries a BoundRows device function."""
    lb = (-INF, -INF) if case == "upper" else (-0.5, -INF)
    jspec, tspec = _double_integrators(lb, (1.0, INF))
    assert tspec.ineq_dim == jspec.ineq_dim == (1 if case == "upper" else 2)
    g = tspec.inequality_constraints
    assert device_fn_of(g).name == f"bound_rows{tspec.ineq_dim}"
    np.testing.assert_allclose(g(torch.tensor([1.5, 7.0]), torch.tensor([0.0])).numpy(),
                               [0.5] if case == "upper" else [0.5, -2.0])
    for x, u in zip(*_points(1)):
        for tf, jf in ((g, jspec.inequality_constraints),
                       (tspec.derivs.ineq_gx, jspec.derivs.ineq_gx),
                       (tspec.derivs.ineq_gu, jspec.derivs.ineq_gu)):
            np.testing.assert_allclose(tf(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                                       np.asarray(jf(jnp.asarray(x), jnp.asarray(u))),
                                       rtol=RTOL, atol=1e-14)
    # Batched values (the fused loop's convention) row by row.
    x, u = _points(2)
    np.testing.assert_array_equal(
        g(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
        np.stack([g(torch.as_tensor(a), torch.as_tensor(b)).numpy() for a, b in zip(x, u)]))


def test_state_bound_transform_identity_and_memo():
    ocp = OCP(state_dim=2, control_dim=1, horizon_steps=5, dt=0.1,
              initial_state=torch.zeros(2), dynamics=lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1),
              state_upper_bounds=torch.tensor([INF, INF]), device="cpu")
    ocp.initialize_problem()
    spec = ocp.spec()
    assert with_state_bound_constraints(spec) is spec
    ocp.state_upper_bounds = torch.tensor([1.0, INF])
    a = with_state_bound_constraints(ocp.spec())
    b = with_state_bound_constraints(ocp.spec())
    assert a.inequality_constraints is b.inequality_constraints


@pytest.mark.parametrize("tagged", [False, True])
def test_state_bound_transform_composes_with_a_base(tagged):
    """Base rows first: ``u - 5`` then ``x_0 - 1`` (as the JAX test); a
    tagged base keeps a device function, an untagged one gives none."""
    t_base = (bound_rows(("u", 0, 5.0, "upper")) if tagged
              else lambda x, u: torch.stack([u[..., 0] - 5.0], -1))
    jspec, tspec = _double_integrators((-INF, -INF), (1.0, INF),
                                       lambda x, u: jnp.stack([u[0] - 5.0]), t_base)
    assert tspec.ineq_dim == jspec.ineq_dim == 2
    g = tspec.inequality_constraints
    np.testing.assert_allclose(g(torch.tensor([1.5, 0.0]), torch.tensor([6.0])).numpy(), [1.0, 0.5])
    assert (device_fn_of(g) is not None) == tagged
    for x, u in zip(*_points(3)):
        np.testing.assert_allclose(tspec.derivs.ineq_gu(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                                   np.asarray(jspec.derivs.ineq_gu(jnp.asarray(x), jnp.asarray(u))),
                                   rtol=RTOL, atol=1e-14)


# -- K6's AL mode ---------------------------------------------------------

B, T_K = 1024, 4
LADDER = (1.0, 0.5, 0.125)
TOL = dict(rtol=1e-5, atol=1e-5)


def _lanes(a: np.ndarray):
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def test_al_select_plain_matches_pallas():
    """Stage-out select in AL mode with one equality and four inequality
    rows, random multipliers and a spread of rho: merit, accept flags and
    the kept trajectories agree with the Pallas kernel's."""
    from tests.problems import single_track_lane_ocp

    j_eq = lambda x, u: jnp.stack([0.1 - u[0]])
    j_in = lambda x, u: jnp.stack([x[1] - 1.6, x[3] - 0.8, -0.1 - x[1], 0.0 - x[3]])
    jspec = single_track_lane_ocp(horizon_steps=T_K).spec().replace(
        equality_constraints=j_eq, eq_dim=1, inequality_constraints=j_in, ineq_dim=4)
    tspec = entry.single_track_spec(T_K, device="cpu").replace(
        equality_constraints=bound_rows(("u", 0, 0.1, "lower")), eq_dim=1,
        inequality_constraints=entry.state_bound_specs(1, "cpu", T_K).inequality_constraints,
        ineq_dim=4)
    rng = np.random.RandomState(12)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(np.stack([rng.uniform(0, 5, (T_K, B)), rng.uniform(-1.5, 1.5, (T_K, B)),
                      rng.uniform(-0.6, 0.6, (T_K, B)), rng.uniform(0, 2, (T_K, B))], 1))
    u = f32(np.stack([rng.uniform(-0.7, 0.7, (T_K, B)), rng.uniform(-1, 1, (T_K, B))], 1))
    xT = f32(x[-1] + rng.uniform(-0.1, 0.1, (NX, B)))
    k = f32(rng.uniform(-0.3, 0.3, (T_K, NU, B)))
    K = f32(rng.uniform(-0.5, 0.5, (T_K, NU, NX, B)))
    merit = f32(rng.uniform(0, 200, B))
    active = rng.uniform(size=B) < 0.8
    lb = f32(np.broadcast_to(np.array([[-0.7], [-1.0]]), (NU, B)))
    ub = -lb
    eq_mult = f32(rng.uniform(-2, 2, (T_K, 1, B)))
    ineq_mult = f32(rng.uniform(0, 3, (T_K, 4, B)) * (rng.uniform(size=(T_K, 4, B)) < 0.7))
    rho = f32(10.0 ** rng.uniform(0, 2, B))
    want = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(K), _lanes(merit), _lanes(lb), _lanes(ub),
        LADDER, True, eq_mult_l=_lanes(eq_mult), ineq_mult_l=_lanes(ineq_mult), rho_l=_lanes(rho),
        act_tol=1e-6, active_l=_lanes(active.astype(np.float32)), xT_l=_lanes(xT), time_unroll=2)
    bufs = [torch.as_tensor(a.copy()) for a in (x, u, xT)]
    T = torch.as_tensor
    k2.AL_STATS.reset()
    merit_g, accept_g = k2.forward_select(
        tspec, *bufs, T(k), T(K), T(merit), T(active), T(lb), T(ub), LADDER, None,
        T(eq_mult), T(ineq_mult), T(rho), 1e-6)
    assert (k2.AL_STATS.launches, k2.AL_STATS.plain_calls) == (0, 1)
    accept_want = _unlanes(want[3]) > 0.5
    assert 0 < accept_want.sum() < active.sum()
    np.testing.assert_array_equal(accept_g.numpy(), accept_want)
    np.testing.assert_allclose(merit_g.numpy(), _unlanes(want[2]), **TOL)
    for g, w in zip(bufs, (want[0], want[1], want[4])):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


# -- the fused AL solve -----------------------------------------------------

SPEED_CAP_Y = (0.5, 1.0, 1.5)


def _speed_cap_specs(horizon=40, dtype=torch.float64):
    """tests/test_fused_loop.py's TestFusedConstrained problem for the port:
    lane follow with v <= 0.8 as one BoundRows inequality, T = 40, inputs
    +-0.5 / +-1, x0 = (0, y, 0, 0.5) for y in SPEED_CAP_Y."""
    ocp = OCP(state_dim=4, control_dim=2, horizon_steps=horizon, dt=0.1,
              initial_state=torch.tensor([0.0, 1.0, 0.0, 0.5], dtype=dtype),
              dynamics=single_track_model,
              stage_cost=lambda x, u, t: (x[..., 1] ** 2 + (x[..., 3] - 1.0) ** 2
                                          + 0.1 * (u[..., 0] ** 2 + u[..., 1] ** 2)),
              input_lower_bounds=torch.tensor([-0.5, -1.0], dtype=dtype),
              input_upper_bounds=torch.tensor([0.5, 1.0], dtype=dtype),
              inequality_constraints=bound_rows(("x", 3, 0.8, "upper")), device="cpu")
    ocp.initialize_problem()
    x0 = np.array([[0.0, y, 0.0, 0.5] for y in SPEED_CAP_Y])
    return entry.batch_specs(ocp.spec(), x0)


@pytest.fixture(scope="module")
def jax_speed_cap():
    from tests.test_fused_loop import TestFusedConstrained

    specs = TestFusedConstrained()._constrained_specs()
    np.testing.assert_array_equal(np.asarray(specs.initial_state)[:, 1], SPEED_CAP_Y)
    return j_solve(specs, JConfig(max_iterations=8, tolerance=1e-8), fused=True)


@pytest.fixture(scope="module")
def jax_equality():
    from tests.test_constraints import _equality_ocp

    spec = _equality_ocp().spec()
    x0 = jnp.asarray(entry.equality_x0(3), jnp.float64)
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    return j_solve(specs, JConfig(max_iterations=1, tolerance=1e-8, constraint_tolerance=1e-3),
                   fused=True)


def test_speed_cap_solve_matches_jax_fused_loop(jax_speed_cap):
    """8 iterations: K2's rollout and K3's hoist (over the horizon) once, K3,
    K4 and K6-AL once per iteration, as plain versions."""
    stats = (k2.STATS, k2.AL_STATS, k3.STATS, k1.BACKWARD_STATS, k1.STATS, k2.ROLLOUT_STATS,
             k3.HOIST_STATS)
    for s in stats:
        s.reset()
    got = solve_ilqr_batched(_speed_cap_specs(), ILQRConfig(max_iterations=8, tolerance=1e-8),
                             fused=True, device="cpu")
    want = jax_speed_cap
    it = int(got.iterations[0])
    assert it == int(np.asarray(want.iterations)[0]) == 8
    assert [s.plain_calls for s in stats] == [0, it, it, it, 0, 1, 1]
    assert [s.launches for s in stats] == [0] * 7
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)
    np.testing.assert_allclose(got.ineq_violation.numpy(), np.asarray(want.ineq_violation),
                               atol=1e-4)
    assert float(got.ineq_violation.max()) > 1e-3          # the cap binds
    np.testing.assert_array_equal(got.eq_violation.numpy(), 0.0)


def test_equality_solve_matches_jax_fused_loop(jax_equality):
    """One iteration.  The problem has no input bounds, and its steering
    passes tan's pole at -pi/2 (the third problem's reaches -1.60 rad in
    this very step), where a last-ulp change of the rollout is amplified a
    thousandfold: the two float32 paths part there within an iteration
    (cost 4.9e-4 apart) and the others within 2-3 (PERF.md).  So one
    iteration is compared: equality violations atol 1e-4 and costs rtol
    1e-3."""
    got = solve_ilqr_batched(entry.equality_specs(3, device="cpu"),
                             dataclasses.replace(entry.EQ_CONFIG, max_iterations=1), fused=True,
                             device="cpu")
    want = jax_equality
    np.testing.assert_allclose(got.eq_violation.numpy(), np.asarray(want.eq_violation), atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-3)
    np.testing.assert_array_equal(got.ineq_violation.numpy(), 0.0)


def test_speed_cap_solve_converges_feasible():
    """As tests/test_fused_loop.py's convergence test, at T = 12 (for time):
    up to 40 iterations; the converged problems keep v <= 0.8 + 1e-3.  All
    three converge here (in 9 iterations, the cap binding within 1e-4); the
    test asks for two, since the endgame under the x5 penalty schedule is
    chaotic in float32 (at T = 40 one problem of the three ends 2.3e-3
    above the cap after 40 iterations), as the JAX package's tests note."""
    r = solve_ilqr_batched(_speed_cap_specs(horizon=12),
                           ILQRConfig(max_iterations=40, tolerance=1e-8), fused=True, device="cpu")
    done = r.converged
    assert int(done.sum()) >= 2
    v = r.states[done, :, 3]
    assert float(v.max()) <= 0.8 + 1e-3, float(v.max())
    assert float(r.ineq_violation[done].max()) < 1e-3


# -- routes -----------------------------------------------------------------

def test_al_select_symbol_and_untagged_constraint():
    """The AL instantiation is named by its constraint tags (``none`` for an
    absent side); an untagged constraint has no device function, so the
    CUDA launch raises NotImplementedError before any device work."""
    spec = entry.state_bound_specs(2, device="cpu", horizon=3)
    symbol, params = k2._symbol(spec, NX, NU, no_constraint, spec.inequality_constraints)
    assert symbol == "mas_forward_select__single_track__diag_quadratic__zero__none__bound_rows4"
    assert params[3] == () and len(params[4]) == 12
    assert params[4][:3] == (0.0, 1.0, pytest.approx(1.6))     # x[1] - 1.6
    assert params[4][6:9] == (1.0, 1.0, pytest.approx(-0.1))   # -0.1 - x[1]
    symbol, _ = k2._symbol(spec, NX, NU)
    assert symbol == "mas_forward_select__single_track__diag_quadratic__zero"
    untagged = spec.replace(inequality_constraints=lambda x, u: x[..., 3:] - 0.8, ineq_dim=1)
    z = lambda *s: torch.zeros(s)
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k2.launch_forward_select(untagged, z(3, NX, 2), z(3, NU, 2), z(NX, 2), z(3, NU, 2),
                                 z(3, NU, NX, 2), z(2), torch.ones(2, dtype=torch.bool), None,
                                 None, LADDER, None, None, z(3, 1, 2), z(2))
    with pytest.raises(ValueError, match="rho"):
        k2.forward_select(spec, z(3, NX, 2), z(3, NU, 2), z(NX, 2), z(3, NU, 2), z(3, NU, NX, 2),
                          z(2), torch.ones(2, dtype=torch.bool), None, None, LADDER, None,
                          None, z(3, 4, 2))


def test_al_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for build in (entry.state_bound_specs, entry.equality_specs):
        with pytest.raises(RuntimeError, match="cuda"):
            build(2)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_ilqr_batched(entry.equality_specs(2, device="cpu", horizon=5), entry.EQ_CONFIG)
