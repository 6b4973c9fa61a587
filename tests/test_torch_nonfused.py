"""The port's non-fused (kernel-per-phase) path, the single-problem solve and
the kernel modes they run, against the JAX package on the CPU.

* ``ops/small.py`` and ``ops/boxqp.py`` against the JAX package's, float64
  on numpy inputs drawn from a seed: the same closed-form arithmetic, so
  rtol 1e-9 (XLA's and PyTorch's matrix products may sum in another
  order) and the same regularization levels and active sets exactly.
* The plain versions of K4's explicit-terminal mode, K7 and the
  continuous-Jacobian modes of K3 and K1 against the Pallas kernels in
  interpret mode at one 1024-lane tile and T = 4, float32 on both sides in
  the same order of operations: rtol = atol = 1e-5, and 1e-4 on the
  feedback gains K, as tests/test_torch_kernels.py.
* The single-problem ``solve(ocp)`` of ``examples/single_track_ocp.py``
  in float64: in the continuous mode against ``tests/reference_mirror.py``
  (cost rtol 1e-9, states and controls atol 1e-8, as tests/test_ilqr.py)
  and the reference's 508.59306030; in the discrete mode against JAX's
  ``solve`` (the same tolerances) and below 181.
* The non-fused batched solve at B = 8, T = 20 against JAX's
  ``solve_ilqr_batched(..., fused=False)`` in the same route.  Routes
  without a kernel (``backward="scan"``) are float64 on both sides: rtol
  1e-9.  Routes through the kernels run them in float32 on both sides
  (JAX's Pallas kernels, the port's plain versions): cost rtol 1e-5,
  controls atol 2e-4, the tolerances of tests/test_fused_loop.py for two
  float32 implementations of one algorithm; AL solves, whose multipliers
  and penalty amplify a float32 difference over the iterations, cost rtol
  1e-4 and violations atol 1e-4, as tests/test_torch_al.py.

Each JAX reference runs once, in a module-scoped fixture.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.ops import boxqp as j_boxqp
from multi_agent_solver_tpu.ops import small as j_small
from multi_agent_solver_tpu.ops.linearize_pallas import linearize_pallas, linearize_pallas_tiled
from multi_agent_solver_tpu.ops.riccati_pallas import (
    riccati_backward_pallas,
    riccati_fusedlin_pallas_tiled,
)
from multi_agent_solver_tpu.solvers import make_solver as j_make_solver
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

from multi_agent_solver_tpu_torch import OCP, entry
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.ocp import bound_rows, with_context_cost, zero_terminal_cost
from multi_agent_solver_tpu_torch.ops import boxqp as t_boxqp
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.ops import small as t_small
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers import ilqr
from multi_agent_solver_tpu_torch.solvers.ilqr import solve_ilqr_batched
from multi_agent_solver_tpu_torch.utils.carry import config_from_dict, spec_from_numpy

torch.set_num_threads(1)

LANES, T_K = 1024, 4                     # one lane tile, the kernel checks' horizon
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_K = dict(rtol=1e-4, atol=1e-4)
TOL_F64 = dict(rtol=1e-9, atol=1e-9)
B, T = 8, 20                             # the batched solves
PARAMS = {"max_iterations": 10, "tolerance": 1e-5, "max_ms": 100}
J_BENCH = JConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125))
LEAVES = ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (LANES,))


# -- ops/small.py and ops/boxqp.py -------------------------------------------

def _spd(rng, shape, n, shift):
    L = rng.normal(size=shape + (n, n))
    return L @ np.swapaxes(L, -1, -2) / n + shift * np.eye(n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_small_matches_jax(n):
    """Determinants, Sylvester's test, inverses and SPD solves; the ladder's
    level on matrices from indefinite to near-singular, where it escalates."""
    rng = np.random.RandomState(n)
    Q = _spd(rng, (64,), n, 0.5)
    rhs = rng.normal(size=(64, n, 3))
    near = _spd(rng, (64,), n, 0.0) - np.linspace(-1e-3, 2.0, 64)[:, None, None] * np.eye(n)
    t = lambda a: torch.as_tensor(a)
    if n <= 4:
        np.testing.assert_allclose(t_small.det_small(t(Q)).numpy(),
                                   np.asarray(j_small.det_small(jnp.asarray(Q))), **TOL_F64)
        np.testing.assert_allclose(t_small.inv_small(t(Q)).numpy(),
                                   np.asarray(j_small.inv_small(jnp.asarray(Q))), **TOL_F64)
    np.testing.assert_array_equal(t_small.leading_minors_positive(t(near)).numpy(),
                                  np.asarray(j_small.leading_minors_positive(jnp.asarray(near))))
    np.testing.assert_allclose(t_small.solve_spd_small(t(Q), t(rhs)).numpy(),
                               np.asarray(j_small.solve_spd_small(jnp.asarray(Q), jnp.asarray(rhs))),
                               **TOL_F64)
    got, idx = t_small.psd_solve_with_escalation(t(near), t(rhs))
    want, jidx = jax.vmap(j_small.psd_solve_with_escalation)(jnp.asarray(near), jnp.asarray(rhs))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.min() == 0 and idx.max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("nu", [2, 4])
def test_boxqp_gains_match_jax(nu):
    """The 3^nu enumeration on random SPD problems whose boxes contain 0:
    interior, one-sided and corner solutions, the same active sets."""
    rng = np.random.RandomState(10 + nu)
    n, nx = 128, 4
    Q = _spd(rng, (n,), nu, 1.0)
    qu, Qux = 0.5 * rng.normal(size=(n, nu)), rng.normal(size=(n, nu, nx))
    lb, ub = -rng.uniform(0.05, 1.0, (n, nu)), rng.uniform(0.05, 1.0, (n, nu))
    args = (Q, qu, Qux, lb, ub)
    k, K = t_boxqp.boxqp_gains(*(torch.as_tensor(a) for a in args))
    jk, jK = jax.vmap(j_boxqp.boxqp_gains)(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL_F64)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), **TOL_F64)
    at_box = ((k.numpy() == lb) | (k.numpy() == ub)).sum(1)
    assert (at_box == 0).any() and (at_box == 1).any() and (at_box >= 2).any()


# -- kernel modes: plain versions against the Pallas kernels -----------------

def _stacks(nx, nu, seed):
    """Batch-first float32 inputs of K4's explicit mode from a seed: A =
    0.9 I + 0.05 N, B = 0.05 N, PSD lxx, and luu = R diag(lam) R^T with one
    eigenvalue in [-0.8, -0.3] at half of the stages -- the ladder
    regularizes those to the level 1.111, away from a level boundary, so
    the gain solves stay well conditioned -- and boxes around 0."""
    rng = np.random.RandomState(seed)
    lead = (LANES, T_K)
    f = lambda a: np.asarray(a, np.float32)
    R = np.linalg.qr(rng.normal(size=lead + (nu, nu)))[0]
    lam = rng.uniform(0.5, 2.0, lead + (nu,))
    lam[..., 0] = np.where(rng.uniform(size=lead) < 0.5, rng.uniform(-0.8, -0.3, lead),
                           lam[..., 0])
    Lx, V = rng.normal(size=lead + (nx, nx)), rng.normal(size=(LANES, nx, nx))
    stacks = (f(0.9 * np.eye(nx) + 0.05 * rng.normal(size=lead + (nx, nx))),
              f(0.05 * rng.normal(size=lead + (nx, nu))), f(rng.normal(size=lead + (nx,))),
              f(rng.normal(size=lead + (nu,))), f(Lx @ np.swapaxes(Lx, -1, -2) / nx),
              f((R * lam[..., None, :]) @ np.swapaxes(R, -1, -2)),
              f(0.1 * rng.normal(size=lead + (nu, nx))), f(rng.normal(size=(LANES, nx))),
              f(V @ np.swapaxes(V, -1, -2) / nx))
    box = (f(-rng.uniform(0.05, 1.0, lead + (nu,))), f(rng.uniform(0.05, 1.0, lead + (nu,))))
    return stacks, box


@pytest.mark.parametrize("dims", [(4, 2), (2, 1)])
@pytest.mark.parametrize("mode", ["clamp", "boxqp"])
def test_riccati_backward_explicit_plain_matches_pallas(dims, mode):
    """K4's explicit-terminal mode through its batch-first wrapper."""
    stacks, box = _stacks(*dims, seed=dims[0] + 10 * (mode == "boxqp"))
    assert 0.4 < (np.linalg.eigvalsh(stacks[5])[..., 0] < 0).mean() < 0.6
    bounds = box if mode == "boxqp" else (None, None)
    kw, Kw = riccati_backward_pallas(*(jnp.asarray(a) for a in stacks), interpret=True,
                                     lb=None if bounds[0] is None else jnp.asarray(bounds[0]),
                                     ub=None if bounds[1] is None else jnp.asarray(bounds[1]))
    opt = lambda a: None if a is None else torch.as_tensor(a)
    kg, Kg = k1.riccati_backward_pallas(*(torch.as_tensor(a) for a in stacks),
                                        lb=opt(bounds[0]), ub=opt(bounds[1]))
    np.testing.assert_allclose(kg.numpy(), np.asarray(kw), **TOL)
    np.testing.assert_allclose(Kg.numpy(), np.asarray(Kw), **TOL_K)
    if mode == "boxqp":
        assert (np.abs(np.asarray(Kw)).sum(-1) == 0).any()


@pytest.fixture(scope="module")
def lane_specs():
    from tests.problems import single_track_lane_ocp

    return (single_track_lane_ocp(horizon_steps=T_K).spec(),
            entry.single_track_spec(horizon=T_K, device="cpu"))


def _inputs(seed, lanes=LANES):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (T_K, lanes)), rng.uniform(-1.5, 1.5, (T_K, lanes)),
                  rng.uniform(-0.6, 0.6, (T_K, lanes)), rng.uniform(0, 2, (T_K, lanes))], 1)
    u = np.stack([rng.uniform(-0.7, 0.7, (T_K, lanes)), rng.uniform(-1, 1, (T_K, lanes))], 1)
    return x.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("discrete", [True, False])
def test_linearize_pallas_plain_matches_pallas(lane_specs, discrete):
    """K7 on 256 problems x T = 4: one 1024-lane tile of problem-stages."""
    jspec, tspec = lane_specs
    x, u = _inputs(20 + discrete, lanes=LANES // T_K)
    xs = np.concatenate([x, x[-1:]], 0).transpose(2, 0, 1).copy()    # [B, T+1, nx]
    us = u.transpose(2, 0, 1).copy()
    want = linearize_pallas(jspec, jnp.asarray(xs), jnp.asarray(us), discrete, interpret=True)
    got = k3.linearize_pallas(tspec, torch.as_tensor(xs), torch.as_tensor(us), discrete)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("hessians", [True, False])
def test_continuous_linearize_plain_matches_pallas(lane_specs, hessians):
    """K3's continuous-Jacobian mode (``discrete=False``)."""
    jspec, tspec = lane_specs
    x, u = _inputs(22 + hessians)
    want = linearize_pallas_tiled(jspec, _lanes(x), _lanes(u), False, True, hessians=hessians)
    got = k3.linearize(tspec, torch.as_tensor(x), torch.as_tensor(u), hessians, None, False)
    assert len(got) == len(want) == (7 if hessians else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


def test_continuous_fusedlin_plain_matches_pallas(lane_specs):
    """K1's continuous-Jacobian mode (``discrete=False``)."""
    jspec, tspec = lane_specs
    x, u = _inputs(24)
    xT = _inputs(25)[0][0]
    lin = k3.linearize_plain(tspec, torch.as_tensor(x[:1]), torch.as_tensor(u[:1]), True)
    hess = [h[0] for h in lin[4:]]
    k_w, K_w = riccati_fusedlin_pallas_tiled(
        _lanes(x), _lanes(u), *(_lanes(h.numpy())[:, None] for h in hess), _lanes(xT),
        dynamics=jspec.dynamics, stage_cost=jspec.stage_cost, terminal_fn=jspec.terminal_cost,
        dt=jspec.dt, discrete=False, reg_init=1e-6, reg_factor=10.0, reg_levels=16,
        interpret=True)
    k_g, K_g = k1.riccati_fusedlin(tspec, torch.as_tensor(x), torch.as_tensor(u), *hess,
                                   torch.as_tensor(xT), k1.reg_ladder(1e-6, 10.0, 16),
                                   discrete=False)
    np.testing.assert_allclose(k_g.numpy(), _unlanes(k_w), **TOL)
    np.testing.assert_allclose(K_g.numpy(), _unlanes(K_w), **TOL_K)


# -- the single-problem solve -------------------------------------------------

def test_single_solve_continuous_matches_reference_mirror():
    from tests.reference_mirror import ilqr_solve as mirror_ilqr
    from tests.test_ilqr import _single_track_callbacks

    ocp = entry.single_track_ocp(torch.float64, device="cpu")
    result = make_solver("ilqr", {**PARAMS, "continuous_jacobians": 1}, device="cpu").solve(ocp)
    X, U, cost, _ = mirror_ilqr(
        *_single_track_callbacks(), x0=np.array([0.0, 1.0, 0.0, 0.0]), U0=np.zeros((80, 2)),
        dt=0.1, max_iterations=10, tolerance=1e-5, input_lower=np.array([-0.7, -1.0]),
        input_upper=np.array([0.7, 1.0]))
    np.testing.assert_allclose(float(result.cost), cost, rtol=1e-9)
    np.testing.assert_allclose(result.controls.numpy(), U, atol=1e-8)
    np.testing.assert_allclose(result.states.numpy(), X, atol=1e-8)
    np.testing.assert_allclose(float(result.cost), 508.59306030, rtol=1e-6)
    assert ocp.best_cost == float(result.cost) and ocp.best_controls is result.controls


@pytest.fixture(scope="module")
def jax_single():
    """JAX's single solves of examples/single_track_ocp.py in float64: the
    default discrete mode, and with a speed cap through state_bounds_al."""
    from tests.problems import single_track_lane_ocp

    discrete = j_make_solver("ilqr", PARAMS).solve(single_track_lane_ocp())
    capped = single_track_lane_ocp(state_upper_bounds=jnp.array([np.inf, np.inf, np.inf, 0.8]),
                                   state_lower_bounds=jnp.array([-np.inf] * 4))
    bounded = j_make_solver("ilqr", {**PARAMS, "state_bounds_al": 1}).solve(capped)
    return discrete, bounded


def test_single_solve_discrete_matches_jax(jax_single):
    want = jax_single[0]
    got = make_solver("ilqr", PARAMS, device="cpu").solve(entry.single_track_ocp(
        torch.float64, device="cpu"))
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-9)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), atol=1e-8)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=1e-8)
    assert int(got.iterations) == int(want.iterations) and bool(got.converged)
    assert float(got.cost) < 181.0


def test_single_solve_state_bounds_al_matches_jax(jax_single):
    """``state_bounds_al=1`` folds the speed cap v <= 0.8 into an AL row."""
    want = jax_single[1]
    ocp = entry.single_track_ocp(torch.float64, device="cpu")
    ocp.state_upper_bounds = torch.tensor([np.inf, np.inf, np.inf, 0.8], dtype=torch.float64)
    ocp.state_lower_bounds = torch.full((4,), -np.inf, dtype=torch.float64)
    got = make_solver("ilqr", {**PARAMS, "state_bounds_al": 1}, device="cpu").solve(ocp)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-8)
    np.testing.assert_allclose(float(got.ineq_violation), float(want.ineq_violation), atol=1e-8)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=1e-7)
    assert float(got.ineq_violation) > 0.0      # the cap binds


def test_single_solve_enforce_max_ms_stops_after_an_iteration():
    """With ``enforce_max_ms`` the host-clock deadline, checked after each
    iteration, stops the solve; the iteration that saw it is kept."""
    params = {**PARAMS, "max_ms": 1e-6, "enforce_max_ms": 1}
    ocp = entry.single_track_ocp(torch.float64, device="cpu")
    t0 = time.perf_counter()
    got = make_solver("ilqr", params, device="cpu").solve(ocp)
    assert time.perf_counter() - t0 < 30.0
    one = make_solver("ilqr", {**PARAMS, "max_iterations": 1}, device="cpu").solve(
        entry.single_track_ocp(torch.float64, device="cpu"))
    assert int(got.iterations) == 1 and not bool(got.converged)
    assert torch.equal(got.controls, one.controls)
    free = make_solver("ilqr", {**PARAMS, "max_ms": 1e-6}, device="cpu").solve(
        entry.single_track_ocp(torch.float64, device="cpu"))
    assert int(free.iterations) > 1


# -- the non-fused batched solve ------------------------------------------------

def _lane_specs_both(batch=B, horizon=T, **overrides):
    """(JAX specs, port specs) of the lane-follow batch in float64, x0 from
    bench.py's generator; ``overrides`` replace fields of both OCPs (given
    as (JAX value, port value) pairs)."""
    from tests.problems import single_track_lane_ocp

    spec = single_track_lane_ocp(horizon_steps=horizon).spec()
    x0 = jnp.asarray(entry.bench_x0(batch), jnp.float64)
    jspecs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    jspecs = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jspecs)
    tspecs = spec_from_numpy({k: np.asarray(getattr(jspecs, k)) for k in LEAVES},
                             dynamics=single_track_model, stage_cost=entry.LANE_FOLLOW_COST,
                             terminal_cost=zero_terminal_cost, dt=spec.dt, horizon_steps=horizon,
                             device="cpu")
    return jspecs, tspecs


def _jax_config(**kw):
    return dataclasses.replace(J_BENCH, **kw)


def _objective_specs():
    """A user objective: the trajectory cost plus a terminal lane penalty
    written on the whole trajectory (no stage decomposition)."""
    jspecs, tspecs = _lane_specs_both()
    j_obj = lambda X, U: jspecs.objective_function(X, U) + 5.0 * X[..., -1, 1] ** 2
    t_obj = lambda X, U: tspecs.objective_function(X, U) + 5.0 * X[..., -1, 1] ** 2
    return (jspecs.replace(objective_function=j_obj, objective_is_default=False),
            tspecs.replace(objective_function=t_obj, objective_is_default=False))


def _unbatched_constraint_specs():
    """A speed cap written on one problem's vectors (``x[3]``): it fails on
    the port's batched values, so the port's kernels do not take it, and
    the non-fused path maps it per stage.  (JAX's lane tiles put the state
    index first, so its kernels trace ``x[3]``: the case runs the scan
    route, where neither side runs a kernel.)"""
    from multi_agent_solver_tpu.ocp import OCP as JOCP

    jspecs, tspecs = _lane_specs_both()
    j_con = lambda x, u: jnp.stack([x[3] - 0.3])
    t_con = lambda x, u: torch.stack([x[3] - 0.3])
    jocp = JOCP(state_dim=4, control_dim=2, horizon_steps=T, dt=0.1,
                initial_state=jnp.zeros(4), dynamics=jspecs.dynamics,
                stage_cost=jspecs.stage_cost, inequality_constraints=j_con)
    jocp.initialize_problem()
    jd = jocp.spec().derivs
    tocp = OCP(state_dim=4, control_dim=2, horizon_steps=T, dt=0.1,
               initial_state=torch.zeros(4, dtype=torch.float64), dynamics=single_track_model,
               stage_cost=entry.LANE_FOLLOW_COST, inequality_constraints=t_con, device="cpu")
    tocp.initialize_problem()
    td = tocp.spec().derivs
    return (jspecs.replace(inequality_constraints=j_con, ineq_dim=1,
                           derivs=jspecs.derivs.replace(ineq_gx=jd.ineq_gx, ineq_gu=jd.ineq_gu)),
            tspecs.replace(inequality_constraints=t_con, ineq_dim=1,
                           derivs=tspecs.derivs.replace(ineq_gx=td.ineq_gx, ineq_gu=td.ineq_gu)))


def _al_specs():
    """The lane-follow batch with the speed cap v <= 0.3 as a batched row
    (``bound_rows``): both routers' CPU ``auto`` takes the non-fused path
    with the select kernel's AL mode."""
    from multi_agent_solver_tpu.ocp import with_state_bound_constraints as j_bounds

    jspecs, tspecs = _lane_specs_both()
    cap = (np.inf, np.inf, np.inf, 0.3)
    jspecs = jax.vmap(lambda s: j_bounds(s.replace(
        state_upper_bounds=jnp.asarray(cap), state_lower_bounds=jnp.full(4, -jnp.inf))))(jspecs)
    row = bound_rows(("x", 3, 0.3, "upper"))
    tocp = OCP(state_dim=4, control_dim=2, horizon_steps=T, dt=0.1,
               initial_state=torch.zeros(4, dtype=torch.float64), dynamics=single_track_model,
               stage_cost=entry.LANE_FOLLOW_COST, inequality_constraints=row, device="cpu")
    tocp.initialize_problem()
    td = tocp.spec().derivs
    return jspecs, tspecs.replace(inequality_constraints=row, ineq_dim=1,
                                  derivs=tspecs.derivs.replace(ineq_gx=td.ineq_gx,
                                                               ineq_gu=td.ineq_gu))


def _context_specs():
    """The lane-follow batch tracking a per-stage lateral reference given
    as its context ``[B, T, 1]``."""
    from multi_agent_solver_tpu.ocp import with_context_cost as j_with_context_cost

    jspecs, tspecs = _lane_specs_both()
    ref = np.broadcast_to(np.linspace(0.0, 0.5, T)[None, :, None], (B, T, 1)).copy()

    def j_cost(x, u, t, c):
        return (10.0 * (x[1] - c[0]) ** 2 + (x[3] - 1.0) ** 2 + 0.1 * u[0] ** 2
                + 0.1 * u[1] ** 2)

    def t_cost(x, u, t, c):
        return (10.0 * (x[..., 1] - c[..., 0]) ** 2 + (x[..., 3] - 1.0) ** 2
                + 0.1 * u[..., 0] ** 2 + 0.1 * u[..., 1] ** 2)

    jspecs = jax.vmap(lambda s, c: j_with_context_cost(s, j_cost).replace(context=c))(
        jspecs, jnp.asarray(ref))
    return jspecs, with_context_cost(tspecs, t_cost).replace(context=torch.as_tensor(ref))


CASES = {
    # name: (specs builder, JAX config overrides, solve keyword arguments)
    "scan": (_lane_specs_both, {}, dict(backward="scan", fused=False)),
    "pallas": (_lane_specs_both, {}, dict(backward="pallas", fused=False)),
    "user_objective": (_objective_specs, {}, dict(fused=False)),
    "unbatched_constraint": (_unbatched_constraint_specs, dict(max_iterations=6),
                             dict(backward="scan")),
    "al_auto": (_al_specs, dict(max_iterations=8, tolerance=1e-8), {}),
    "context_auto": (_context_specs, {}, {}),
    "boxqp_scan": (_lane_specs_both, dict(bound_mode="boxqp"), dict(backward="scan",
                                                                    fused=False)),
}


@pytest.fixture(scope="module")
def jax_nonfused():
    """Each case's JAX solve, once (lazily: a case's first test runs it)."""
    cache = {}

    def get(case):
        if case not in cache:
            build, over, kw = CASES[case]
            jspecs, tspecs = build()
            cache[case] = (j_solve(jspecs, _jax_config(**over), **kw), tspecs)
        return cache[case]

    return get


def _port(case, tspecs, **extra):
    _, over, kw = CASES[case]
    config = config_from_dict(dataclasses.asdict(_jax_config(**over)))
    return solve_ilqr_batched(tspecs, config, device="cpu", **{**kw, **extra})


def _assert_matches(got, want, cost_tol, ctrl_atol):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **cost_tol)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), atol=ctrl_atol)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_nonfused_scan_matches_jax(jax_nonfused):
    """The torch scan functions alone: no kernel, float64 on both sides."""
    want, tspecs = jax_nonfused("scan")
    stats = (k1.EXPLICIT_STATS, k2.STATS, k3.FLAT_STATS, k2.ROLLOUT_STATS)
    for s in stats:
        s.reset()
    got = _port("scan", tspecs)
    _assert_matches(got, want, TOL_F64, 1e-9)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=1e-9)
    assert [s.plain_calls for s in stats] == [0, 0, 0, 0]


def test_nonfused_pallas_matches_jax(jax_nonfused):
    """The K2 rollout, then per iteration K4 explicit and K2 select (at the
    reference ladder) around the vmapped linearizer."""
    want, tspecs = jax_nonfused("pallas")
    stats = (k1.EXPLICIT_STATS, k2.STATS, k3.FLAT_STATS, k1.STATS, k3.STATS, k2.ROLLOUT_STATS)
    for s in stats:
        s.reset()
    got = _port("pallas", tspecs)
    it = int(got.iterations[0])
    _assert_matches(got, want, dict(rtol=1e-5), 2e-4)
    assert [s.plain_calls for s in stats] == [it, it, 0, 0, 0, 1]


def test_nonfused_linearize_pallas_matches_jax(jax_nonfused):
    """``linearize="pallas"``: K7 in place of the vmapped linearizer (it
    emits its own Hessians), against JAX's route with its vmapped one --
    the same stacks in float32 and float64 (JAX's own K7 route is held to
    it by the plain-versus-Pallas check of K7 above)."""
    want, tspecs = jax_nonfused("pallas")
    k3.FLAT_STATS.reset()
    got = _port("pallas", tspecs, linearize="pallas")
    _assert_matches(got, want, dict(rtol=1e-5), 2e-4)
    assert k3.FLAT_STATS.plain_calls == int(got.iterations[0])


def test_nonfused_user_objective_matches_jax(jax_nonfused):
    """A user objective: no K2 (the kernels accumulate only stage costs),
    the torch rollout and forward pass around K4 explicit."""
    want, tspecs = jax_nonfused("user_objective")
    assert ilqr.route(tspecs, entry.BENCH_CONFIG, fused=False, device_type="cpu") == ilqr.Route(
        fused=False, backward="pallas", lane_forward=False)
    k2.STATS.reset()
    k2.ROLLOUT_STATS.reset()
    got = _port("user_objective", tspecs)
    _assert_matches(got, want, dict(rtol=1e-5), 2e-4)
    assert k2.STATS.plain_calls == k2.ROLLOUT_STATS.plain_calls == 0


def test_nonfused_unbatched_constraint_matches_jax(jax_nonfused):
    """A constraint written for one problem's vectors is solved (the AL
    machinery maps it per stage), no longer refused."""
    want, tspecs = jax_nonfused("unbatched_constraint")
    assert not ilqr.route(tspecs, entry.BENCH_CONFIG, device_type="cpu").lane_forward
    got = _port("unbatched_constraint", tspecs)
    _assert_matches(got, want, TOL_F64, 1e-9)
    np.testing.assert_allclose(got.ineq_violation.numpy(), np.asarray(want.ineq_violation),
                               **TOL_F64)
    assert float(got.ineq_violation.max()) > 1e-3           # the cap binds


def test_nonfused_al_auto_route_matches_jax(jax_nonfused):
    """On the CPU both routers' ``fused="auto"`` send an AL solve to the
    non-fused path: K2 rollout, per iteration K4 explicit and the select
    kernel's AL mode (K6) through the batch-first wrapper, the torch AL
    fold and dual updates."""
    want, tspecs = jax_nonfused("al_auto")
    assert ilqr.route(tspecs, entry.BENCH_CONFIG, device_type="cpu") == ilqr.Route(
        fused=False, backward="pallas", lane_forward=True)
    stats = (k2.STATS, k2.AL_STATS, k1.EXPLICIT_STATS, k1.BACKWARD_STATS, k2.ROLLOUT_STATS)
    for s in stats:
        s.reset()
    got = _port("al_auto", tspecs)
    it = int(got.iterations[0])
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)
    np.testing.assert_allclose(got.ineq_violation.numpy(), np.asarray(want.ineq_violation),
                               atol=1e-4)
    assert float(got.ineq_violation.max()) > 1e-3           # the cap binds
    assert [s.plain_calls for s in stats] == [0, it, it, 0, 1]


def test_nonfused_context_auto_route_matches_jax(jax_nonfused):
    """On the CPU a context solve takes the non-fused path on both sides:
    the K2 rollout and select in context mode, K4 explicit."""
    want, tspecs = jax_nonfused("context_auto")
    assert ilqr.route(tspecs, entry.BENCH_CONFIG, device_type="cpu") == ilqr.Route(
        fused=False, backward="pallas", lane_forward=True)
    k2.CTX_STATS.reset()
    k2.ROLLOUT_STATS.reset()
    got = _port("context_auto", tspecs)
    _assert_matches(got, want, dict(rtol=1e-5), 2e-4)
    assert k2.CTX_STATS.plain_calls == int(got.iterations[0])
    assert k2.ROLLOUT_STATS.plain_calls == 1


def test_nonfused_boxqp_scan_matches_jax(jax_nonfused):
    """``bound_mode="boxqp"`` on the scan path: ops/boxqp.py's gains."""
    want, tspecs = jax_nonfused("boxqp_scan")
    got = _port("boxqp_scan", tspecs)
    _assert_matches(got, want, TOL_F64, 1e-9)
    assert (got.controls.abs() <= torch.tensor([0.7, 1.0], dtype=torch.float64) + 1e-12).all()


# -- routing --------------------------------------------------------------------

def test_untagged_problem_routes_nonfused_on_the_card():
    """On the card the kernels take only tagged callables: the lane-follow
    cost as a plain torch callable takes the non-fused path with the torch
    rollout and forward pass and K4 explicit, which evaluates no user
    function.  The router decides before the solve; nothing is launched."""
    tagged = entry.bench_specs(4, device="cpu", horizon=5)
    untagged = entry.untagged_specs(4, device="cpu", horizon=5)
    cfg = entry.BENCH_CONFIG
    assert ilqr.route(tagged, cfg, device_type="cuda") == ilqr.Route(fused=True)
    assert ilqr.route(untagged, cfg, device_type="cuda") == ilqr.Route(
        fused=False, backward="pallas", lane_forward=False, lane_linearize=False)
    assert ilqr.route(untagged, cfg, linearize="pallas", device_type="cuda").lane_linearize is False
    assert ilqr.route(untagged, cfg, device_type="cpu") == ilqr.Route(fused=True)
    assert ilqr.route(tagged, cfg, linearize="pallas", fused=False,
                      device_type="cuda").lane_linearize
    al = entry.state_bound_specs(4, device="cpu", horizon=5)
    assert ilqr.route(al, cfg, device_type="cuda").fused
    assert not ilqr.route(al, cfg, device_type="cpu").fused
    assert ilqr.route(al, dataclasses.replace(cfg, fused="on"), device_type="cpu").fused
    assert ilqr.route(tagged, cfg, backward="scan", device_type="cuda") == ilqr.Route(
        fused=False, backward="scan")


def test_explicit_mode_raises_for_a_pair_without_an_instantiation():
    """K4 explicit is instantiated per (nx, nu); another pair raises before
    any device work, naming the ROADMAP item."""
    z = lambda *s: torch.zeros(s)
    nx, nu, Tz, Bz = 3, 2, 2, 4
    assert (nx, nu) not in k1.EXPLICIT_DIMS
    with pytest.raises(NotImplementedError, match="model zoo"):
        k1.launch_riccati_explicit(z(Tz, nx, nx, Bz), z(Tz, nx, nu, Bz), z(Tz, nx, Bz),
                                   z(Tz, nu, Bz), z(Tz, nx, nx, Bz), z(Tz, nu, nu, Bz),
                                   z(Tz, nu, nx, Bz), z(nx, Bz), z(nx, nx, Bz),
                                   k1.reg_ladder(1e-6, 10.0, 16))


def test_rollout_select_nan_rollout_matches_jax():
    """``rollout_select`` on a problem whose controls hold a NaN: its cost
    does not beat +inf, so it is +inf, and its states are the rollout's, as
    the JAX kernel's alpha-0 phase 2 re-rolls them."""
    from multi_agent_solver_tpu.ops.forward_select_pallas import rollout_select as j_rollout

    jspecs, tspecs = _lane_specs_both(horizon=T_K)
    us = np.random.RandomState(30).uniform(-0.5, 0.5, (B, T_K, 2)).astype(np.float32)
    us[3, 2, 0] = np.nan
    x0 = entry.bench_x0(B)
    xs_w, cost_w = j_rollout(jspecs, jnp.asarray(x0), jnp.asarray(us), True)
    xs_g, cost_g = k2.rollout_select(tspecs, torch.as_tensor(x0), torch.as_tensor(us))
    assert np.isinf(np.asarray(cost_w)[3]) and np.isinf(float(cost_g[3]))
    np.testing.assert_allclose(cost_g.numpy(), np.asarray(cost_w), **TOL)
    np.testing.assert_allclose(xs_g.numpy(), np.asarray(xs_w), equal_nan=True, **TOL)
    assert np.isnan(xs_g.numpy()[3, -1]).any()
