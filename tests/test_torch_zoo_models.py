"""The model zoo (the rocket, the dynamic bicycle, both quadrotors, the
pendulum swing-up on its fused route) and the ``fd`` derivative mode
against the JAX package.

Inputs are drawn with numpy from a seed and handed to both sides.  The
model functions and their Jacobians are compared in float64 at rtol 1e-12
on seeded points and at the guards' kinks (the rocket's mass floor and the
bicycle's speed floor, ``max`` at and on both sides of its tie, where both
frameworks give the tangent 0.5; the quadrotor's ``cos theta`` at 0 and at
+-C_EPS and on both sides); the finite-difference stencils at rtol 1e-10.
The solves compare the float64 scan routes of both packages (``fused=False,
backward="scan"``) at rtol 1e-8 at B = 4, T = 12, and the port's float32
fused loop on the CPU (the plain versions of its kernels) against JAX's
float64 scan route at cost rtol 1e-4; the rocket's fd solves both
packages' float64 fd routes at rtol 1e-8.  The router is held to JAX's
decision for every model and for fd.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from multi_agent_solver_tpu import finite_differences as jfd
from multi_agent_solver_tpu.examples import pendulum_swing_up as jpend_ex
from multi_agent_solver_tpu.examples import rocket_max_altitude as jrocket_ex
from multi_agent_solver_tpu.models import dynamic_bicycle as jbike
from multi_agent_solver_tpu.models import quadrotor as jquad
from multi_agent_solver_tpu.models import quadrotor_rotor as jrotor
from multi_agent_solver_tpu.models import rocket as jrocket
from multi_agent_solver_tpu.ocp import OCP as JOCP
from multi_agent_solver_tpu.ops.forward_pallas import (
    spec_supports_lane_forward as j_supports_lane_forward)
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import _lane_cost_traceable as j_cost_traceable
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

import multi_agent_solver_tpu_torch.models as tmodels
from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch import finite_differences as tfd
from multi_agent_solver_tpu_torch.examples import pendulum_swing_up as tpend_ex
from multi_agent_solver_tpu_torch.examples import rocket_max_altitude as trocket_ex
from multi_agent_solver_tpu_torch.models import dynamic_bicycle as tbike
from multi_agent_solver_tpu_torch.models import quadrotor as tquad
from multi_agent_solver_tpu_torch.models import quadrotor_rotor as trotor
from multi_agent_solver_tpu_torch.models import rocket as trocket
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, Route, route, solve_ilqr_batched
from multi_agent_solver_tpu_torch.types import device_fn_of

torch.set_num_threads(1)

RTOL = 1e-12
PARAMS = trocket.RocketParameters(initial_mass=1.0, gravity=9.81, exhaust_velocity=50.0)
C_EPS = tquad.C_EPS


def _kink_points(model, seed):
    """Seeded states and controls of ``model``, with the rows at and on
    both sides of its guards' kinks."""
    rng = np.random.RandomState(seed)
    up = lambda v: np.nextafter(v, np.inf)
    down = lambda v: np.nextafter(v, -np.inf)
    if model == "rocket":
        x = rng.uniform(-3.0, 3.0, (8, 3))
        x[:3, 2] = (down(1e-6), 1e-6, up(1e-6))
        u = rng.uniform(0.0, 20.0, (8, 1))
    elif model == "bicycle":
        x = rng.uniform(-3.0, 3.0, (8, 6))
        x[:3, 3] = (down(0.5), 0.5, up(0.5))
        x[3, 3] = 15.0
        u = rng.uniform(-0.5, 0.5, (8, 2))
    else:
        nx = 12 if model == "quadrotor" else 16
        x = rng.uniform(-1.0, 1.0, (12, nx))
        # cos(theta) at 0, +-C_EPS and on both sides of each.
        c_eps = np.arccos(C_EPS)
        x[:9, 7] = (np.pi / 2, down(np.pi / 2), up(np.pi / 2),
                    c_eps, down(c_eps), up(c_eps), np.pi - c_eps, down(np.pi - c_eps),
                    up(np.pi - c_eps))
        u = rng.uniform(0.0, 12.0, (12, 4))
    return x, u


MODELS = {
    "rocket": (jrocket.make_rocket_dynamics(jrocket.RocketParameters(1.0, 9.81, 50.0)),
               trocket_ex.ROCKET_DYNAMICS),
    "bicycle": (jbike.dynamic_bicycle_model, tbike.dynamic_bicycle_model),
    "quadrotor": (jquad.quadrotor_dynamics, tquad.quadrotor_dynamics),
    "quadrotor_rotor": (jrotor.quadrotor_rotor_dynamics, trotor.quadrotor_rotor_dynamics),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_model_and_jacobians_match_jax(model):
    """f and its Jacobians (``jax.jacfwd`` / ``torch.func.jacfwd``) in
    float64 at seeded points and at the guards' kinks."""
    jf, tf = MODELS[model]
    x, u = _kink_points(model, 3)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(tf(tx, tu).numpy(), np.asarray(jax.vmap(jf)(x, u)), rtol=RTOL,
                               atol=1e-13)
    for arg in (0, 1):
        want = np.asarray(jax.vmap(jax.jacfwd(jf, argnums=arg))(x, u))
        got = torch.func.vmap(jacfwd(tf, argnums=arg))(tx, tu).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


def test_guards_take_jax_tangents_at_their_ties():
    """At an exact tie ``max`` / ``min`` give the tangent 0.5 in both
    frameworks: the rocket's mass at 1e-6, the bicycle's speed at 0.5."""
    jf, tf = MODELS["rocket"]
    x, u = np.array([1.0, 2.0, 1e-6]), np.array([3.0])
    want = np.asarray(jax.jacfwd(jf)(x, u))
    got = jacfwd(tf)(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[1, 2] == pytest.approx(-0.5 * 3.0 / 1e-12)
    jf, tf = MODELS["bicycle"]
    x, u = np.array([0.0, 0.0, 0.1, 0.5, 0.2, 0.3]), np.array([0.1, 1.0])
    want = np.asarray(jax.jacfwd(jf)(x, u))
    np.testing.assert_allclose(jacfwd(tf)(torch.as_tensor(x), torch.as_tensor(u)).numpy(), want,
                               rtol=RTOL)


def test_rocket_analytic_jacobians_match_jax():
    x, u = _kink_points("rocket", 4)
    for j_make, t_make in ((jrocket.make_rocket_state_jacobian, trocket.make_rocket_state_jacobian),
                           (jrocket.make_rocket_control_jacobian,
                            trocket.make_rocket_control_jacobian)):
        want = np.asarray(jax.vmap(j_make(jrocket.RocketParameters(1.0, 9.81, 50.0)))(x, u))
        got = t_make(PARAMS)(torch.as_tensor(x), torch.as_tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_models_export_and_tags():
    """``models`` exports the JAX package's names; each dynamics carries
    the tag of its device function with the parameter count and (nx, nu)
    that ops/_build.py expects."""
    import multi_agent_solver_tpu.models as jmodels
    assert set(jmodels.__all__) <= set(tmodels.__all__)
    assert tmodels.HOVER_THRUST == jmodels.HOVER_THRUST
    assert tmodels.HOVER_ROTOR_THRUST == jmodels.HOVER_ROTOR_THRUST
    for fn, dims in ((trocket_ex.ROCKET_DYNAMICS, (3, 1)), (tbike.dynamic_bicycle_model, (6, 2)),
                     (tquad.quadrotor_dynamics, (12, 4)),
                     (trotor.quadrotor_rotor_dynamics, (16, 4)),
                     (tmodels.pendulum_dynamics, (2, 1))):
        tag = device_fn_of(fn)
        assert _build.dynamics_dims(tag.name) == dims
        assert len(tag.params) == _build._param_count(tag, *dims)


@pytest.mark.parametrize("t", [0, 17, 59])
def test_pendulum_swing_up_cost_matches_jax(t):
    """The swing-up's stage cost at stage t, as an integer and as the float
    K1 and K3 hand it, and its terminal cost, against JAX in float64; the
    tags name PendulumSwingUp (the span T - 1 = 59 first) and its
    terminal."""
    x = np.random.RandomState(t).uniform(-3.0, 3.0, (5, 2))
    u = np.random.RandomState(t + 1).uniform(-5.0, 5.0, (5, 1))
    j_ocp = jpend_ex.create_pendulum_swingup_ocp()
    t_ocp = tpend_ex.create_pendulum_swingup_ocp(torch.float64, "cpu")
    want = np.asarray(jax.vmap(lambda a, b: j_ocp.stage_cost(a, b, jnp.asarray(t)))(x, u))
    for k in (t, torch.tensor(float(t), dtype=torch.float64)):
        got = t_ocp.stage_cost(torch.as_tensor(x), torch.as_tensor(u), k).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(t_ocp.terminal_cost(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.vmap(j_ocp.terminal_cost)(x)), rtol=RTOL)
    stage, term = device_fn_of(t_ocp.stage_cost), device_fn_of(t_ocp.terminal_cost)
    assert stage.name == "pendulum_swing_up" and stage.params[0] == 59.0
    assert term.name == "pendulum_swing_up_terminal"


def test_finite_differences_match_jax():
    """Every stencil of ``finite_differences.py`` against JAX's in float64
    at rtol 1e-10: the Jacobians on the bicycle's dynamics, the gradient,
    Hessian and cross stencils on a polynomial cost; the shooting gradient
    on the rocket's rollout at rtol 1e-8 (below)."""
    x = np.array([0.3, -1.2, 0.2, 12.0, 0.4, -0.1])
    u = np.array([0.05, 0.7])
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    jf, tf = jbike.dynamic_bicycle_model, tbike.dynamic_bicycle_model
    close = lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                                    atol=1e-10)
    close(tfd.fd_jacobian(lambda y: tf(y, tu), tx), jfd.fd_jacobian(lambda y: jf(y, u), x))
    close(tfd.fd_jacobian(lambda w: tf(tx, w), tu), jfd.fd_jacobian(lambda w: jf(x, w), u))
    # A cost both frameworks evaluate to the same bits (products and sums
    # in one order, no transcendental): the Hessian stencils divide by
    # eps^2 = 1e-10, which would lift a last-ulp difference to 1e-6.
    poly = lambda a, b: (((a[0] * a[1] + a[2] * a[2] * a[3]) + a[4] * b[0] * b[0] * b[0])
                         + b[1] * b[1] * a[5]) + 3.0 * b[0] * b[1]
    jl = tl = poly
    close(tfd.fd_gradient(lambda y: tl(y, tu), tx), jfd.fd_gradient(lambda y: jl(y, u), x))
    close(tfd.fd_hessian(lambda w: tl(tx, w), tu), jfd.fd_hessian(lambda w: jl(x, w), u))
    close(tfd.fd_hessian(lambda y: tl(y, tu), tx), jfd.fd_hessian(lambda y: jl(y, u), x))
    close(tfd.fd_cross_term(tl, tx, tu), jfd.fd_cross_term(jl, x, u))
    # A non-finite probe reads as 0.
    inf_at = lambda y: 1.0 / (y[0] - 0.3)
    np.testing.assert_array_equal(tfd.safe_eval(inf_at, tx).numpy(),
                                  np.asarray(jfd.safe_eval(inf_at, x)))
    # The shooting gradient on the rocket's rollout, of an objective summed
    # stage by stage in both frameworks, at rtol 1e-8: XLA:CPU rounds the
    # RK4 rollout apart from torch in the last ulp of the cost, which the
    # central difference's 1 / (2 eps) = 5e5 lifts to ~3e-9 of the gradient.
    def objective(X, U):
        total = -15.0 * X[-1, 0] + X[-1, 1] * X[-1, 1]
        for t in range(U.shape[0]):
            total = total + 0.0025 * U[t, 0] * U[t, 0]
        return total

    us = np.random.RandomState(5).uniform(0.0, 20.0, (8, 1))
    want = jfd.finite_differences_gradient(jnp.array([0.0, 0.0, 1.5]), jnp.asarray(us),
                                           MODELS["rocket"][0], objective, 0.1)
    got = tfd.finite_differences_gradient(torch.tensor([0.0, 0.0, 1.5], dtype=torch.float64),
                                          torch.as_tensor(us), MODELS["rocket"][1], objective, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)


def test_fd_derivative_bundles_match_jax():
    """The ``fd`` bundle of ``derivatives.py`` and the discrete-step fd
    Jacobians of ``ocp.py`` against the JAX package's, in float64 (rtol
    1e-10), on the bicycle lane change."""
    j_spec, t_spec = _bicycle_pair(12, mode="fd")
    x = np.array([0.3, 1.2, 0.2, 14.0, 0.4, -0.1])
    u = np.array([0.05, 0.7])
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    jd, td = j_spec.derivs, t_spec.derivs
    for name in ("fx", "fu", "step_fx", "step_fu"):
        np.testing.assert_allclose(getattr(td, name)(tx, tu).numpy(),
                                   np.asarray(getattr(jd, name)(x, u)), rtol=1e-10, atol=1e-10)
    for name in ("lx", "lu", "lxx", "luu", "lux"):
        np.testing.assert_allclose(getattr(td, name)(tx, tu, 3).numpy(),
                                   np.asarray(getattr(jd, name)(x, u, 3)), rtol=1e-10, atol=1e-7)
    np.testing.assert_allclose(td.phix(tx).numpy(), np.asarray(jd.phix(x)), atol=1e-12)


# The solves: each model's JAX problem (its test's or script's) and the
# port's (entry's), batched over one x0 draw.
def _bicycle_pair(T, mode="ad"):
    j_ocp = JOCP(
        state_dim=6, control_dim=2, horizon_steps=T, dt=0.05,
        initial_state=jnp.array([0.0, 2.0, 0.0, 15.0, 0.0, 0.0]),
        dynamics=jbike.dynamic_bicycle_model,
        stage_cost=lambda x, u, t: (2.0 * x[1] ** 2 + 0.5 * x[2] ** 2 + 0.05 * (x[3] - 15.0) ** 2
                                    + 2.0 * u[0] ** 2 + 0.1 * u[1] ** 2),
        input_lower_bounds=jnp.array([-0.4, -4.0]), input_upper_bounds=jnp.array([0.4, 2.0]),
        derivative_mode=mode)
    j_ocp.initialize_problem()
    t_ocp = OCP(
        state_dim=6, control_dim=2, horizon_steps=T, dt=0.05,
        initial_state=torch.tensor([0.0, 2.0, 0.0, 15.0, 0.0, 0.0], dtype=torch.float64),
        dynamics=tbike.dynamic_bicycle_model, stage_cost=entry.BICYCLE_COST,
        input_lower_bounds=torch.tensor([-0.4, -4.0], dtype=torch.float64),
        input_upper_bounds=torch.tensor([0.4, 2.0], dtype=torch.float64),
        derivative_mode=mode, device="cpu")
    t_ocp.initialize_problem()
    t_spec = t_ocp.spec()
    return j_ocp.spec(), t_spec


def _quad_pair(model, T):
    from zoo_anchors import quadrotor_rotor_spec, quadrotor_spec
    j_spec = (quadrotor_spec if model == "quadrotor" else quadrotor_rotor_spec)()[0]
    j_spec = j_spec.replace(initial_controls=j_spec.initial_controls[:T], horizon_steps=T)
    make = entry.quadrotor_spec if model == "quadrotor" else entry.quadrotor_rotor_spec
    return j_spec, make(T, torch.float64, "cpu")


def _rocket_pair(T, mode="ad"):
    j_ocp = jrocket_ex.create_max_altitude_rocket_ocp()
    t_ocp = trocket_ex.create_max_altitude_rocket_ocp(torch.float64, "cpu")
    for o in (j_ocp, t_ocp):
        o.horizon_steps = T
        o.initial_controls = o.initial_controls[:T]
        o.derivative_mode = mode
    j_ocp.initialize_problem()
    t_ocp.initialize_problem()
    return j_ocp.spec(), t_ocp.spec()


X0 = {"rocket": lambda B: entry.rocket_x0(B, 1), "bicycle": lambda B: entry.bicycle_x0(B, 1),
      "quadrotor": lambda B: entry.quadrotor_x0(B, 1),
      "quadrotor_rotor": lambda B: entry.quadrotor_x0(B, 1, nx=16)}
CONFIGS = {"rocket": entry.ROCKET_CONFIG, "bicycle": entry.BICYCLE_CONFIG,
           "quadrotor": entry.QUADROTOR_CONFIG, "quadrotor_rotor": entry.QUADROTOR_CONFIG}


def _pair(model, T, mode="ad"):
    if model == "rocket":
        return _rocket_pair(T, mode)
    if model == "bicycle":
        return _bicycle_pair(T, mode)
    return _quad_pair(model, T)


def _batched_pair(model, B, T, iterations, mode="ad"):
    j_spec, t_spec = _pair(model, T, mode)
    x0 = X0[model](B).astype(np.float64)
    j_specs = jax.vmap(lambda s0: j_spec.replace(initial_state=s0))(jnp.asarray(x0))
    cfg = dataclasses.replace(CONFIGS[model], max_iterations=iterations)
    j_cfg = JConfig(max_iterations=cfg.max_iterations, tolerance=cfg.tolerance)
    return j_specs, entry.batch_specs(t_spec, x0), cfg, j_cfg


# (B, T, iterations) of each model's solves: B = 4, T = 12; the quadrotors'
# plain fused loop takes its Hessians (the hoist's 136 / 210 entries and
# K1's terminal 78 / 136) by jvp over jvp, ~40 ms an entry on the CPU, so
# the quadrotor runs one iteration at B = 1, T = 3 there and the rotor
# quadrotor's fused loop is held on the card alone (chip_smoke.py phase
# 29, and tests/test_torch_zoo_cpu.py's g++ build of its kernels).
SOLVES = {"rocket": (4, 12, 25), "bicycle": (4, 12, 10), "quadrotor": (2, 6, 4),
          "quadrotor_rotor": (2, 6, 4)}
FUSED = {"rocket": SOLVES["rocket"], "bicycle": SOLVES["bicycle"], "quadrotor": (1, 3, 1)}
_JAX = {}


def _jax_reference(model, sizes):
    """JAX's float64 scan solve of ``model`` at ``sizes`` (B, T,
    iterations), once."""
    if (model, sizes) not in _JAX:
        j_specs, _, _, j_cfg = _batched_pair(model, *sizes)
        _JAX[model, sizes] = j_solve(j_specs, j_cfg, backward="scan", fused=False)
    return _JAX[model, sizes]


@pytest.mark.parametrize("model", list(SOLVES))
def test_scan_solve_matches_jax(model):
    """The float64 scan routes of both packages at rtol 1e-8."""
    _, t_specs, cfg, _ = _batched_pair(model, *SOLVES[model])
    want = _jax_reference(model, SOLVES[model])
    got = solve_ilqr_batched(t_specs, cfg, backward="scan", fused=False, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-8)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))


@pytest.mark.parametrize("model", list(FUSED))
def test_fused_float32_matches_jax(model):
    """The port's float32 fused loop on the CPU (the plain versions of K2,
    K3's hoist and K1) against JAX's float64 scan route, cost rtol 1e-4."""
    B, T, its = FUSED[model]
    _, _, cfg, _ = _batched_pair(model, B, T, its)
    want = _jax_reference(model, FUSED[model])
    _, t_spec = _pair(model, T)
    t_spec = t_spec.replace(**{k: (None if v is None else v.to(torch.float32)) for k, v in (
        ("initial_state", t_spec.initial_state), ("initial_controls", t_spec.initial_controls),
        ("input_lower_bounds", t_spec.input_lower_bounds),
        ("input_upper_bounds", t_spec.input_upper_bounds))})
    t32 = entry.batch_specs(t_spec, X0[model](B))
    assert route(t32, cfg, device_type="cpu").fused
    got = solve_ilqr_batched(t32, cfg, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)


def test_rocket_fd_solve_matches_jax():
    """``derivative_mode="fd"``: both packages' float64 fd routes (the
    finite-difference oracles under the example's analytic overrides) at
    rtol 1e-8."""
    j_specs, t_specs, cfg, j_cfg = _batched_pair("rocket", 4, 12, 10, mode="fd")
    assert t_specs.derivative_mode == "fd"
    want = j_solve(j_specs, j_cfg, backward="scan", fused=False)
    got = solve_ilqr_batched(t_specs, cfg, backward="scan", fused=False, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-8)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), rtol=1e-8,
                               atol=1e-8)


def _per_component(fn):
    """The JAX form of a tagged diagonal quadratic cost: its weights and
    targets, summed component by component on ``x[i]``."""
    p = device_fn_of(fn).params
    if device_fn_of(fn).name == "diag_quadratic_terminal":
        n = len(p) // 2
        return lambda x: sum(p[i] * (x[i] - p[n + i]) ** 2 for i in range(n))
    nx = 16 if len(p) == 40 else 12
    w, r, wu, ru = p[:nx], p[nx:2 * nx], p[2 * nx:2 * nx + 4], p[2 * nx + 4:]
    return lambda x, u, t: (sum(w[i] * (x[i] - r[i]) ** 2 for i in range(nx))
                            + sum(wu[i] * (u[i] - ru[i]) ** 2 for i in range(4)))


@pytest.mark.parametrize("model", list(SOLVES) + ["pendulum", "rocket_fd"])
def test_route_matches_jax_router(model):
    """The port's route on the card's terms against the JAX router's
    decision off its interpreter: every zoo model fuses (nx <= 16, nu <= 4,
    its functions traceable), the pendulum too (its cost reads the stage
    index, which the device functions now take), and fd takes the
    non-fused path with the K2 rollout and select and K4 but no K7
    (JAX's ``derivative_mode == "ad"`` gates)."""
    if model == "pendulum":
        j_spec = jpend_ex.create_pendulum_swingup_ocp().spec()
        t_spec = tpend_ex.create_pendulum_swingup_ocp(device="cpu").spec()
        mode, name = "ad", model
    else:
        name, mode = (("rocket", "fd") if model == "rocket_fd" else (model, "ad"))
        j_spec, t_spec = _pair(name, 6, mode)
    if name.startswith("quadrotor"):
        # The script's and test's costs sum with jnp.sum over the state
        # vector, which JAX's lane trace refuses (layout-driven routing,
        # ROADMAP section 3); the port's tagged diagonal costs, written per
        # component, trace, and JAX fuses them too.
        j_spec = j_spec.replace(stage_cost=_per_component(t_spec.stage_cost),
                                terminal_cost=_per_component(t_spec.terminal_cost))
    t_specs = entry.batch_specs(t_spec, t_spec.initial_state[None].numpy())
    j_specs = jax.tree_util.tree_map(lambda a: a[None], j_spec)
    nx, nu = t_spec.state_dim, t_spec.control_dim
    j_lane = j_supports_lane_forward(j_specs, None)
    j_fused = j_lane and mode == "ad" and j_cost_traceable(j_specs, nx, nu)
    for linearize in ("xla", "pallas"):
        got = route(t_specs, ILQRConfig(), linearize=linearize, device_type="cuda")
        assert got.fused is j_fused
        if not j_fused:
            assert got == Route(False, "pallas", lane_forward=j_lane, lane_linearize=False)
    assert j_fused is (mode == "ad")
