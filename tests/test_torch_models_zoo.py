"""The port's pendulum and cart-pole models and their examples against the
JAX package.

Inputs are drawn with numpy from a seed and handed to both sides.  The
model functions are plain arithmetic, compared in float64 at rtol 1e-12
(the last-ulp difference of XLA:CPU's and PyTorch's sin/cos).  The solves
compare the float64 scan routes of both packages (``fused=False,
backward="scan"``) at rtol 1e-8, and the port's float32 fused loop on the
CPU (the plain versions of its kernels) against JAX's float64 scan route
at float32 tolerance (cost rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.examples.cartpole_swing_up import (
    create_cartpole_swingup_ocp as j_cartpole_ocp,
)
from multi_agent_solver_tpu.examples.pendulum_swing_up import (
    create_pendulum_swingup_ocp as j_pendulum_ocp,
)
from multi_agent_solver_tpu.models import cartpole as jcp
from multi_agent_solver_tpu.models import pendulum as jpd
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.examples.cartpole_swing_up import create_cartpole_swingup_ocp
from multi_agent_solver_tpu_torch.examples.pendulum_swing_up import create_pendulum_swingup_ocp
from multi_agent_solver_tpu_torch.models import cartpole as tcp
from multi_agent_solver_tpu_torch.models import pendulum as tpd
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, route, solve_ilqr_batched
from multi_agent_solver_tpu_torch.types import device_fn_of

torch.set_num_threads(1)

RTOL = 1e-12


def _points(seed, nx, nu, B=7):
    rng = np.random.RandomState(seed)
    return rng.uniform(-3.0, 3.0, (B, nx)), rng.uniform(-5.0, 5.0, (B, nu))


def _jax(fn, x, u=None):
    args = (jnp.asarray(x),) if u is None else (jnp.asarray(x), jnp.asarray(u))
    return np.asarray(jax.vmap(fn)(*args))


@pytest.mark.parametrize("name", ["pendulum_dynamics", "pendulum_state_jacobian",
                                  "pendulum_control_jacobian"])
def test_pendulum_functions_match_jax(name):
    x, u = _points(0, 2, 1)
    got = getattr(tpd, name)(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), _jax(getattr(jpd, name), x, u), rtol=RTOL,
                               atol=1e-14)


def test_cartpole_functions_match_jax():
    x, u = _points(1, 4, 1)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(tcp.cartpole_dynamics(tx, tu).numpy(),
                               _jax(jcp.cartpole_dynamics, x, u), rtol=RTOL, atol=1e-13)
    want = _jax(lambda a, b: jcp.cartpole_swing_up_stage_cost(a, b, 0), x, u)
    np.testing.assert_allclose(tcp.cartpole_swing_up_stage_cost(tx, tu, 0).numpy(), want,
                               rtol=RTOL)
    np.testing.assert_allclose(tcp.cartpole_swing_up_terminal_cost(tx).numpy(),
                               _jax(jcp.cartpole_swing_up_terminal_cost, x), rtol=RTOL)


def test_cartpole_derivatives_match_jax():
    """The AD oracles of the port's cart-pole spec (torch.func) against
    ``jax.jacfwd`` / ``jax.hessian`` of the JAX functions, in float64."""
    x, u = _points(2, 4, 1, B=1)
    x, u = x[0], u[0]
    d = create_cartpole_swingup_ocp(torch.float64, "cpu").spec().derivs
    tx, tu, t = torch.as_tensor(x), torch.as_tensor(u), torch.tensor(0)
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    stage = lambda a, b: jcp.cartpole_swing_up_stage_cost(a, b, 0)
    pairs = [
        (d.fx(tx, tu), jax.jacfwd(jcp.cartpole_dynamics, 0)(jx, ju)),
        (d.fu(tx, tu), jax.jacfwd(jcp.cartpole_dynamics, 1)(jx, ju)),
        (d.step_fx(tx, tu), jax.jacfwd(lambda a: _rk4(a, ju), 0)(jx)),
        (d.lx(tx, tu, t), jax.grad(stage, 0)(jx, ju)),
        (d.lxx(tx, tu, t), jax.hessian(stage, 0)(jx, ju)),
        (d.luu(tx, tu, t), jax.hessian(stage, 1)(jx, ju)),
        (d.phixx(tx), jax.hessian(jcp.cartpole_swing_up_terminal_cost)(jx)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def _rk4(x, u):
    from multi_agent_solver_tpu.integrators import integrate_rk4

    return integrate_rk4(x, u, 0.05, jcp.cartpole_dynamics)


def test_cartpole_tags_name_their_device_functions():
    """The three callables carry the tags of csrc/problems.cuh's Cartpole,
    CartpoleSwingUp and CartpoleSwingUpTerminal, with the parameter counts
    ops/_build.py expects, and K3's symbol resolves for (4, 1)."""
    spec = create_cartpole_swingup_ocp(device="cpu").spec()
    tags = [device_fn_of(f) for f in (spec.dynamics, spec.stage_cost, spec.terminal_cost)]
    assert [t.name for t in tags] == ["cartpole", "cartpole_swing_up",
                                      "cartpole_swing_up_terminal"]
    m_l, m_g = tags[0].params[4:]
    assert m_l == np.float32(tcp.M_POLE * tcp.L_POLE)
    assert m_g == np.float32((tcp.M_CART + tcp.M_POLE) * tcp.G)
    symbol, _ = _build.problem_symbol("linearize", 4, 1, spec.dynamics, spec.stage_cost)
    assert symbol == "mas_linearize__cartpole__cartpole_swing_up"
    with pytest.raises(ValueError, match=r"\(4, 1\)"):
        _build.problem_symbol("linearize", 4, 2, spec.dynamics, spec.stage_cost)


def test_examples_match_jax():
    """The examples' problems: initial state, warm start, bounds, horizon
    and the warm start's rolled-out cost, in float64."""
    for t_make, j_make in ((create_pendulum_swingup_ocp, j_pendulum_ocp),
                           (create_cartpole_swingup_ocp, j_cartpole_ocp)):
        t_ocp, j_ocp = t_make(torch.float64, "cpu"), j_make()
        for name in ("initial_state", "initial_controls", "input_lower_bounds",
                     "input_upper_bounds", "initial_states"):
            np.testing.assert_allclose(getattr(t_ocp, name).numpy(),
                                       np.asarray(getattr(j_ocp, name)), rtol=RTOL,
                                       atol=1e-14)
        assert (t_ocp.horizon_steps, t_ocp.dt) == (j_ocp.horizon_steps, j_ocp.dt)
        np.testing.assert_allclose(t_ocp.best_cost, float(j_ocp.best_cost), rtol=1e-11)


# The cart-pole balanced upright: a quadratic cost around theta = pi over
# half a second (T = 10), from zero controls.  The swing-up's backward
# recursion is ill-conditioned (its q_uu falls to -8e12 from the hanging
# start, and a 1e-13 relative move of lxx moves JAX's own gains by 3e3), so
# two implementations of it part after one iteration even in float64; the
# balancing problem runs the same model and solver where the recursion is
# well-conditioned and every problem converges.
BALANCE_W = (1.0, 10.0, 0.1, 0.1, 0.01)
BALANCE_T = 10


def _balance_stage(x, u, t):
    w_p, w_th, w_v, w_w, w_u = BALANCE_W
    return (w_p * x[..., 0] ** 2 + w_th * (x[..., 1] - np.pi) ** 2 + w_v * x[..., 2] ** 2
            + w_w * x[..., 3] ** 2 + w_u * u[..., 0] ** 2)


def _balance_terminal(x):
    return 10.0 * _balance_stage(x, x[..., :1] * 0.0, 0)


def _balance_ocps(dtype):
    from multi_agent_solver_tpu.ocp import OCP as JOCP

    from multi_agent_solver_tpu_torch.ocp import OCP

    common = dict(state_dim=4, control_dim=1, horizon_steps=BALANCE_T, dt=0.05,
                  stage_cost=_balance_stage, terminal_cost=_balance_terminal)
    j_ocp = JOCP(dynamics=jcp.cartpole_dynamics, initial_state=jnp.zeros(4),
                 input_lower_bounds=jnp.array([-12.0]), input_upper_bounds=jnp.array([12.0]),
                 **common)
    t_ocp = OCP(dynamics=tcp.cartpole_dynamics, initial_state=torch.zeros(4, dtype=dtype),
                input_lower_bounds=torch.tensor([-12.0]), input_upper_bounds=torch.tensor([12.0]),
                device="cpu", **common)
    j_ocp.initialize_problem()
    t_ocp.initialize_problem()
    return j_ocp, t_ocp


def _cartpole_both(B, dtype=torch.float64, balance=False):
    x0 = entry.cartpole_x0(B).astype(np.float64)
    if balance:
        rng = np.random.RandomState(3)
        x0[:, 0] = rng.uniform(-0.2, 0.2, B)
        x0[:, 1] = np.pi + rng.uniform(-0.1, 0.1, B)
        j_ocp, t_ocp = _balance_ocps(dtype)
    else:
        j_ocp, t_ocp = j_cartpole_ocp(), create_cartpole_swingup_ocp(dtype, "cpu")
    j_spec = j_ocp.spec()
    j_specs = jax.vmap(lambda s0: j_spec.replace(initial_state=s0))(jnp.asarray(x0))
    return j_specs, entry.batch_specs(t_ocp.spec(), x0)


def test_cartpole_batched_solve_matches_jax():
    """Five cart-poles balanced upright, 8 iterations: the float64 scan
    routes at rtol 1e-8, and the port's float32 fused loop (the plain
    versions of K2, K3 and K4 on the CPU) at cost rtol 1e-4."""
    j_specs, t_specs = _cartpole_both(5, balance=True)
    cfg = dict(max_iterations=8, tolerance=1e-7)
    want = j_solve(j_specs, JConfig(**cfg), backward="scan", fused=False)
    got = solve_ilqr_batched(t_specs, ILQRConfig(**cfg), backward="scan", fused=False,
                             device="cpu")
    cost0 = t_specs.cost(t_specs.rollout(t_specs.initial_controls), t_specs.initial_controls)
    assert bool((torch.as_tensor(np.asarray(want.cost)) < cost0).all())
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-8)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))

    _, t32 = _cartpole_both(5, torch.float32, balance=True)
    assert route(t32, ILQRConfig(**cfg), device_type="cpu").fused
    fused = solve_ilqr_batched(t32, ILQRConfig(**cfg), device="cpu")
    np.testing.assert_allclose(fused.cost.numpy(), np.asarray(want.cost), rtol=1e-4)
    np.testing.assert_allclose(fused.controls.numpy(), np.asarray(want.controls), atol=2e-3)


def test_cartpole_swing_up_first_iteration_matches_jax():
    """The swing-up batch itself: its first rollout, and the stage
    derivatives of its first iteration against JAX's float64
    ``_linearize`` -- the port's float64 scan function at rtol 1e-10, the
    plain version of K3 (float32, Hessians included) at rtol 1e-5 with a
    floor of 1e-5; then the port's float32 fused general branch lowers
    every cost."""
    from multi_agent_solver_tpu.solvers.ilqr import _linearize as j_linearize
    from multi_agent_solver_tpu_torch.ops import linearize as k3
    from multi_agent_solver_tpu_torch.solvers.ilqr import _linearize

    j_specs, t_specs = _cartpole_both(4)
    j_xs = jax.vmap(lambda s: s.rollout(s.initial_controls))(j_specs)
    t_xs = t_specs.rollout(t_specs.initial_controls)
    np.testing.assert_allclose(t_xs.numpy(), np.asarray(j_xs), rtol=1e-12, atol=1e-13)
    want = jax.vmap(lambda s, xs: j_linearize(s, JConfig(), xs, s.initial_controls))(j_specs, j_xs)
    us = t_specs.initial_controls
    got = _linearize(t_specs, ILQRConfig(), t_xs, us)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    x = t_xs[:, :-1].permute(1, 2, 0).to(torch.float32).contiguous()
    u = us.permute(1, 2, 0).to(torch.float32).contiguous()
    for g, w in zip(k3.linearize_plain(t_specs, x, u, True), want):
        w = np.moveaxis(np.asarray(w), 0, -1)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())

    _, t32 = _cartpole_both(4, torch.float32)
    cost0 = t32.cost(t32.rollout(t32.initial_controls), t32.initial_controls)
    result = solve_ilqr_batched(t32, ILQRConfig(max_iterations=4, tolerance=1e-7), device="cpu")
    assert bool(torch.isfinite(result.states).all()) and bool((result.cost < cost0).all())


def test_cartpole_and_pendulum_routes_on_the_card():
    """On the card's terms the tagged cart-pole fuses (the general branch
    on the kernels), and so does the pendulum swing-up, whose tagged cost
    reads the stage index that the device functions now take; an untagged
    cart-pole cost takes the non-fused path without the lane kernels, as
    the router decides -- never a silent fallback."""
    config = ILQRConfig(max_iterations=3, tolerance=1e-7)
    specs = entry.cartpole_specs(4, device="cpu")
    assert route(specs, config, device_type="cuda").fused
    untagged = specs.replace(stage_cost=lambda x, u, t: tcp.cartpole_swing_up_stage_cost(x, u, t))
    decision = route(untagged, config, device_type="cuda")
    assert not decision.fused and not decision.lane_forward and decision.backward == "pallas"
    pend = create_pendulum_swingup_ocp(device="cpu").spec()
    pend = entry.batch_specs(pend, pend.initial_state[None].numpy())
    assert route(pend, config, device_type="cuda").fused
