"""The last three TPU kernels' plain versions against the Pallas kernels, on
the CPU: K8 (the select kernel's emit mode), K9 (the first-generation
all-alpha forward pass) and K10 (the terminal derivatives).

Both sides run float32 arithmetic in the same order at one 1024-lane tile
and T = 4, on the same inputs drawn with numpy from a seed; XLA:CPU's and
PyTorch's float32 sin / cos / tan / exp differ in the last ulps, so values
are held to rtol = atol = 1e-5, as tests/test_torch_kernels.py holds K2 and
K3, and with a context (pair costs up to 25, Hessian entries ~10) to rtol
1e-5, atol 1e-4, as tests/test_torch_coupled.py.  K10 on a quadratic
terminal cost has no transcendental: rtol 1e-6.  The CUDA kernels run only
on the card, where chip_smoke.py holds them against these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.examples import multi_agent_single_track as j_circ
from multi_agent_solver_tpu.ocp import with_context_cost as j_with_context_cost
from multi_agent_solver_tpu.ops.forward_pallas import forward_pass_pallas as j_forward_pass
from multi_agent_solver_tpu.ops.forward_pallas import rollout_pallas as j_rollout
from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.ops.linearize_pallas import terminal_derivs_tiled as j_terminal
from multi_agent_solver_tpu.strategies.nash import make_coupled_stage as j_coupled_stage

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as t_circ
from multi_agent_solver_tpu_torch.ocp import diagonal_quadratic_terminal_cost, with_context_cost
from multi_agent_solver_tpu_torch.ops import _build, forward_pallas as k9
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.strategies.nash import make_coupled_stage

torch.set_num_threads(1)

B, T, NX, NU, K = 1024, 4, 4, 2, 3
TOL = dict(rtol=1e-5, atol=1e-5)
CTX_TOL = dict(rtol=1e-5, atol=1e-4)
LADDER = (1.0, 0.5, 0.125)
# A quadratic terminal cost with a device function, and its JAX twin.
W_T, R_T = (2.0, 3.0, 0.5, 1.5), (1.0, -0.5, 0.2, 1.0)
T_TERMINAL = diagonal_quadratic_terminal_cost(W_T, R_T)


def _j_terminal(x):
    c = W_T[0] * (x[0] - R_T[0]) ** 2
    for i in range(1, NX):
        c = c + W_T[i] * (x[i] - R_T[i]) ** 2
    return c


@pytest.fixture(scope="module")
def lane_specs():
    """(JAX spec, port spec) of the lane-follow problem at T = 4."""
    from tests.problems import single_track_lane_ocp

    return (single_track_lane_ocp(horizon_steps=T).spec(),
            entry.single_track_spec(horizon=T, device="cpu"))


def _coupled_specs():
    """(JAX spec, port spec) of one car of the coupled game."""
    jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
    jspec = j_with_context_cost(jspec, j_coupled_stage(jspec.stage_cost,
                                                      j_circ.make_collision_cost(25.0)))
    tspec = t_circ.create_single_track_circular_ocp(0.0, device="cpu").spec()
    tspec = with_context_cost(tspec, make_coupled_stage(tspec.stage_cost,
                                                       t_circ.make_collision_cost(25.0)))
    return jspec, tspec


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def _lane_inputs(seed):
    """Lane-follow states, controls in the box and gains."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (T, B)), rng.uniform(-1.5, 1.5, (T, B)),
                  rng.uniform(-0.6, 0.6, (T, B)), rng.uniform(0, 2, (T, B))], 1)
    u = np.stack([rng.uniform(-0.7, 0.7, (T, B)), rng.uniform(-1, 1, (T, B))], 1)
    k = rng.uniform(-0.3, 0.3, (T, NU, B))
    Kg = rng.uniform(-0.2, 0.2, (T, NU, NX, B))
    return tuple(a.astype(np.float32) for a in (x, u, k, Kg))


def _ring_inputs(seed):
    """States around the track, controls in the box, gains, and K
    neighbours per (stage, problem) within ~3 of the car."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, (T, B))
    r = 20.0 + rng.uniform(-1, 1, (T, B))
    x = np.stack([r * np.cos(th), r * np.sin(th), th + 1.57, rng.uniform(3, 6, (T, B))], 1)
    u = rng.uniform(-0.5, 0.5, (T, NU, B))
    k = rng.uniform(-0.3, 0.3, (T, NU, B))
    Kg = rng.uniform(-0.2, 0.2, (T, NU, NX, B))
    ctx = x[:, None] + np.concatenate(
        [rng.normal(0, 2.0, (T, K, 2, B)), rng.normal(0, 0.5, (T, K, 2, B))], 2)
    return tuple(a.astype(np.float32) for a in (x, u, k, Kg, ctx))


@pytest.mark.parametrize("case", ["lane discrete", "lane continuous", "context discrete",
                                  "lane AL discrete"])
def test_emit_lin_plain_matches_pallas(lane_specs, case):
    """K8: the select outputs and the seven linearization stacks at the
    accepted trajectory agree with the Pallas kernel's ``emit_lin`` mode,
    in both Jacobian modes, with a context, and with AL multipliers on the
    speed cap (``entry.SPEED_CAP``, speeds about the cap) -- which the
    select's merit takes and the stacks do not."""
    discrete = case.endswith("discrete")
    al = {}
    if case.startswith("context"):
        jspec, tspec = _coupled_specs()
        x, u, k, Kg, ctx = _ring_inputs(31)
        bound, tol = 0.5, CTX_TOL
    else:
        jspec, tspec = lane_specs
        (x, u, k, Kg), ctx = _lane_inputs(30), None
        bound, tol = 1.0, TOL
    if "AL" in case:
        jspec = jspec.replace(inequality_constraints=lambda x, u: jnp.array([x[3] - 4.5]),
                              ineq_dim=1)
        tspec = tspec.replace(inequality_constraints=entry.SPEED_CAP, ineq_dim=1)
        x = x.copy()
        x[:, 3] += 3.0
        arng = np.random.RandomState(35)
        mult = (arng.uniform(0, 3, (T, 1, B)) * (arng.uniform(size=(T, 1, B)) < 0.7))
        al = dict(ineq_mult=mult.astype(np.float32),
                  rho=(10.0 ** arng.uniform(0, 3, B)).astype(np.float32))
    tctx = None if ctx is None else torch.as_tensor(ctx)
    _, cost0 = k2.rollout_cost_plain(tspec, torch.as_tensor(x[0]), torch.as_tensor(u), tctx)
    rng = np.random.RandomState(32)
    merit = (cost0.numpy() * rng.uniform(*((0.9, 1.4) if al else (0.8, 1.2)), B)).astype(np.float32)
    lb = np.stack([np.full(B, -0.5 if ctx is not None else -0.7, np.float32),
                   np.full(B, -bound, np.float32)])
    ub = -lb
    want = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(Kg), _lanes(merit), _lanes(lb),
        _lanes(ub), LADDER, True, ctx_l=None if ctx is None else _lanes(ctx),
        ineq_mult_l=_lanes(al["ineq_mult"]) if al else None,
        rho_l=_lanes(al["rho"]) if al else None, act_tol=1e-3, emit_lin=True,
        lin_discrete=discrete)
    k2.EMIT_STATS.reset()
    got = k2.forward_select_emit_lin(tspec, *(torch.as_tensor(a) for a in (x, u, k, Kg, merit)),
                                     torch.as_tensor(lb), torch.as_tensor(ub), LADDER, tctx,
                                     discrete, act_tol=1e-3,
                                     **{n: torch.as_tensor(a) for n, a in al.items()})
    assert (k2.EMIT_STATS.plain_calls, k2.EMIT_STATS.launches) == (1, 0)
    assert len(got) == len(want) == 11
    accept = _unlanes(want[3]) > 0.5
    assert 0 < accept.sum() < B
    np.testing.assert_array_equal(got[3].numpy(), accept)
    np.testing.assert_allclose(got[2].numpy(), _unlanes(want[2]), rtol=1e-5)
    for name, g, w in zip(("xs", "us", "", "", "A", "B", "lx", "lu", "lxx", "luu", "lux"), got,
                          want):
        if name:
            np.testing.assert_allclose(g.numpy(), _unlanes(w), **tol, err_msg=name)
    # The stacks are K3's at the accepted (x_t, u_t).
    xs_stage = torch.cat([torch.as_tensor(x[:1]), got[0][:-1]], 0)
    lin = k3.linearize_plain(tspec, xs_stage, got[1], True, tctx, discrete)
    for g, w in zip(got[4:], lin):
        assert torch.equal(g, w)


def test_emit_lin_takes_al_only_as_the_plain_version(lane_specs):
    """K8 with AL multipliers, the plain version: the AL terms enter the
    merit, and the emitted stacks stay the un-augmented cost's."""
    _, tspec = lane_specs
    spec = tspec.replace(inequality_constraints=entry.SPEED_CAP, ineq_dim=1)
    x, u, k, Kg = (torch.as_tensor(a) for a in _lane_inputs(33))
    merit = torch.full((B,), 1e9)
    mult, rho = torch.ones(T, 1, B), torch.full((B,), 10.0)
    plain = k2.forward_select_emit_lin(spec, x, u, k, Kg, merit, None, None, LADDER,
                                       ineq_mult=mult, rho=rho)
    free = k2.forward_select_emit_lin(spec, x, u, k, Kg, merit, None, None, LADDER)
    assert bool(plain[3].all()) and torch.equal(plain[0], free[0])
    for g, w in zip(plain[4:], free[4:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bounded", [True, False])
def test_forward_pass_plain_matches_pallas(lane_specs, bounded):
    """K9: every candidate's trajectory, controls and cost, with and without
    the clamp, at 256 problems x 3 candidates (one lane tile)."""
    jspec, tspec = lane_specs
    if not bounded:
        jspec = jspec.replace(input_lower_bounds=None, input_upper_bounds=None)
        tspec = tspec.replace(input_lower_bounds=None, input_upper_bounds=None)
    n = B // 4
    x, u, k, Kg = (a[..., :n] for a in _lane_inputs(34))
    xs = np.concatenate([x, x[-1:]], 0).transpose(2, 0, 1)            # [n, T+1, nx]
    us, ks, Ks = u.transpose(2, 0, 1), k.transpose(2, 0, 1), Kg.transpose(3, 0, 1, 2)
    alphas = np.array(LADDER, np.float32)
    want = j_forward_pass(jspec, *(jnp.asarray(a) for a in (xs, us, ks, Ks, alphas)), True)
    k9.STATS.reset()
    got = k9.forward_pass_pallas(tspec, *(torch.as_tensor(a) for a in (xs, us, ks, Ks)), alphas)
    assert (k9.STATS.plain_calls, k9.STATS.launches) == (1, 0)
    assert [tuple(g.shape) for g in got] == [(n, 3, T + 1, NX), (n, 3, T, NU), (n, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    clamped = np.abs(got[1].numpy()).max(axis=(0, 1, 2))
    assert (clamped <= [0.7, 1.0]).all() == bounded


def test_rollout_pallas_plain_matches_pallas(lane_specs):
    """K9's plain rollout: alpha 0, zero gains, no clamp (controls beyond the
    bounds are applied raw)."""
    jspec, tspec = lane_specs
    x, u, _, _ = _lane_inputs(35)
    x0, us = x[0].T, 2.0 * u.transpose(2, 0, 1)
    xs_w, cost_w = j_rollout(jspec, jnp.asarray(x0), jnp.asarray(us), True)
    xs_g, cost_g = k9.rollout_pallas(tspec, torch.as_tensor(x0), torch.as_tensor(us))
    np.testing.assert_allclose(xs_g.numpy(), np.asarray(xs_w), **TOL)
    np.testing.assert_allclose(cost_g.numpy(), np.asarray(cost_w), **TOL)
    # The select kernel's rollout mode computes the same rollout.
    xs_k2, cost_k2 = k2.rollout_select(tspec, torch.as_tensor(x0), torch.as_tensor(us))
    np.testing.assert_allclose(xs_g.numpy(), xs_k2.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cost_g.numpy(), cost_k2.numpy(), rtol=1e-6)


@pytest.mark.parametrize("terminal", ["quadratic", "zero"])
def test_terminal_derivs_plain_matches_pallas(lane_specs, terminal):
    """K10: phi_x and the symmetrized phi_xx per problem; its plain version
    is the terminal path of K1's and K4's plain versions."""
    jspec, tspec = lane_specs
    if terminal == "quadratic":
        jspec, tspec = jspec.replace(terminal_cost=_j_terminal), tspec.replace(
            terminal_cost=T_TERMINAL)
    xT = _lane_inputs(36)[0][0]                                        # [nx, B]
    gx_w, hxx_w = j_terminal(jspec, _lanes(xT), True)
    k3.TERMINAL_STATS.reset()
    gx, hxx = k3.terminal_derivs_tiled(tspec, torch.as_tensor(xT))
    assert (k3.TERMINAL_STATS.plain_calls, k3.TERMINAL_STATS.launches) == (1, 0)
    assert gx.shape == (NX, B) and hxx.shape == (NX, NX, B)
    np.testing.assert_allclose(gx.numpy(), _unlanes(gx_w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hxx.numpy(), _unlanes(hxx_w), rtol=1e-6, atol=1e-6)
    assert torch.equal(hxx, hxx.transpose(0, 1))
    vx, vxx = k1.terminal_derivatives(tspec.terminal_cost, torch.as_tensor(xT).T)
    assert torch.equal(gx, torch.stack(vx))
    if terminal == "quadratic":
        np.testing.assert_allclose(hxx[:, :, 0].numpy(), 2.0 * np.diag(W_T), rtol=1e-6)


def test_new_kernels_name_their_instantiations(lane_specs):
    """Symbols of K8, K9 and K10 from the device-function tags; an untagged
    callable raises NotImplementedError before any launch."""
    _, tspec = lane_specs
    fns = (tspec.dynamics, tspec.stage_cost, tspec.terminal_cost)
    assert _build.problem_symbol("forward_select_emit", NX, NU, *fns)[0] == \
        "mas_forward_select_emit__single_track__diag_quadratic__zero"
    assert _build.problem_symbol("forward_pass", NX, NU, *fns)[0] == \
        "mas_forward_pass__single_track__diag_quadratic__zero"
    symbol, params = _build.problem_symbol("terminal_derivs", NX, NU, tspec.dynamics, T_TERMINAL)
    assert symbol == "mas_terminal_derivs__single_track__diag_quadratic_terminal"
    assert params[1] == W_T + R_T
    untagged = tspec.replace(terminal_cost=lambda x: x[..., 0] ** 2)
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k3.launch_terminal_derivs_tiled(untagged, torch.zeros(NX, 8))
    x, u, k, Kg = (torch.as_tensor(a[..., :8].copy()) for a in _lane_inputs(37))
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k9.launch_forward_pass(untagged, x, u, k, Kg, LADDER)
    with pytest.raises(NotImplementedError, match="device-function tag"):
        k2.launch_forward_select_emit_lin(untagged, x, u, k, Kg, torch.zeros(8), None, None,
                                          LADDER)
