"""Each kernel module's plain version against its Pallas kernel, and the
wrappers' dispatch, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).  Here the plain PyTorch versions
meet the Pallas kernels in interpret mode at one 1024-lane tile and T = 4,
on the same float32 inputs drawn with numpy from a seed.  Both sides run
float32 arithmetic in the same order; XLA:CPU's and PyTorch's float32
sin/cos/tan differ in the last ulps, so the tolerance is rtol = atol = 1e-5,
and 1e-4 on the feedback gains K, which the Riccati recursion amplifies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.ops.forward_select_pallas import forward_select_pallas_tiled
from multi_agent_solver_tpu.ops.linearize_pallas import linearize_pallas_tiled
from multi_agent_solver_tpu.ops.riccati_pallas import riccati_fusedlin_pallas_tiled

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1

torch.set_num_threads(1)

B, T, NX, NU = 1024, 4, 4, 2
TOL = dict(rtol=1e-5, atol=1e-5)
LADDER = (1.0, 0.5, 0.125)


@pytest.fixture(scope="module")
def specs():
    from tests.problems import single_track_lane_ocp

    return (single_track_lane_ocp(horizon_steps=T).spec(),
            entry.single_track_spec(horizon=T, device="cpu"))


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (T, B)), rng.uniform(-1.5, 1.5, (T, B)),
                  rng.uniform(-0.6, 0.6, (T, B)), rng.uniform(0, 2, (T, B))], 1)
    u = np.stack([rng.uniform(-0.7, 0.7, (T, B)), rng.uniform(-1, 1, (T, B))], 1)
    return x.astype(np.float32), u.astype(np.float32)


def test_linearize_plain_matches_pallas(specs):
    jspec, tspec = specs
    x, u = _inputs(0)
    want = linearize_pallas_tiled(jspec, _lanes(x), _lanes(u), True, True, hessians=True)
    got = k3.linearize_plain(tspec, torch.as_tensor(x), torch.as_tensor(u), True)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)


def _hessians(tspec):
    x, u = _inputs(1)
    lin = k3.linearize_plain(tspec, torch.as_tensor(x[:1]), torch.as_tensor(u[:1]), True)
    return [h[0] for h in lin[4:]]          # [nx, nx, B], [nu, nu, B], [nu, nx, B]


def test_riccati_fusedlin_plain_matches_pallas(specs):
    jspec, tspec = specs
    x, u = _inputs(2)
    xT = _inputs(3)[0][0]
    hess = _hessians(tspec)
    levels = k1.reg_ladder(1e-6, 10.0, 16)
    k_w, K_w = riccati_fusedlin_pallas_tiled(
        _lanes(x), _lanes(u), *(_lanes(h.numpy())[:, None] for h in hess), _lanes(xT),
        dynamics=jspec.dynamics, stage_cost=jspec.stage_cost,
        terminal_fn=jspec.terminal_cost, dt=jspec.dt, discrete=True,
        reg_init=1e-6, reg_factor=10.0, reg_levels=16, interpret=True, time_unroll=2,
    )
    k_g, K_g = k1.riccati_fusedlin_plain(
        tspec, torch.as_tensor(x), torch.as_tensor(u), *hess, torch.as_tensor(xT), levels)
    np.testing.assert_allclose(k_g.numpy(), _unlanes(k_w), **TOL)
    np.testing.assert_allclose(K_g.numpy(), _unlanes(K_w), rtol=1e-4, atol=1e-4)


def test_forward_select_rollout_mode_matches_pallas(specs):
    """alpha = 0, zero gains, bounds stripped, merit +inf: the initial rollout."""
    jspec, tspec = specs
    x, u = _inputs(4)
    x0 = x[0]
    zk, zK = np.zeros((T, NU, B), np.float32), np.zeros((T, NU, NX, B), np.float32)
    zb = np.zeros((NU, B), np.float32)
    plain = jspec.replace(input_lower_bounds=None, input_upper_bounds=None)
    xs_w, _, cost_w, _ = forward_select_pallas_tiled(
        plain, _lanes(np.broadcast_to(x0, (T, NX, B))), _lanes(u), _lanes(zk), _lanes(zK),
        _lanes(np.full(B, np.inf, np.float32)), _lanes(zb), _lanes(zb), (0.0,), True,
    )
    xs_g, cost_g = k2.rollout_cost_plain(tspec, torch.as_tensor(x0), torch.as_tensor(u))
    np.testing.assert_allclose(xs_g.numpy(), _unlanes(xs_w), **TOL)
    np.testing.assert_allclose(cost_g.numpy(), _unlanes(cost_w), **TOL)


def test_forward_select_stage_out_mode_matches_pallas(specs):
    """Stage-out mode with the bench ladder, bounds, and frozen problems:
    trajectories, merit, accept flags and x_T all agree."""
    jspec, tspec = specs
    x, u = _inputs(5)
    rng = np.random.RandomState(6)
    xT = _inputs(7)[0][0]
    k = rng.uniform(-0.3, 0.3, (T, NU, B)).astype(np.float32)
    K = rng.uniform(-0.5, 0.5, (T, NU, NX, B)).astype(np.float32)
    merit = rng.uniform(0, 60, B).astype(np.float32)
    active = rng.uniform(size=B) < 0.8
    lb = np.broadcast_to(np.array([[-0.7], [-1.0]], np.float32), (NU, B)).copy()
    ub = -lb
    xs_w, us_w, merit_w, accept_w, xT_w = forward_select_pallas_tiled(
        jspec, _lanes(x), _lanes(u), _lanes(k), _lanes(K), _lanes(merit), _lanes(lb),
        _lanes(ub), LADDER, True, active_l=_lanes(active.astype(np.float32)),
        xT_l=_lanes(xT), time_unroll=2,
    )
    bufs = [torch.as_tensor(a.copy()) for a in (x, u, xT)]
    merit_g, accept_g = k2.forward_select_plain(
        tspec, *bufs, torch.as_tensor(k), torch.as_tensor(K), torch.as_tensor(merit),
        torch.as_tensor(active), torch.as_tensor(lb), torch.as_tensor(ub), LADDER)
    accept_want = _unlanes(accept_w) > 0.5
    assert 0 < accept_want.sum() < B
    np.testing.assert_array_equal(accept_g.numpy(), accept_want)
    np.testing.assert_allclose(merit_g.numpy(), _unlanes(merit_w), **TOL)
    for g, w in zip(bufs, (xs_w, us_w, xT_w)):
        np.testing.assert_allclose(g.numpy(), _unlanes(w), **TOL)
    # Rejected and frozen problems keep the reference verbatim.
    keep = ~accept_g.numpy()
    np.testing.assert_array_equal(bufs[0].numpy()[:, :, keep], x[:, :, keep])
    np.testing.assert_array_equal(bufs[2].numpy()[:, keep], xT[:, keep])


def test_cpu_tensors_take_the_plain_versions(specs):
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay at 0 and the plain counters move."""
    _, tspec = specs
    x, u = _inputs(8)
    xt, ut = torch.as_tensor(x[:, :, :16]).contiguous(), torch.as_tensor(u[:, :, :16]).contiguous()
    stats = (k1.STATS, k2.STATS, k3.STATS)
    for s in stats:
        s.reset()
    lin = k3.linearize(tspec, xt[:1].contiguous(), ut[:1].contiguous(), True)
    xs_tail, cost = k2.rollout_cost(tspec, xt[0].contiguous(), ut)
    k, K = k1.riccati_fusedlin(tspec, xt, ut, *(h[0] for h in lin[4:]), xs_tail[-1].clone(),
                               k1.reg_ladder(1e-6, 10.0, 16))
    k2.forward_select(tspec, xt.clone(), ut.clone(), xs_tail[-1].clone(), k, K, cost,
                      torch.ones(16, dtype=torch.bool), None, None, LADDER)
    assert [s.launches for s in stats] == [0, 0, 0]
    assert [s.plain_calls for s in stats] == [1, 2, 1]


def test_problem_symbol_names_the_instantiation(specs):
    _, tspec = specs
    symbol, params = _build.problem_symbol(
        "riccati_fusedlin", NX, NU, tspec.dynamics, tspec.stage_cost, tspec.terminal_cost)
    assert symbol == "mas_riccati_fusedlin__single_track__diag_quadratic__zero"
    assert params == [(2.5,), (0.0, 10.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.1, 0.1, 0.0, 0.0), ()]
    with pytest.raises(NotImplementedError, match="device-function tag"):
        _build.problem_symbol("linearize", NX, NU, tspec.dynamics, lambda x, u, t: x[..., 0])
    with pytest.raises(ValueError, match="nx, nu"):
        _build.problem_symbol("linearize", 3, NU, tspec.dynamics, tspec.stage_cost)
