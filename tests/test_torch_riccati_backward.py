"""K4 (the Riccati pass on precomputed stacks), K5 (the box-QP stage solve)
and the fused-loop branches that run them, against the JAX package.

The plain PyTorch versions meet the Pallas kernels in interpret mode at one
1024-lane tile and T = 4 on the same float32 inputs drawn with numpy from a
seed, as in tests/test_torch_kernels.py: rtol = atol = 1e-5 on the
feedforward gains k, 1e-4 on the feedback gains K, which the recursion
amplifies.  K5 is called directly on lane arrays; it is float32 arithmetic
in the same order on both sides, so its tolerance is 1e-6 and the selected
active sets must agree.  The solves run the port's plain versions on the CPU
against JAX's ``solve_ilqr_batched`` (Pallas in interpret mode) in the same
branch, with the tolerances of tests/test_fused_loop.py for two float32
implementations of one algorithm: cost rtol 1e-5, controls atol 2e-4.
Under boxqp the active-set choice takes exact KKT comparisons, and on this
problem it is knife-edge: a 1e-7 relative change of x0 moves JAX's own
converged controls by up to 2.1e-3 at equal cost, so there the controls
are held to atol 3e-3 (and to their box) while the cost keeps rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.examples import multi_agent_single_track as j_circ
from multi_agent_solver_tpu.ops.riccati_pallas import (
    _boxqp_lane_gains,
    riccati_backward_pallas_tiled,
    riccati_fusedlin_pallas_tiled,
)
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

from chip_smoke import SWEEP_ANCHOR, SWEEP_ITERATIONS
from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.derivatives import make_derivatives
from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as t_circ
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.ocp import zero_terminal_cost
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.solvers.ilqr import solve_ilqr_batched
from multi_agent_solver_tpu_torch.utils.carry import config_from_dict, spec_from_numpy

torch.set_num_threads(1)

B, T, NX, NU = 1024, 4, 4, 2
TOL_k = dict(rtol=1e-5, atol=1e-5)
TOL_K = dict(rtol=1e-4, atol=1e-4)
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)
LEAVES = ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")


def _lanes(a: np.ndarray):
    """Port layout ``[..., 1024]`` -> one JAX lane tile ``[1, ..., 8, 128]``."""
    return jnp.asarray(a.reshape(a.shape[:-1] + (8, 128))[None], jnp.float32)


def _unlanes(a) -> np.ndarray:
    a = np.asarray(a)[0]
    return a.reshape(a.shape[:-2] + (B,))


def _j_terminal(x):
    return 0.5 * x[1] ** 2 + 0.1 * x[0] * x[3]


def _t_terminal(x):
    return 0.5 * x[..., 1] ** 2 + 0.1 * x[..., 0] * x[..., 3]


def _t_time_varying(x, u, t):
    return (10.0 * (1.0 + 0.05 * t) * x[..., 1] ** 2 + (x[..., 3] - 1.0) ** 2
            + 0.1 * (u[..., 0] ** 2 + u[..., 1] ** 2))


def _tv_spec():
    """The lane-follow problem with tests/test_fused_loop.py's time-varying
    weights: cost Hessians that differ by stage."""
    spec = entry.single_track_spec(horizon=T, device="cpu")
    return spec.replace(stage_cost=_t_time_varying, terminal_cost=_t_terminal,
                        derivs=make_derivatives(single_track_model, _t_time_varying, _t_terminal))


def _states_controls(seed):
    """Lane-follow states and controls inside the +-0.7 / +-1 box (the
    inputs of tests/test_torch_kernels.py)."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (T, B)), rng.uniform(-1.5, 1.5, (T, B)),
                  rng.uniform(-0.6, 0.6, (T, B)), rng.uniform(0, 2, (T, B))], 1)
    u = np.stack([rng.uniform(-0.7, 0.7, (T, B)), rng.uniform(-1, 1, (T, B))], 1)
    return x.astype(np.float32), u.astype(np.float32)


BOX = np.array([[0.7], [1.0]], np.float32)


@pytest.fixture(scope="module")
def stacks():
    """K4's inputs from the port's plain K3 (per-stage Hessians of the
    time-varying cost), a terminal state, and the delta bounds of the
    lane-follow box around the controls."""
    x, u = _states_controls(0)
    lin = k3.linearize_plain(_tv_spec(), torch.as_tensor(x), torch.as_tensor(u), True)
    xT = _states_controls(1)[0][0]
    return [a.numpy() for a in lin], xT, (-BOX - u).astype(np.float32), (BOX - u).astype(np.float32)


def _k4_pallas(lin, xT, lb=None, ub=None, hess_tconst=False):
    k, K = riccati_backward_pallas_tiled(
        *(_lanes(a) for a in lin), _lanes(xT), jnp.zeros((1, NX, NX, 8, 128), jnp.float32),
        reg_init=1e-6, reg_factor=10.0, reg_levels=16, interpret=True,
        lb_l=None if lb is None else _lanes(lb), ub_l=None if ub is None else _lanes(ub),
        terminal_fn=_j_terminal, hess_tconst=hess_tconst)
    return _unlanes(k), _unlanes(K)


@pytest.mark.parametrize("mode", ["per_stage", "hess_tconst", "boxqp"])
def test_riccati_backward_plain_matches_pallas(stacks, mode):
    lin, xT, lb, ub = stacks
    if mode == "hess_tconst":
        lin = lin[:4] + [h[:1] for h in lin[4:]]
    bounds = (lb, ub) if mode == "boxqp" else (None, None)
    k_w, K_w = _k4_pallas(lin, xT, *bounds, hess_tconst=mode == "hess_tconst")
    opt = lambda a: None if a is None else torch.as_tensor(a)
    k_g, K_g = k1.riccati_backward_plain(
        _tv_spec(), *(torch.as_tensor(a) for a in lin), torch.as_tensor(xT), LEVELS,
        opt(bounds[0]), opt(bounds[1]))
    np.testing.assert_allclose(k_g.numpy(), k_w, **TOL_k)
    np.testing.assert_allclose(K_g.numpy(), K_w, **TOL_K)
    if mode == "boxqp":
        # Some stage solves end on the box: feedback rows zeroed there.
        assert (np.abs(K_w).sum(1) == 0).any()


def test_boxqp_lane_gains_plain_matches_pallas():
    """K5 alone on lane arrays: random SPD q_uu, gradients and boxes that
    contain zero, so interior, one-sided and corner solutions all occur."""
    rng = np.random.RandomState(2)
    n = 4096
    L = rng.normal(size=(NU, NU, n))
    Q = np.einsum("ikb,jkb->ijb", L, L) + 0.1 * np.eye(NU)[:, :, None]
    q_u = rng.normal(size=(NU, n))
    q_ux = rng.normal(size=(NU, NX, n))
    lb = -rng.uniform(0.05, 1.0, (NU, n))
    ub = rng.uniform(0.05, 1.0, (NU, n))
    arrays = [a.astype(np.float32) for a in (Q, q_u, q_ux, lb, ub)]

    def nested(a, conv):
        if a.ndim == 2:
            return [conv(r) for r in a]
        return [[conv(c) for c in r] for r in a]

    k_w, K_w = _boxqp_lane_gains(*(nested(a, jnp.asarray) for a in arrays[:3]),
                                 nested(arrays[3], jnp.asarray), nested(arrays[4], jnp.asarray),
                                 NU, NX)
    k_g, K_g = k1.boxqp_lane_gains_plain(*(nested(a, torch.as_tensor) for a in arrays), NU, NX)
    k_w, k_g = np.stack(k_w), torch.stack(k_g).numpy()
    K_w = np.stack([np.stack(r) for r in K_w])
    K_g = torch.stack([torch.stack(r) for r in K_g]).numpy()
    np.testing.assert_allclose(k_g, k_w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(K_g, K_w, rtol=1e-6, atol=1e-6)
    # The same active sets: the same rows at the box, with zero feedback.
    at_box = lambda k: (k <= arrays[3] + 1e-7) | (k >= arrays[4] - 1e-7)
    np.testing.assert_array_equal(at_box(k_g), at_box(k_w))
    rows_at_box = at_box(k_w).sum(0)
    assert all((rows_at_box == m).mean() > 0.05 for m in range(NU + 1))


def test_riccati_fusedlin_boxqp_plain_matches_pallas():
    """K1 under boxqp (tests/test_torch_kernels.py's clamp-mode check with
    the delta bounds of the lane-follow box around the controls)."""
    from tests.problems import single_track_lane_ocp

    jspec = single_track_lane_ocp(horizon_steps=T).spec()
    tspec = entry.single_track_spec(horizon=T, device="cpu")
    x, u = _states_controls(3)
    xT = _states_controls(4)[0][0]
    lb, ub = (-BOX - u).astype(np.float32), (BOX - u).astype(np.float32)
    lin = k3.linearize_plain(tspec, torch.as_tensor(x[:1]), torch.as_tensor(u[:1]), True)
    hess = [h[0] for h in lin[4:]]
    k_w, K_w = riccati_fusedlin_pallas_tiled(
        _lanes(x), _lanes(u), *(_lanes(h.numpy())[:, None] for h in hess), _lanes(xT),
        dynamics=jspec.dynamics, stage_cost=jspec.stage_cost, terminal_fn=jspec.terminal_cost,
        dt=jspec.dt, discrete=True, reg_init=1e-6, reg_factor=10.0, reg_levels=16,
        interpret=True, lb_l=_lanes(lb), ub_l=_lanes(ub))
    k_g, K_g = k1.riccati_fusedlin_plain(
        tspec, torch.as_tensor(x), torch.as_tensor(u), *hess, torch.as_tensor(xT), LEVELS,
        torch.as_tensor(lb), torch.as_tensor(ub))
    np.testing.assert_allclose(k_g.numpy(), _unlanes(k_w), **TOL_k)
    np.testing.assert_allclose(K_g.numpy(), _unlanes(K_w), **TOL_K)


# --- solves in each new branch against JAX solve_ilqr_batched -------------

J_BENCH = JConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125))


def _j_time_varying(x, u, t):
    # tests/test_fused_loop.py's time-varying quadratic cost.
    return 10.0 * (1.0 + 0.05 * t) * x[1] ** 2 + (x[3] - 1.0) ** 2 + 0.1 * (u[0] ** 2 + u[1] ** 2)


CASES = {
    # name: (JAX config, problem)
    "separate_kernel_stationary": (dataclasses.replace(J_BENCH, stationary_fusedlin=False), "lane"),
    "quadratic_time_varying": (dataclasses.replace(J_BENCH, quadratic_cost=True), "time_varying"),
    "general": (dataclasses.replace(J_BENCH, quadratic_cost=False), "lane"),
    "boxqp": (dataclasses.replace(J_BENCH, bound_mode="boxqp"), "lane"),
    "circular_track": (JConfig(max_iterations=100, tolerance=1e-5), "circular"),
}


def _problem(kind):
    """(JAX batched spec, the port's spec from its leaves) at B = 8, T = 10."""
    from tests.problems import single_track_lane_ocp

    if kind == "circular":
        jspec = j_circ.create_single_track_circular_ocp(0.0).spec()
        x0 = entry.circular_sweep_x0(8, 1)
        t_cost, t_term = t_circ._stage_cost, t_circ._terminal_cost
    else:
        over = {"stage_cost": _j_time_varying} if kind == "time_varying" else {}
        jspec = single_track_lane_ocp(horizon_steps=10, **over).spec()
        x0 = entry.bench_x0(8)
        t_cost = _t_time_varying if kind == "time_varying" else entry.LANE_FOLLOW_COST
        t_term = zero_terminal_cost
    specs = jax.vmap(lambda s0: jspec.replace(initial_state=s0))(jnp.asarray(x0))
    specs = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), specs)
    ported = spec_from_numpy(
        {k: np.asarray(getattr(specs, k)) for k in LEAVES}, dynamics=single_track_model,
        stage_cost=t_cost, terminal_cost=t_term, dt=jspec.dt, horizon_steps=10, device="cpu")
    return specs, ported


@pytest.fixture(scope="module")
def jax_solves():
    """JAX reference solves, each built once per module, on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            config, kind = CASES[case]
            j_specs, t_specs = _problem(kind)
            cache[case] = (j_solve(j_specs, config), t_specs, config)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_branch_solve_matches_jax(jax_solves, case):
    want, t_specs, jconfig = jax_solves(case)
    stats = (k1.STATS, k1.BACKWARD_STATS, k2.STATS, k3.STATS, k2.ROLLOUT_STATS, k3.HOIST_STATS)
    for s in stats:
        s.reset()
    got = solve_ilqr_batched(t_specs, config_from_dict(dataclasses.asdict(jconfig)), device="cpu")
    atol = 3e-3 if case == "boxqp" else 2e-4
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), atol=atol)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=atol)
    it = int(got.iterations[0])
    assert it == int(np.asarray(want.iterations)[0])
    if case == "circular_track":
        # The JAX package's f32 fused path gives every agent chip_smoke.py's
        # anchor for the sweep.
        np.testing.assert_allclose(np.asarray(want.cost), SWEEP_ANCHOR, rtol=1e-7)
        assert it == SWEEP_ITERATIONS
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    lo, hi = t_specs.input_lower_bounds[:, None], t_specs.input_upper_bounds[:, None]
    assert ((got.controls >= lo - 1e-6) & (got.controls <= hi + 1e-6)).all()
    # The plain versions the branch runs, as the JAX router launches its
    # kernels: K1 (stationary, boxqp here) or K4 once an iteration; K3's
    # hoist once (not in the general branch) and K3 once an iteration off
    # the K1 route; K2's rollout once and its select once an iteration.
    fusedlin = case == "boxqp"
    hoist = case not in ("general", "circular_track")
    want_calls = [it if fusedlin else 0, 0 if fusedlin else it, it, 0 if fusedlin else it, 1,
                  int(hoist)]
    assert [s.plain_calls for s in stats] == want_calls
    assert [s.launches for s in stats] == [0] * 6
