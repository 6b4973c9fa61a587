"""The port's main path -- the batched iLQR solve -- against the JAX package.

Problems are the single-track lane-follow solve of ``bench.py`` with its
solver config, x0 drawn by ``bench.py``'s generator; the JAX spec is
exported to the port through ``utils/carry.py``.  On CPU tensors the port
runs the plain PyTorch versions of its kernels.  Tolerances are those of
tests/test_fused_loop.py for two implementations of the same float32
algorithm (cost rtol 1e-5, controls atol 2e-4); against the f32 scan path,
a different Riccati implementation, cost rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import solve_ilqr_batched as j_solve

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.derivatives import make_derivatives
from multi_agent_solver_tpu_torch.models import single_track_model
from multi_agent_solver_tpu_torch.ocp import with_context_cost, zero_terminal_cost
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.solvers import make_solver
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig, solve_ilqr_batched
from multi_agent_solver_tpu_torch.utils.carry import config_from_dict, spec_from_numpy

torch.set_num_threads(1)

J_BENCH = JConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125))
LEAVES = ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")


def _both(B, T, dtype=jnp.float64):
    from tests.problems import single_track_lane_ocp

    spec = single_track_lane_ocp(horizon_steps=T).spec()
    x0 = jnp.asarray(entry.bench_x0(B), dtype)
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    specs = jax.tree_util.tree_map(lambda a: a.astype(dtype), specs)
    ported = spec_from_numpy(
        {k: np.asarray(getattr(specs, k)) for k in LEAVES},
        dynamics=single_track_model, stage_cost=entry.LANE_FOLLOW_COST,
        terminal_cost=zero_terminal_cost, dt=spec.dt, horizon_steps=T, device="cpu",
    )
    return specs, ported


def test_solve_matches_jax_fused_path():
    """JAX's default route for this problem is the fused lane-resident
    loop (Pallas kernels in interpret mode here): the port's fused loop."""
    j_specs, t_specs = _both(B=8, T=20)
    want = j_solve(j_specs, J_BENCH)
    got = solve_ilqr_batched(t_specs, config_from_dict(dataclasses.asdict(J_BENCH)), device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(want.controls), atol=2e-4)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=2e-4)
    assert int(got.iterations[0]) == int(np.asarray(want.iterations)[0])
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_full_horizon_matches_jax_scan_path():
    j_specs, t_specs = _both(B=4, T=80, dtype=jnp.float32)
    want = j_solve(j_specs, J_BENCH, backward="scan", fused=False)
    got = solve_ilqr_batched(t_specs, entry.BENCH_CONFIG, device="cpu")
    assert got.states.shape == (4, 81, 4) and got.controls.shape == (4, 80, 2)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)


def test_short_and_scheduled_ladders_match_reference_ladder():
    """As JAX's tests/test_fused_loop.py asserts for its fused loop: on this
    problem the 3-rung ladder, and the full ladder for 2 warm-up
    iterations then the 3-rung one, reach the 10-rung reference ladder's
    costs (rtol 1e-6)."""
    specs = entry.bench_specs(8, device="cpu", horizon=20)
    ref = solve_ilqr_batched(specs, ILQRConfig(max_iterations=10, tolerance=1e-5), device="cpu")
    for cfg in (entry.BENCH_CONFIG, dataclasses.replace(entry.BENCH_CONFIG, alpha_warmup=2)):
        got = solve_ilqr_batched(specs, cfg, device="cpu")
        np.testing.assert_allclose(got.cost.numpy(), ref.cost.numpy(), rtol=1e-6)


def test_cpu_solve_runs_plain_versions_only():
    """K2's rollout and K3's hoist once, K1 and K2's select once per
    iteration, K3 whole never -- as plain versions: no kernel launches on
    the CPU."""
    stats = (k1.STATS, k2.STATS, k3.STATS, k2.ROLLOUT_STATS, k3.HOIST_STATS)
    for s in stats:
        s.reset()
    specs = entry.bench_specs(3, device="cpu", horizon=10)
    r = solve_ilqr_batched(specs, entry.BENCH_CONFIG, device="cpu")
    it = int(r.iterations[0])
    assert it >= 1
    assert [s.launches for s in stats] == [0, 0, 0, 0, 0]
    assert [s.plain_calls for s in stats] == [it, it, 0, 1, 1]
    assert torch.isfinite(r.cost).all()
    assert (r.controls[..., 0].abs() <= 0.7 + 1e-6).all()


def _time_varying_specs():
    specs = entry.bench_specs(2, device="cpu", horizon=10)
    cost = lambda x, u, t: (1 + t) * x[..., 1] ** 2 + 0.1 * u[..., 0] ** 2
    return specs.replace(stage_cost=cost, derivs=make_derivatives(
        single_track_model, cost, zero_terminal_cost))


def test_time_varying_cost_hoists_per_stage_hessians():
    """A quadratic cost with time-varying weights probes as quadratic, not
    stationary: K3 hoists per-stage Hessians once, then K3 without
    Hessians and K4 run every iteration.  The Hessians of a quadratic cost
    do not depend on the trajectory, so the result is bit-identical to the
    general branch, which evaluates them every iteration (as JAX's
    tests/test_fused_loop.py asserts for its own two branches)."""
    specs = _time_varying_specs()
    stats = (k1.STATS, k1.BACKWARD_STATS, k2.STATS, k3.STATS, k2.ROLLOUT_STATS, k3.HOIST_STATS)
    for s in stats:
        s.reset()
    hoisted = solve_ilqr_batched(specs, entry.BENCH_CONFIG, device="cpu")
    it = int(hoisted.iterations[0])
    assert [s.plain_calls for s in stats] == [0, it, it, it, 1, 1]
    general = solve_ilqr_batched(
        specs, dataclasses.replace(entry.BENCH_CONFIG, quadratic_cost=False), device="cpu")
    assert torch.isfinite(hoisted.cost).all()
    assert torch.equal(hoisted.cost, general.cost)
    assert torch.equal(hoisted.controls, general.controls)


def _context_specs():
    """The lane-follow batch tracking a per-stage lateral reference given as
    its context ``[B, T, 1]``: quadratic in (x, u), not stationary."""
    specs = entry.bench_specs(2, device="cpu", horizon=10)

    def cost(x, u, t, ctx):
        return (10.0 * (x[..., 1] - ctx[..., 0]) ** 2 + (x[..., 3] - 1.0) ** 2
                + 0.1 * u[..., 0] ** 2 + 0.1 * u[..., 1] ** 2)

    ref = torch.linspace(0.0, 0.5, 10).expand(2, 10)[..., None].contiguous()
    return with_context_cost(specs, cost).replace(context=ref)


def test_context_cost_hoists_per_stage_hessians():
    """With ``fused=True`` (on the CPU both routers' ``"auto"`` take the
    non-fused path for a context) a context cost takes the fused loop:
    quadratic with a context, K3
    hoists per-stage Hessians once in context mode, then K3 without
    Hessians, K4 and K2 select run with the context every iteration; the
    result is bit-identical to the general branch, and the reference moves
    it."""
    specs = _context_specs()
    stats = (k1.BACKWARD_STATS, k2.CTX_STATS, k3.CTX_STATS, k2.STATS, k3.STATS, k2.ROLLOUT_STATS,
             k3.HOIST_STATS)
    for s in stats:
        s.reset()
    hoisted = solve_ilqr_batched(specs, entry.BENCH_CONFIG, fused=True, device="cpu")
    it = int(hoisted.iterations[0])
    assert [s.plain_calls for s in stats] == [it, it, 1 + it, 0, 0, 1, 0]
    general = solve_ilqr_batched(
        specs, dataclasses.replace(entry.BENCH_CONFIG, quadratic_cost=False), fused=True,
        device="cpu")
    assert torch.isfinite(hoisted.cost).all()
    assert torch.equal(hoisted.cost, general.cost)
    assert torch.equal(hoisted.controls, general.controls)
    fixed = solve_ilqr_batched(specs.replace(context=torch.zeros(2, 10, 1)), entry.BENCH_CONFIG,
                               fused=True, device="cpu")
    assert not torch.allclose(fixed.controls, hoisted.controls)


@pytest.mark.parametrize("case", ["ddp", "differentiable", "assoc", "al_with_context"])
def test_unported_branches_raise(case):
    specs = entry.bench_specs(2, device="cpu", horizon=10)
    config, kwargs = entry.BENCH_CONFIG, {}
    if case == "ddp":
        config = dataclasses.replace(config, ddp=True)
    elif case == "differentiable":
        config = dataclasses.replace(config, differentiable=True)
    elif case == "assoc":
        kwargs = {"backward": "assoc"}
    else:
        # AL with a context solves now (tests/test_torch_al_coupled.py), and
        # the select kernel's emit mode (K8) takes AL multipliers on the
        # card; off the CPU it still raises, before any launch, for a cost
        # that has no device function, naming what is missing.
        specs = _context_specs().replace(ineq_dim=1, inequality_constraints=entry.SPEED_CAP)
        T, B = specs.horizon_steps, 2
        args = [torch.zeros(shape, device="meta") for shape in
                ((T, 4, B), (T, 2, B), (T, 2, B), (T, 2, 4, B), (B,))]
        with pytest.raises(NotImplementedError, match=r"\['cost'\] carry no device-function tag"):
            k2.forward_select_emit_lin(specs, *args, None, None, (1.0,),
                                       torch.zeros((T, 1, 1, B), device="meta"),
                                       ineq_mult=torch.zeros((T, 1, B), device="meta"),
                                       rho=torch.ones(B, device="meta"))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_ilqr_batched(specs, config, device="cpu", **kwargs)


def test_cuda_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_ilqr_batched(entry.bench_specs(2, device="cpu", horizon=10), ILQRConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        entry.single_track_spec()
    with pytest.raises(RuntimeError, match="cuda"):
        entry.coupled_game(2)
    problem, _ = entry.coupled_game(2, device="cpu")
    _, strategy = entry.coupled_game(2, device="cpu")
    strategy.solver_proto = make_solver("ilqr")
    with pytest.raises(RuntimeError, match="cuda"):
        strategy(problem)
