"""The PyTorch port's core modules against the JAX package, and its import
boundary.

Inputs are drawn with numpy from a seed and handed to both sides.  These
modules are plain arithmetic in float64 on both sides, so the tolerance is
rtol 1e-12: only the last-ulp difference of XLA:CPU's and PyTorch's
float64 sin/cos/tan may separate them.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_agent_solver_tpu import integrators as jint
from multi_agent_solver_tpu.derivatives import make_derivatives as j_make_derivatives
from multi_agent_solver_tpu.models import single_track as jst
from multi_agent_solver_tpu.ocp import OCPSpec as JSpec
from multi_agent_solver_tpu.ocp import compute_trajectory_cost as j_trajectory_cost
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig as JConfig
from multi_agent_solver_tpu.solvers.ilqr import resolve_cost_structure as j_resolve

from multi_agent_solver_tpu_torch import entry, integrators as tint
from multi_agent_solver_tpu_torch.derivatives import make_derivatives as t_make_derivatives
from multi_agent_solver_tpu_torch.models import single_track as tst
from multi_agent_solver_tpu_torch.ocp import OCPSpec as TSpec
from multi_agent_solver_tpu_torch.ocp import compute_trajectory_cost as t_trajectory_cost
from multi_agent_solver_tpu_torch.ocp import zero_terminal_cost
from multi_agent_solver_tpu_torch.solvers.ilqr import ILQRConfig as TConfig
from multi_agent_solver_tpu_torch.solvers.ilqr import resolve_cost_structure as t_resolve
from multi_agent_solver_tpu_torch.utils.carry import config_from_dict, spec_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multi_agent_solver_tpu_torch"
RTOL = 1e-12


def _states_controls(seed, B=5, T=12):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (B, T + 1)), rng.uniform(-1.5, 1.5, (B, T + 1)),
                  rng.uniform(-0.6, 0.6, (B, T + 1)), rng.uniform(0, 2, (B, T + 1))], -1)
    u = np.stack([rng.uniform(-0.7, 0.7, (B, T)), rng.uniform(-1, 1, (B, T))], -1)
    return x, u


def _jax_lane_cost(x, u, t):
    return 10.0 * x[1] ** 2 + (x[3] - 1.0) ** 2 + 0.1 * u[0] ** 2 + 0.1 * u[1] ** 2


def _jax_zero_terminal(x):
    return jnp.asarray(0.0)


class TestImportBoundary:
    def test_port_imports_without_jax(self):
        code = ("import sys, multi_agent_solver_tpu_torch, multi_agent_solver_tpu_torch.entry, "
                "multi_agent_solver_tpu_torch.utils.carry; "
                "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
                "or m == 'multi_agent_solver_tpu' or m.startswith('multi_agent_solver_tpu.')]; "
                "assert not bad, bad")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr

    def test_sources_import_neither_jax_nor_the_jax_package(self):
        files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
        banned = []
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for name in names:
                    root = name.split(".")[0]
                    if root in ("jax", "jaxlib", "multi_agent_solver_tpu"):
                        banned.append(f"{path.relative_to(REPO)}: {name}")
        assert len(files) > 15
        assert not banned, banned


class TestCoreAgainstJax:
    @pytest.mark.parametrize("name", ["euler", "rk4"])
    def test_single_step(self, name):
        x, u = _states_controls(0)
        want = jax.vmap(lambda a, b: jint.INTEGRATORS[name](a, b, 0.1, jst.single_track_model))(
            jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0]))
        got = tint.INTEGRATORS[name](torch.as_tensor(x[:, 0]), torch.as_tensor(u[:, 0]), 0.1,
                                     tst.single_track_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-14)

    def test_integrate_horizon(self):
        x, u = _states_controls(1)
        want = jax.vmap(lambda a, b: jint.integrate_horizon(a, b, 0.1, jst.single_track_model))(
            jnp.asarray(x[:, 0]), jnp.asarray(u))
        got = tint.integrate_horizon(torch.as_tensor(x[:, 0]), torch.as_tensor(u), 0.1,
                                     tst.single_track_model)
        assert got.shape == (5, 13, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-13)

    @pytest.mark.parametrize("fn", ["single_track_model", "single_track_state_jacobian",
                                    "single_track_control_jacobian"])
    def test_single_track_model(self, fn):
        x, u = _states_controls(2)
        want = jax.vmap(jax.vmap(getattr(jst, fn)))(jnp.asarray(x[:, :-1]), jnp.asarray(u))
        got = getattr(tst, fn)(torch.as_tensor(x[:, :-1]), torch.as_tensor(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-14)

    def test_trajectory_cost(self):
        x, u = _states_controls(3)
        want = jax.vmap(lambda a, b: j_trajectory_cost(a, b, _jax_lane_cost, _jax_zero_terminal))(
            jnp.asarray(x), jnp.asarray(u))
        got = t_trajectory_cost(torch.as_tensor(x), torch.as_tensor(u),
                                entry.LANE_FOLLOW_COST, zero_terminal_cost)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


_COSTS = {
    # name: (JAX stage cost, torch stage cost, expected (quadratic, stationary))
    "lane_follow": (_jax_lane_cost, entry.LANE_FOLLOW_COST, (True, True)),
    "time_varying": (lambda x, u, t: (1 + t) * x[1] ** 2 + 0.1 * u[0] ** 2,
                     lambda x, u, t: (1 + t) * x[..., 1] ** 2 + 0.1 * u[..., 0] ** 2,
                     (True, False)),
    "non_quadratic": (lambda x, u, t: jnp.cos(x[1]) + x[3] ** 4 + 0.1 * u[0] ** 2,
                      lambda x, u, t: torch.cos(x[..., 1]) + x[..., 3] ** 4 + 0.1 * u[..., 0] ** 2,
                      (False, False)),
}


@pytest.mark.parametrize("name", sorted(_COSTS))
def test_resolve_cost_structure_matches_jax(name):
    j_cost, t_cost, expected = _COSTS[name]
    T = 10
    jspec = JSpec(
        initial_state=jnp.zeros(4), initial_controls=jnp.zeros((T, 2)),
        dynamics=jst.single_track_model, stage_cost=j_cost, terminal_cost=_jax_zero_terminal,
        derivs=j_make_derivatives(jst.single_track_model, j_cost, _jax_zero_terminal),
        state_dim=4, control_dim=2, horizon_steps=T, dt=0.1,
    )
    tspec = TSpec(
        initial_state=torch.zeros(4), initial_controls=torch.zeros(T, 2),
        dynamics=tst.single_track_model, stage_cost=t_cost, terminal_cost=zero_terminal_cost,
        derivs=t_make_derivatives(tst.single_track_model, t_cost, zero_terminal_cost),
        state_dim=4, control_dim=2, horizon_steps=T, dt=0.1,
    )
    assert j_resolve(jspec, JConfig()) == expected
    assert t_resolve(tspec, TConfig()) == expected


def test_carry_round_trip():
    """A batched JAX spec and config cross over through numpy and dicts:
    leaves are bit-equal, and the port's rollout and cost match JAX's."""
    from tests.problems import single_track_lane_ocp

    spec = single_track_lane_ocp(horizon_steps=15).spec()
    x0 = entry.bench_x0(6).astype(np.float64)
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(jnp.asarray(x0))
    leaves = {k: np.asarray(getattr(specs, k)) for k in
              ("initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")}
    ported = spec_from_numpy(
        leaves, dynamics=tst.single_track_model, stage_cost=entry.LANE_FOLLOW_COST,
        terminal_cost=zero_terminal_cost, dt=spec.dt, horizon_steps=spec.horizon_steps,
        device="cpu",
    )
    for k, v in leaves.items():
        np.testing.assert_array_equal(getattr(ported, k).numpy(), v)
    rng = np.random.RandomState(4)
    us = rng.uniform(-0.5, 0.5, (6, 15, 2))
    j_xs = jax.vmap(lambda s, c: s.rollout(c))(specs, jnp.asarray(us))
    j_cost = jax.vmap(lambda s, a, c: s.cost(a, c))(specs, j_xs, jnp.asarray(us))
    t_xs = ported.rollout(torch.as_tensor(us))
    np.testing.assert_allclose(t_xs.numpy(), np.asarray(j_xs), rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(ported.cost(t_xs, torch.as_tensor(us)).numpy(),
                               np.asarray(j_cost), rtol=RTOL)

    jcfg = JConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125),
                   alpha_warmup=2, early_exit=False)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == TConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125),
                           alpha_warmup=2, early_exit=False)
    with pytest.raises(TypeError):
        config_from_dict({"not_a_field": 1})
