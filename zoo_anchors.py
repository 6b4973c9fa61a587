#!/usr/bin/env python3
"""Anchors of the model zoo's batched solves, from the JAX package on the CPU.

For each model of the zoo that ``chip_smoke.py`` phase 29 solves on the
kernels, the JAX package solves the first ``--problems`` problems of the
phase's draw (the port's ``entry`` x0 functions, float32 draws, so a
shorter draw would give other problems) in float64 on its scan route
(``fused=False, backward="scan"``), with the phase's configuration:

* the rocket of ``examples/rocket_max_altitude.py`` (its analytic
  oracles, thrust box and half-thrust guess), initial masses from
  ``entry.rocket_x0(262144)``, T = 50, 25 iterations, tolerance 1e-6; and
  the example's own single solve (``solve_ilqr``, its x0), in float64 and
  float32;
* the dynamic bicycle's lane change of ``tests/test_dynamic_bicycle.py``,
  ``entry.bicycle_x0(32768)``, T = 30, 10 iterations, tolerance 1e-8;
* the quadrotor hover of ``scripts/bench_quadrotor.py``,
  ``entry.quadrotor_x0(8192)``, T = 40, 10 iterations, tolerance 1e-6;
* the rotor-lag quadrotor hover of ``tests/test_quadrotor_rotor.py``
  (T = 40), ``entry.quadrotor_x0(8192, nx=16)``, the same configuration.

The costs are written as the JAX tests and scripts write them (sums of
weighted squares); the port writes the same sums as
``ocp.diagonal_quadratic_cost`` in another order, which float64 does not
see.  The same solves run again in float32, and a problem whose float32
cost parts from its float64 one beyond rtol 1e-4, or whose float64 solve
accepted no step, is knife-edge.  It prints one JSON line: per model the
``--problems`` final costs (float64, repr), the float32 costs, the
knife-edge problems and the seconds it took; ``chip_smoke.py`` keeps the
costs as ``ZOO_ANCHORS`` and the knife-edge problems as ``ZOO_KNIFE_EDGE``,
and holds the port's float32 solves on the card to the anchors at rtol
1e-4, the knife-edge problems to finite costs at or below their warm
start.

    python3 zoo_anchors.py [--problems 64]

About 2-3 minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_cpu_prefer_vector_width" not in _flags:
    os.environ["XLA_FLAGS"] = f"{_flags} --xla_cpu_prefer_vector_width=128".strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from multi_agent_solver_tpu.examples.rocket_max_altitude import (  # noqa: E402
    create_max_altitude_rocket_ocp)
from multi_agent_solver_tpu.models import (HOVER_ROTOR_THRUST, HOVER_THRUST,  # noqa: E402
                                           dynamic_bicycle_model, quadrotor_dynamics,
                                           quadrotor_rotor_dynamics)
from multi_agent_solver_tpu.ocp import OCP  # noqa: E402
from multi_agent_solver_tpu.solvers.ilqr import (ILQRConfig, solve_ilqr,  # noqa: E402
                                                 solve_ilqr_batched)
from multi_agent_solver_tpu_torch import entry  # noqa: E402

# The phase's draws: (x0 function, its batch, keyword arguments).
DRAWS = {
    "rocket": (entry.rocket_x0, 262144, {}),
    "bicycle": (entry.bicycle_x0, 32768, {}),
    "quadrotor": (entry.quadrotor_x0, 8192, {}),
    "quadrotor_rotor": (entry.quadrotor_x0, 8192, {"nx": 16}),
}


def rocket_spec():
    return create_max_altitude_rocket_ocp().spec(), ILQRConfig(max_iterations=25, tolerance=1e-6)


def bicycle_spec():
    ocp = OCP(
        state_dim=6, control_dim=2, horizon_steps=30, dt=0.05,
        initial_state=jnp.array([0.0, 2.0, 0.0, 15.0, 0.0, 0.0]),
        dynamics=dynamic_bicycle_model,
        stage_cost=lambda x, u, t: (
            2.0 * x[1] ** 2 + 0.5 * x[2] ** 2 + 0.05 * (x[3] - 15.0) ** 2
            + 2.0 * u[0] ** 2 + 0.1 * u[1] ** 2
        ),
        input_lower_bounds=jnp.array([-0.4, -4.0]),
        input_upper_bounds=jnp.array([0.4, 2.0]),
    )
    ocp.initialize_problem()
    return ocp.spec(), ILQRConfig(max_iterations=10, tolerance=1e-8)


def quadrotor_spec():
    w = jnp.array([4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.1, 0.1, 0.1])
    u_hover = jnp.array([HOVER_THRUST, 0.0, 0.0, 0.0])
    ru = jnp.array([0.1, 1.0, 1.0, 1.0])

    def stage_cost(x, u, t):
        du = u - u_hover
        return jnp.sum(w * x * x) + jnp.sum(ru * du * du)

    ocp = OCP(
        state_dim=12, control_dim=4, horizon_steps=40, dt=0.05,
        initial_state=jnp.zeros(12).at[0].set(1.0),
        dynamics=quadrotor_dynamics,
        stage_cost=stage_cost,
        terminal_cost=lambda x: 10.0 * jnp.sum(w * x * x),
        initial_controls=jnp.tile(u_hover, (40, 1)),
    )
    ocp.initialize_problem()
    return ocp.spec(), ILQRConfig(max_iterations=10, tolerance=1e-6)


def quadrotor_rotor_spec():
    W = jnp.array([4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.1, 0.1, 0.1,
                   0.01, 0.01, 0.01, 0.01])
    u_hover = jnp.full(4, HOVER_ROTOR_THRUST)
    ref = jnp.zeros(16).at[12:16].set(HOVER_ROTOR_THRUST)

    def stage_cost(x, u, t):
        dx = x - ref
        du = u - u_hover
        return jnp.sum(W * dx * dx) + 0.1 * jnp.sum(du * du)

    def terminal_cost(x):
        dx = x - ref
        return 10.0 * jnp.sum(W * dx * dx)

    ocp = OCP(
        state_dim=16, control_dim=4, horizon_steps=40, dt=0.05,
        initial_state=jnp.zeros(16).at[0].set(1.0).at[1].set(-0.5).at[6].set(0.2).at[12:16]
        .set(HOVER_ROTOR_THRUST),
        dynamics=quadrotor_rotor_dynamics,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        initial_controls=jnp.tile(u_hover, (40, 1)),
    )
    ocp.initialize_problem()
    return ocp.spec(), ILQRConfig(max_iterations=10, tolerance=1e-6)


SPECS = {"rocket": rocket_spec, "bicycle": bicycle_spec, "quadrotor": quadrotor_spec,
         "quadrotor_rotor": quadrotor_rotor_spec}


def solve(name, problems):
    """``(costs, warm-start costs, iterations)`` of ``name``'s first
    ``problems`` problems, in the current precision."""
    draw, batch, kw = DRAWS[name]
    spec, config = SPECS[name]()
    x0 = draw(batch, **kw)[:problems]
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    x0 = jnp.asarray(np.asarray(x0, np.float32), dtype)
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    warm = jax.vmap(lambda s: s.cost(s.rollout(s.initial_controls), s.initial_controls))(specs)
    res = solve_ilqr_batched(specs, config, fused=False, backward="scan")
    return (np.asarray(res.cost, np.float64), np.asarray(warm, np.float64),
            [int(i) for i in np.asarray(res.iterations)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=64)
    args = ap.parse_args()
    out = {"problems": args.problems}
    f64 = {}
    for name in DRAWS:
        t0 = time.perf_counter()
        f64[name] = solve(name, args.problems)
        out[name] = {"costs": [float(c) for c in f64[name][0]], "iterations": f64[name][2],
                     "seconds": round(time.perf_counter() - t0, 1)}
    spec, config = rocket_spec()
    out["rocket_single_f64"] = float(solve_ilqr(spec, config).cost)
    jax.config.update("jax_enable_x64", False)
    for name in DRAWS:
        # Knife-edge problems: where the JAX package's own float32 solve
        # parts from its float64 one beyond rtol 1e-4, or where its float64
        # solve accepted no step (the rocket's mass-floor regime, where
        # any change of the arithmetic may let a step through).
        cost32 = solve(name, args.problems)[0]
        cost, warm, _ = f64[name]
        apart = np.abs(cost32 - cost) > 1e-4 * np.abs(cost)
        out[name]["float32_costs"] = [float(c) for c in cost32]
        out[name]["knife_edge"] = [int(i) for i in np.flatnonzero(apart | (cost == warm))]
    spec, config = rocket_spec()
    out["rocket_single_f32"] = float(solve_ilqr(spec, config).cost)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
