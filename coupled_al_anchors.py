#!/usr/bin/env python3
"""Cost anchors of the constrained coupled Nash game, from the JAX package on the CPU.

The game is ``coupled_anchors.py``'s -- ``scripts/bench_multi_agent.py::
bench_coupled``: the circular-track cars with the collision coupling 25
(radius 3) and the ``sequential`` strategy -- with every car's speed capped
by one shared AL inequality row, ``x[3] - 4.5 <= 0`` (the cars start at
4.0 and the track's target speed is 5.0, so the cap binds).  The solver
parameters are ``{"max_iterations": 100, "tolerance": 1e-5, "max_ms": 1e9,
"constraint_tolerance": 1e-3}`` with ``"fused": 1``: the JAX package's
float32 fused loop, Pallas in interpret mode on the CPU, its select kernel
in AL and context mode at once.  Rows:

* ``12:3:3:8`` -- a 12-car ring, 3 nearest neighbours, 3 sweeps of at most
  8 iterations (AL endgames are knife-edge, so the ring is held agent by
  agent after a few iterations, as ``al_anchors.py`` holds its batch);
* ``64:all:10:100`` and ``256:8:10:100`` -- two of ``bench_coupled``'s rows
  at 10 sweeps.

It prints one JSON line per row: the total cost, per-agent statistics, the
largest speed of any car at a constrained stage (x_0..x_{T-1}) of its
final plan, and for small rows every
agent's cost.  ``chip_smoke.py`` holds the port's game on the GPU against
these numbers.

    python3 coupled_al_anchors.py [--rows 12:3:3:8 64:all:10:100 256:8:10:100]

Float32 throughout (x64 off), as the port runs the game on the card.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from multi_agent_solver_tpu.examples.multi_agent_single_track import build_problem  # noqa: E402
from multi_agent_solver_tpu.solvers import make_solver  # noqa: E402
from multi_agent_solver_tpu.strategies import make_strategy  # noqa: E402
from multi_agent_solver_tpu.strategies import solve as solve_strategy  # noqa: E402

SPEED_CAP = 4.5
PARAMS = {"max_iterations": 100, "tolerance": 1e-5, "max_ms": 1e9, "constraint_tolerance": 1e-3,
          "fused": 1}


def speed_cap(x, u):
    """The one inequality row every car shares: ``v - 4.5 <= 0``."""
    return jnp.array([x[3] - SPEED_CAP])


def constrained_problem(n_agents: int, neighbors, coupling: float = 25.0):
    """``bench_coupled``'s problem with :func:`speed_cap` on every car (one
    function object, so the agents stay homogeneous)."""
    problem = build_problem(n_agents, coupling=coupling)
    problem.coupling_neighbors = neighbors
    for agent in problem.agents:
        agent.ocp.inequality_constraints = speed_cap
        agent.ocp.initialize_problem()
    return problem


def anchor(n_agents: int, neighbors, max_outer: int, max_iterations: int) -> dict:
    problem = constrained_problem(n_agents, neighbors)
    params = {**PARAMS, "max_iterations": max_iterations}
    strategy = make_strategy("sequential", make_solver("ilqr"), params, max_outer)
    t0 = time.perf_counter()
    solution = solve_strategy(strategy, problem)
    costs = np.asarray([float(c) for c in solution.costs])
    # The row constrains (x_t, u_t) for t < T: x_T is free.
    v_max = max(float(np.max(np.asarray(s)[:-1, 3])) for s in solution.states)
    row = {"agents": n_agents, "neighbors": neighbors, "max_outer": max_outer,
           "max_iterations": max_iterations, "total_cost": float(solution.total_cost),
           "per_agent_mean": float(costs.mean()), "per_agent_min": float(costs.min()),
           "per_agent_max": float(costs.max()), "v_max": v_max,
           "seconds": round(time.perf_counter() - t0, 1)}
    if n_agents <= 16:
        row["per_agent"] = costs.tolist()
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", nargs="*", default=["12:3:3:8", "64:all:10:100", "256:8:10:100"],
                        help="AGENTS:NEIGHBORS:SWEEPS:ITERATIONS, NEIGHBORS 'all' for all pairs")
    args = parser.parse_args()
    for row in args.rows:
        n, k, sweeps, iters = row.split(":")
        print(json.dumps(anchor(int(n), None if k == "all" else int(k), int(sweeps), int(iters))),
              flush=True)


if __name__ == "__main__":
    main()
