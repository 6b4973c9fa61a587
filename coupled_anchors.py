#!/usr/bin/env python3
"""Cost anchors of the coupled Nash game, from the JAX package on the CPU.

Runs ``scripts/bench_multi_agent.py::bench_coupled``'s game -- the
circular-track cars with the collision coupling 25 (radius 3), the
``sequential`` strategy, 10 sweeps, ``{"max_iterations": 100,
"tolerance": 1e-5, "max_ms": 1e9}`` -- through the JAX package's float32
fused loop (``"fused": 1``; Pallas in interpret mode on the CPU) and prints
one JSON line per row with the total cost and the per-agent costs.
``chip_smoke.py`` holds the port's game on the GPU against these numbers.

    python3 coupled_anchors.py [--rows 12:3 64:all 256:8]

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

import numpy as np  # noqa: E402

from multi_agent_solver_tpu.examples.multi_agent_single_track import build_problem  # noqa: E402
from multi_agent_solver_tpu.solvers import make_solver  # noqa: E402
from multi_agent_solver_tpu.strategies import make_strategy  # noqa: E402
from multi_agent_solver_tpu.strategies import solve as solve_strategy  # noqa: E402

PARAMS = {"max_iterations": 100, "tolerance": 1e-5, "max_ms": 1e9, "fused": 1}


def anchor(n_agents: int, neighbors, max_outer: int = 10, coupling: float = 25.0) -> dict:
    problem = build_problem(n_agents, coupling=coupling)
    problem.coupling_neighbors = neighbors
    strategy = make_strategy("sequential", make_solver("ilqr"), PARAMS, max_outer)
    t0 = time.perf_counter()
    solution = solve_strategy(strategy, problem)
    costs = np.asarray([float(c) for c in solution.costs])
    row = {"agents": n_agents, "neighbors": neighbors, "max_outer": max_outer,
           "total_cost": float(solution.total_cost), "per_agent_mean": float(costs.mean()),
           "per_agent_min": float(costs.min()), "per_agent_max": float(costs.max()),
           "seconds": round(time.perf_counter() - t0, 1)}
    if n_agents <= 16:
        row["per_agent"] = costs.tolist()
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", nargs="*", default=["12:3", "64:all", "256:8"],
                        help="AGENTS:NEIGHBORS, NEIGHBORS 'all' for all pairs")
    args = parser.parse_args()
    for row in args.rows:
        n, k = row.split(":")
        print(json.dumps(anchor(int(n), None if k == "all" else int(k))), flush=True)


if __name__ == "__main__":
    main()
