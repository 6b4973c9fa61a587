#!/usr/bin/env python3
"""Anchors of the AL-constrained batched solve, from the JAX package on the CPU.

The problem is ``bench.py``'s lane-follow batch (``__graft_entry__``'s
single-track spec: nx=4, nu=2, T=80, dt=0.1, inputs +-0.7 / +-1; x0 drawn
by ``bench.py`` from ``RandomState(0)``: lateral offsets U(0.5, 1.5) over
the whole batch, then speeds U(0, 0.5)), with the state bounds
``lb = (-inf, -0.1, -inf, 0)`` and ``ub = (inf, 1.6, inf, 0.8)`` folded
into four AL inequality rows by ``ocp.with_state_bound_constraints``.  It
solves the first ``--problems`` problems of a ``--draw``-problem draw (the
draw is column by column, so a shorter draw gives other problems) through
the JAX package's float32 fused loop (``fused=True``; Pallas in interpret
mode on the CPU) with ``ILQRConfig(max_iterations=8, tolerance=1e-5,
constraint_tolerance=1e-3, alpha_ladder=(1.0, 0.5, 0.125))`` and prints one
JSON line: summary statistics, and the per-problem costs and inequality
violations as little-endian float32 in base64.  ``chip_smoke.py`` holds
the port's solve on the GPU against these numbers.

    python3 al_anchors.py [--draw 262144] [--problems 1024] [--iterations 8]

Float32 throughout (x64 off), as the port runs the solve on the card.
"""

from __future__ import annotations

import argparse
import base64
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

from __graft_entry__ import _single_track_spec  # noqa: E402
from multi_agent_solver_tpu.ocp import with_state_bound_constraints  # noqa: E402
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig, solve_ilqr_batched  # noqa: E402

INF = float("inf")
STATE_LOWER, STATE_UPPER = (-INF, -0.1, -INF, 0.0), (INF, 1.6, INF, 0.8)


def bench_x0(batch: int) -> np.ndarray:
    """``bench.py``'s initial states, drawn column by column."""
    rng = np.random.RandomState(0)
    x0 = np.zeros((batch, 4), np.float32)
    x0[:, 1] = rng.uniform(0.5, 1.5, batch)
    x0[:, 3] = rng.uniform(0.0, 0.5, batch)
    return x0


def b64(a) -> str:
    return base64.b64encode(np.asarray(a, "<f4").tobytes()).decode()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draw", type=int, default=262_144)
    parser.add_argument("--problems", type=int, default=1024)
    parser.add_argument("--iterations", type=int, default=8)
    args = parser.parse_args()

    spec = _single_track_spec().replace(state_lower_bounds=jnp.asarray(STATE_LOWER, jnp.float32),
                                        state_upper_bounds=jnp.asarray(STATE_UPPER, jnp.float32))
    spec = with_state_bound_constraints(spec)
    x0 = jnp.asarray(bench_x0(args.draw)[:args.problems])
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    config = ILQRConfig(max_iterations=args.iterations, tolerance=1e-5,
                        constraint_tolerance=1e-3, alpha_ladder=(1.0, 0.5, 0.125))
    t0 = time.perf_counter()
    result = solve_ilqr_batched(specs, config, fused=True)
    cost = np.asarray(result.cost, np.float32)
    viol = np.asarray(result.ineq_violation, np.float32)
    print(json.dumps({
        "draw": args.draw, "problems": args.problems, "ineq_dim": spec.ineq_dim,
        "config": {"max_iterations": args.iterations, "tolerance": 1e-5,
                   "constraint_tolerance": 1e-3, "alpha_ladder": [1.0, 0.5, 0.125]},
        "iterations": int(np.asarray(result.iterations)[0]),
        "converged": int(np.asarray(result.converged).sum()),
        "cost_median": float(np.median(cost)), "cost_max": float(cost.max()),
        "ineq_violation_max": float(viol.max()),
        "seconds": round(time.perf_counter() - t0, 1),
        "cost_f32_b64": b64(cost), "ineq_violation_f32_b64": b64(viol),
    }), flush=True)


if __name__ == "__main__":
    main()
