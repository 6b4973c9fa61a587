#!/usr/bin/env python3
"""Anchors of the non-fused and continuous-Jacobian solves, from the JAX
package on the CPU.

The batched problem is ``bench.py``'s lane-follow batch
(``__graft_entry__``'s single-track spec: nx=4, nu=2, T=80, dt=0.1, inputs
+-0.7 / +-1, analytic dynamics Jacobians; x0 drawn by ``bench.py`` from
``RandomState(0)``: lateral offsets U(0.5, 1.5) over the whole batch, then
speeds U(0, 0.5)).  The first ``--problems`` problems of a ``--draw``-problem
draw (the draw is column by column, so a shorter draw gives other problems)
are solved through the JAX package's kernel-per-phase scan path
(``backward="scan", fused=False``: XLA, no Pallas) with
``ILQRConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5,
0.125))``, once in the discrete and once in the continuous Jacobian mode.
The single problem of ``examples/single_track_ocp.py`` (x0 = (0, 1, 0, 0))
is solved through ``make_solver("ilqr", params).solve(ocp)`` with the
example's parameters, in both modes.  It prints one JSON line: the batched
costs as little-endian float32 in base64 with summary statistics, and the
single solves' costs.  ``chip_smoke.py`` holds the port's solves on the GPU
against these numbers.

    python3 nonfused_anchors.py [--draw 262144] [--problems 1024]

Float32 throughout (x64 off), as the port runs the solves on the card.
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
from multi_agent_solver_tpu.examples.single_track_ocp import (  # noqa: E402
    create_single_track_lane_following_ocp,
)
from multi_agent_solver_tpu.solvers import make_solver  # noqa: E402
from multi_agent_solver_tpu.solvers.ilqr import ILQRConfig, solve_ilqr_batched  # noqa: E402

SINGLE_PARAMS = {"max_iterations": 10, "tolerance": 1e-5, "max_ms": 100}


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
    args = parser.parse_args()

    spec = _single_track_spec()
    x0 = jnp.asarray(bench_x0(args.draw)[:args.problems])
    specs = jax.vmap(lambda s0: spec.replace(initial_state=s0))(x0)
    out = {"draw": args.draw, "problems": args.problems,
           "config": {"max_iterations": 10, "tolerance": 1e-5, "alpha_ladder": [1.0, 0.5, 0.125],
                      "backward": "scan", "fused": False}}
    t0 = time.perf_counter()
    for mode in ("discrete", "continuous"):
        config = ILQRConfig(max_iterations=10, tolerance=1e-5, alpha_ladder=(1.0, 0.5, 0.125),
                            jacobian_mode=mode)
        result = solve_ilqr_batched(specs, config, backward="scan", fused=False)
        cost = np.asarray(result.cost, np.float32)
        out[mode] = {"iterations": int(np.asarray(result.iterations)[0]),
                     "converged": int(np.asarray(result.converged).sum()),
                     "cost_median": float(np.median(cost)), "cost_max": float(cost.max()),
                     "cost_f32_b64": b64(cost)}
        problem = create_single_track_lane_following_ocp()
        params = {**SINGLE_PARAMS, "continuous_jacobians": float(mode == "continuous")}
        single = make_solver("ilqr", params).solve(problem)
        out[f"single_{mode}"] = {"cost": float(single.cost),
                                 "iterations": int(np.asarray(single.iterations)),
                                 "dtype": str(np.asarray(single.cost).dtype)}
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
