"""Multi-start solving: race random warm starts as batch lanes, keep the best.

PyTorch counterpart of ``multi_agent_solver_tpu/parallel/multistart.py``.
Nonconvex problems (the pendulum and cart-pole swing-ups) trap local-descent
solvers in poor basins; solving N initial guesses as the lanes of one
batched solve costs little more than one, so multi-start is the idiomatic
fix.  An explicit ``torch.Generator`` takes the place of the JAX key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..ocp import OCPSpec
from ..solvers.base import SolveResult
from .batching import replicate_spec


def _uniform(generator: torch.Generator, shape, dtype, lo: float, hi: float) -> torch.Tensor:
    """U(lo, hi) draws on the generator's device, ``lo + (hi - lo) U(0, 1)``."""
    return lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=dtype,
                                       device=generator.device)


def random_control_starts(
    generator: torch.Generator,
    spec: OCPSpec,
    n_starts: int,
    scale: Optional[float] = None,
    include_warm_start: bool = True,
) -> torch.Tensor:
    """``[n_starts, T, nu]`` smooth random control initializations, on the
    spec's device.

    Sinusoids with a random amplitude, frequency and phase per control
    channel, drawn from ``generator`` in that order.  Amplitudes are 40% of
    the input range around its centre (or ``scale`` around 0; 1 without
    input bounds).  Lane 0 keeps the spec's own warm start when
    ``include_warm_start``, so multi-start never does worse.
    """
    T, nu = spec.initial_controls.shape
    dtype, dev = spec.initial_controls.dtype, spec.initial_controls.device

    if scale is None:
        if spec.has_input_bounds:
            amp = 0.4 * (spec.input_upper_bounds - spec.input_lower_bounds) / 2.0
            center = (spec.input_upper_bounds + spec.input_lower_bounds) / 2.0
        else:
            amp = torch.ones((nu,), dtype=dtype, device=dev)
            center = torch.zeros((nu,), dtype=dtype, device=dev)
    else:
        amp = torch.full((nu,), scale, dtype=dtype, device=dev)
        center = torch.zeros((nu,), dtype=dtype, device=dev)

    shape = (n_starts, 1, nu)
    amps = amp * _uniform(generator, shape, dtype, 0.2, 1.0).to(dev)
    freqs = _uniform(generator, shape, dtype, 0.5, 3.0).to(dev)
    phases = _uniform(generator, shape, dtype, 0.0, 2.0 * math.pi).to(dev)
    ts = (torch.arange(T, dtype=dtype, device=dev) * spec.dt)[None, :, None]
    starts = center + amps * torch.sin(2.0 * math.pi * freqs * ts + phases)

    if include_warm_start:
        starts[0] = spec.initial_controls
    return starts


def multistart_solve(
    solve_batched_fn: Callable[[OCPSpec], SolveResult],
    spec: OCPSpec,
    starts: torch.Tensor,
) -> SolveResult:
    """Solve every start as a batch lane; the lane of the lowest cost."""
    specs = replicate_spec(spec, starts.shape[0]).replace(initial_controls=starts)
    results = solve_batched_fn(specs)
    best = torch.argmin(results.cost).reshape(1)
    pick = lambda leaf: None if leaf is None else leaf.index_select(0, best)[0]
    return SolveResult(**{f.name: pick(getattr(results, f.name))
                          for f in dataclasses.fields(SolveResult)})


def multistart_solve_host(solver, problem, n_starts: int, seed: int = 0) -> SolveResult:
    """Multi-start through a reference-style solver object: ``n_starts``
    random starts from a generator seeded with ``seed``, raced as one
    batched solve, the best written back into ``problem`` (the mutation
    contract of ``solver.solve``)."""
    spec = problem.spec()
    starts = random_control_starts(torch.Generator().manual_seed(seed), spec, n_starts)
    result = multistart_solve(lambda specs: solver._solve_batched_fn(specs, solver.config),
                              spec, starts)
    problem.set_result(result.states, result.controls, result.cost)
    return result
