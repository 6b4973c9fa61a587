"""Batched solving over problem instances (one card).

PyTorch counterpart of ``multi_agent_solver_tpu/parallel/batching.py``.  A
batch is an :class:`OCPSpec` whose tensor leaves carry a leading batch axis
(functions and dimensions stay shared), the input of
``solve_ilqr_batched``, which solves it on the card's batched kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ocp import OCPSpec
from ..solvers.base import SolveResult


def _tensor_leaves(spec: OCPSpec) -> dict:
    """The spec's tensor fields that are set, by name."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if isinstance(getattr(spec, f.name), torch.Tensor)}


def replicate_spec(spec: OCPSpec, batch: int) -> OCPSpec:
    """Every tensor leaf of ``spec`` along a new leading batch axis (an
    expanded view, as ``jnp.broadcast_to``)."""
    return spec.replace(**{name: leaf.expand((batch,) + tuple(leaf.shape))
                           for name, leaf in _tensor_leaves(spec).items()})


def batch_spec_over(spec: OCPSpec, **leaf_batches) -> OCPSpec:
    """Batch a spec by overriding selected leaves with batched tensors::

        specs = batch_spec_over(spec, initial_state=x0_batch)   # [B, nx]

    The other leaves broadcast to the batch size; ``ValueError`` when the
    given leaves disagree on it."""
    sizes = {v.shape[0] for v in leaf_batches.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes: {sizes}")
    specs = replicate_spec(spec, sizes.pop())
    return specs.replace(**leaf_batches)


def _problem_spec(specs: OCPSpec, i: int) -> OCPSpec:
    """Problem ``i`` of batched ``specs``: every tensor leaf at ``[i]``."""
    return specs.replace(**{name: leaf[i] for name, leaf in _tensor_leaves(specs).items()})


def batch_solve(solve_fn: Callable[[OCPSpec], SolveResult], specs: OCPSpec) -> SolveResult:
    """Solve a batched spec with the semantics of JAX's
    ``jit(vmap(solve_fn))``: ``solve_fn`` of each problem, the results
    stacked along a leading batch axis.

    ``torch.func.vmap`` cannot map the single solve's data-dependent loop
    (it stops at convergence), so the problems are solved one at a time;
    ``solve_ilqr_batched`` solves a whole batch at once on the card's
    batched kernels.  JAX's ``donate`` (buffer donation to XLA) has no
    torch counterpart and is left out.
    """
    batch = specs.initial_state.shape[0]
    results = [solve_fn(_problem_spec(specs, i)) for i in range(batch)]
    return SolveResult(**{
        f.name: torch.stack([getattr(r, f.name) for r in results])
        for f in dataclasses.fields(SolveResult) if getattr(results[0], f.name) is not None})
