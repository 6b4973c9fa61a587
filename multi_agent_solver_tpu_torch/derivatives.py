"""Derivative oracles by exact forward/reverse AD (``torch.func``).

PyTorch counterpart of the ``ad`` bundle of
``multi_agent_solver_tpu/derivatives.py``.  Every oracle takes one problem
(``x [nx]``, ``u [nu]``); ``torch.func.vmap`` batches it.  The
finite-difference parity mode is not ported yet.

* ``fx(x, u) -> [nx, nx]``, ``fu(x, u) -> [nx, nu]``: continuous dynamics
* ``lx/lu(x, u, t) -> [n]``, ``lxx/luu(x, u, t) -> [n, n]``,
  ``lux(x, u, t) -> [nu, nx]``
* ``phix(x) -> [nx]``, ``phixx(x) -> [nx, nx]``
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from torch.func import grad, jacfwd

from .types import MotionModel, StageCostFunction, TerminalCostFunction


@dataclasses.dataclass(frozen=True)
class Derivatives:
    """Bundle of derivative callables."""

    fx: Callable
    fu: Callable
    lx: Callable
    lu: Callable
    lxx: Callable
    luu: Callable
    lux: Callable
    phix: Callable
    phixx: Callable

    def replace(self, **kwargs) -> "Derivatives":
        return dataclasses.replace(self, **kwargs)


def make_derivatives(
    dynamics: MotionModel,
    stage_cost: StageCostFunction,
    terminal_cost: TerminalCostFunction,
    mode: str = "ad",
    **overrides,
) -> Derivatives:
    """Build the AD oracle bundle; any oracle may be overridden by an
    analytic callable (``overrides`` keys are :class:`Derivatives` fields)."""
    if mode != "ad":
        raise NotImplementedError(
            f"derivative mode {mode!r}: only 'ad' is ported (the 'fd' parity "
            "mode waits for ROADMAP queue 1, model zoo and derivative oracles)"
        )
    derivs = Derivatives(
        fx=jacfwd(dynamics, argnums=0),
        fu=jacfwd(dynamics, argnums=1),
        lx=grad(stage_cost, argnums=0),
        lu=grad(stage_cost, argnums=1),
        lxx=jacfwd(grad(stage_cost, argnums=0), argnums=0),
        luu=jacfwd(grad(stage_cost, argnums=1), argnums=1),
        lux=jacfwd(grad(stage_cost, argnums=1), argnums=0),
        phix=grad(terminal_cost),
        phixx=jacfwd(grad(terminal_cost)),
    )
    overrides = {k: v for k, v in overrides.items() if v is not None}
    unknown = set(overrides) - {f.name for f in dataclasses.fields(Derivatives)}
    if unknown:
        raise ValueError(f"unknown derivative overrides: {sorted(unknown)}")
    return derivs.replace(**overrides) if overrides else derivs
