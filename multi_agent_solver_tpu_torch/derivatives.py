"""Derivative oracles: exact forward/reverse AD (``torch.func``) by
default, the reference's finite differences in the ``fd`` parity mode.

PyTorch counterpart of ``multi_agent_solver_tpu/derivatives.py``: the
``ad`` bundle, and the ``fd`` bundle of ``finite_differences.py``'s
stencils with the reference's epsilons.  Every oracle takes one problem
(``x [nx]``, ``u [nu]``); ``torch.func.vmap`` batches it.

* ``fx(x, u) -> [nx, nx]``, ``fu(x, u) -> [nx, nu]``: continuous dynamics
* ``step_fx(x, u) -> [nx, nx]``, ``step_fu(x, u) -> [nx, nu]``: the
  Jacobians of one discrete (RK4) step, which the OCP builds
  (``ocp.step_jacobians``); None where the spec was built without them
* ``lx/lu(x, u, t) -> [n]``, ``lxx/luu(x, u, t) -> [n, n]``,
  ``lux(x, u, t) -> [nu, nx]``; for a context cost
  (``ocp.with_context_cost``) each takes the stage's context as a fourth
  argument, a constant of the derivatives (only ``x`` and ``u`` are
  differentiated)
* ``phix(x) -> [nx]``, ``phixx(x) -> [nx, nx]``
* ``eq_gx/ineq_gx(x, u) -> [m, nx]``, ``eq_gu/ineq_gu(x, u) -> [m, nu]``:
  the constraint Jacobians, None where the problem has no such constraint

:func:`map_leading` maps such a one-problem function over leading batch
and stage axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from torch.func import grad, jacfwd, vmap

from . import finite_differences as fd
from .types import ConstraintsFunction, MotionModel, StageCostFunction, TerminalCostFunction


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
    step_fx: Optional[Callable] = None
    step_fu: Optional[Callable] = None
    eq_gx: Optional[Callable] = None
    eq_gu: Optional[Callable] = None
    ineq_gx: Optional[Callable] = None
    ineq_gu: Optional[Callable] = None

    def replace(self, **kwargs) -> "Derivatives":
        return dataclasses.replace(self, **kwargs)


def _ad_derivatives(dynamics, stage_cost, terminal_cost, equality_constraints,
                    inequality_constraints) -> Derivatives:
    """Exact derivatives by ``torch.func`` (forward mode for the Jacobians)."""
    return Derivatives(
        fx=jacfwd(dynamics, argnums=0),
        fu=jacfwd(dynamics, argnums=1),
        lx=grad(stage_cost, argnums=0),
        lu=grad(stage_cost, argnums=1),
        lxx=jacfwd(grad(stage_cost, argnums=0), argnums=0),
        luu=jacfwd(grad(stage_cost, argnums=1), argnums=1),
        lux=jacfwd(grad(stage_cost, argnums=1), argnums=0),
        phix=grad(terminal_cost),
        phixx=jacfwd(grad(terminal_cost)),
        eq_gx=jacfwd(equality_constraints, argnums=0) if equality_constraints else None,
        eq_gu=jacfwd(equality_constraints, argnums=1) if equality_constraints else None,
        ineq_gx=jacfwd(inequality_constraints, argnums=0) if inequality_constraints else None,
        ineq_gu=jacfwd(inequality_constraints, argnums=1) if inequality_constraints else None,
    )


def fd_jacobians(g):
    """``(g_x, g_u)`` of ``g(x, u)`` by central differences, eps = 1e-6."""
    return (lambda x, u: fd.fd_jacobian(lambda y: g(y, u), x, eps=1e-6),
            lambda x, u: fd.fd_jacobian(lambda w: g(x, w), u, eps=1e-6))


def _fd_derivatives(dynamics, stage_cost, terminal_cost, equality_constraints,
                    inequality_constraints) -> Derivatives:
    """Finite differences with the reference's epsilons (the parity mode)."""
    fx, fu = fd_jacobians(dynamics)
    eq_gx, eq_gu = fd_jacobians(equality_constraints) if equality_constraints else (None, None)
    ineq_gx, ineq_gu = (fd_jacobians(inequality_constraints) if inequality_constraints
                        else (None, None))
    return Derivatives(
        fx=fx,
        fu=fu,
        lx=lambda x, u, t: fd.fd_gradient(lambda y: stage_cost(y, u, t), x, eps=1e-6),
        lu=lambda x, u, t: fd.fd_gradient(lambda w: stage_cost(x, w, t), u, eps=1e-6),
        lxx=lambda x, u, t: fd.fd_hessian(lambda y: stage_cost(y, u, t), x, eps=1e-5),
        luu=lambda x, u, t: fd.fd_hessian(lambda w: stage_cost(x, w, t), u, eps=1e-5),
        lux=lambda x, u, t: fd.fd_cross_term(lambda y, w: stage_cost(y, w, t), x, u, eps=1e-6),
        phix=lambda x: fd.fd_gradient(terminal_cost, x, eps=1e-6),
        phixx=lambda x: fd.fd_hessian(terminal_cost, x, eps=1e-5),
        eq_gx=eq_gx,
        eq_gu=eq_gu,
        ineq_gx=ineq_gx,
        ineq_gu=ineq_gu,
    )


def make_derivatives(
    dynamics: MotionModel,
    stage_cost: StageCostFunction,
    terminal_cost: TerminalCostFunction,
    equality_constraints: Optional[ConstraintsFunction] = None,
    inequality_constraints: Optional[ConstraintsFunction] = None,
    mode: str = "ad",
    **overrides,
) -> Derivatives:
    """Build the oracle bundle of ``mode`` (``"ad"``: exact, ``"fd"``: the
    reference's central differences); any oracle may be overridden by an
    analytic callable (``overrides`` keys are :class:`Derivatives`
    fields).  The constraint Jacobians are None without the constraint."""
    if mode == "ad":
        derivs = _ad_derivatives(dynamics, stage_cost, terminal_cost, equality_constraints,
                                 inequality_constraints)
    elif mode == "fd":
        derivs = _fd_derivatives(dynamics, stage_cost, terminal_cost, equality_constraints,
                                 inequality_constraints)
    else:
        raise ValueError(f"unknown derivative mode {mode!r} (expected 'ad' or 'fd')")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    unknown = set(overrides) - {f.name for f in dataclasses.fields(Derivatives)}
    if unknown:
        raise ValueError(f"unknown derivative overrides: {sorted(unknown)}")
    return derivs.replace(**overrides) if overrides else derivs


def map_leading(fn: Callable, *args, lead: tuple):
    """``fn`` of one problem (or problem-stage) over the leading axes
    ``lead`` of ``args`` -- ``torch.func.vmap`` over their flattening -- in
    the dtype of the first argument: forward-mode AD of some PyTorch builds
    (2.13 on the CPU) gives a 0-d tensor times a Python float a float64
    tangent."""
    n = math.prod(lead)
    out = vmap(fn)(*(a.reshape((n,) + a.shape[len(lead):]) for a in args))
    return out.reshape(tuple(lead) + out.shape[1:]).to(args[0].dtype)
