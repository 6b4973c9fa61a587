"""Core types, parameter handling and device selection.

PyTorch counterpart of ``multi_agent_solver_tpu/types.py``.  Problems are
plain functions over ``torch.Tensor`` values written on ``x[..., i]``, so
every leading axis (batch, time) broadcasts:

* ``MotionModel``          ``f(x [..., nx], u [..., nu]) -> [..., nx]``
* ``StageCostFunction``    ``l(x, u, t) -> [...]``
* ``TerminalCostFunction`` ``lT(x) -> [...]``

A torch callable cannot run inside a CUDA kernel.  A callable that has a
hand-written device counterpart in ``csrc/problems.cuh`` carries a
:class:`DeviceFn` tag naming it and its float parameters; the kernel
wrappers dispatch on that tag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

Tensor = torch.Tensor

MotionModel = Callable[[Tensor, Tensor], Tensor]
StageCostFunction = Callable[[Tensor, Tensor, object], Tensor]
TerminalCostFunction = Callable[[Tensor], Tensor]
ObjectiveFunction = Callable[[Tensor, Tensor], Tensor]
ConstraintsFunction = Callable[[Tensor, Tensor], Tensor]

SolverParams = Mapping[str, float]


def get_param(params: SolverParams, key: str, default: Optional[float] = None) -> float:
    """Look up ``key`` in a reference-style parameter map.

    Raises ``KeyError`` when ``default`` is None and the key is missing
    (the reference's required-key ``params.at(...)``).
    """
    if key in params:
        return float(params[key])
    if default is None:
        raise KeyError(f"required solver parameter '{key}' missing")
    return default


def param_flag(params: SolverParams, key: str) -> bool:
    """Boolean flag semantics of the reference: present and > 0.5."""
    return key in params and float(params[key]) > 0.5


@dataclasses.dataclass(frozen=True)
class DeviceFn:
    """The CUDA device function that computes a torch callable.

    ``name`` selects the template in ``csrc/problems.cuh`` and ``params``
    are its float parameters, in the order that template reads them.
    """

    name: str
    params: tuple = ()


def tag_device_fn(fn: Callable, name: str, params=()) -> Callable:
    """Attach a :class:`DeviceFn` tag to ``fn`` and return ``fn``."""
    fn.device_fn = DeviceFn(name, tuple(float(p) for p in params))
    return fn


def device_fn_of(fn: Callable) -> Optional[DeviceFn]:
    """The :class:`DeviceFn` tag of ``fn``, or None for an untagged callable."""
    return getattr(fn, "device_fn", None)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
