"""K2's rollout kernel and K3's hoist mode on the CPU: the real ``csrc``
sources, built by g++.

``forward_rollout_kernel`` (``csrc/forward_select.cuh``) runs K2's rollout
mode, one thread a problem, with or without a context, and
``linearize_hessians_kernel`` (``csrc/linearize.cu``) K3's hoist mode, the
cost Hessians alone.  Both are built here by g++ against
``tests/cuda_on_cpu/cuda_runtime.h`` (see test_torch_riccati_lanes.py) and
called through the port's own wrappers (``ops/forward_select.py::
launch_rollout_cost``, ``ops/linearize.py::launch_linearize_hessians``),
``ops/_build.py``'s library pointed at the g++ build.  The rollout is held
to its plain version at float32 tolerance (rtol 1e-5, as ``chip_smoke.py``
phase 3 holds it; with a context rtol 1e-5 and a floor of 1e-5 of the
scale, as phase 13), NaN where the plain version is NaN, on problems whose
states stop being finite; the hoist's Hessians equal K3's last three
outputs exactly, at one stage and over a horizon.
"""

import contextlib
import ctypes
import math
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.examples import multi_agent_single_track as circ
from multi_agent_solver_tpu_torch.ocp import with_context_cost
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.strategies.nash import make_coupled_stage
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches

SOURCES = ("forward_select.cu", "linearize.cu")
T = 6


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The select kernels' and K3's entry points of ``csrc``, built by g++
    for the CPU."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_rollout")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (d / f.name).write_text(cpu_launches(f.read_text()))
    flags = ["g++", "-std=c++20", "-O0", "-ffp-contract=off", "-fPIC", "-pthread",
             f"-I{STUB}", f"-I{d}", "-x", "c++", "-c"]
    builds = [subprocess.Popen(flags + [str(d / s), "-o", str(d / f"{s}.o")],
                               stderr=subprocess.PIPE, text=True) for s in SOURCES]
    for p in builds:
        assert p.wait() == 0, p.stderr.read()
    subprocess.run(["g++", "-shared", "-pthread", *(str(d / f"{s}.o") for s in SOURCES), "-o",
                    str(d / "k2k3.so")], check=True)
    return ctypes.CDLL(str(d / "k2k3.so"))


@pytest.fixture
def launches_on_cpu(lib, monkeypatch):
    """The wrappers' ``launch_*`` functions call the g++ build on CPU
    tensors: the library, the CUDA device guard and the stream stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


def _lane_problems(nb, seed, drawn):
    """Lane-follow starts (psi in [-1, 1], v in [0, 2]) and controls inside
    the bounds (zero: the main path's warm start); with ``drawn`` two
    problems start from states that are not finite -- a NaN heading and an
    infinite position -- so that every control is NaN and the cost +inf."""
    rng = np.random.RandomState(seed)
    x0 = np.stack([rng.standard_normal(nb), rng.standard_normal(nb), rng.uniform(-1, 1, nb),
                   rng.uniform(0, 2, nb)]).astype(np.float32)
    us = np.zeros((T, 2, nb), np.float32)
    if drawn:
        us = np.stack([rng.uniform(-0.7, 0.7, (T, nb)), rng.uniform(-1, 1, (T, nb))],
                      1).astype(np.float32)
        x0[2, 0], x0[0, 1] = np.nan, np.inf
    return torch.as_tensor(x0), torch.as_tensor(us).contiguous()


@pytest.mark.parametrize("case, nb", [("lane zero", 37), ("lane drawn", 37),
                                      ("lane zero", 300), ("circular drawn", 37)])
def test_rollout_kernel_matches_plain(launches_on_cpu, case, nb):
    """The rollout kernel against ``rollout_cost_plain``: one part-filled
    128-thread block at 37 problems, three at 300; the lane-follow spec on
    zero and drawn controls, the circular track's on drawn ones."""
    spec = (entry.single_track_spec(horizon=T, device="cpu") if case.startswith("lane")
            else entry.circular_sweep_specs(1, 1, device="cpu"))
    x0, us = _lane_problems(nb, seed=nb, drawn=case.endswith("drawn"))
    k2.ROLLOUT_STATS.reset()
    xs, cost = k2.launch_rollout_cost(spec, x0, us)
    assert (k2.ROLLOUT_STATS.launches, k2.ROLLOUT_STATS.plain_calls) == (1, 0)
    xs_p, cost_p = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(xs, xs_p, rtol=1e-5, atol=1e-5, equal_nan=True)
    torch.testing.assert_close(cost, cost_p, rtol=1e-5, atol=0.0)
    if case.endswith("drawn"):
        assert torch.isnan(xs[:, :, :2]).all()          # NaN controls from stage 0 on
        assert torch.isfinite(xs[:, :, 2:]).all()
        assert (cost[:2] == math.inf).all() and torch.isfinite(cost[2:]).all()


def test_rollout_kernel_context_matches_plain(launches_on_cpu):
    """The context instantiation (one car of the coupled game) on a small
    game: 37 problems, 11 neighbours each (a part-filled group of pairs),
    drawn controls."""
    base = entry.circular_sweep_specs(1, 1, device="cpu")
    spec = with_context_cost(base, make_coupled_stage(base.stage_cost,
                                                      circ.make_collision_cost(entry.COUPLING)))
    nb, K = 37, 11
    rng = np.random.RandomState(5)
    th = rng.uniform(0, 2 * np.pi, nb)
    x0 = np.stack([20 * np.cos(th), 20 * np.sin(th), th + 1.57, rng.uniform(3, 6, nb)])
    us = rng.uniform(-0.5, 0.5, (T, 2, nb))
    ctx = (x0[None, None] + np.concatenate([rng.normal(0, 2.0, (T, K, 2, nb)),
                                            rng.normal(0, 0.5, (T, K, 2, nb))], 2))
    x0, us, ctx = (torch.as_tensor(a.astype(np.float32)).contiguous() for a in (x0, us, ctx))
    k2.ROLLOUT_STATS.reset()
    xs, cost = k2.launch_rollout_cost(spec, x0, us, ctx)
    assert k2.ROLLOUT_STATS.launches == 1
    xs_p, cost_p = k2.rollout_cost_plain(spec, x0, us, ctx)
    for got, want in ((xs, xs_p), (cost, cost_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("horizon", [1, T])
@pytest.mark.parametrize("track", [False, True])
def test_hoist_kernel_equals_linearize_hessians(launches_on_cpu, horizon, track):
    """The hoist's Hessians are K3's last three outputs bit for bit (one
    device function on the same inputs), at one stage and over a horizon,
    and its plain version's within float32 rounding."""
    spec = (entry.circular_sweep_specs(1, 1, device="cpu") if track
            else entry.single_track_spec(horizon=horizon, device="cpu"))
    x0, us = _lane_problems(37, seed=3 + horizon, drawn=False)
    us = us + torch.as_tensor(np.random.RandomState(4).uniform(-0.5, 0.5, us.shape),
                              dtype=torch.float32)
    xs_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0)[:horizon].contiguous()
    us = us[:horizon].contiguous()
    k3.HOIST_STATS.reset()
    hess = k3.launch_linearize_hessians(spec, xs, us)
    assert k3.HOIST_STATS.launches == 1
    want = k3.launch_linearize(spec, xs, us, True)[4:]
    assert len(hess) == 3
    for got, full in zip(hess, want):
        assert torch.equal(got, full)
    for got, plain in zip(hess, k3.linearize_hessians_plain(spec, xs, us)):
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
