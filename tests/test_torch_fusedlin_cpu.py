"""K1's kernel on the CPU: the real ``csrc`` sources, built by g++.

K1 (``riccati_fusedlin_kernel``) linearizes each stage in the kernel with
``stage_derivatives_live``: tangents only for the state components the
dynamics read (psi and v at the single track) and the controls, the
other columns of A written exactly, sin and cos of psi taken once an
evaluation and tan(delta) once a step.  K3 (``linearize.cu``) keeps the
pass in all NX + NU tangents, and K4 runs the same ``stage_core`` on its
stacks, so K3 over the horizon followed by K4 with time-constant Hessians
must give K1's gains exactly, in the discrete and the continuous Jacobian
mode, clamp and boxqp.  Both are built here by g++ against
``tests/cuda_on_cpu/cuda_runtime.h`` (see test_torch_riccati_lanes.py),
on inputs with non-zero steering, so that tan(delta) and every live
tangent carry weight; the gains are also held to ``ops/riccati.py``'s
plain version within ``chip_smoke.py``'s tolerances (phases 3, 8, 19).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.ops._build import problem_symbol, step_constants
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches, launch

SOURCES = ("riccati.cu", "linearize.cu")
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)
T, NB = 6, 9


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """K1's, K3's and K4's entry points of ``csrc``, built by g++ for the CPU."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_fusedlin")
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
                    str(d / "k1.so")], check=True)
    return ctypes.CDLL(str(d / "k1.so"))


@pytest.fixture(scope="module")
def inputs():
    """A rollout of the lane-follow spec from seeded states (psi in
    [-1, 1], v in [0, 2]) under seeded controls inside the input bounds;
    the cost's Hessians of one stage, x_T and the delta bounds."""
    rng = np.random.RandomState(7)
    spec = entry.single_track_spec(horizon=T, device="cpu")
    x0 = np.stack([rng.standard_normal(NB), rng.standard_normal(NB), rng.uniform(-1, 1, NB),
                   rng.uniform(0, 2, NB)]).astype(np.float32)
    us = np.stack([rng.uniform(-0.7, 0.7, (T, NB)), rng.uniform(-1, 1, (T, NB))], 1)
    x0 = torch.as_tensor(x0)
    us = torch.as_tensor(us.astype(np.float32)).contiguous()
    xs_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0).contiguous()
    hess = [h[0].contiguous() for h in k3.linearize_plain(spec, xs[:1].contiguous(),
                                                          us[:1].contiguous(), True)[4:]]
    lb = torch.tensor([-0.7, -1.0])[None, :, None]
    ub = torch.tensor([0.7, 1.0])[None, :, None]
    box = ((lb - us).contiguous(), (ub - us).contiguous())
    return spec, xs, us, hess, xs_tail[-1].contiguous(), box


def kernel_gains(lib, spec, xs, us, hess, xT, bounds, discrete):
    """K1 as built, and K3 over the horizon followed by K4 (time-constant
    Hessians) as built, on the same inputs."""
    nx, nu = xs.shape[1], us.shape[1]
    nan = lambda *s: torch.full(s, float("nan"))
    k, K = nan(T, nu, NB), nan(T, nu, nx, NB)
    symbol, (dyn_p, cost_p, term_p) = problem_symbol(
        "riccati_fusedlin", nx, nu, spec.dynamics, spec.stage_cost, spec.terminal_cost)
    launch(lib, symbol, xs, us, *hess, *bounds, xT, k, K, T, NB, int(discrete), dyn_p, cost_p,
           term_p, step_constants(spec.dt), tuple(LEVELS), len(LEVELS))
    lin = [nan(T, nx, nx, NB), nan(T, nx, nu, NB), nan(T, nx, NB), nan(T, nu, NB)]
    symbol, (dyn_p, cost_p) = problem_symbol("linearize", nx, nu, spec.dynamics, spec.stage_cost)
    launch(lib, symbol, xs, us, *lin, None, None, None, None, T, NB, 0, nx, 0, int(discrete),
           dyn_p, cost_p, step_constants(spec.dt))
    k4, K4 = nan(T, nu, NB), nan(T, nu, nx, NB)
    launch(lib, "mas_riccati_backward__single_track__zero", *lin, *(h[None] for h in hess),
           *bounds, xT, k4, K4, T, NB, 1, (), tuple(LEVELS), len(LEVELS))
    return (k, K), (k4, K4)


@pytest.mark.parametrize("discrete", [True, False])
@pytest.mark.parametrize("boxqp", [False, True])
def test_fusedlin_matches_linearize_then_backward(lib, inputs, discrete, boxqp):
    """K1's gains equal K3 -> K4's exactly (-0 equal to +0, as
    torch.equal compares), and the plain version's within the chip's
    tolerances: rtol 1e-4 and atol 1e-5 in clamp mode, atol 1e-4 with the
    box QP."""
    spec, xs, us, hess, xT, box = inputs
    bounds = box if boxqp else (None, None)
    (k, K), (k4, K4) = kernel_gains(lib, spec, xs, us, hess, xT, bounds, discrete)
    assert not (k.isnan().any() or K.isnan().any())
    assert torch.equal(k, k4) and torch.equal(K, K4)
    kp, Kp = k1.riccati_fusedlin_plain(spec, xs, us, *hess, xT, LEVELS, *bounds, discrete)
    atol = 1e-4 if boxqp else 1e-5
    torch.testing.assert_close(k, kp, rtol=1e-4, atol=atol)
    torch.testing.assert_close(K, Kp, rtol=1e-4, atol=atol)


def test_op_counts_match_chip_smoke_bounds():
    """chip_smoke.py's K1 operation counts, which its bound_ms rows use,
    are what op_counts.py counts from K1's arithmetic."""
    import chip_smoke
    import op_counts

    A, B, lx, lu = op_counts.linearization(True)
    outputs, solve_in, gains = op_counts.stage(A, B, lx, lu)
    assert chip_smoke.OPS_K1_STAGE == op_counts.count(outputs)
    assert chip_smoke.OPS_K1_SOLVE == op_counts.count(gains) - op_counts.count(solve_in)
    outputs = op_counts.stage(*op_counts.linearization(False))[0]
    assert chip_smoke.OPS_K1_CONT == op_counts.count(outputs)
