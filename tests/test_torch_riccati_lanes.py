"""K4's kernels on the CPU: the real ``csrc`` sources, built by g++.

Below its crossover (``csrc/riccati.cuh::backward_group_max_b``) K4 runs on
``riccati_backward_group_kernel``: a group of G lanes a problem (G: nx
rounded up to a power of two), 32 // G problems a 32-thread block, the
lanes exchanging columns by shuffles.  On the card ``chip_smoke.py``
(phases 8, 15, 19 and 24) holds it to the plain versions and
``kernel_times.py`` to the one-thread kernel by a digest of its gains.
Here g++ compiles the same sources against ``tests/cuda_on_cpu/
cuda_runtime.h``, which runs a block's threads as std::threads and meets
a warp's lanes at a barrier for every shuffle, once each launch
``kernel<<<grid, block, 0, stream>>>(args)`` is rewritten as a call of its
``mas_launch``.  Each lane's sums run in the one-thread kernel's order,
which is the plain version's, so the gains are held to
``ops/riccati.py``'s plain versions with ``torch.equal`` at a few problems
and stages: each instantiated (nx, nu), clamp and boxqp, per-stage and
time-constant Hessians, and batches that end in a part-filled block.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.ops import riccati as k1

CSRC = Path(k1.__file__).resolve().parent.parent / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_on_cpu"
# K4's sources: the fused loop's entry point (in-kernel terminal value) and
# the explicit-terminal mode's, each instantiated (nx, nu).
SOURCES = ("riccati.cu", "riccati_explicit.cu", "riccati_explicit_wide.cu",
           "riccati_explicit_wide_group.cu")
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<([^>]*)>>>\s*\(")


def cpu_launches(src):
    """``kernel<...><<<grid, block, 0, stream>>>(args)`` as
    ``mas_launch(grid, block, [=] { kernel<...>(args); })``."""
    out, pos = [], 0
    for m in LAUNCH.finditer(src):
        depth, end = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        grid, block = (a.strip() for a in m.group(2).split(",")[:2])
        out += [src[pos:m.start()],
                f"mas_launch({grid}, {block}, [=] {{ {m.group(1)}({src[m.end():end - 1]}); }})"]
        pos = end
    return "".join(out) + src[pos:]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The K4 entry points of ``csrc``, built by g++ for the CPU."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_cpu")
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
                    str(d / "k4.so")], check=True)
    return ctypes.CDLL(str(d / "k4.so"))


def launch(lib, symbol, *args):
    """Call the C launcher ``symbol`` as ``ops/_build.launch`` does, with a
    null stream."""
    c_args = []
    for a in args:
        if isinstance(a, torch.Tensor):
            c_args.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            c_args.append(ctypes.c_void_p(0))
        elif isinstance(a, tuple):
            c_args.append(ctypes.cast((ctypes.c_float * max(1, len(a)))(*a), ctypes.c_void_p))
        else:
            c_args.append(ctypes.c_int(a))
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    assert fn(*c_args, ctypes.c_void_p(0)) == 0


def stacks_of(nx, nu, T, nb, hconst, seed):
    """Random K4 inputs ``[T or 1, ..., B]``: A near the identity, PSD lxx,
    luu indefinite at a third of the problems (so that the ladder climbs),
    delta bounds around 0, a PSD initial v_xx."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    H = 1 if hconst else T
    A = (0.9 * torch.eye(nx)[None, :, :, None] + 0.1 * f(T, nx, nx, nb)).contiguous()
    M, N = f(H, nx, nx, nb), f(H, nu, nu, nb)
    lxx = (torch.einsum("hijb,hkjb->hikb", M, M) / nx).contiguous()
    flip = torch.as_tensor(rng.uniform(size=(H, 1, 1, nb)) < 0.3, dtype=torch.float32)
    luu = (torch.einsum("hijb,hkjb->hikb", N, N) / nu
           + (0.05 - 3.0 * flip) * torch.eye(nu)[None, :, :, None]).contiguous()
    stacks = (A, 0.3 * f(T, nx, nu, nb), f(T, nx, nb), f(T, nu, nb), lxx, luu,
              0.2 * f(H, nu, nx, nb))
    box = (-torch.as_tensor(rng.uniform(0.01, 1.5, (T, nu, nb)).astype(np.float32)),
           torch.as_tensor(rng.uniform(0.01, 1.5, (T, nu, nb)).astype(np.float32)))
    V = f(nx, nx, nb)
    return stacks, box, f(nx, nb), (torch.einsum("ijb,kjb->ikb", V, V) / nx).contiguous()


def gains_buffers(T, nx, nu, nb):
    """k and K filled with NaN, so that a problem no lane wrote shows."""
    return (torch.full((T, nu, nb), float("nan")), torch.full((T, nu, nx, nb), float("nan")))


def explicit_gains(lib, nx, nu, T, nb, boxqp, seed):
    """K4's explicit-terminal mode and its plain version on seeded stacks."""
    stacks, box, vx0, vxx0 = stacks_of(nx, nu, T, nb, False, seed)
    bounds = box if boxqp else (None, None)
    k, K = gains_buffers(T, nx, nu, nb)
    launch(lib, f"mas_riccati_explicit__{nx}x{nu}", *stacks, *bounds, vx0, vxx0, k, K, T, nb,
           tuple(LEVELS), len(LEVELS))
    return (k, K), k1.riccati_backward_explicit_plain(*stacks, vx0, vxx0, LEVELS, *bounds)


@pytest.mark.parametrize("nx, nu, nb", [(4, 2, 8), (4, 2, 11), (2, 1, 8), (2, 1, 33),
                                        (6, 3, 8), (6, 3, 11), (8, 4, 8), (8, 4, 5)])
@pytest.mark.parametrize("boxqp", [False, True])
def test_group_mapping_matches_plain(lib, nx, nu, nb, boxqp):
    """The explicit-terminal mode at each instantiated (nx, nu), T = 4."""
    got, want = explicit_gains(lib, nx, nu, 4, nb, boxqp, seed=nx * 100 + nb + 2 * boxqp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("boxqp", [False, True])
@pytest.mark.parametrize("hconst", [False, True])
def test_group_mapping_in_kernel_terminal_matches_plain(lib, boxqp, hconst):
    """The fused loop's mode: the initial value from the lane-follow spec's
    terminal cost, per-stage or time-constant Hessians."""
    T, nb = 4, 8
    spec = entry.single_track_spec(horizon=T, device="cpu")
    stacks, box, _, _ = stacks_of(4, 2, T, nb, hconst, seed=9 + 2 * boxqp + hconst)
    bounds = box if boxqp else (None, None)
    xT = torch.as_tensor(np.random.RandomState(10).standard_normal((4, nb)).astype(np.float32))
    k, K = gains_buffers(T, 4, 2, nb)
    launch(lib, "mas_riccati_backward__single_track__zero", *stacks, *bounds, xT, k, K, T, nb,
           int(hconst), (), tuple(LEVELS), len(LEVELS))
    want = k1.riccati_backward_plain(spec, *stacks, xT, LEVELS, *bounds)
    assert torch.equal(k, want[0]) and torch.equal(K, want[1])


@pytest.mark.parametrize("nb", [1, 7, 9, 33, 1001])
def test_group_coverage_with_tail(lib, nb):
    """Every problem of a batch that ends in a part-filled block (8
    problems a block at nx = 4) gets its gains, and only its own."""
    got, want = explicit_gains(lib, 4, 2, 2, nb, False, seed=nb)
    assert not got[1].isnan().any()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
