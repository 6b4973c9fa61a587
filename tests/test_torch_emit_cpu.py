"""K9 and K8 on the CPU: the real ``csrc`` sources, built by g++.

K9 (``csrc/forward_pass.cu``) runs a block of 32 problems by the
candidates (threadIdx.y, one or two candidates a thread, in chunks of 32,
a launch each); K8 (``csrc/forward_select.cuh``, instantiated in
``forward_select_emit*.cu``) runs one kernel a thread a problem -- the
select with AL where the instantiation has constraint rows, the re-roll
at the kept alpha (0 where no candidate improved), the stacks by K3's
device code -- or with a context three: the group select, the re-roll, and
K3's context mode (``csrc/linearize.cuh``) at the emitted trajectory.  Both
are built
here by g++ against ``tests/cuda_on_cpu/cuda_runtime.h`` (see
test_torch_riccati_lanes.py) and called through the port's own wrappers
(``ops/forward_pallas.py::launch_forward_pass``,
``ops/forward_select.py::launch_forward_select_emit_lin``), with
``ops/_build.py``'s library pointed at the g++ build.  K9 is held to its
plain version at rtol = atol = 1e-5 (as ``chip_smoke.py`` phase 22c), NaN
where the plain version is NaN; K8's merit, accept flags and trajectory to
its plain version (merit rtol 1e-5, the trajectory rtol = atol = 1e-5; with
a context atol 1e-5 of the scale, as phase 13), and its stacks exactly to
K3's g++ launch at the trajectory K8 emitted.
"""

import contextlib
import ctypes
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
from multi_agent_solver_tpu_torch.ops import forward_pallas as k9
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.strategies.nash import make_coupled_stage
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches

SOURCES = ("forward_pass.cu", "forward_select_emit.cu", "forward_select_emit_ctx.cu",
           "forward_select_emit_al.cu", "linearize.cu")
T, NX, NU = 6, 4, 2
LADDER = (1.0, 0.5, 0.125)
TEN = tuple(0.5 ** i for i in range(10))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """K9's, K8's and K3's entry points of ``csrc``, built by g++ for the
    CPU."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_emit")
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
                    str(d / "k8k9.so")], check=True)
    return ctypes.CDLL(str(d / "k8k9.so"))


@pytest.fixture
def launches_on_cpu(lib, monkeypatch):
    """The wrappers' ``launch_*`` functions call the g++ build on CPU
    tensors: the library, the CUDA device guard and the stream stubbed."""
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


def _tensors(*arrays):
    return tuple(torch.as_tensor(a.astype(np.float32)).contiguous() for a in arrays)


def _lane_inputs(nb, seed, poison=False):
    """Lane-follow reference states and controls in the box, and gains; with
    ``poison`` problem 0 starts with a NaN heading and problem 1 at an
    infinite position."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(0, 5, (T, nb)), rng.uniform(-1.5, 1.5, (T, nb)),
                  rng.uniform(-0.6, 0.6, (T, nb)), rng.uniform(0, 2, (T, nb))], 1)
    u = np.stack([rng.uniform(-0.7, 0.7, (T, nb)), rng.uniform(-1, 1, (T, nb))], 1)
    k = rng.uniform(-0.5, 0.5, (T, NU, nb))
    K = rng.uniform(-0.2, 0.2, (T, NU, NX, nb))
    if poison:
        x[0, 2, 0], x[0, 0, 1] = np.nan, np.inf
    return _tensors(x, u, k, K)


def _bounds(spec, nb):
    return tuple(torch.as_tensor(b, dtype=torch.float32).expand(nb, NU).T.contiguous()
                 for b in (spec.input_lower_bounds, spec.input_upper_bounds))


@pytest.mark.parametrize("nb", [37, 300])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("A", [3, 5, 10])
def test_forward_pass_kernel_matches_plain(launches_on_cpu, A, bounded, nb):
    """K9 against ``forward_pass_plain``: A = 3, 10 and 5 (one chain a
    thread at odd A, two at even A), bounded and unbounded, one part-filled block at 37 problems
    and ten at 300 (the last part-filled), two problems from non-finite
    starts, whose states are NaN from the first stage on."""
    spec = entry.single_track_spec(horizon=T, device="cpu")
    if not bounded:
        spec = spec.replace(input_lower_bounds=None, input_upper_bounds=None)
    xs, us, k, K = _lane_inputs(nb, seed=10 * A + nb, poison=True)
    alphas = TEN[:A] if A != 3 else LADDER
    k9.STATS.reset()
    got = k9.launch_forward_pass(spec, xs, us, k, K, alphas)
    assert (k9.STATS.launches, k9.STATS.plain_calls) == (1, 0)
    want = k9.forward_pass_plain(spec, xs, us, k, K, alphas)
    for name, g, w in zip(("xs", "us", "cost"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, equal_nan=True, msg=name)
    assert torch.isnan(got[0][:, :, :, :2]).all() and torch.isfinite(got[0][:, :, :, 2:]).all()
    clamped = got[1][..., 2:].abs().amax(dim=(0, 2, 3))
    assert bool((clamped <= torch.tensor([0.7, 1.0])).all()) == bounded


def test_forward_pass_kernel_chunks_candidates(launches_on_cpu):
    """K9 at A = 40: two chunks of candidates, a launch each, the second
    part-filled."""
    spec = entry.single_track_spec(horizon=T, device="cpu")
    xs, us, k, K = _lane_inputs(37, seed=40)
    alphas = tuple(1.0 - 0.02 * a for a in range(40))
    got = k9.launch_forward_pass(spec, xs, us, k, K, alphas)
    want = k9.forward_pass_plain(spec, xs, us, k, K, alphas)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _coupled_spec():
    base = entry.circular_sweep_specs(1, 1, device="cpu")
    return with_context_cost(base, make_coupled_stage(base.stage_cost,
                                                      circ.make_collision_cost(entry.COUPLING)))


def _ring_inputs(nb, seed, n_ctx=5):
    """States around the track, controls in the box, gains, and n_ctx
    neighbours a stage within a few metres of the car."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, (T, nb))
    r = 20.0 + rng.uniform(-1, 1, (T, nb))
    x = np.stack([r * np.cos(th), r * np.sin(th), th + 1.57, rng.uniform(3, 6, (T, nb))], 1)
    u = rng.uniform(-0.5, 0.5, (T, NU, nb))
    k = rng.uniform(-0.3, 0.3, (T, NU, nb))
    K = rng.uniform(-0.2, 0.2, (T, NU, NX, nb))
    ctx = x[:, None] + np.concatenate([rng.normal(0, 2.0, (T, n_ctx, 2, nb)),
                                       rng.normal(0, 0.5, (T, n_ctx, 2, nb))], 2)
    return _tensors(x, u, k, K, ctx)


def _emit_case(context, nb, seed):
    """(spec, xs, us, k, K, merit, lb, ub, alphas, ctx): merits a random
    0.8-1.2 of the reference rollout's cost, so that some problems accept
    and some do not."""
    rng = np.random.RandomState(seed)
    if context:
        spec = _coupled_spec()
        xs, us, k, K, ctx = _ring_inputs(nb, seed)
        lb = torch.full((NU, nb), -0.5)
        ub = -lb
        alphas = TEN
    else:
        spec = entry.single_track_spec(horizon=T, device="cpu")
        (xs, us, k, K), ctx = _lane_inputs(nb, seed), None
        lb, ub = _bounds(spec, nb)
        alphas = LADDER
    _, cost0 = k2.rollout_cost_plain(spec, xs[0].contiguous(), us, ctx)
    merit = cost0 * torch.as_tensor(rng.uniform(0.8, 1.2, nb), dtype=torch.float32)
    return spec, xs, us, k, K, merit, lb, ub, alphas, ctx


def _check_emit(got, want, spec, xs, ctx, discrete, atol_scale=False):
    """K8's launch ``got`` against its plain version ``want``; its stacks
    equal to K3's g++ launch at K8's own trajectory."""
    assert len(got) == len(want) == 11
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0, equal_nan=True)
    for name, g, w in zip(("xs", "us"), got[:2], want[:2]):
        atol = 1e-5 * float(w.abs().max()) if atol_scale else 1e-5
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol, msg=name)
    xs_k = torch.cat([xs[:1], got[0][:-1]], 0).contiguous()
    lin = k3.launch_linearize(spec, xs_k, got[1], True, ctx, discrete)
    for name, g, w in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux"), got[4:], lin):
        assert torch.equal(g, w), name
    plain = k3.linearize_plain(spec, xs_k, got[1], True, ctx, discrete)
    for name, g, w in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux"), got[4:], plain):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())),
                                   msg=name)


@pytest.mark.parametrize("context", [False, True])
@pytest.mark.parametrize("discrete", [True, False])
def test_emit_kernels_match_plain_and_k3(launches_on_cpu, discrete, context):
    """K8 without and with a context (one kernel; the group select), both
    Jacobian modes: the select and the trajectory against the plain
    version, the stacks equal to K3's launch at K8's trajectory; some
    problems accept and some do not."""
    nb = 37 if context else 300
    spec, xs, us, k, K, merit, lb, ub, alphas, ctx = _emit_case(context, nb, seed=5 + context)
    k2.EMIT_STATS.reset()
    got = k2.launch_forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas, ctx,
                                            discrete)
    assert (k2.EMIT_STATS.launches, k2.EMIT_STATS.plain_calls) == (1, 0)
    want = k2.forward_select_emit_lin_plain(spec, xs, us, k, K, merit, lb, ub, alphas, ctx,
                                            discrete)
    assert 0 < int(got[3].sum()) < nb
    _check_emit(got, want, spec, xs, ctx, discrete, atol_scale=context)


def test_emit_rerolls_rejected_problems_at_alpha_zero(launches_on_cpu):
    """Where no candidate beats the merit (-inf, NaN, or below every
    total), K8 keeps the merit and re-rolls the problem at alpha 0 -- the
    feedback rollout that K9 gives at alpha 0 -- not at the ladder's
    first alpha."""
    nb = 37
    spec, xs, us, k, K, merit, lb, ub, alphas, _ = _emit_case(False, nb, seed=9)
    merit = merit.clone()
    merit[:10] = -1.0
    merit[10], merit[11] = float("-inf"), float("nan")
    got = k2.launch_forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas)
    want = k2.forward_select_emit_lin_plain(spec, xs, us, k, K, merit, lb, ub, alphas)
    _check_emit(got, want, spec, xs, None, True)
    assert not got[3][:12].any() and got[3][12:].any()
    torch.testing.assert_close(got[2][:12], merit[:12], equal_nan=True, rtol=0.0, atol=0.0)
    at_zero = k9.forward_pass_plain(spec, xs, us, k, K, (0.0,))
    at_first = k9.forward_pass_plain(spec, xs, us, k, K, alphas[:1])
    torch.testing.assert_close(got[0][..., :12], at_zero[0][:, :, 0, :12], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1][..., :12], at_zero[1][:, :, 0, :12], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got[0][..., :12], at_first[0][:, :, 0, :12], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("discrete", [True, False])
def test_emit_al_matches_plain(launches_on_cpu, discrete):
    """K8 with AL multipliers on the speed cap (one inequality row,
    ``entry.SPEED_CAP``): the lane kernel's AL select scores the AL merit;
    the stacks are the un-augmented cost's, K3's at K8's trajectory."""
    nb = 300
    spec, xs, us, k, K, merit, lb, ub, alphas, _ = _emit_case(False, nb, seed=13)
    spec = spec.replace(inequality_constraints=entry.SPEED_CAP, ineq_dim=1)
    rng = np.random.RandomState(14)
    mult = torch.as_tensor(rng.uniform(0, 3, (T, 1, nb)) * (rng.uniform(size=(T, 1, nb)) < 0.7),
                           dtype=torch.float32).contiguous()
    rho = torch.as_tensor(10.0 ** rng.uniform(0, 3, nb), dtype=torch.float32)
    xs = xs.clone()
    xs[:, 3] = xs[:, 3] + 3.0          # speeds about the cap of 4.5, so that the row acts
    _, cost0 = k2.rollout_cost_plain(spec, xs[0].contiguous(), us)
    merit = cost0 * torch.as_tensor(rng.uniform(0.9, 1.4, nb), dtype=torch.float32)
    al = dict(ineq_mult=mult, rho=rho, act_tol=1e-3)
    k2.EMIT_STATS.reset()
    got = k2.launch_forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas, None,
                                            discrete, **al)
    assert k2.EMIT_STATS.launches == 1
    want = k2.forward_select_emit_lin_plain(spec, xs, us, k, K, merit, lb, ub, alphas, None,
                                            discrete, **al)
    free = k2.forward_select_emit_lin_plain(spec, xs, us, k, K, merit, lb, ub, alphas, None,
                                            discrete)
    assert 0 < int(got[3].sum()) < nb
    assert (want[3] != free[3]).any()          # the AL terms moved the selection
    _check_emit(got, want, spec, xs, None, discrete)


def test_emit_al_without_instantiation_raises(launches_on_cpu):
    """K8 with AL multipliers where the constraint rows have no
    instantiation (the speed cap with the coupled context cost): the
    wrapper raises before any launch and names the missing symbol; no
    plain version stands in."""
    nb = 37
    spec, xs, us, k, K, merit, lb, ub, alphas, ctx = _emit_case(True, nb, seed=17)
    spec = spec.replace(inequality_constraints=entry.SPEED_CAP, ineq_dim=1)
    al = dict(ineq_mult=torch.zeros((T, 1, nb)), rho=torch.ones(nb), act_tol=1e-3)
    k2.EMIT_STATS.reset()
    with pytest.raises(NotImplementedError,
                       match=r"no CUDA instantiation mas_forward_select_emit__\w+coupled\w+"):
        k2.launch_forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas, ctx, True,
                                          **al)
    assert (k2.EMIT_STATS.launches, k2.EMIT_STATS.plain_calls) == (0, 0)
