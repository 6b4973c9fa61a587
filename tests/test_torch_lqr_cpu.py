"""The LQR's device functions and kernel instantiations on the CPU: the real
``csrc`` sources, built by g++.

``Linear<4, 4>``, ``Quadratic<4, 4>`` and ``QuadraticTerminal<4>``
(``csrc/problems.cuh``) are built by g++ against
``tests/cuda_on_cpu/cuda_runtime.h`` (see test_torch_riccati_lanes.py) into
a probe library: values in float, first derivatives in ``Dual<float, 8>``
and second derivatives in ``Dual<Dual<float, 8>, 8>`` at seeded points, on
the example's identity matrices and on drawn ones.  The values are held
bit for bit to the float32 torch callables of ``models/lqr.py`` (same
products, same order), the derivatives to ``torch.func`` in float64 at
rtol 1e-5 with a floor of 1e-5 of each output's scale.  Then the LQR's
instantiations run through the port's wrappers, ``ops/_build.py``'s
library pointed at a g++ build, against their plain versions at
``chip_smoke.py``'s tolerances: K1 in both Jacobian modes (and its boxqp
mode, not instantiated, raising ``NotImplementedError``), K2's rollout and
select, K3's hoist, and K4's explicit mode at (4, 4) (clamp) and at the
padded mixed fleet's (6, 2) (clamp and boxqp) on its group kernel.
"""

import contextlib
import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd

from multi_agent_solver_tpu_torch import entry
from multi_agent_solver_tpu_torch.models import lqr
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.types import device_fn_of
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches, stacks_of

torch.set_num_threads(1)

SOURCES = ("riccati_lqr.cu", "forward_select_lqr.cu", "linearize.cu", "riccati_explicit.cu")
T, NB = 7, 37
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)

PROBE = r"""
#include <cuda_runtime.h>

#include "problems.cuh"
using namespace mas;
constexpr int NZ = 8;
using D = Dual<float, NZ>;
using D2 = Dual<Dual<float, NZ>, NZ>;
using Dyn = Linear<4, 4>;
using Cost = Quadratic<4, 4>;
using Term = QuadraticTerminal<4>;

template <typename S, typename Seed>
static void inputs(const float* x, const float* u, S* xs, S* us, Seed seed) {
  for (int i = 0; i < 4; ++i) xs[i] = seed(x[i], i);
  for (int i = 0; i < 4; ++i) us[i] = seed(u[i], 4 + i);
}

// f, its Jacobian J[i][z] and its Hessians H[i][p][q], z = (x, u).
extern "C" void lqr_dynamics(const float* p, const float* x, const float* u, float* f, float* J,
                             float* H) {
  const Dyn dyn = Dyn::from(p);
  dyn(x, u, f);
  D xd[4], ud[4], fd[4];
  inputs(x, u, xd, ud, [](float v, int k) { return seed<NZ>(v, k); });
  dyn(xd, ud, fd);
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < NZ; ++k) J[i * NZ + k] = fd[i].d[k];
  D2 x2[4], u2[4], f2[4];
  inputs(x, u, x2, u2, [](float v, int k) { return seed2<NZ>(v, k); });
  dyn(x2, u2, f2);
  for (int i = 0; i < 4; ++i)
    for (int a = 0; a < NZ; ++a)
      for (int b = 0; b < NZ; ++b) H[(i * NZ + a) * NZ + b] = f2[i].d[b].d[a];
}

// The stage cost's value, gradient and Hessian in z = (x, u).
extern "C" void lqr_stage(const float* p, const float* x, const float* u, float* v, float* g,
                          float* H) {
  const Cost cost = Cost::from(p);
  *v = cost(x, u);
  D xd[4], ud[4];
  inputs(x, u, xd, ud, [](float w, int k) { return seed<NZ>(w, k); });
  const D c = cost(xd, ud);
  for (int k = 0; k < NZ; ++k) g[k] = c.d[k];
  D2 x2[4], u2[4];
  inputs(x, u, x2, u2, [](float w, int k) { return seed2<NZ>(w, k); });
  const D2 c2 = cost(x2, u2);
  for (int a = 0; a < NZ; ++a)
    for (int b = 0; b < NZ; ++b) H[a * NZ + b] = c2.d[b].d[a];
}

// The terminal cost's value, gradient and Hessian in x.
extern "C" void lqr_terminal(const float* p, const float* x, float* v, float* g, float* H) {
  const Term term = Term::from(p);
  *v = term(x);
  D xd[4];
  for (int i = 0; i < 4; ++i) xd[i] = seed<NZ>(x[i], i);
  const D c = term(xd);
  for (int k = 0; k < 4; ++k) g[k] = c.d[k];
  D2 x2[4];
  for (int i = 0; i < 4; ++i) x2[i] = seed2<NZ>(x[i], i);
  const D2 c2 = term(x2);
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) H[a * 4 + b] = c2.d[b].d[a];
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The probe library and the kernels' entry points, built by g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_lqr")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (d / f.name).write_text(cpu_launches(f.read_text()))
    (d / "probe.cpp").write_text(PROBE)
    flags = ["g++", "-std=c++20", "-O0", "-ffp-contract=off", "-fPIC", "-pthread",
             f"-I{STUB}", f"-I{d}", "-x", "c++", "-c"]
    procs = [subprocess.Popen(flags + [str(d / s), "-o", str(d / f"{s}.o")],
                              stderr=subprocess.PIPE, text=True) for s in SOURCES + ("probe.cpp",)]
    for p in procs:
        assert p.wait() == 0, p.stderr.read()
    link = lambda objs, out: subprocess.run(
        ["g++", "-shared", "-pthread", *(str(d / f"{s}.o") for s in objs), "-o", str(d / out)],
        check=True)
    link(SOURCES, "kernels.so")
    link(("probe.cpp",), "probe.so")
    return ctypes.CDLL(str(d / "probe.so")), ctypes.CDLL(str(d / "kernels.so"))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _near(got, want):
    """rtol 1e-5 with a floor of 1e-5 of the output's scale."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


def _functions(drawn):
    """The example's LQR functions (A = B = Q = R = Qf = I), or ones on
    drawn matrices (Q, R, Qf symmetric positive definite)."""
    if not drawn:
        f = entry.lqr_fleet(1, device="cpu").agents[0].ocp
        return f.dynamics, f.stage_cost, f.terminal_cost
    rng = np.random.RandomState(11)
    spd = lambda n: (lambda M: M @ M.T / n + 0.5 * np.eye(n))(rng.standard_normal((n, n)))
    return (lqr.make_linear_dynamics(rng.standard_normal((4, 4)), rng.standard_normal((4, 4))),
            lqr.quadratic_stage_cost(spd(4), spd(4)), lqr.quadratic_terminal_cost(spd(4)))


def _points(seed, n=5):
    rng = np.random.RandomState(seed)
    return _f32(rng.uniform(-2, 2, (n, 4))), _f32(rng.uniform(-1.5, 1.5, (n, 4)))


def test_tags_and_symbols():
    """The tags name the dims (linear_4x4) and carry the matrices row-major;
    the symbols and parameter counts follow."""
    dyn, stage, term = _functions(True)
    assert device_fn_of(dyn).name == "linear_4x4" and len(device_fn_of(dyn).params) == 32
    assert device_fn_of(stage).name == "quadratic" and len(device_fn_of(stage).params) == 32
    assert device_fn_of(term).name == "quadratic_terminal"
    symbol, params = _build.problem_symbol("riccati_fusedlin", 4, 4, dyn, stage, term)
    assert symbol == "mas_riccati_fusedlin__linear_4x4__quadratic__quadratic_terminal"
    assert [len(p) for p in params] == [32, 32, 16]
    with pytest.raises(ValueError):
        _build.problem_symbol("forward_select", 4, 2, dyn, stage, term)
    mixed = entry.mixed_fleet(2, device="cpu").agents[1].ocp
    assert _build.dynamics_dims(device_fn_of(mixed.dynamics).name) == (2, 1)


@pytest.mark.parametrize("drawn", [False, True])
def test_lqr_device_functions(builds, drawn):
    probe, _ = builds
    dyn, stage, term = _functions(drawn)
    pd, ps, pt = (_f32(device_fn_of(f).params) for f in (dyn, stage, term))
    for x, u in zip(*_points(int(drawn))):
        f, J, H = np.zeros(4, np.float32), np.zeros((4, 8), np.float32), np.zeros((4, 8, 8),
                                                                                  np.float32)
        probe.lqr_dynamics(_ptr(pd), _ptr(x), _ptr(u), _ptr(f), _ptr(J), _ptr(H))
        xt, ut = torch.as_tensor(x), torch.as_tensor(u)
        assert np.array_equal(f, dyn(xt, ut).numpy())
        z = torch.as_tensor(np.concatenate([x, u]), dtype=torch.float64)
        fz = lambda zz: dyn(zz[:4], zz[4:])
        _near(J, jacfwd(fz)(z).numpy())
        assert not H.any()                        # linear: every second derivative is 0

        v, g, Hs = np.zeros(1, np.float32), np.zeros(8, np.float32), np.zeros((8, 8), np.float32)
        probe.lqr_stage(_ptr(ps), _ptr(x), _ptr(u), _ptr(v), _ptr(g), _ptr(Hs))
        assert v[0] == stage(xt, ut, 0).item()
        sz = lambda zz: stage(zz[:4], zz[4:], 0)
        _near(g, jacfwd(sz)(z).numpy())
        _near(Hs, hessian(sz)(z).numpy())

        v, g, Ht = np.zeros(1, np.float32), np.zeros(4, np.float32), np.zeros((4, 4), np.float32)
        probe.lqr_terminal(_ptr(pt), _ptr(x), _ptr(v), _ptr(g), _ptr(Ht))
        assert v[0] == term(xt).item()
        xd = torch.as_tensor(x, dtype=torch.float64)
        _near(g, jacfwd(term)(xd).numpy())
        _near(Ht, hessian(term)(xd).numpy())


@pytest.fixture
def launches_on_cpu(builds, monkeypatch):
    """The wrappers' launches call the g++ build on CPU tensors."""
    monkeypatch.setattr(_build, "_lib", builds[1])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


@pytest.fixture(scope="module", params=[False, True], ids=["example", "drawn"])
def lqr_inputs(request):
    """An LQR spec at T = 7 (the example's matrices, or drawn ones) and
    seeded states and controls, batch innermost: x0 [4, B], us [T, 4, B],
    the rollout x_0..x_{T-1} [T, 4, B], x_T [4, B] and its cost."""
    ocp = entry.lqr_fleet(1, device="cpu").agents[0].ocp
    dyn, stage, term = _functions(request.param)
    spec = ocp.spec().replace(dynamics=dyn, stage_cost=stage, terminal_cost=term,
                              horizon_steps=T)
    rng = np.random.RandomState(7)
    x0 = torch.as_tensor(_f32(rng.uniform(-1, 1, (4, NB))))
    us = torch.as_tensor(_f32(rng.uniform(-1, 1, (T, 4, NB))))
    tail, cost = k2.rollout_cost_plain(spec, x0, us)
    xs = torch.cat([x0[None], tail[:-1]], 0).contiguous()
    return spec, x0, us, xs, tail[-1].contiguous(), cost


def _fusedlin(spec, xs, us, hess, xT, discrete, bounds=(None, None)):
    symbol, (dyn_p, cost_p, term_p) = _build.problem_symbol(
        "riccati_fusedlin", 4, 4, spec.dynamics, spec.stage_cost, spec.terminal_cost)
    k, K = torch.empty(T, 4, NB), torch.empty(T, 4, 4, NB)
    _build.launch(symbol, xs, us, *hess, *bounds, xT, k, K, T, NB, int(discrete), dyn_p, cost_p,
                  term_p, _build.step_constants(spec.dt), tuple(LEVELS), len(LEVELS))
    return k, K


@pytest.mark.parametrize("discrete", [True, False])
def test_fusedlin_and_hoist(launches_on_cpu, lqr_inputs, discrete):
    """K3's hoist (rtol 1e-5 with a floor) and K1 on its Hessians against
    the plain versions (rtol 1e-4, atol 1e-5, as phase 3 holds K1)."""
    spec, x0, us, xs, xT, _ = lqr_inputs
    hess = k3.launch_linearize_hessians(spec, xs[:1].contiguous(), us[:1].contiguous())
    want = k3.linearize_hessians_plain(spec, xs[:1].contiguous(), us[:1].contiguous())
    for g, w in zip(hess, want):
        _near(g.numpy(), w.numpy())
    hess = tuple(h[0].contiguous() for h in hess)
    k, K = _fusedlin(spec, xs, us, hess, xT, discrete)
    kp, Kp = k1.riccati_fusedlin_plain(spec, xs, us, *hess, xT, LEVELS, None, None, discrete)
    torch.testing.assert_close(k, kp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(K, Kp, rtol=1e-4, atol=1e-5)


def test_fusedlin_boxqp_is_not_instantiated(launches_on_cpu, lqr_inputs):
    """The LQR's K1 is built in clamp mode alone: boxqp raises."""
    spec, _, us, xs, xT, _ = lqr_inputs
    hess = tuple(h[0].contiguous() for h in k3.linearize_hessians_plain(
        spec, xs[:1].contiguous(), us[:1].contiguous()))
    bounds = ((-1.0 - us).contiguous(), (1.0 - us).contiguous())
    with pytest.raises(NotImplementedError, match="not instantiated"):
        _fusedlin(spec, xs, us, hess, xT, True, bounds)


def test_rollout_and_select(launches_on_cpu, lqr_inputs):
    """K2's rollout (rtol 1e-5) and select at the reference ladder (states
    and controls atol 5e-4, merit rtol 1e-4, accept flags equal, as
    phase 3 holds them) on gains from the plain K3 -> K4."""
    spec, x0, us, xs, xT, cost = lqr_inputs
    tail, got_cost = k2.launch_rollout_cost(spec, x0, us)
    want_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(tail, want_tail, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_cost, cost, rtol=1e-5, atol=1e-5)
    lin = k3.linearize_plain(spec, xs, us, True)
    k, K = k1.riccati_backward_plain(spec, *lin, xT, LEVELS)
    active = torch.ones(NB, dtype=torch.bool)
    ladder = tuple(0.5 ** i for i in range(10))
    outs = []
    for select in (k2.launch_forward_select, k2.forward_select_plain):
        x, u, t_ = xs.clone(), us.clone(), xT.clone()
        merit, accept = select(spec, x, u, t_, k, K, cost, active, None, None, ladder)
        outs.append((x, u, t_, merit, accept))
    (x, u, t_, merit, accept), (px, pu, pt, pmerit, paccept) = outs
    assert bool(accept.any()) and torch.equal(accept, paccept)
    for g, w in ((x, px), (u, pu), (t_, pt)):
        torch.testing.assert_close(g, w, rtol=0, atol=5e-4)
    torch.testing.assert_close(merit, pmerit, rtol=1e-4, atol=0)


@pytest.mark.parametrize("nx, nu, boxqp", [(4, 4, False), (6, 2, False), (6, 2, True)])
def test_explicit_group_kernel(launches_on_cpu, nx, nu, boxqp):
    """K4's explicit mode at the new (nx, nu) on its group kernel (37
    problems, a part-filled block) against the plain version with
    ``torch.equal``: each lane sums in the plain version's order."""
    stacks, box, vx0, vxx0 = stacks_of(nx, nu, 4, NB, False, seed=nx * 10 + nu + boxqp)
    bounds = box if boxqp else (None, None)
    got = k1.launch_riccati_explicit(*stacks, vx0, vxx0, LEVELS, *bounds)
    want = k1.riccati_backward_explicit_plain(*stacks, vx0, vxx0, LEVELS, *bounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_explicit_4x4_boxqp_is_not_instantiated(launches_on_cpu):
    stacks, box, vx0, vxx0 = stacks_of(4, 4, 4, NB, False, seed=3)
    with pytest.raises(NotImplementedError, match="not instantiated"):
        k1.launch_riccati_explicit(*stacks, vx0, vxx0, LEVELS, *box)
