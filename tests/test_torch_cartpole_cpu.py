"""The cart-pole's device functions and kernel instantiations on the CPU:
the real ``csrc`` sources, built by g++.

``Cartpole``, ``CartpoleSwingUp`` and ``CartpoleSwingUpTerminal``
(``csrc/problems.cuh``) and the new ``Dual / Dual`` (``csrc/dual.cuh``)
are built by g++ against ``tests/cuda_on_cpu/cuda_runtime.h`` (see
test_torch_riccati_lanes.py) into a small probe library: values in float,
first derivatives in ``Dual<float, 5>`` and second derivatives in
``Dual<Dual<float, 5>, 5>`` at seeded points, held to the torch callables
and ``torch.func`` (float64) at rtol 1e-5 with a floor of 1e-5 of each
output's scale.  Then the cart-pole's instantiations of K2 (rollout and
select), K3 (with and without Hessians, both Jacobian modes, its hoist),
K7 and K4 (in-kernel terminal, and the explicit mode at (4, 1)) run
through the port's wrappers, ``ops/_build.py``'s library pointed at a g++
build, against their plain versions at ``chip_smoke.py``'s tolerances.
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
from multi_agent_solver_tpu_torch.models import cartpole as cp
from multi_agent_solver_tpu_torch.ocp import OCP
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.types import device_fn_of
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches

SOURCES = ("forward_select.cu", "linearize.cu", "riccati.cu", "riccati_explicit.cu")
T, NB = 7, 37
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)

PROBE = r"""
#include <cuda_runtime.h>

#include "problems.cuh"
using namespace mas;
constexpr int NZ = 5;
using D = Dual<float, NZ>;
using D2 = Dual<Dual<float, NZ>, NZ>;

template <typename S, typename Seed>
static void inputs(const float* x, const float* u, S* xs, S* us, Seed seed) {
  for (int i = 0; i < 4; ++i) xs[i] = seed(x[i], i);
  us[0] = seed(u[0], 4);
}

// f, its Jacobian J[i][z] and its Hessians H[i][p][q], z = (x, u).
extern "C" void cp_dynamics(const float* p, const float* x, const float* u, float* f, float* J,
                            float* H) {
  const Cartpole dyn = Cartpole::from(p);
  dyn(x, u, f);
  D xd[4], ud[1], fd[4];
  inputs(x, u, xd, ud, [](float v, int k) { return seed<NZ>(v, k); });
  dyn(xd, ud, fd);
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < NZ; ++k) J[i * NZ + k] = fd[i].d[k];
  D2 x2[4], u2[1], f2[4];
  inputs(x, u, x2, u2, [](float v, int k) { return seed2<NZ>(v, k); });
  dyn(x2, u2, f2);
  for (int i = 0; i < 4; ++i)
    for (int a = 0; a < NZ; ++a)
      for (int b = 0; b < NZ; ++b) H[(i * NZ + a) * NZ + b] = f2[i].d[b].d[a];
}

// The stage cost's value, gradient and Hessian in z = (x, u).
extern "C" void cp_stage(const float* p, const float* x, const float* u, float* v, float* g,
                         float* H) {
  const CartpoleSwingUp cost = CartpoleSwingUp::from(p);
  *v = cost(x, u);
  D xd[4], ud[1];
  inputs(x, u, xd, ud, [](float w, int k) { return seed<NZ>(w, k); });
  const D c = cost(xd, ud);
  for (int k = 0; k < NZ; ++k) g[k] = c.d[k];
  D2 x2[4], u2[1];
  inputs(x, u, x2, u2, [](float w, int k) { return seed2<NZ>(w, k); });
  const D2 c2 = cost(x2, u2);
  for (int a = 0; a < NZ; ++a)
    for (int b = 0; b < NZ; ++b) H[a * NZ + b] = c2.d[b].d[a];
}

// The terminal cost's value, gradient and Hessian in x (tangent 4 unused).
extern "C" void cp_terminal(const float* p, const float* x, float* v, float* g, float* H) {
  const CartpoleSwingUpTerminal term = CartpoleSwingUpTerminal::from(p);
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

// a / b of two variables: value, gradient (a, b) and Hessian.
extern "C" void dual_div(float a, float b, float* out) {
  const Dual<float, 2> r = seed<2>(a, 0) / seed<2>(b, 1);
  out[0] = r.v;
  out[1] = r.d[0];
  out[2] = r.d[1];
  const Dual<Dual<float, 2>, 2> r2 = seed2<2>(a, 0) / seed2<2>(b, 1);
  for (int p = 0; p < 2; ++p)
    for (int q = 0; q < 2; ++q) out[3 + p * 2 + q] = r2.d[q].d[p];
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The probe library and the kernels' entry points, built by g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_cartpole")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (d / f.name).write_text(cpu_launches(f.read_text()))
    (d / "probe.cpp").write_text(PROBE)
    flags = ["g++", "-std=c++20", "-O0", "-ffp-contract=off", "-fPIC", "-pthread",
             f"-I{STUB}", f"-I{d}", "-x", "c++", "-c"]
    builds = [subprocess.Popen(flags + [str(d / s), "-o", str(d / f"{s}.o")],
                               stderr=subprocess.PIPE, text=True) for s in SOURCES + ("probe.cpp",)]
    for p in builds:
        assert p.wait() == 0, p.stderr.read()
    link = lambda objs, out: subprocess.run(
        ["g++", "-shared", "-pthread", *(str(d / f"{s}.o") for s in objs), "-o", str(d / out)],
        check=True)
    link(SOURCES, "kernels.so")
    link(("probe.cpp",), "probe.so")
    return ctypes.CDLL(str(d / "probe.so")), ctypes.CDLL(str(d / "kernels.so"))


def _f32p(a):
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def _params(fn):
    return _f32p(np.asarray(device_fn_of(fn).params, np.float64))


def _points(seed, n=6):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-np.pi, 2 * np.pi, n),
                  rng.uniform(-3, 3, n), rng.uniform(-6, 6, n)], 1).astype(np.float32)
    return x, rng.uniform(-12, 12, (n, 1)).astype(np.float32)


def _near(got, want):
    """rtol 1e-5 with a floor of 1e-5 of the output's scale."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


def _z_fn(fn):
    return lambda z: fn(z[:4], z[4:])


def test_cartpole_dynamics_device_function(builds):
    probe, _ = builds
    p, pp = _params(cp.cartpole_dynamics)
    for x, u in zip(*_points(0)):
        f, J, H = np.zeros(4, np.float32), np.zeros((4, 5), np.float32), np.zeros((4, 5, 5),
                                                                                  np.float32)
        probe.cp_dynamics(pp, _f32p(x)[1], _f32p(u)[1], f.ctypes.data_as(ctypes.c_void_p),
                          J.ctypes.data_as(ctypes.c_void_p), H.ctypes.data_as(ctypes.c_void_p))
        # Values against the float32 torch callable, derivatives against
        # torch.func in float64.
        _near(f, cp.cartpole_dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy())
        z = torch.as_tensor(np.concatenate([x, u]), dtype=torch.float64)
        fz = _z_fn(cp.cartpole_dynamics)
        _near(J, jacfwd(fz)(z).numpy())
        for i in range(4):
            _near(H[i], hessian(lambda zz: fz(zz)[i])(z).numpy())


def test_cartpole_cost_device_functions(builds):
    probe, _ = builds
    ps, pps = _params(cp.cartpole_swing_up_stage_cost)
    pt, ppt = _params(cp.cartpole_swing_up_terminal_cost)
    stage = _z_fn(lambda x, u: cp.cartpole_swing_up_stage_cost(x, u, 0))
    for x, u in zip(*_points(1)):
        v, g, H = np.zeros(1, np.float32), np.zeros(5, np.float32), np.zeros((5, 5), np.float32)
        probe.cp_stage(pps, _f32p(x)[1], _f32p(u)[1], *(a.ctypes.data_as(ctypes.c_void_p)
                                                        for a in (v, g, H)))
        _near(v[0], float(cp.cartpole_swing_up_stage_cost(torch.as_tensor(x), torch.as_tensor(u),
                                                          0)))
        z = torch.as_tensor(np.concatenate([x, u]), dtype=torch.float64)
        _near(g, jacfwd(stage)(z).numpy())
        _near(H, hessian(stage)(z).numpy())
        v, g, H = np.zeros(1, np.float32), np.zeros(4, np.float32), np.zeros((4, 4), np.float32)
        probe.cp_terminal(ppt, _f32p(x)[1], *(a.ctypes.data_as(ctypes.c_void_p) for a in (v, g, H)))
        _near(v[0], float(cp.cartpole_swing_up_terminal_cost(torch.as_tensor(x))))
        xd = torch.as_tensor(x, dtype=torch.float64)
        _near(g, jacfwd(cp.cartpole_swing_up_terminal_cost)(xd).numpy())
        _near(H, hessian(cp.cartpole_swing_up_terminal_cost)(xd).numpy())


def test_dual_division(builds):
    """``Dual / Dual``: the value one IEEE division (bit for bit float32
    a / b), the gradient and Hessian of a / b."""
    probe, _ = builds
    probe.dual_div.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    for a, b in ((1.5, 0.3), (-2.25, 7.0), (3.0, -0.125), (0.1, 3.0)):
        out = np.zeros(7, np.float32)
        probe.dual_div(a, b, out.ctypes.data_as(ctypes.c_void_p))
        assert out[0] == np.float32(a) / np.float32(b)
        z = torch.tensor([a, b], dtype=torch.float64)
        div = lambda zz: zz[0] / zz[1]
        _near(out[1:3], jacfwd(div)(z).numpy())
        _near(out[3:].reshape(2, 2), hessian(div)(z).numpy())


@pytest.fixture
def launches_on_cpu(builds, monkeypatch):
    """The wrappers' launches call the g++ build on CPU tensors."""
    monkeypatch.setattr(_build, "_lib", builds[1])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


@pytest.fixture(scope="module")
def cart():
    """A cart-pole swing-up spec at T = 7 and a batch of seeded states and
    controls inside the force box, batch innermost: x0 [4, B], us [T, 1, B],
    and the rollout x_0..x_{T-1} [T, 4, B], x_T [4, B]."""
    ocp = OCP(state_dim=4, control_dim=1, horizon_steps=T, dt=0.05,
              initial_state=torch.zeros(4), dynamics=cp.cartpole_dynamics,
              stage_cost=cp.cartpole_swing_up_stage_cost,
              terminal_cost=cp.cartpole_swing_up_terminal_cost,
              input_lower_bounds=torch.tensor([-12.0]), input_upper_bounds=torch.tensor([12.0]),
              device="cpu")
    ocp.initialize_problem()
    spec = ocp.spec()
    rng = np.random.RandomState(5)
    x0 = torch.as_tensor(np.stack([rng.uniform(-1, 1, NB), rng.uniform(0, 2 * np.pi, NB),
                                   rng.uniform(-1, 1, NB), rng.uniform(-2, 2, NB)]).astype(
        np.float32))
    us = torch.as_tensor(rng.uniform(-12, 12, (T, 1, NB)).astype(np.float32))
    tail, cost = k2.rollout_cost_plain(spec, x0, us)
    xs = torch.cat([x0[None], tail[:-1]], 0).contiguous()
    return spec, x0, us, xs, tail[-1].contiguous(), cost


def test_rollout_and_select(launches_on_cpu, cart):
    """K2's rollout (rtol 1e-5) and select at the reference ladder (states
    and controls atol 5e-4, merit rtol 1e-4, accept flags equal, as
    phase 3 holds them) on gains from the plain K3 -> K4."""
    spec, x0, us, xs, xT, cost = cart
    tail, got_cost = k2.launch_rollout_cost(spec, x0, us)
    want_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(tail, want_tail, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_cost, cost, rtol=1e-5, atol=1e-5)
    lin = k3.linearize_plain(spec, xs, us, True)
    k, K = k1.riccati_backward_plain(spec, *lin, xT, LEVELS)
    lb, ub = torch.full((1, NB), -12.0), torch.full((1, NB), 12.0)
    active = torch.ones(NB, dtype=torch.bool)
    ladder = tuple(0.5 ** i for i in range(10))
    outs = []
    for select in (k2.launch_forward_select, k2.forward_select_plain):
        x, u, t_ = xs.clone(), us.clone(), xT.clone()
        merit, accept = select(spec, x, u, t_, k, K, cost, active, lb, ub, ladder)
        outs.append((x, u, t_, merit, accept))
    (x, u, t_, merit, accept), (px, pu, pt, pmerit, paccept) = outs
    assert bool(accept.any()) and torch.equal(accept, paccept)
    for g, w in ((x, px), (u, pu), (t_, pt)):
        torch.testing.assert_close(g, w, rtol=0, atol=5e-4)
    torch.testing.assert_close(merit, pmerit, rtol=1e-4, atol=0)


@pytest.mark.parametrize("discrete", [True, False])
def test_linearize_modes(launches_on_cpu, cart, discrete):
    """K3 with and without Hessians, its hoist and K7 against their plain
    versions at rtol 1e-5 with a floor of 1e-5 of each output's scale."""
    spec, _, us, xs, _, _ = cart
    want = k3.linearize_plain(spec, xs, us, True, None, discrete)
    for hessians in (True, False):
        got = k3.launch_linearize(spec, xs, us, hessians, None, discrete)
        assert len(got) == (7 if hessians else 4)
        for g, w in zip(got, want):
            _near(g.numpy(), w.numpy())
    for g, w in zip(k3.launch_linearize_hessians(spec, xs, us), want[4:]):
        _near(g.numpy(), w.numpy())
    xs_bf = torch.cat([xs, xs[-1:]], 0).permute(2, 0, 1).contiguous()     # [B, T+1, 4]
    us_bf = us.permute(2, 0, 1).contiguous()
    flat = k3.launch_linearize_pallas(spec, xs_bf, us_bf, discrete)
    for g, w in zip(flat, k3.linearize_pallas_plain(spec, xs_bf, us_bf, discrete)):
        _near(g.numpy(), w.numpy())


@pytest.mark.parametrize("boxqp", [False, True])
def test_backward_modes(launches_on_cpu, cart, boxqp):
    """K4 with the cart-pole's terminal cost in the kernel and K4's
    explicit mode at (4, 1) against their plain versions (rtol 1e-4,
    atol 1e-5; 1e-4 with the box QP), on regularized stages."""
    spec, _, us, xs, xT, _ = cart
    A, Bm, lx, lu, lxx, luu, lux = k3.linearize_plain(spec, xs, us, True)
    luu = luu + 1.0          # keep q_uu away from the regularization ladder's steps
    lin = (A, Bm, lx, lu, lxx, luu, lux)
    bounds = ((-12.0 - us).contiguous(), (12.0 - us).contiguous()) if boxqp else (None, None)
    atol = 1e-4 if boxqp else 1e-5
    symbol, (_, term_p) = _build.problem_symbol("riccati_backward", 4, 1, spec.dynamics,
                                                spec.terminal_cost)
    k = torch.empty(T, 1, NB)
    K = torch.empty(T, 1, 4, NB)
    _build.launch(symbol, *lin, *bounds, xT, k, K, T, NB, 0, term_p, tuple(LEVELS), len(LEVELS))
    kp, Kp = k1.riccati_backward_plain(spec, *lin, xT, LEVELS, *bounds)
    torch.testing.assert_close(k, kp, rtol=1e-4, atol=atol)
    torch.testing.assert_close(K, Kp, rtol=1e-4, atol=atol)
    vx0, vxx0 = k3.terminal_derivs_tiled_plain(spec, xT)
    got = k1.launch_riccati_explicit(*lin, vx0, vxx0, LEVELS, *bounds)
    want = k1.riccati_backward_explicit_plain(*lin, vx0, vxx0, LEVELS, *bounds)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=atol)
