"""The model zoo's device functions, its kernel instantiations and the stage
index on the CPU: the real ``csrc`` sources, built by g++.

``Pendulum``, ``PendulumSwingUp`` (a stage cost that reads the stage
index), ``PendulumSwingUpTerminal``, ``Rocket``, ``RocketTerminal``,
``DynamicBicycle``, ``Quadrotor`` and ``QuadrotorRotor``
(``csrc/problems.cuh``) are built by g++ against
``tests/cuda_on_cpu/cuda_runtime.h`` (see test_torch_riccati_lanes.py) into
a probe library: values in float, first derivatives in ``Dual<float,
NZ>`` and second derivatives in ``Dual<Dual<float, NZ>, NZ>`` (NZ = nx + nu)
at seeded points and at the guards' kinks, held to the float32 torch
callables and to ``torch.func`` in float64 at rtol 1e-5 with a floor of
1e-5 of each output's scale (1e-4 for the quadrotors' second derivatives,
whose 1 / cos theta terms reach 1e3).  Then the zoo's instantiations run
through the port's wrappers, ``ops/_build.py``'s library pointed at a g++
build, against their plain versions at ``chip_smoke.py``'s tolerances
(the quadrotors' Hessian hoist against ``torch.func.hessian``, and their
K1 against the plain K3 -> K4 explicit with the terminal derivatives by
``torch.func``: the plain versions' jvp-over-jvp entries take ~40 ms each
on the CPU).  A test-only stage cost that reads the stage index (a
reference moving with t) is instantiated in K1, K2's rollout and select
and K3: each kernel against its plain version shows that the index
reaches it; with the reference at rest it gives the lane-follow cost's
floats bit for bit.
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
from multi_agent_solver_tpu_torch.examples import pendulum_swing_up as pend_ex
from multi_agent_solver_tpu_torch.examples import rocket_max_altitude as rocket_ex
from multi_agent_solver_tpu_torch.models import dynamic_bicycle as bike
from multi_agent_solver_tpu_torch.models import pendulum as pend
from multi_agent_solver_tpu_torch.models import quadrotor as quad
from multi_agent_solver_tpu_torch.models import quadrotor_rotor as rotor
from multi_agent_solver_tpu_torch.ops import _build
from multi_agent_solver_tpu_torch.ops import forward_select as k2
from multi_agent_solver_tpu_torch.ops import linearize as k3
from multi_agent_solver_tpu_torch.ops import riccati as k1
from multi_agent_solver_tpu_torch.solvers.ilqr import _alpha_ladder_floats, _unbatch
from multi_agent_solver_tpu_torch.types import device_fn_of, tag_device_fn
from tests.test_torch_riccati_lanes import CSRC, STUB, cpu_launches, stacks_of

torch.set_num_threads(1)

SOURCES = ("riccati_zoo.cu", "riccati_quadrotor.cu", "riccati_quadrotor_rotor.cu",
           "riccati_explicit_zoo.cu", "riccati_explicit_quadrotor.cu", "forward_select_zoo.cu",
           "forward_select_quadrotor.cu", "linearize_zoo.cu", "ramp.cu")
NB = 37
CONT_T = 3
LEVELS = k1.reg_ladder(1e-6, 10.0, 16)

# The test-only stage cost: the single track tracking a reference that
# moves with the stage index, under constant weights -- quadratic and
# stationary (its Hessians do not depend on t), so the fused loop runs it
# on K1 --, sum_i w_i (x_i - (r_i + v_i t))^2 + sum_i wu_i u_i^2, and its
# instantiations of K1, K2 and K3.
RAMP = r"""
#include "riccati.cuh"
#include "forward_select.cuh"
#include "linearize_modes.cuh"

namespace mas {
struct RampTracking {
  static constexpr int NPARAMS = 14;
  static constexpr bool TAKES_STAGE = true;
  float w[4], r[4], v[4], wu[2];

  static RampTracking from(const float* p) {
    RampTracking c;
    for (int i = 0; i < 4; ++i) c.w[i] = p[i], c.r[i] = p[4 + i], c.v[i] = p[8 + i];
    c.wu[0] = p[12];
    c.wu[1] = p[13];
    return c;
  }

  template <typename S, typename I>
  __device__ __forceinline__ S operator()(const S* x, const S* u, I t) const {
    const float tf = static_cast<float>(t);
    S e = x[0] - (r[0] + v[0] * tf);
    S c = w[0] * (e * e);
    for (int i = 1; i < 4; ++i) {
      e = x[i] - (r[i] + v[i] * tf);
      c = c + w[i] * (e * e);
    }
    for (int i = 0; i < 2; ++i) c = c + wu[i] * (u[i] * u[i]);
    return c;
  }
};
}  // namespace mas

extern "C" int mas_riccati_fusedlin__single_track__ramp_tracking__zero(
    const float* xs, const float* us, const float* lxx, const float* luu, const float* lux,
    const float* lb, const float* ub, const float* xT, float* k, float* K, int T, int B,
    int discrete, const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  return mas::launch_riccati_fusedlin<mas::SingleTrack, mas::RampTracking, mas::ZeroTerminal,
                                      false>(xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B,
                                             discrete, dyn_p, cost_p, term_p, step_p, levels,
                                             n_levels, static_cast<cudaStream_t>(stream));
}
MAS_FORWARD_SELECT(single_track__ramp_tracking__zero, mas::SingleTrack, mas::RampTracking,
                   mas::ZeroTerminal, NoConstraint, NoConstraint)
MAS_LINEARIZE(single_track__ramp_tracking, mas::SingleTrack, mas::RampTracking)
MAS_LINEARIZE_HESSIANS(single_track__ramp_tracking, mas::SingleTrack, mas::RampTracking)
// The lane-follow cost beside it, for the bit-for-bit comparison at rest.
using LaneFollow = mas::DiagQuadratic<4, 2>;
extern "C" int mas_riccati_fusedlin__single_track__diag_quadratic__zero(
    const float* xs, const float* us, const float* lxx, const float* luu, const float* lux,
    const float* lb, const float* ub, const float* xT, float* k, float* K, int T, int B,
    int discrete, const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  return mas::launch_riccati_fusedlin<mas::SingleTrack, LaneFollow, mas::ZeroTerminal, false>(
      xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, discrete, dyn_p, cost_p, term_p, step_p,
      levels, n_levels, static_cast<cudaStream_t>(stream));
}
MAS_FORWARD_SELECT(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollow,
                   mas::ZeroTerminal, NoConstraint, NoConstraint)
MAS_LINEARIZE(single_track__diag_quadratic, mas::SingleTrack, LaneFollow)
"""

# Value, Jacobian and Hessians of each device function: dynamics
# dyn_<name>(p, x, u, f, J [nx, NZ], H [nx, NZ, NZ]); costs cost_<name>(p,
# x, u, t, v, g [NZ], H [NZ, NZ]); terminals term_<name>(p, x, v, g [nx], H).
PROBE = r"""
#include <cuda_runtime.h>

#include "problems.cuh"
using namespace mas;

template <typename Dyn>
static void dyn_probe(const float* p, const float* x, const float* u, float* f, float* J,
                      float* H) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NZ = NX + NU;
  const Dyn dyn = Dyn::from(p);
  dyn(x, u, f);
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU], fd[NX];
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  dyn(xd, ud, fd);
  for (int i = 0; i < NX; ++i)
    for (int k = 0; k < NZ; ++k) J[i * NZ + k] = fd[i].d[k];
  using D2 = Dual<Dual<float, NZ>, NZ>;
  static D2 x2[NX], u2[NU], f2[NX];
  for (int i = 0; i < NX; ++i) x2[i] = seed2<NZ>(x[i], i);
  for (int i = 0; i < NU; ++i) u2[i] = seed2<NZ>(u[i], NX + i);
  dyn(x2, u2, f2);
  for (int i = 0; i < NX; ++i)
    for (int a = 0; a < NZ; ++a)
      for (int b = 0; b < NZ; ++b) H[(i * NZ + a) * NZ + b] = f2[i].d[b].d[a];
}

template <typename Cost, int NX, int NU>
static void cost_probe(const float* p, const float* x, const float* u, int t, float* v,
                       float* g, float* H) {
  constexpr int NZ = NX + NU;
  const Cost cost = Cost::from(p);
  *v = stage_value(cost, x, u, t);
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU];
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  const D c = stage_value(cost, xd, ud, static_cast<float>(t));
  for (int k = 0; k < NZ; ++k) g[k] = c.d[k];
  using D2 = Dual<Dual<float, NZ>, NZ>;
  D2 x2[NX], u2[NU];
  for (int i = 0; i < NX; ++i) x2[i] = seed2<NZ>(x[i], i);
  for (int i = 0; i < NU; ++i) u2[i] = seed2<NZ>(u[i], NX + i);
  const D2 c2 = stage_value(cost, x2, u2, t);
  for (int a = 0; a < NZ; ++a)
    for (int b = 0; b < NZ; ++b) H[a * NZ + b] = c2.d[b].d[a];
}

template <typename Term, int NX>
static void term_probe(const float* p, const float* x, float* v, float* g, float* H) {
  const Term term = Term::from(p);
  *v = term(x);
  using D = Dual<float, NX>;
  D xd[NX];
  for (int i = 0; i < NX; ++i) xd[i] = seed<NX>(x[i], i);
  const D c = term(xd);
  for (int k = 0; k < NX; ++k) g[k] = c.d[k];
  using D2 = Dual<Dual<float, NX>, NX>;
  D2 x2[NX];
  for (int i = 0; i < NX; ++i) x2[i] = seed2<NX>(x[i], i);
  const D2 c2 = term(x2);
  for (int a = 0; a < NX; ++a)
    for (int b = 0; b < NX; ++b) H[a * NX + b] = c2.d[b].d[a];
}

#define DYN(NAME, T)                                                                   \
  extern "C" void dyn_##NAME(const float* p, const float* x, const float* u, float* f, \
                             float* J, float* H) {                                     \
    dyn_probe<T>(p, x, u, f, J, H);                                                    \
  }
DYN(pendulum, Pendulum)
DYN(rocket, Rocket)
DYN(dynamic_bicycle, DynamicBicycle)
DYN(quadrotor, Quadrotor)
DYN(quadrotor_rotor, QuadrotorRotor)

extern "C" void cost_pendulum_swing_up(const float* p, const float* x, const float* u, int t,
                                       float* v, float* g, float* H) {
  cost_probe<PendulumSwingUp, 2, 1>(p, x, u, t, v, g, H);
}
extern "C" void term_pendulum_swing_up_terminal(const float* p, const float* x, float* v,
                                                float* g, float* H) {
  term_probe<PendulumSwingUpTerminal, 2>(p, x, v, g, H);
}
extern "C" void term_rocket_terminal(const float* p, const float* x, float* v, float* g,
                                     float* H) {
  term_probe<RocketTerminal, 3>(p, x, v, g, H);
}

// The Hessian column passes (seed_col) against the full pass, at NZ = 16.
extern "C" int hessian_columns_equal(const float* p, const float* x, const float* u) {
  const DiagQuadratic<12, 4> c = DiagQuadratic<12, 4>::from(p);
  float a[12][12], b[4][4], d[4][12];
  stage_hessians<12, 4>(c, x, u, CtxView(), 0.0f, a, b, d);
  using D2 = Dual<Dual<float, 16>, 16>;
  static D2 x2[12], u2[4];
  for (int i = 0; i < 12; ++i) x2[i] = seed2<16>(x[i], i);
  for (int i = 0; i < 4; ++i) u2[i] = seed2<16>(u[i], 12 + i);
  const D2 r = c(x2, u2);
  int same = 1;
  for (int i = 0; i < 12; ++i)
    for (int j = 0; j < 12; ++j) same &= a[i][j] == r.d[j > i ? j : i].d[j > i ? i : j];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      same &= b[i][j] == r.d[12 + (j > i ? j : i)].d[12 + (j > i ? i : j)];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 12; ++j) same &= d[i][j] == r.d[j].d[12 + i];
  return same;
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The probe library and the kernels' entry points, built by g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc_zoo")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (d / f.name).write_text(cpu_launches(f.read_text()))
    (d / "ramp.cu").write_text(cpu_launches(RAMP))
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


def _near(got, want, rtol=1e-5):
    """rtol with a floor of rtol of the output's scale."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


DYNAMICS = {   # name: (torch callable, nx, nu, point draw)
    "pendulum": (pend.pendulum_dynamics, 2, 1),
    "rocket": (rocket_ex.ROCKET_DYNAMICS, 3, 1),
    "dynamic_bicycle": (bike.dynamic_bicycle_model, 6, 2),
    "quadrotor": (quad.quadrotor_dynamics, 12, 4),
    "quadrotor_rotor": (rotor.quadrotor_rotor_dynamics, 16, 4),
}


N_SEEDED = 4


def _points(name, nx, nu, seed=0, n=N_SEEDED):
    """Seeded points, and the guards' kinks: the rocket's mass at the floor
    1e-6 and one float either side, the bicycle's vx at 0.5 and either
    side, the quadrotors' cos theta on either side of 0 and of +-0.1."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.5, 1.5, (n, nx)).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, (n, nu)).astype(np.float32)
    f = np.float32
    if name == "rocket":
        kinks = [f(1e-6), np.nextafter(f(1e-6), f(1)), np.nextafter(f(1e-6), f(0))]
        extra = np.repeat(x[:1], 3, 0)
        extra[:, 2] = kinks
    elif name == "dynamic_bicycle":
        extra = np.repeat(x[:1], 3, 0)
        extra[:, 3] = [f(0.5), np.nextafter(f(0.5), f(1)), np.nextafter(f(0.5), f(0))]
    elif name.startswith("quadrotor"):
        c = np.arccos(0.1)
        extra = np.repeat(x[:1], 6, 0)
        extra[:, 7] = [np.pi / 2 - 1e-3, np.pi / 2 + 1e-3, c - 1e-3, c + 1e-3, np.pi - c - 1e-3,
                       np.pi - c + 1e-3]
    else:
        extra = x[:0]
    x = np.concatenate([x, extra]).astype(np.float32)
    return x, np.concatenate([u, np.repeat(u[:1], len(extra), 0)]).astype(np.float32)


@pytest.mark.parametrize("name", list(DYNAMICS))
def test_dynamics_device_functions(builds, name):
    """Each dynamics' value (the float32 torch callable), Jacobian and
    Hessians (``torch.func`` in float64) at seeded points and at its
    guards' kinks."""
    probe, _ = builds
    fn, nx, nu = DYNAMICS[name]
    nz = nx + nu
    p = _f32(device_fn_of(fn).params)
    rtol2 = 1e-4 if name.startswith("quadrotor") else 1e-5
    for row, (x, u) in enumerate(zip(*_points(name, nx, nu))):
        f, J, H = np.zeros(nx, np.float32), np.zeros((nx, nz), np.float32), np.zeros(
            (nx, nz, nz), np.float32)
        getattr(probe, f"dyn_{name}")(_ptr(p), _ptr(x), _ptr(u), _ptr(f), _ptr(J), _ptr(H))
        _near(f, fn(torch.as_tensor(x), torch.as_tensor(u)).numpy())
        # At a kink the guard's constant is compared in float32, as the
        # device function compares it (float32 1e-6 is no tie in float64).
        dtype = torch.float64 if row < N_SEEDED else torch.float32
        z = torch.as_tensor(np.concatenate([x, u]), dtype=dtype)
        fz = lambda zz: fn(zz[:nx], zz[nx:])
        _near(J, jacfwd(fz)(z).numpy())
        _near(H, jacfwd(jacfwd(fz))(z).numpy(), rtol2)


def test_pendulum_and_rocket_costs(builds):
    """The swing-up's stage cost at several stage indices (value, gradient,
    Hessian), its terminal cost and the rocket's terminal cost."""
    probe, _ = builds
    ocp = pend_ex.create_pendulum_swingup_ocp(device="cpu")
    ps = _f32(device_fn_of(ocp.stage_cost).params)
    for t in (0, 13, 59):
        for x, u in zip(*_points("pendulum", 2, 1, seed=t)):
            v, g, H = np.zeros(1, np.float32), np.zeros(3, np.float32), np.zeros((3, 3),
                                                                                 np.float32)
            probe.cost_pendulum_swing_up(_ptr(ps), _ptr(x), _ptr(u), ctypes.c_int(t), _ptr(v),
                                         _ptr(g), _ptr(H))
            _near(v[0], float(ocp.stage_cost(torch.as_tensor(x), torch.as_tensor(u), t)))
            z = torch.as_tensor(np.concatenate([x, u]), dtype=torch.float64)
            cz = lambda zz: ocp.stage_cost(zz[:2], zz[2:], t)
            _near(g, jacfwd(cz)(z).numpy())
            _near(H, hessian(cz)(z).numpy())
    for name, term, nx in (("pendulum_swing_up_terminal", ocp.terminal_cost, 2),
                           ("rocket_terminal", rocket_ex.terminal_cost, 3)):
        p = _f32(device_fn_of(term).params)
        for x in _f32(np.random.RandomState(7).uniform(-1.5, 1.5, (4, nx))):
            v, g, H = np.zeros(1, np.float32), np.zeros(nx, np.float32), np.zeros((nx, nx),
                                                                                  np.float32)
            getattr(probe, f"term_{name}")(_ptr(p), _ptr(x), _ptr(v), _ptr(g), _ptr(H))
            _near(v[0], float(term(torch.as_tensor(x))))
            xd = torch.as_tensor(x, dtype=torch.float64)
            _near(g, jacfwd(term)(xd).numpy())
            _near(H, hessian(term)(xd).numpy())


def test_hessian_columns_are_the_full_pass(builds):
    """Past HESSIAN_FULL_MAX directions stage_hessians takes one column a
    pass (seed_col): bit for bit the full Dual<Dual<float, 16>, 16> pass."""
    probe, _ = builds
    spec = entry.quadrotor_spec(4, device="cpu")
    p = _f32(device_fn_of(spec.stage_cost).params)
    for x, u in zip(*_points("quadrotor", 12, 4, seed=3)):
        assert probe.hessian_columns_equal(_ptr(p), _ptr(x), _ptr(u)) == 1


@pytest.fixture
def launches_on_cpu(builds, monkeypatch):
    """The wrappers' launches call the g++ build on CPU tensors."""
    monkeypatch.setattr(_build, "_lib", builds[1])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


# name: (specs function, T, control draw (center, half-width))
MODELS = {
    "rocket": (lambda B: entry.rocket_specs(B, device="cpu"), 6, ((10.0,), (10.0,))),
    "bicycle": (lambda B: entry.bicycle_specs(B, device="cpu"), 6, ((0.0, 0.0), (0.3, 1.5))),
    "quadrotor": (lambda B: entry.quadrotor_specs(B, device="cpu"), 3,
                  ((9.81, 0.0, 0.0, 0.0), (2.0, 0.05, 0.05, 0.05))),
    "quadrotor_rotor": (lambda B: entry.quadrotor_rotor_specs(B, device="cpu"), 3,
                        ((2.4525,) * 4, (0.5,) * 4)),
    "pendulum": (lambda B: entry.pendulum_specs(B, device="cpu"), 6, ((0.0,), (2.0,))),
}


def _inputs(name, seed=1):
    """A spec of ``name`` and drawn states and controls, batch innermost:
    x0 [nx, B], us [T, nu, B], the plain rollout x_0..x_{T-1}, x_T, cost."""
    make, T, (center, half) = MODELS[name]
    specs = make(NB)
    spec = _unbatch(specs)
    rng = np.random.RandomState(seed)
    x0 = torch.as_tensor(specs.initial_state.numpy().T.copy())
    us = torch.as_tensor(_f32(np.asarray(center)[None, :, None] + np.asarray(half)[None, :, None]
                              * rng.uniform(-1, 1, (T, len(center), NB))))
    tail, cost = k2.rollout_cost_plain(spec, x0, us)
    xs = torch.cat([x0[None], tail[:-1]], 0).contiguous()
    return spec, x0, us, xs, tail[-1].contiguous(), cost


def _bounds(spec, B):
    lb, ub = spec.input_lower_bounds, spec.input_upper_bounds
    if lb is None:
        return None, None
    col = lambda b: b.reshape(-1, b.shape[-1])[0].reshape(-1, 1).expand(-1, B).contiguous()
    return col(lb), col(ub)


def _fusedlin(spec, xs, us, hess, xT, discrete):
    nx, nu = spec.state_dim, spec.control_dim
    T = xs.shape[0]
    symbol, (dyn_p, cost_p, term_p) = _build.problem_symbol(
        "riccati_fusedlin", nx, nu, spec.dynamics, spec.stage_cost, spec.terminal_cost)
    k, K = torch.empty(T, nu, NB), torch.empty(T, nu, nx, NB)
    _build.launch(symbol, xs, us, *hess, None, None, xT, k, K, T, NB, int(discrete), dyn_p,
                  cost_p, term_p, _build.step_constants(spec.dt), tuple(LEVELS), len(LEVELS))
    return k, K


def _select_both(spec, xs, us, xT, k, K, cost):
    """K2's select through the kernel and the plain version."""
    active = torch.ones(NB, dtype=torch.bool)
    ladder = _alpha_ladder_floats(1e-3)
    outs = []
    for select in (k2.launch_forward_select, k2.forward_select_plain):
        x, u, t_ = xs.clone(), us.clone(), xT.clone()
        merit, accept = select(spec, x, u, t_, k, K, cost, active, *_bounds(spec, NB), ladder)
        outs.append((x, u, t_, merit, accept))
    return outs


def _check_select(outs):
    (x, u, t_, merit, accept), (px, pu, pt, pmerit, paccept) = outs
    assert bool(accept.any()) and torch.equal(accept, paccept)
    for g, w in ((x, px), (u, pu), (t_, pt)):
        torch.testing.assert_close(g, w, rtol=0, atol=5e-4)
    torch.testing.assert_close(merit, pmerit, rtol=1e-4, atol=0)


def _terminal_plain(spec, xT):
    """``(vx0 [nx, B], vxx0 [nx, nx, B])`` of the terminal cost by
    ``torch.func`` (float32)."""
    f = spec.terminal_cost
    vx = torch.func.vmap(jacfwd(f))(xT.T)
    vxx = torch.func.vmap(hessian(f))(xT.T)
    return vx.T.contiguous(), vxx.permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("name", ["rocket", "bicycle", "quadrotor", "quadrotor_rotor"])
def test_stationary_models(launches_on_cpu, name):
    """K2's rollout (rtol 1e-5, the cost with a floor of its scale) and its
    select (phase 3's tolerances), K3's hoist (rtol 1e-5 with a floor) and
    K1 in both Jacobian modes (rtol 1e-4, atol 1e-5) against their plain
    versions; at nx >= 12 the hoist against ``torch.func.hessian`` and K1
    against the plain K3 -> K4 explicit on ``torch.func`` terminal
    derivatives, and K4 explicit at the model's (nx, nu) against its plain
    version."""
    spec, x0, us, xs, xT, cost = _inputs(name)
    nx, nu = spec.state_dim, spec.control_dim
    tail, got_cost = k2.launch_rollout_cost(spec, x0, us)
    want_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(tail, want_tail, rtol=1e-5, atol=1e-5)
    _near(got_cost.numpy(), cost.numpy())
    hess = k3.launch_linearize_hessians(spec, xs, us)
    if nx < 12:
        want = k3.linearize_hessians_plain(spec, xs, us)
    else:
        H = torch.func.vmap(hessian(lambda z: spec.stage_cost(z[:nx], z[nx:], 0)))(
            torch.cat([xs, us], 1).permute(0, 2, 1).reshape(-1, nx + nu).double())
        H = H.reshape(xs.shape[0], NB, nx + nu, nx + nu).permute(0, 2, 3, 1).float()
        want = (H[:, :nx, :nx], H[:, nx:, nx:], H[:, nx:, :nx])
    for g, w in zip(hess, want):
        _near(g.numpy(), w.numpy())
    hess = tuple(h[0].contiguous() for h in hess)
    gains = {}
    # The continuous mode over the first CONT_T stages (chip_smoke.py's
    # ZOO_CONT_T: its raw A makes longer recursions ill-conditioned).
    for discrete, T in ((True, xs.shape[0]), (False, CONT_T)):
        xs_t, us_t, xT_t = xs[:T].contiguous(), us[:T].contiguous(), (
            xT if T == xs.shape[0] else xs[T].contiguous())
        k, K = _fusedlin(spec, xs_t, us_t, hess, xT_t, discrete)
        if nx < 12:
            kp, Kp = k1.riccati_fusedlin_plain(spec, xs_t, us_t, *hess, xT_t, LEVELS, None, None,
                                               discrete)
        else:
            A, Bm, lx, lu = k3.linearize_plain(spec, xs_t, us_t, False, None, discrete)
            tile = lambda h: h[None].expand((T,) + h.shape).contiguous()
            kp, Kp = k1.riccati_backward_explicit_plain(
                A, Bm, lx, lu, *(tile(h) for h in hess), *_terminal_plain(spec, xT_t), LEVELS)
        torch.testing.assert_close(k, kp, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(K, Kp, rtol=1e-4, atol=1e-5)
        gains[discrete] = kp, Kp
    _check_select(_select_both(spec, xs, us, xT, *gains[True], cost))
    if (nx, nu) != (6, 2):
        boxes = (False,) if (nx, nu) in k1.EXPLICIT_CLAMP_ONLY else (False, True)
        for boxqp in boxes:
            # 5 problems at nx >= 12: the stub runs the group kernel's 16
            # lanes a problem as threads that meet at every shuffle.
            stacks, box, vx0, vxx0 = stacks_of(nx, nu, 4, NB if nx < 12 else 5, False,
                                               seed=nx + boxqp)
            bounds = box if boxqp else (None, None)
            got = k1.launch_riccati_explicit(*stacks, vx0, vxx0, LEVELS, *bounds)
            want = k1.riccati_backward_explicit_plain(*stacks, vx0, vxx0, LEVELS, *bounds)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pendulum_fused_route_kernels(launches_on_cpu):
    """The swing-up's general branch: K2's rollout and select, K3 with
    Hessians in both Jacobian modes -- its stage cost reads the stage index
    the kernel hands it -- and K4 with its terminal cost in the kernel
    (clamp and boxqp, on regularized stages), against the plain versions."""
    spec, x0, us, xs, xT, cost = _inputs("pendulum")
    tail, got_cost = k2.launch_rollout_cost(spec, x0, us)
    want_tail, _ = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(tail, want_tail, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_cost, cost, rtol=1e-5, atol=1e-5)
    for discrete in (True, False):
        want = k3.linearize_plain(spec, xs, us, True, None, discrete)
        for g, w in zip(k3.launch_linearize(spec, xs, us, True, None, discrete), want):
            _near(g.numpy(), w.numpy())
    A, Bm, lx, lu, lxx, luu, lux = k3.linearize_plain(spec, xs, us, True)
    lin = (A, Bm, lx, lu, lxx, luu + 1.0, lux)
    T = xs.shape[0]
    symbol, (_, term_p) = _build.problem_symbol("riccati_backward", 2, 1, spec.dynamics,
                                                spec.terminal_cost)
    for bounds, atol in (((None, None), 1e-5),
                         (((-5.0 - us).contiguous(), (5.0 - us).contiguous()), 1e-4)):
        k, K = torch.empty(T, 1, NB), torch.empty(T, 1, 2, NB)
        _build.launch(symbol, *lin, *bounds, xT, k, K, T, NB, 0, term_p, tuple(LEVELS),
                      len(LEVELS))
        kp, Kp = k1.riccati_backward_plain(spec, *lin, xT, LEVELS, *bounds)
        torch.testing.assert_close(k, kp, rtol=1e-4, atol=atol)
        torch.testing.assert_close(K, Kp, rtol=1e-4, atol=atol)
    kp, Kp = k1.riccati_backward_plain(spec, *lin, xT, LEVELS)
    _check_select(_select_both(spec, xs, us, xT, kp, Kp, cost))


def _ramp_cost(v):
    """The test-only cost reading t, as a tagged torch callable (the plain
    versions run it); ``v`` the reference's velocity a stage."""
    w, r, wu = (0.0, 10.0, 0.0, 1.0), (0.0, 0.0, 0.0, 1.0), (0.1, 0.1)

    def stage(x, u, t):
        t = t if torch.is_tensor(t) else torch.tensor(t)
        tf = t.to(x.dtype)
        e = x[..., 0] - (r[0] + v[0] * tf)
        c = w[0] * (e * e)
        for i in range(1, 4):
            e = x[..., i] - (r[i] + v[i] * tf)
            c = c + w[i] * (e * e)
        for i in range(2):
            c = c + wu[i] * (u[..., i] * u[..., i])
        return c

    return tag_device_fn(stage, "ramp_tracking", w + r + tuple(v) + wu)


@pytest.fixture(scope="module")
def lane():
    """The lane-follow spec at T = 8 with seeded states and controls."""
    spec = entry.single_track_spec(8, device="cpu")
    rng = np.random.RandomState(4)
    x0 = torch.as_tensor(_f32(np.stack([rng.uniform(-1, 1, NB), rng.uniform(0.5, 1.5, NB),
                                        rng.uniform(-0.3, 0.3, NB), rng.uniform(0, 1, NB)])))
    us = torch.as_tensor(_f32(rng.uniform(-0.5, 0.5, (8, 2, NB))))
    return spec, x0, us


def test_stage_index_reaches_every_kernel(launches_on_cpu, lane):
    """A cost that reads t (a reference moving 0.05 a stage in y and 0.1 in
    v) through K3 (with Hessians, both modes), K1 (both modes), K2's
    rollout and K2's select, each against its plain version, which hands
    the cost the index as the kernel's type; a kernel that handed it 0
    would part from the plain version at every stage past the first."""
    base, x0, us = lane
    spec = base.replace(stage_cost=_ramp_cost((0.0, 0.05, 0.0, 0.1)))
    tail, cost = k2.launch_rollout_cost(spec, x0, us)
    want_tail, want_cost = k2.rollout_cost_plain(spec, x0, us)
    torch.testing.assert_close(tail, want_tail, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cost, want_cost, rtol=1e-5, atol=1e-5)
    at_zero = k2.rollout_cost_plain(spec.replace(stage_cost=lambda x, u, t: spec.stage_cost(
        x, u, 0)), x0, us)[1]
    assert not torch.allclose(cost, at_zero, rtol=1e-3)
    xs = torch.cat([x0[None], tail[:-1]], 0).contiguous()
    xT = tail[-1].contiguous()
    for discrete in (True, False):
        want = k3.linearize_plain(spec, xs, us, True, None, discrete)
        for g, w in zip(k3.launch_linearize(spec, xs, us, True, None, discrete), want):
            _near(g.numpy(), w.numpy())
    hess = tuple(h[0].contiguous() for h in k3.launch_linearize_hessians(spec, xs, us))
    for discrete in (True, False):
        k, K = _fusedlin(spec, xs, us, hess, xT, discrete)
        kp, Kp = k1.riccati_fusedlin_plain(spec, xs, us, *hess, xT, LEVELS, None, None, discrete)
        torch.testing.assert_close(k, kp, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(K, Kp, rtol=1e-4, atol=1e-5)
    _check_select(_select_both(spec, xs, us, xT, kp, Kp, cost))


def test_cost_at_rest_gives_the_lane_follow_bits(launches_on_cpu, lane):
    """With the reference at rest the t-reading cost is the lane-follow
    cost term by term (x - (r + 0 t) = x - r): its K1, K2 and K3 outputs
    are the lane-follow instantiations' bit for bit, so handing the index
    down changes no arithmetic of a cost that does not use it."""
    base, x0, us = lane
    ramp = base.replace(stage_cost=_ramp_cost((0.0,) * 4))
    outs = []
    for spec in (base, ramp):
        tail, cost = k2.launch_rollout_cost(spec, x0, us)
        xs = torch.cat([x0[None], tail[:-1]], 0).contiguous()
        xT = tail[-1].contiguous()
        lin = k3.launch_linearize(spec, xs, us, True)
        hess = tuple(h[0].contiguous() for h in lin[4:])
        k, K = _fusedlin(spec, xs, us, hess, xT, True)
        sel = _select_both(spec, xs, us, xT, k, K, cost)[0]
        outs.append((tail, cost) + tuple(lin) + (k, K) + sel)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
