#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``multi_agent_solver_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives
the main path -- the batched single-track lane-follow iLQR solve of
``bench.py`` -- through ``solve_ilqr_batched`` at full width, checks the
solve's cost distribution and the kernels' launch counts, and times it.

Phases, each reported on its own lines:

1. card: ``nvidia-smi``'s name and power limit of the GPU;
2. build: the kernels' build time and ptxas' register / spill report;
3. per-kernel checks at B = 8192, T = 80, each output's tolerance printed
   beside its max abs error and max error relative to the output's scale;
4. end to end at B = 4096: kernels against the plain versions on the card
   (cost rtol 1e-5, controls atol 2e-4, as tests/test_fused_loop.py);
5. the main path at B = 262,144: cost median / p99 / max against the
   anchors of docs/BENCHMARKS.md, launch counts K3 = 1, K2 = 1 + iterations,
   K1 = iterations; then 5 timed warm solves at 262,144 and 524,288 and the
   kernels' times per launch;
6. one JSON line listing every ported kernel;
7. last line: ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without CUDA it
exits 1 and prints no result.  Long output goes to
``build/chip_smoke.log`` as well.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ANCHORS = {"median": (157.19426, 1e-4), "p99": (436.50748, 1e-3), "max": (499.59595, 1e-3)}
MAIN_BATCH, BENCH_BATCH = 262_144, 524_288
CHECK_BATCH, E2E_BATCH, T = 8192, 4096, 80
TIMED_SOLVES = 5
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 ops/s
# outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# Float32 operations per unit of work, counted from the csrc arithmetic at
# nx = 4, nu = 2 (a transcendental counts as one operation, so these are a
# floor): a float RK4 step of the single-track model, a 6-tangent dual RK4
# step plus the dual cost gradient, one Riccati stage core (one Sylvester
# test), the float lane-follow cost and feedback control, the one-stage
# K3 work with second-order duals.
OPS_RK4, OPS_DUAL_STAGE, OPS_STAGE_CORE = 80, 932, 818
OPS_COST, OPS_CONTROL, OPS_K3 = 24, 28, 3300


def log(msg: str = "") -> None:
    print(msg, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(msg + "\n")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


LOG_PATH = "build/chip_smoke.log"
DEVICE = "cuda"


def compare(name, got, want, rtol, atol):
    """``(ok, max abs error, max abs error / max |want|)`` of ``got`` against
    ``want``; ok is False if any element is outside ``atol + rtol |want|``
    (NaNs count as outside)."""
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    err = np.abs(got - want)
    bad = ~(err <= atol + rtol * np.abs(want))
    max_abs = float(np.max(err)) if err.size else 0.0
    max_rel = max_abs / max(float(np.max(np.abs(want))), 1e-30) if err.size else 0.0
    log(f"  {name:28s} max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}) {'OK' if not bad.any() else 'MISMATCH %d' % bad.sum()}")
    return (not bad.any()), max_abs, max_rel


def event_times(fn, reps):
    """Times in ms of ``reps`` calls of ``fn()``, each between two CUDA
    events and synchronized."""
    import torch
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def event_ms(fns):
    """Mean device time in ms per call of the callables ``fns``, launched
    back to back between two CUDA events and synchronized."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for fn in fns:
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(fns)


def main_path_inputs(spec, B, seed):
    """Realistic inputs of every kernel at the main path's shapes: the
    bench x0 batch with controls drawn uniformly inside the bounds."""
    import torch
    from multi_agent_solver_tpu_torch import entry
    rng = np.random.RandomState(seed)
    dev = spec.initial_state.device
    x0 = torch.as_tensor(entry.bench_x0(B).T.copy(), device=dev)                 # [nx, B]
    us = np.stack([rng.uniform(-0.7, 0.7, (T, B)), rng.uniform(-1.0, 1.0, (T, B))], 1)
    us = torch.as_tensor(us, dtype=torch.float32, device=dev).contiguous()       # [T, nu, B]
    lb = torch.tensor([-0.7, -1.0], device=dev)[:, None].expand(2, B).contiguous()
    ub = torch.tensor([0.7, 1.0], device=dev)[:, None].expand(2, B).contiguous()
    active = torch.as_tensor(rng.uniform(size=B) < 0.9, device=dev)
    return x0, us, lb, ub, active


def check_kernels(spec):
    """Phase 3: each kernel against its plain version at B = CHECK_BATCH."""
    import torch
    from multi_agent_solver_tpu_torch.ops import forward_select as k2, linearize as k3, riccati as k1
    from multi_agent_solver_tpu_torch.entry import BENCH_CONFIG
    from multi_agent_solver_tpu_torch.solvers.ilqr import _alpha_ladder_floats
    B = CHECK_BATCH
    x0, us, lb, ub, active = main_path_inputs(spec, B, seed=1)
    errs, ok = {}, True

    def record(kernel, results):
        nonlocal ok
        for good, max_abs, max_rel in results:
            ok = ok and good
            a, r = errs.get(kernel, (0.0, 0.0))
            errs[kernel] = (max(a, max_abs), max(r, max_rel))

    log(f"[3] per-kernel checks, B={B}, T={T}")
    xs_k, cost_k = k2.rollout_cost(spec, x0, us)
    xs_p, cost_p = k2.rollout_cost_plain(spec, x0, us)
    record("K2", [compare("K2 rollout xs", xs_k, xs_p, 1e-5, 1e-5),
                  compare("K2 rollout cost", cost_k, cost_p, 1e-5, 0.0)])

    lin_k = k3.linearize(spec, x0[None].contiguous(), us[:1].contiguous(), True)
    lin_p = k3.linearize_plain(spec, x0[None].contiguous(), us[:1].contiguous(), True)
    record("K3", [compare(f"K3 {n}", a, b, 1e-5, 1e-5)
                  for n, a, b in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux"), lin_k, lin_p)])

    xs = torch.cat([x0[None], xs_p[:-1]], 0).contiguous()
    xT = xs_p[-1].clone()
    hess = [h[0] for h in lin_p[4:]]
    levels = k1.reg_ladder(BENCH_CONFIG.reg_init, BENCH_CONFIG.reg_factor, BENCH_CONFIG.reg_levels)
    k_k, K_k = k1.riccati_fusedlin(spec, xs, us, *hess, xT, levels)
    k_p, K_p = k1.riccati_fusedlin_plain(spec, xs, us, *hess, xT, levels)
    record("K1", [compare("K1 k", k_k, k_p, 1e-4, 1e-5),
                  compare("K1 K", K_k, K_p, 1e-4, 1e-5)])

    # The bench ladder (3 candidate registers), and the reference's full
    # 10-rung ladder (16) that configs without alpha_ladder run.
    for ladder in (BENCH_CONFIG.alpha_ladder, _alpha_ladder_floats(BENCH_CONFIG.alpha_min)):
        outs = {}
        for name, fn in (("kernel", k2.forward_select), ("plain", k2.forward_select_plain)):
            bufs = [xs.clone(), us.clone(), xT.clone()]
            merit, accept = fn(spec, *bufs, k_p, K_p, cost_p, active, lb, ub, ladder)
            outs[name] = bufs + [merit, accept]
        kx, ku, kT, km, ka = outs["kernel"]
        px, pu, pT, pm, pa = outs["plain"]
        n_diff = int((ka != pa).sum())
        tag = f"K2 select A={len(ladder)}"
        log(f"  {tag} accept {int(ka.sum())} of {B} accepted, {n_diff} differ")
        record("K2", [compare(f"{tag} xs", kx, px, 1e-4, 1e-4),
                      compare(f"{tag} us", ku, pu, 1e-4, 1e-4),
                      compare(f"{tag} xT", kT, pT, 1e-4, 1e-4),
                      compare(f"{tag} merit", km, pm, 1e-5, 0.0),
                      (n_diff == 0, 0.0, 0.0)])
    torch.cuda.synchronize()
    if not ok:
        fail("a kernel disagrees with its plain version (phase 3)")
    return errs


def check_end_to_end(ilqr, entry):
    """Phase 4: the solve through the kernels against the plain versions."""
    log(f"[4] end to end, B={E2E_BATCH}: kernels vs plain versions on the card")
    specs = entry.bench_specs(E2E_BATCH, device=DEVICE)
    t0 = time.perf_counter()
    rk = ilqr.solve_ilqr_batched(specs, entry.BENCH_CONFIG, device=DEVICE)
    t1 = time.perf_counter()
    rp = ilqr.solve_ilqr_batched_fused(specs, entry.BENCH_CONFIG, ilqr.PLAIN_OPS)
    t2 = time.perf_counter()
    log(f"  kernels {t1 - t0:.3f} s, plain {t2 - t1:.3f} s, iterations "
        f"{int(rk.iterations[0])} / {int(rp.iterations[0])}")
    good = [compare("e2e cost", rk.cost, rp.cost, 1e-5, 0.0)[0],
            compare("e2e controls", rk.controls, rp.controls, 0.0, 2e-4)[0]]
    if not all(good):
        fail("end-to-end solve through the kernels disagrees with the plain versions (phase 4)")


def solve_and_check(ilqr, entry, stats):
    """Phase 5a: the main path once at MAIN_BATCH, anchors and launch counts."""
    import torch
    log(f"[5] main path, B={MAIN_BATCH}")
    specs = entry.bench_specs(MAIN_BATCH, device=DEVICE)
    for s in stats.values():
        s.reset()
    result = ilqr.solve_ilqr_batched(specs, entry.BENCH_CONFIG, device=DEVICE)
    torch.cuda.synchronize()
    launches = {name: s.launches for name, s in stats.items()}
    it = int(result.iterations[0])
    costs = result.cost.double().cpu().numpy()
    if result.states.shape != (MAIN_BATCH, T + 1, 4) or result.controls.shape != (MAIN_BATCH, T, 2):
        fail(f"result shapes {tuple(result.states.shape)} {tuple(result.controls.shape)}")
    if not (np.all(np.isfinite(costs)) and torch.isfinite(result.controls).all()):
        fail("non-finite costs or controls")
    got = {"median": float(np.median(costs)), "p99": float(np.percentile(costs, 99)),
           "max": float(np.max(costs))}
    log(f"  iterations {it}, converged {int(result.converged.sum())} of {MAIN_BATCH}")
    for key, (anchor, rtol) in ANCHORS.items():
        rel = abs(got[key] - anchor) / anchor
        log(f"  cost {key:6s} {got[key]!r} anchor {anchor} rel {rel:.3e} (rtol {rtol:g}) "
            f"{'OK' if rel <= rtol else 'MISMATCH'}")
        if rel > rtol:
            fail(f"cost {key} {got[key]} is off the anchor {anchor}")
    want = {"K3": 1, "K2": 1 + it, "K1": it}
    log(f"  launches {launches} expected {want}")
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    return launches, got, it


def time_solves(ilqr, entry, B):
    """Phase 5b: median wall time of TIMED_SOLVES warm solves (CUDA events)."""
    import torch
    specs = entry.bench_specs(B, device=DEVICE)
    ilqr.solve_ilqr_batched(specs, entry.BENCH_CONFIG, device=DEVICE)   # warm-up
    torch.cuda.synchronize()
    result = {}

    def solve():
        result["r"] = ilqr.solve_ilqr_batched(specs, entry.BENCH_CONFIG, device=DEVICE)

    times = [t / 1e3 for t in event_times(solve, TIMED_SOLVES)]
    r = result["r"]
    med = float(np.median(times))
    log(f"  B={B}: solve times {[round(t, 6) for t in times]} s, median {med:.6f} s, "
        f"{B / med:.1f} solves/s, iterations {int(r.iterations[0])}")
    # Host time of the solver's per-call cost-structure probe (tiny
    # torch.func evaluations and device-to-host copies), one part of the
    # solve time spent outside the kernels.
    one = specs.replace(initial_state=specs.initial_state[0],
                        initial_controls=specs.initial_controls[0])
    t0 = time.perf_counter()
    for _ in range(TIMED_SOLVES):
        ilqr.resolve_cost_structure(one, entry.BENCH_CONFIG)
    torch.cuda.synchronize()
    log(f"  B={B}: cost-structure probe {(time.perf_counter() - t0) / TIMED_SOLVES * 1e3:.3f} ms "
        f"host time per solve")
    return B / med


def time_kernels(spec, B, with_plain):
    """Phase 5c: each kernel's device time per launch at the main path's
    shapes (iteration-1 inputs), its bound from these inputs, and
    optionally the plain version's time."""
    import torch
    from multi_agent_solver_tpu_torch.ops import forward_select as k2, linearize as k3, riccati as k1
    from multi_agent_solver_tpu_torch.entry import BENCH_CONFIG
    x0, us0, lb, ub, _ = main_path_inputs(spec, B, seed=2)
    us0.zero_()                                   # the main path's warm start
    active = torch.ones(B, dtype=torch.bool, device=x0.device)
    x1 = x0[None].contiguous()
    u1 = us0[:1].contiguous()
    levels = k1.reg_ladder(BENCH_CONFIG.reg_init, BENCH_CONFIG.reg_factor, BENCH_CONFIG.reg_levels)
    ladder = BENCH_CONFIG.alpha_ladder
    A = len(ladder)

    xs_tail, cost = k2.rollout_cost(spec, x0, us0)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0).contiguous()
    xT = xs_tail[-1].clone()
    hess = [h[0] for h in k3.linearize(spec, x1, u1, True)[4:]]
    k, K = k1.riccati_fusedlin(spec, xs, us0, *hess, xT, levels)
    fresh = lambda: [xs.clone(), us0.clone(), xT.clone()]
    _, accept = k2.forward_select(spec, *fresh(), k, K, cost, active, lb, ub, ladder)
    n_acc = int(accept.sum())

    # Each kernel REPS times back to back between two events, so the host's
    # launch overhead overlaps the previous launch; the select kernel works
    # in place, so each of its launches gets its own copy of the buffers.
    reps = 5
    sel_bufs = [fresh() for _ in range(reps)]
    ms = {
        "K3": event_ms([lambda: k3.linearize(spec, x1, u1, True)] * reps),
        "K2_rollout": event_ms([lambda: k2.rollout_cost(spec, x0, us0)] * reps),
        "K1": event_ms([lambda: k1.riccati_fusedlin(spec, xs, us0, *hess, xT, levels)] * reps),
        "K2": event_ms([lambda b=b: k2.forward_select(spec, *b, k, K, cost, active, lb, ub, ladder)
                        for b in sel_bufs]),
    }
    del sel_bufs
    plain = {}
    if with_plain:
        b = fresh()
        plain = {
            "K3": event_ms([lambda: k3.linearize_plain(spec, x1, u1, True)]),
            "K1": event_ms([lambda: k1.riccati_fusedlin_plain(spec, xs, us0, *hess, xT, levels)]),
            "K2": event_ms([lambda: k2.forward_select_plain(spec, *b, k, K, cost, active,
                                                            lb, ub, ladder)]),
        }

    # Bounds: bytes each input read once / each output written once, and
    # float32 operations, of this run's inputs (K2's phase 2 and its writes
    # only on accepted problems).
    nx, nu, f = 4, 2, 4
    bytes_ = {
        "K3": B * f * ((nx + nu) + nx * nx + nx * nu + nx + nu + nx * nx + nu * nu + nu * nx),
        "K1": B * f * (T * (nx + nu) + T * nu * (1 + nx) + nx * nx + nu * nu + nu * nx + nx),
        # reads x, u, k, K, merit, lb, ub (+ 1 byte active); writes merit
        # (+ 1 byte accept) and, where accepted, x, u and x_T.
        "K2": B * f * (T * (nx + 2 * nu + nu * nx) + 1 + 2 * nu + 1) + 2 * B
              + n_acc * f * (T * (nx + nu) + nx),
    }
    ops = {
        "K3": B * OPS_K3,
        "K1": B * T * (OPS_DUAL_STAGE + OPS_STAGE_CORE),
        "K2": B * T * A * (OPS_CONTROL + OPS_COST + OPS_RK4) + n_acc * T * (OPS_CONTROL + OPS_RK4),
    }
    bound = {}
    for name in ("K1", "K2", "K3"):
        t_bytes, t_ops = bytes_[name] / PEAK_BYTES * 1e3, ops[name] / PEAK_F32 * 1e3
        bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    log(f"  B={B}: kernel ms/launch {json.dumps({k: round(v, 6) for k, v in ms.items()})}; "
        f"K2 accepted {n_acc} of {B}")
    if plain:
        log(f"  B={B}: plain ms/call {json.dumps({k: round(v, 6) for k, v in plain.items()})}")
    log(f"  B={B}: bound ms {json.dumps({k: [round(v[0], 6), v[1]] for k, v in bound.items()})}")
    return ms, plain, bound


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs an NVIDIA GPU")
    from multi_agent_solver_tpu_torch import entry
    from multi_agent_solver_tpu_torch.ops import _build
    from multi_agent_solver_tpu_torch.ops import forward_select as k2
    from multi_agent_solver_tpu_torch.ops import linearize as k3
    from multi_agent_solver_tpu_torch.ops import riccati as k1
    from multi_agent_solver_tpu_torch.solvers import ilqr

    import os
    os.makedirs("build", exist_ok=True)
    open(LOG_PATH, "w").close()

    # [1] card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card line: {smi.stderr.strip()}")
    log(card)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # [2] build
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

    spec = entry.single_track_spec(device=DEVICE)
    errs = check_kernels(spec)
    check_end_to_end(ilqr, entry)

    stats = {"K1": k1.STATS, "K2": k2.STATS, "K3": k3.STATS}
    launches, got, it = solve_and_check(ilqr, entry, stats)
    rates = {B: time_solves(ilqr, entry, B) for B in (MAIN_BATCH, BENCH_BATCH)}
    timing = {B: time_kernels(spec, B, with_plain=(B == MAIN_BATCH)) for B in (MAIN_BATCH, BENCH_BATCH)}
    log(f"  card {card}: {rates[MAIN_BATCH]:.1f} solves/s at {MAIN_BATCH}, "
        f"{rates[BENCH_BATCH]:.1f} solves/s at {BENCH_BATCH}")
    for B in (MAIN_BATCH, BENCH_BATCH):
        kms = timing[B][0]
        in_kernels = (launches["K1"] * kms["K1"] + (launches["K2"] - 1) * kms["K2"]
                      + kms["K2_rollout"] + launches["K3"] * kms["K3"])
        solve_ms = B / rates[B] * 1e3
        log(f"  B={B}: kernel time per solve {in_kernels:.3f} ms (launch counts x ms per "
            f"launch) of {solve_ms:.3f} ms median solve, {100 * in_kernels / solve_ms:.1f}%")

    ms, plain, bound = timing[MAIN_BATCH]
    ms_big = timing[BENCH_BATCH][0]
    meta = {
        "K1": ("K1 riccati_fusedlin", "multi_agent_solver_tpu_torch/csrc/riccati.cu",
               "multi_agent_solver_tpu/ops/riccati_pallas.py:526"),
        "K2": ("K2 forward_select", "multi_agent_solver_tpu_torch/csrc/forward_select.cu",
               "multi_agent_solver_tpu/ops/forward_select_pallas.py:300"),
        "K3": ("K3 linearize", "multi_agent_solver_tpu_torch/csrc/linearize.cu",
               "multi_agent_solver_tpu/ops/linearize_pallas.py:143"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        entry_ = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key][0], "max_rel_err": errs[key][1],
            "ms": ms[key], "plain_ms": plain[key], "bound_ms": bound[key][0],
            "bound_by": bound[key][1], "library_ms": None,
            "batch": MAIN_BATCH, "ms_at_524288": ms_big[key],
        }
        if key == "K2":
            entry_["ms_rollout_mode"] = ms["K2_rollout"]
            entry_["ms_rollout_mode_at_524288"] = ms_big["K2_rollout"]
        kernels.append(entry_)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
