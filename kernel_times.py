"""Per-launch times of the port's redesigned kernels, so that two trees of
the port can be compared on one card.

Three groups of rows:

* the coupled game's context kernels at each row of the game
  (``entry.COUPLED_ROWS``: 64, 256 and 1,024 cars) on first-iteration
  inputs: K6's context select and AL + context select (the game's 10
  candidates), K3's context mode with and without Hessians, and K4 with
  the digest of its gains (``chip_smoke.py``'s ``time_game_kernels``,
  ``time_al_context_kernel``);
* the main path's at 262,144 problems and T = 80 (``redesigned_calls``):
  K2's select without a context at the bench ladder (A = 3, phase 5's
  inputs) and the reference ladder (A = 10, phase 12's), K7 in both
  Jacobian modes (phase 21's), K6's AL select at both ladders (phase 18's
  inputs), K4 with per-stage Hessians in both terminal modes and K1 in
  its three modes (clamp, boxqp, continuous), each
  with the digests of its outputs (K2's and K6-AL's also on ``rung_inputs``', where
  every rung wins somewhere; K1's also on a rollout under drawn controls),
  so that two trees' outputs are compared bit
  for bit, and the device ms of each kernel that a call launches (a
  torch.profiler trace, ``kernel_split``); and K2's rollout (the main
  path's, also at 524,288 problems, the sweep's at T = 10 and the game
  rows' with a context, ``K6_rollout_N``) and K3's hoist (one stage and the
  horizon), with the digests of their outputs on zero and on drawn
  controls from partly non-finite starts (``chip_smoke.py``'s
  ``rollout_hoist_calls``), and K1 clamp at 524,288 problems; and the
  kernels on no solve path (``emit_pass_calls``): K9 at the bench and the
  reference ladder (``K9_A3``, ``K9_A10``), K8 in both Jacobian modes (``K8``,
  ``K8_continuous``) and K10, each with the digests of every output on two
  inputs;
* K4 at T = 10 on 64 to 65,536 problems (``K4_SWEEP``), on the 1,024-car
  game's stacks, tiled, and in the explicit-terminal mode at each
  instantiated (nx, nu), clamp and boxqp, on seeded random stacks: where
  the group kernel and the one-thread kernel cross.

Each row is timed two ways: CUDA events around 20 back-to-back wrapper
calls (the host's cost of each call included), and a CUDA graph of 20
wrapper calls (the kernels alone), so a tree is timed only where a graph
can capture its wrappers (a K9 wrapper that copies its candidates to the
card before the launch cannot be).  The inputs and the timing are this
checkout's ``chip_smoke.py``; ``--tree DIR`` takes the package from another
checkout instead (an earlier commit unpacked with ``git archive``), which
builds its kernels into its own ``DIR/build/``.  ``--trial NAME`` times a
copy of that tree's package under ``build/trial_NAME_TREE/`` patched by one
of ``TRIALS`` (K1 cut to one of its parts, the rollout bounded to one
wave).  Prints the card's name and
power limit, then one JSON line ``{"tree": ..., "card": ..., "ms": {cars:
{kernel: [wrapper-call ms, device ms(, digest)]}}, "main": {row: [wrapper-call
ms, device ms, digests, {kernel: device ms}]}, "k4_sweep": {instantiation:
{problems: [wrapper-call ms, device ms, digest]}}, "ptxas": {instantiation of
K1, of the rollout and of the hoist: ptxas's lines of its registers, stack
frame and spills}, "sass": the rollout's stage and the hoist's body in SASS
instructions, and their issue floors (``chip_smoke.sass_floors``)}``; the
log goes to ``build/kernel_times.log``, the SASS of those functions to
``build/sass_*.txt``.  ``--parts`` and ``--rows`` time a subset.

    python3 kernel_times.py [--tree DIR] [--trial NAME] [--parts games main sweep] [--rows K1 ...]

Run two trees alternately on one machine (a, b, b, a) to compare them: the
host's share of a wrapper call varies from machine to machine.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MAIN_ROWS = ("K2_A3", "K2_A10", "K7", "K7_continuous", "K6AL_A3", "K6AL_A10", "K4_per_stage",
             "K4_explicit", "K1", "K1_boxqp", "K1_continuous", "K2_rollout", "K2_rollout_524288",
             "K2_rollout_sweep", "K6_rollout_64", "K6_rollout_256", "K6_rollout_1024",
             "K3_hoist_stage", "K3_hoist_horizon", "K1_524288", "K9_A3", "K9_A10", "K8",
             "K8_continuous", "K10")
K4_SWEEP = (64, 256, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
PARTS = ("games", "main", "sweep")
# Trial copies of a tree, as text patches of one of its csrc files (file,
# the kernel patched or None for the whole file, (before, after) pairs,
# each found there exactly once).  K1 cut to its parts, patches of
# riccati_fusedlin_kernel in csrc/riccati.cuh (the stage loop's lines are
# matched by regular expressions, so that any tree's K1 takes them):
# "lin_only" runs the linearization and writes the sum of A, B, lx, lu to k
# (K = 0) in place of the stage core; "rec_only" runs the stage core on the
# A, B, lx, lu of stage T-1, computed once before the loop, so that no stage
# loads x or u.  "rollout_one_wave" bounds the rollout kernel
# (csrc/forward_select.cuh) to 32 registers a thread, 16 blocks of 128 an
# SM, so that 262,144 problems are one wave.
K1_CORE = re.compile(r"    stage_core<NX, NU, BOXQP>\(A, Bm, lx, lu, lxx, luu, lux, [^;]*\);\n")
K1_LIN = re.compile(r"    stage_derivatives\w*<DISCRETE>\(dyn, cost, h, [^;]*\);\n")
K1_LOOP = "  for (int t = T - 1; t >= 0; --t) {\n"
UNROLL = "#pragma unroll\n"
TRIALS = {
    "lin_only": ("riccati.cuh", "riccati_fusedlin_kernel", [(K1_CORE, (
        "    float sum = 0.0f;\n" + UNROLL + "    for (int i = 0; i < NX; ++i) {\n"
        + UNROLL + "      for (int j = 0; j < NX; ++j) sum = sum + A[i][j];\n"
        + UNROLL + "      for (int j = 0; j < NU; ++j) sum = sum + Bm[i][j];\n"
        "      sum = sum + lx[i];\n    }\n"
        + UNROLL + "    for (int i = 0; i < NU; ++i) {\n      k[i] = sum + lu[i];\n"
        + UNROLL + "      for (int j = 0; j < NX; ++j) K[i][j] = 0.0f;\n    }\n"))]),
    "rec_only": ("riccati.cuh", "riccati_fusedlin_kernel", [
        (K1_LIN, (
            UNROLL + "    for (int i = 0; i < NX; ++i) {\n"
            + UNROLL + "      for (int j = 0; j < NX; ++j) A[i][j] = A0[i][j];\n"
            + UNROLL + "      for (int j = 0; j < NU; ++j) Bm[i][j] = B0[i][j];\n"
            "      lx[i] = lx0[i];\n    }\n"
            + UNROLL + "    for (int i = 0; i < NU; ++i) lu[i] = lu0[i];\n")),
        (K1_LOOP, (
            "  float A0[NX][NX], B0[NX][NU], lx0[NX], lu0[NU];\n  {\n"
            "    float x0[NX], u0[NU];\n    const size_t s0 = static_cast<size_t>(T - 1);\n"
            + UNROLL + "    for (int i = 0; i < NX; ++i) x0[i] = xs[(s0 * NX + i) * sB + b];\n"
            + UNROLL + "    for (int i = 0; i < NU; ++i) u0[i] = us[(s0 * NU + i) * sB + b];\n"
            "    stage_derivatives<DISCRETE>(dyn, cost, h, x0, u0, A0, B0, lx0, lu0);\n  }\n"
            + K1_LOOP))]),
    "rollout_one_wave": ("forward_select.cuh", "forward_rollout_kernel", [
        ("__launch_bounds__(ROLLOUT_BLOCK)", "__launch_bounds__(ROLLOUT_BLOCK, 16)")]),
}
# ptxas's report of these instantiations (a regular expression on the
# mangled name of "Compiling entry function"): K1's four, the rollout's
# (this tree's kernel, or the one-thread kernel's rollout mode, MAXA = 1,
# INIT = true) and the Hessian hoist's (this tree's) beside K3 with
# Hessians (the parent's hoist); the first label that matches names a line.
PTXAS = {
    "K1 boxqp=0 discrete=1": r"riccati_fusedlin_kernel\w*?Lb0ELb1E",
    "K1 boxqp=1 discrete=1": r"riccati_fusedlin_kernel\w*?Lb1ELb1E",
    "K1 boxqp=0 discrete=0": r"riccati_fusedlin_kernel\w*?Lb0ELb0E",
    "K1 boxqp=1 discrete=0": r"riccati_fusedlin_kernel\w*?Lb1ELb0E",
    "K2 rollout, lane follow": r"forward_rollout_kernel\w*DiagQuadratic|"
                               r"forward_select_kernel\w*DiagQuadratic\w*Li1ELb1ELb0E",
    "K2 rollout, coupled": r"forward_rollout_kernel\w*Coupled|"
                           r"forward_select_kernel\w*Coupled\w*Li1ELb1ELb0E",
    "K2 rollout, circular track": r"forward_rollout_kernel\w*?_13CircularTrackE|"
                                  r"forward_select_kernel\w*?_13CircularTrackE\w*Li1ELb1ELb0E",
    "K3 hoist, lane follow": r"linearize_hessians_kernel\w*DiagQuadratic",
    "K3 with Hessians, lane follow": r"linearize_kernel\w*DiagQuadratic\w*Lb1ELb1E",
    "K3 with Hessians, continuous, lane follow": r"linearize_kernel\w*DiagQuadratic\w*Lb1ELb0E",
    "K9": r"forward_pass_kernel",
    "K8 re-roll": r"forward_emit_reroll_kernel\w*SingleTrack",
    "K8 in one kernel, A <= 4, discrete": r"forward_emit_one_thread_kernel\w*Li4ELb1EEEv",
    "K8 in one kernel, A <= 4, continuous": r"forward_emit_one_thread_kernel\w*Li4ELb0EEEv",
    "K2 lane select, lane follow": r"forward_select_lanes_kernel\w*DiagQuadratic\w*"
                               r"NoConstraintES\w*_EEv",
    "K8 one-thread, A <= 4, discrete": r"forward_select_kernel\w*DiagQuadratic\w*Li4ELb1E",
    "K8 one-thread, A <= 4, continuous": r"forward_select_kernel\w*DiagQuadratic\w*Li4ELb0E",
}


def trial_tree(tree: Path, name: str) -> Path:
    """A copy of ``tree``'s package under ``build/trial_NAME_TREE/`` patched
    by ``TRIALS[name]``, without the sources of K4's explicit mode at (8, 4)
    (``riccati_explicit_wide*.cu``, the build's long pole), which no trial's
    rows run."""
    dest = HERE / "build" / f"trial_{name}_{tree.name}"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(tree / "multi_agent_solver_tpu_torch", dest / "multi_agent_solver_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "riccati_explicit_wide*.cu"))
    file, kernel_name, patches = TRIALS[name]
    src = dest / "multi_agent_solver_tpu_torch" / "csrc" / file
    text = src.read_text()
    start, end = 0, len(text)
    if kernel_name is not None:
        start = text.rindex("__global__", 0, text.index(kernel_name + "("))
        end = text.index("\n}\n", start)
    part = text[start:end]
    for before, after in patches:
        pattern = before if isinstance(before, re.Pattern) else re.compile(re.escape(before))
        if len(pattern.findall(part)) != 1:
            sys.exit(f"trial {name}: {pattern.pattern!r} is not in {kernel_name or file} "
                     "exactly once")
        part = pattern.sub(lambda m: after, part)
    src.write_text(text[:start] + part + text[end:])
    return dest


def ptxas_report(build_log: Path) -> dict:
    """``{PTXAS label: ptxas's lines}`` of the instantiations PTXAS names in
    a build's log: their registers, and their stack frames and spills."""
    out, name = {}, None
    for line in build_log.read_text().splitlines() if build_log.exists() else ():
        if "Compiling entry function" in line:
            name = next((label for label, pattern in PTXAS.items() if re.search(pattern, line)),
                        None)
        elif name and ("registers" in line or "stack frame" in line):
            out[name] = (out.get(name, "") + " " + line.strip()).strip()
    return out


def k4_sweep(cs, entry):
    """``{instantiation: {B: [ms a wrapper call, ms a launch on the device,
    digest]}}`` of K4 at each K4_SWEEP batch, T = 10: "game" on the 1,024-car
    game's first-iteration stacks (K3's context mode; (4, 2), clamp,
    per-stage Hessians, the terminal cost's value), tiled along the batch;
    "explicit NXxNU clamp" / "... boxqp" in the explicit-terminal mode on
    ``chip_smoke.random_riccati_stacks``' seeded stacks, each instantiated
    (nx, nu), the first B problems."""
    import torch
    from multi_agent_solver_tpu_torch.entry import BENCH_CONFIG, SWEEP_CONFIG
    from multi_agent_solver_tpu_torch.ops import forward_select as k2, linearize as k3, riccati as k1
    spec, x0, us, ctx = cs.game_inputs(entry, *entry.COUPLED_ROWS[-1])
    levels = k1.reg_ladder(SWEEP_CONFIG.reg_init, SWEEP_CONFIG.reg_factor, SWEEP_CONFIG.reg_levels)
    xs_tail, _ = k2.rollout_cost(spec, x0, us, ctx)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0).contiguous()
    lin = k3.linearize(spec, xs, us, True, ctx) + (xs_tail[-1],)
    runs = {"game": lambda B: [a.repeat(*([1] * (a.dim() - 1)), -(-B // x0.shape[1]))[..., :B]
                               for a in lin]}
    for nx, nu in k1.EXPLICIT_DIMS:
        stacks, box, _ = cs.random_riccati_stacks(nx, nu, K4_SWEEP[-1], seed=19 * nx + nu,
                                                  horizon=xs.shape[0])
        stacks = [k1.stage_major(a) for a in stacks]
        box = [k1.stage_major(a) for a in box]
        runs[f"explicit {nx}x{nu} clamp"] = lambda B, s=stacks: [a[..., :B] for a in s]
        if (nx, nu) not in k1.EXPLICIT_CLAMP_ONLY:
            runs[f"explicit {nx}x{nu} boxqp"] = lambda B, s=stacks + box: [a[..., :B] for a in s]
    explicit_levels = k1.reg_ladder(BENCH_CONFIG.reg_init, BENCH_CONFIG.reg_factor,
                                    BENCH_CONFIG.reg_levels)
    out = {}
    for name, cut in runs.items():
        out[name] = {}
        for B in K4_SWEEP:
            a = [t.contiguous() for t in cut(B)]
            if name == "game":
                call = lambda: k1.riccati_backward(spec, *a, levels)
            else:
                call = lambda: k1.riccati_backward_explicit(*a[:9], explicit_levels, *a[9:])
            ms, device = cs.time_calls([call] * 20)
            out[name][B] = [ms, device, cs.digest(call())]
            cs.log(f"  K4 {name} at B={B}, T={xs.shape[0]}: {ms:.6f} ms a wrapper call, "
                   f"{device:.6f} ms a launch on the device (CUDA graph); gains digest "
                   f"{out[name][B][2]}")
            del a
    return out


def kernel_split(fns):
    """Device ms a call of each kernel that the callables ``fns`` launch, by
    kernel name, from a torch.profiler trace of one pass over them ({} if
    the trace holds no device time)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"mas::(\w+)", e.key)
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if name and us:
            out[name.group(1)] = out.get(name.group(1), 0.0) + us / 1e3 / len(fns)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(HERE),
                        help="root of the checkout whose package is timed (default: this one)")
    parser.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS,
                        help="which groups of rows to time (default: all)")
    parser.add_argument("--rows", nargs="+", choices=MAIN_ROWS, default=MAIN_ROWS,
                        help="which of the main path's rows to time (default: all)")
    parser.add_argument("--trial", choices=sorted(TRIALS),
                        help="time a copy of the tree patched by one of TRIALS")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    if args.trial:
        tree = trial_tree(tree, args.trial)
    sys.path.insert(0, str(tree))
    # chip_smoke.py of this checkout, whatever the tree timed.
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (HERE / "build").mkdir(exist_ok=True)
    cs.LOG_PATH = str(HERE / "build" / "kernel_times.log")

    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times.py needs a CUDA card")
    import multi_agent_solver_tpu_torch as pkg
    if tree not in Path(pkg.__file__).resolve().parents:
        sys.exit(f"the package came from {pkg.__file__}, not from {tree}")
    from multi_agent_solver_tpu_torch import entry
    from multi_agent_solver_tpu_torch.ops import _build
    from multi_agent_solver_tpu_torch.solvers import ilqr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"
    _build.library()
    ptxas = ptxas_report(_build.BUILD_DIR / "build.log")
    cs.log(f"tree {tree}, package {pkg.__file__}, card {card}")
    for name, line in ptxas.items():
        cs.log(f"  {name}: {line}")
    from multi_agent_solver_tpu_torch.ops import forward_select as k2
    sass = cs.sass_floors(_build.BUILD_DIR, cs.MAIN_BATCH, cs.T,
                          parent=not hasattr(k2, "ROLLOUT_STATS"))
    rows, main_rows, sweep = {}, {}, {}
    for agents, neighbors in entry.COUPLED_ROWS if "games" in args.parts else ():
        ms, _, _, device, k4_digest = cs.time_game_kernels(entry, agents, neighbors,
                                                           with_plain=False)
        al_ms, _, _, al_device, _ = cs.time_al_context_kernel(entry, ilqr, agents, neighbors,
                                                              False)
        row = {name: [ms[name], device[name]] for name in ("K6_A10", "K3ctx_hess", "K3ctx")}
        row["K4"] = [ms["K4"], device["K4"], k4_digest]
        row["K6alctx"] = [al_ms, al_device]
        rows[agents] = row
    for row, calls, restore, digests in cs.redesigned_calls(
            entry.single_track_spec(device=cs.DEVICE), cs.MAIN_BATCH,
            args.rows if "main" in args.parts else ()):
        ms, device = cs.time_calls(calls, restore)
        restore()
        main_rows[row] = [ms, device, digests, kernel_split(calls)]
        cs.log(f"  {row}: {ms:.6f} ms a wrapper call, {device:.6f} ms a launch on the device "
               f"(CUDA graph); by kernel {main_rows[row][3]}; output digests {' '.join(digests)}")
    if "sweep" in args.parts:
        sweep = k4_sweep(cs, entry)
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"tree": str(tree), "card": card, "ms": rows,
                      "main": main_rows, "k4_sweep": sweep, "ptxas": ptxas, "sass": sass}))


if __name__ == "__main__":
    main()
