"""Per-launch times of the port's redesigned kernels, so that two trees of
the port can be compared on one card.

Two groups of rows:

* the coupled game's context kernels at each row of the game
  (``entry.COUPLED_ROWS``: 64, 256 and 1,024 cars) on first-iteration
  inputs: K6's context select and AL + context select (the game's 10
  candidates), K3's context mode with and without Hessians, and K4
  (``chip_smoke.py``'s ``time_game_kernels``, ``time_al_context_kernel``);
* the main path's at 262,144 problems and T = 80 (``redesigned_calls``):
  K2's select without a context at the bench ladder (A = 3, phase 5's
  inputs) and the reference ladder (A = 10, phase 12's), K7 in both
  Jacobian modes (phase 21's), each with the digests of its outputs (K2's
  also on ``rung_inputs``', where every rung wins somewhere), so that two
  trees' outputs are compared bit for bit, and the device ms of each
  kernel that a call launches (a torch.profiler trace, ``kernel_split``).

Each row is timed two ways: CUDA events around 20 back-to-back wrapper
calls (the host's cost of each call included), and a CUDA graph of 20
launches (the kernels alone).  The inputs and the timing are this
checkout's ``chip_smoke.py``; ``--tree DIR`` takes the package from another
checkout instead (an earlier commit unpacked with ``git archive``), which
builds its kernels into its own ``DIR/build/``.  Prints the card's name and
power limit, then one JSON line ``{"tree": ..., "card": ..., "ms": {cars:
{kernel: [wrapper-call ms, device ms]}}, "main": {row: [wrapper-call ms,
device ms, digests, {kernel: device ms}]}}``; the log goes to
``build/kernel_times.log``.

    python3 kernel_times.py [--tree DIR]

Run two trees alternately on one machine (a, b, b, a) to compare them: the
host's share of a wrapper call varies from machine to machine.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MAIN_ROWS = ("K2_A3", "K2_A10", "K7", "K7_continuous")


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
    tree = Path(parser.parse_args().tree).resolve()
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
    cs.log(f"tree {tree}, package {pkg.__file__}, card {card}")
    rows = {}
    for agents, neighbors in entry.COUPLED_ROWS:
        ms, _, _, device = cs.time_game_kernels(entry, agents, neighbors, with_plain=False)
        al_ms, _, _, al_device, _ = cs.time_al_context_kernel(entry, ilqr, agents, neighbors, False)
        row = {name: [ms[name], device[name]] for name in ("K6_A10", "K3ctx_hess", "K3ctx", "K4")}
        row["K6alctx"] = [al_ms, al_device]
        rows[agents] = row
    main_rows = {}
    for row, calls, restore, digests in cs.redesigned_calls(
            entry.single_track_spec(device=cs.DEVICE), cs.MAIN_BATCH, MAIN_ROWS):
        ms, device = cs.time_calls(calls, restore)
        restore()
        main_rows[row] = [ms, device, digests, kernel_split(calls)]
        cs.log(f"  {row}: {ms:.6f} ms a wrapper call, {device:.6f} ms a launch on the device "
               f"(CUDA graph); by kernel {main_rows[row][3]}; output digests {' '.join(digests)}")
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"tree": str(tree), "card": card, "ms": rows,
                      "main": main_rows}))


if __name__ == "__main__":
    main()
