"""Per-launch times of the coupled game's context kernels, so that two trees
of the port can be compared on one card.

Times K6's context select and AL + context select (the game's 10
candidates) and K3's context mode with and without Hessians at each row of
the game (``entry.COUPLED_ROWS``: 64, 256 and 1,024 cars) on first-iteration
inputs, two ways: CUDA events around 20 back-to-back wrapper calls (the
host's cost of each call included), and a CUDA graph of 20 launches (the
kernels alone).  The inputs and the timing are this checkout's
``chip_smoke.py`` (``time_game_kernels``, ``time_al_context_kernel``);
``--tree DIR`` takes the package from another checkout instead (an earlier
commit unpacked with ``git archive``), which builds its kernels into its own
``DIR/build/``.  Prints the card's name and power limit, then one JSON line
``{"tree": ..., "card": ..., "ms": {cars: {kernel: [wrapper-call ms, device
ms]}}}``; the log goes to ``build/context_kernel_times.log``.

    python3 context_kernel_times.py [--tree DIR]

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
    cs.LOG_PATH = str(HERE / "build" / "context_kernel_times.log")

    import torch
    if not torch.cuda.is_available():
        sys.exit("context_kernel_times.py needs a CUDA card")
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
        al_ms, _, _, al_device = cs.time_al_context_kernel(entry, ilqr, agents, neighbors, False)
        row = {name: [ms[name], device[name]] for name in ("K6_A10", "K3ctx_hess", "K3ctx")}
        row["K6alctx"] = [al_ms, al_device]
        rows[agents] = row
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"tree": str(tree), "card": card, "ms": rows}))


if __name__ == "__main__":
    main()
