"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one process per
source, at most one a core, the longest first) and links one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at first use, into
``build/torch_kernels/`` under the repository root, keyed by a hash of the
sources and flags so an edited source is rebuilt.  Nothing here runs at
import time: CPU-only installs import the package without ``nvcc``.

Each exported C function launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises on a non-zero code.
Its symbol names the kernel and the device functions it was instantiated
with (``mas_<kernel>__<dynamics>__<stage cost>[__<terminal cost>]``; a
coupled stage cost is named ``coupled_<base>_<pair>``; the select kernel's
AL mode appends ``__<equality>__<inequality>`` constraint names, ``none``
for an absent side), so a problem without a matching instantiation raises
``NotImplementedError``; so does a launcher built without the mode asked
for (it returns ``cudaErrorNotSupported``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..types import device_fn_of

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # No a*b+c contraction into FMA: every rounding then happens where the
    # plain PyTorch versions round, which keeps kernel and plain results
    # within the tolerances chip_smoke.py states.
    "-fmad=false",
    "-Xptxas", "-v",
)
# (nx, nu) of each dynamics device function, and the number of float
# parameters each device function reads, given (nx, nu).  A linear model
# comes in any size, so its tag names its dims (LINEAR + "4x4": Linear<4, 4>)
# and each size is an instantiation of its own.
DYNAMICS_DIMS = {"single_track": (4, 2), "cartpole": (4, 1), "pendulum": (2, 1),
                 "rocket": (3, 1), "dynamic_bicycle": (6, 2), "quadrotor": (12, 4),
                 "quadrotor_rotor": (16, 4)}
LINEAR = "linear_"
PARAM_COUNT = {
    "single_track": lambda nx, nu: 1,
    "cartpole": lambda nx, nu: 6,
    "pendulum": lambda nx, nu: 3,
    "rocket": lambda nx, nu: 2,
    "dynamic_bicycle": lambda nx, nu: 7,
    "quadrotor": lambda nx, nu: 9,
    "quadrotor_rotor": lambda nx, nu: 12,
    "pendulum_swing_up": lambda nx, nu: 7,
    "pendulum_swing_up_terminal": lambda nx, nu: 2,
    "rocket_terminal": lambda nx, nu: 2,
    "linear": lambda nx, nu: nx * nx + nx * nu,
    "quadratic": lambda nx, nu: nx * nx + nu * nu,
    "quadratic_terminal": lambda nx, nu: nx * nx,
    "cartpole_swing_up": lambda nx, nu: 5,
    "cartpole_swing_up_terminal": lambda nx, nu: 4,
    "diag_quadratic": lambda nx, nu: 2 * (nx + nu),
    "diag_quadratic_terminal": lambda nx, nu: 2 * nx,
    "circular_track": lambda nx, nu: 6,
    "gaussian_collision": lambda nx, nu: 2,
    "zero": lambda nx, nu: 0,
    "none": lambda nx, nu: 0,
}
BOUND_ROWS = "bound_rows"   # + M: BoundRows<M>, three parameters a row
# What a launcher returns for a mode it was built without (riccati.cuh:
# BOXQP_MODES).
CUDA_ERROR_NOT_SUPPORTED = 801


def dynamics_dims(name: str):
    """``(nx, nu)`` of the dynamics device function ``name``, None if it
    fixes none."""
    if name.startswith(LINEAR):
        nx, _, nu = name[len(LINEAR):].partition("x")
        return int(nx), int(nu)
    return DYNAMICS_DIMS.get(name)


def _param_count(tag, nx: int, nu: int) -> int:
    """Parameters the device function of ``tag`` reads; a composed one
    (``Coupled``) reads its parts' in turn."""
    if tag.parts:
        return sum(_param_count(p, nx, nu) for p in tag.parts)
    if tag.name.startswith(BOUND_ROWS):
        return 3 * int(tag.name[len(BOUND_ROWS):])
    name = "linear" if tag.name.startswith(LINEAR) else tag.name
    return PARAM_COUNT[name](nx, nu) if name in PARAM_COUNT else len(tag.params)


@dataclasses.dataclass
class KernelStats:
    """Counts for one kernel: CUDA launches, and calls of its plain version."""

    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


# The sources that take longest to compile, longest first: the (8, 4) box
# QP's 81 configurations in the two riccati_explicit_wide sources, the
# quadrotors' K1 (a dual RK4 step in 13 and 17 live tangents, fully
# unrolled), then K8's AL instantiations (build.log gives each source's
# seconds).
LONG_POLES = ("riccati_explicit_wide.cu", "riccati_explicit_wide_group.cu",
              "riccati_quadrotor_rotor.cu", "riccati_quadrotor.cu",
              "riccati_explicit_quadrotor.cu", "forward_select_quadrotor.cu",
              "forward_select_emit_al.cu", "riccati_explicit.cu", "linearize.cu")

_lib = None
build_seconds = None   # wall time of the build done by this process, if any


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library; return its path."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libmas_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path

    start = time.perf_counter()
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    # At most one nvcc a core, the longest compiles first: with every source
    # started at once the long poles share their cores with the short ones
    # and end last, later than they would alone.
    queue = sorted(sources, key=lambda src: (src.name not in LONG_POLES,
                                             LONG_POLES.index(src.name)
                                             if src.name in LONG_POLES else 0, src.name))
    slots = max(1, len(os.sched_getaffinity(0)))
    procs = []
    # Each source's compile time since the build began, for the build report.
    seconds = {}
    while len(seconds) < len(sources):
        running = sum(1 for src, *_, proc in procs if src.name not in seconds)
        while queue and running < slots:
            src = queue.pop(0)
            obj = obj_dir / (src.stem + ".o")
            out = open(obj_dir / (src.stem + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, out, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, text=True)))
            running += 1
        for src, _, _, proc in procs:
            if src.name not in seconds and proc.poll() is not None:
                seconds[src.name] = time.perf_counter() - start
        time.sleep(0.05)
    log, failed = [], []
    for src, _, out, proc in procs:
        out.seek(0)
        log.append(f"== {src.name} (rc {proc.returncode}, {seconds[src.name]:.1f} s)\n{out.read()}")
        out.close()
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = obj_dir / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - start
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_library()))
    return _lib


def problem_symbol(kernel: str, nx: int, nu: int, dynamics, *costs) -> tuple:
    """``(symbol, params)`` of ``kernel`` instantiated for the device
    functions tagged on ``dynamics`` and ``costs``; ``params`` holds one
    tuple of floats per callable.  ``NotImplementedError`` for an untagged
    callable, ``ValueError`` when the tags do not fit the shapes."""
    fns = (dynamics,) + costs
    tags = [device_fn_of(fn) for fn in fns]
    if any(t is None for t in tags):
        missing = [getattr(f, "__name__", repr(f)) for f, t in zip(fns, tags) if t is None]
        raise NotImplementedError(
            f"{kernel}: {missing} carry no device-function tag, so the CUDA "
            "kernel cannot evaluate them; use CPU tensors for the plain "
            "PyTorch version, or add a device function in csrc/problems.cuh"
        )
    dims = dynamics_dims(tags[0].name)
    if dims is not None and dims != (nx, nu):
        raise ValueError(f"{kernel}: {tags[0].name} has (nx, nu) = {dims}, the tensors "
                         f"{(nx, nu)}")
    for t in tags:
        want = _param_count(t, nx, nu)
        if len(t.params) != want:
            raise ValueError(f"{kernel}: device function {t.name} takes {want} "
                             f"parameters, its tag carries {len(t.params)}")
    return "mas_" + "__".join([kernel] + [t.name for t in tags]), [t.params for t in tags]


def launch(symbol: str, *args) -> None:
    """Call the C launcher ``symbol``: tensors pass their data pointers,
    tuples of floats a host float array, ints and floats as such, and the
    current CUDA stream goes last.  Raises if the launch reports an error."""
    fn = getattr(library(), symbol, None)
    if fn is None:
        raise NotImplementedError(
            f"no CUDA instantiation {symbol} in csrc/: this combination of "
            "device functions has no kernel yet"
        )
    c_args, argtypes, keep = [], [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            c_args.append(ctypes.c_void_p(a.data_ptr()))
            argtypes.append(ctypes.c_void_p)
        elif a is None:
            c_args.append(ctypes.c_void_p(0))
            argtypes.append(ctypes.c_void_p)
        elif isinstance(a, tuple):
            arr = (ctypes.c_float * max(1, len(a)))(*a)
            keep.append(arr)
            c_args.append(ctypes.cast(arr, ctypes.c_void_p))
            argtypes.append(ctypes.c_void_p)
        elif isinstance(a, int):
            c_args.append(ctypes.c_int(int(a)))
            argtypes.append(ctypes.c_int)
        elif isinstance(a, float):
            c_args.append(ctypes.c_float(a))
            argtypes.append(ctypes.c_float)
        else:
            raise TypeError(f"unsupported launch argument {type(a)}")
    stream = torch.cuda.current_stream().cuda_stream
    c_args.append(ctypes.c_void_p(stream))
    argtypes.append(ctypes.c_void_p)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*c_args)
    if err == CUDA_ERROR_NOT_SUPPORTED:
        raise NotImplementedError(
            f"{symbol}: this mode of the kernel is not instantiated for these device "
            "functions (e.g. boxqp for a model without input bounds)")
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")


def check_context(ctx, stage_cost, T: int, nx: int, B: int, device: torch.device) -> int:
    """Number of neighbours K of a context ``ctx [T, K, nx, B]``, 0 for
    None.  Raises unless a context comes exactly with a stage cost whose
    device function reads one (``Coupled``)."""
    tag = device_fn_of(stage_cost)
    takes = tag is not None and tag.takes_context
    if ctx is None:
        if takes:
            raise ValueError(f"{tag.name} reads a per-stage context; none was passed")
        return 0
    if not takes:
        raise ValueError("a context was passed, but the stage cost's device function reads none")
    if ctx.dim() != 4:
        raise ValueError(f"ctx: expected [T, K, nx, B], got shape {tuple(ctx.shape)}")
    check_tensor(ctx, "ctx", (T, ctx.shape[1], nx, B), device)
    return int(ctx.shape[1])


def check_tensor(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def step_constants(dt: float) -> tuple:
    """RK4 step constants ``(0.5 dt, dt, dt / 6)`` rounded to float32 from
    double, as the reference rounds its Python-float coefficients."""
    return (0.5 * dt, float(dt), dt / 6.0)


def stage_major(a: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous float32 ``[..., B]`` copy of batch-first ``a
    [B, ...]``: the kernels' layout, converted once by the batch-first
    wrappers (the select kernel works in place, so it must never alias the
    caller's tensor)."""
    a = a.movedim(0, -1)
    return torch.empty(a.shape, dtype=torch.float32, device=a.device).copy_(a)
