"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links one shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at first use, into
``build/torch_kernels/`` under the repository root, keyed by a hash of the
sources and flags so an edited source is rebuilt.  Nothing here runs at
import time: CPU-only installs import the package without ``nvcc``.

Each exported C function launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises on a non-zero code.
Its symbol names the kernel and the device functions it was instantiated
with (``mas_<kernel>__<dynamics>__<stage cost>[__<terminal cost>]``), so a
problem without a matching instantiation raises ``NotImplementedError``.
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
# parameters each device function reads, given (nx, nu).
DYNAMICS_DIMS = {"single_track": (4, 2)}
PARAM_COUNT = {
    "single_track": lambda nx, nu: 1,
    "diag_quadratic": lambda nx, nu: 2 * (nx + nu),
    "zero": lambda nx, nu: 0,
}


@dataclasses.dataclass
class KernelStats:
    """Counts for one kernel: CUDA launches, and calls of its plain version."""

    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


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
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = obj_dir / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
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
    if DYNAMICS_DIMS.get(tags[0].name, (nx, nu)) != (nx, nu):
        raise ValueError(f"{kernel}: {tags[0].name} has (nx, nu) = "
                         f"{DYNAMICS_DIMS[tags[0].name]}, the tensors {(nx, nu)}")
    for t in tags:
        want = PARAM_COUNT[t.name](nx, nu) if t.name in PARAM_COUNT else len(t.params)
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
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")


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
