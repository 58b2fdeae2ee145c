"""Build and bind layer for the hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled for Hopper (`sm_90a`) by `nvcc` into one
shared library with a plain C interface, loaded with `ctypes`. The library is
built at first use into `build/dualhyp_tpu_torch/<hash>/` under the checkout
(a directory `.gitignore` lists), keyed by a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is loaded as it is.

Each C entry point launches its kernel on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0, so a
refused launch (too many threads, too much shared memory) never passes
silently. Nothing here is imported or built until a kernel is called on a
CUDA tensor: the CPU tests import every module without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dualhyp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)
LIB_NAME = "libdualhyp_kernels.so"

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
        "of dualhyp_tpu_torch are built from source at first use and need the "
        "CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; return its path.

    One `nvcc -c` per source runs in parallel, then one link step. The
    library is written under a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a half-written file."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    procs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", file=sys.stderr, flush=True)
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.dh_error_string.argtypes = [ctypes.c_int]
            lib.dh_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


C_PTR = ctypes.c_void_p
C_INT = ctypes.c_int
C_I64 = ctypes.c_longlong
C_F32 = ctypes.c_float


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    `launches` counts successful launches only: a run can read it to show
    that its main path went through the kernel."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = [*self.argtypes, C_PTR]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().dh_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def dtype_code(t: torch.Tensor) -> int:
    """0 for bfloat16, 1 for float32 (the `DType` enum of csrc/common.cuh)."""
    if t.dtype == torch.bfloat16:
        return 0
    if t.dtype == torch.float32:
        return 1
    raise TypeError(f"kernel takes bfloat16 or float32, got {t.dtype}")


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel takes CUDA tensors, got {dev}")
    return dev
