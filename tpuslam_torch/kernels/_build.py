"""Build and bind the port's CUDA kernels (`tpuslam_torch/csrc/*.cu`).

The sources have a plain C interface: nvcc compiles them into one shared
library for `sm_90a`, which `ctypes` loads.  That takes seconds, where an
extension that includes PyTorch's headers takes minutes.  The build runs at
first use, into `tpuslam_torch/_build/` (listed in `.gitignore`), under a
name that hashes the sources and flags, so a later process with the same
sources loads the library without building.

Nothing here runs at import time: the CPU tests import every module of the
port on machines that have neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("correspond.cu", "gn_partials.cu", "gn_epilogue.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types: a pointer (and the stream) is a
# c_void_p, otherwise ctypes would pass it as a 32-bit int.
_SIGNATURES = {
    "tpuslam_correspond": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F,
                           _F, _I, _P, _P, _P, _P, _P, _P],
    "tpuslam_gn_partials": [_P, _P, _P, _P, _I, _F, _P, _P, _I, _P],
    "tpuslam_gn_epilogue": [_P, _I, _P, _P, _F, _F, _F, _F, _I, _I, _I, _F,
                            _P, _P, _P],
}


class LaunchCounter:
    """Plain-integer counts of one kernel's launches and of calls to its
    plain PyTorch twin, so a run can show which of the two did the work."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of tpuslam_torch cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources into the cached shared library; return its path.

    Returns at once when a library for these exact sources exists."""
    out = BUILD_DIR / f"libtpuslam_kernels_{_source_hash()}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpuslam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuslam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().tpuslam_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}: {msg})")


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on `t`'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, *, dtype, shape=None, device=None) -> None:
    """Raise unless `t` is a contiguous tensor of the given dtype/shape on
    `device` — what a kernel can take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, kernel runs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
