"""Build and bind the port's CUDA kernels (`tpuslam_torch/csrc/*.cu`):
correspond, gn_partials, gn_epilogue, gn_step, gn_fused, ring_nn,
grid_correspond (with its table of occupied cells), preprocess,
posegraph_dense and warm_start.

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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("correspond.cu", "gn_partials.cu", "gn_epilogue.cu",
           "gn_step.cu", "gn_fused.cu", "ring_nn.cu", "grid_correspond.cu",
           "preprocess.cu", "posegraph_dense.cu", "warm_start.cu")
HEADERS = ("gn_solve.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types: a pointer (and the stream) is a
# c_void_p, otherwise ctypes would pass it as a 32-bit int.
_SIGNATURES = {
    "tpuslam_correspond": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                           _F, _F, _I, _P, _P, _P, _P, _P, _P],
    "tpuslam_gn_partials": [_P, _P, _P, _P, _P, _I, _F, _P, _P, _I, _P],
    "tpuslam_gn_epilogue": [_P, _I, _P, _P, _F, _F, _F, _F, _I, _I, _I, _F,
                            _P, _P, _P],
    "tpuslam_gn_step": [_P, _P, _P, _P, _I, _F, _P, _P, _F, _F, _F, _F, _I,
                        _I, _I, _F, _P, _P, _I, _P],
    "tpuslam_gn_fused_step": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                              _F, _F, _F, _F, _P, _P, _I, _P, _F, _F, _F,
                              _F, _I, _I, _I, _F, _P, _P, _I, _P],
    "tpuslam_ring_nn": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                        _F, _P, _P, _P, _P, _P],
    "tpuslam_grid_correspond": [_P, _P, _P, _P, _P, _I, _P, _I, _P, _F, _I,
                                _F, _P, _P, _P, _P, _P, _P],
    "tpuslam_grid_table": [_P, _I, _P, _I, _P],
    "tpuslam_ring_nn_slices": [_I, _I],
    "tpuslam_ring_nn_query_tiles": [_I],
    "tpuslam_preprocess": [_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I,
                           _P, _P, _P, _P, _P],
    "tpuslam_posegraph_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                                _F, _I, _P, _P, _P],
    "tpuslam_warm_start": [_P, _P, _F, _P, _P],
}


_capture = threading.local()    # the graph under warm-up or capture, if any


@contextlib.contextmanager
def scratch_scope(token, lane: int):
    """While the block runs on this thread: key the kernels' scratch by
    `token` (a graph, which bakes in scratch of its own), and count its
    launches under `lane`, the stream that called the graph's program (its
    warm-up runs on a capture stream ordered after that stream)."""
    prev = (getattr(_capture, "scope", None), getattr(_capture, "lane", None))
    _capture.scope, _capture.lane = token, lane
    try:
        yield
    finally:
        _capture.scope, _capture.lane = prev


def scratch_key(dev) -> tuple:
    """The key of the calling thread's scratch on `dev`: the graph under
    warm-up or capture, else the current stream's handle."""
    scope = getattr(_capture, "scope", None)
    if scope is None:
        scope = stream_handle_on(dev)
    return (dev.type, dev.index, scope)


_workspaces: list = []      # (dict, lock) of each module's scratch


def register_workspace(table: dict, lock) -> None:
    _workspaces.append((table, lock))


def drop_scratch(token) -> None:
    """Forget the scratch a graph baked in (the graph is gone)."""
    for table, lock in _workspaces:
        with lock:
            for key in [k for k in table if k[2] == token]:
                del table[key]


@contextlib.contextmanager
def recording():
    """Record the launches counted on this thread while the block runs,
    by counter, into the dict yielded, instead of counting them: during a
    graph's capture nothing runs."""
    prev = getattr(_capture, "record", None)
    rec: dict = {}
    _capture.record = rec
    try:
        yield rec
    finally:
        _capture.record = prev


class LaunchCounter:
    """Plain-integer counts of one kernel's launches and of calls to its
    plain PyTorch twin, so a run can show which of the two did the work.

    `by_stream` splits the launches by the CUDA stream they went to (its
    handle), so a run can show that a second stream (the SLAM backend's
    worker) launched the kernel too.  The counts are taken under a lock:
    two threads launching at once must not lose a count.  A launch issued
    while a graph is captured is recorded for the graph (`recording`), and
    each replay of the graph counts it again (`replayed`)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls = 0
        self.by_stream: dict[int, int] = {}

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self.by_stream = {}

    def launched(self, stream: int) -> None:
        """Count one launch of the kernel on `stream` (a handle), or
        record it for the graph under capture."""
        rec = getattr(_capture, "record", None)
        if rec is not None:
            rec[self] = rec.get(self, 0) + 1
            return
        lane = getattr(_capture, "lane", None)
        self.replayed(1, stream if lane is None else lane)

    def replayed(self, n: int, stream: int) -> None:
        """Count `n` launches on `stream`: a graph's replay."""
        with self._lock:
            self.launches += n
            self.by_stream[stream] = self.by_stream.get(stream, 0) + n

    def plain(self) -> None:
        """Count one call of the plain twin."""
        with self._lock:
            self.plain_calls += 1


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _check(proc: subprocess.Popen, cmd: list) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}\n{err}")
    return out + err


def library_path() -> Path:
    """Where the library for these sources and flags is (or will be)."""
    return BUILD_DIR / f"libtpuslam_kernels_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources into the cached shared library; return its path.

    One nvcc per source, all started together, then one link.  Returns at
    once when a library for these exact sources exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name in SOURCES:
            cmd = [nvcc, *COMPILE_FLAGS, *(["-Xptxas", "-v"] if verbose
                                           else []),
                   "-c", str(CSRC / name), "-o", f"{tmp}/{name}.o"]
            jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         cmd))
        try:
            for proc, cmd in jobs:
                log.append(_check(proc, cmd))
        finally:
            for proc, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = f"{tmp}/lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
               *(f"{tmp}/{name}.o" for name in SOURCES)]
        log.append(_check(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          cmd))
        os.replace(lib, out)
    if verbose:
        print("".join(log))
    return out


_library: ctypes.CDLL | None = None
_library_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call.  The first load
    runs under a lock: two threads launching their first kernels at once
    build and bind it once."""
    global _library
    if _library is not None:
        return _library
    with _library_lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tpuslam_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpuslam_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().tpuslam_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}: {msg})")


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on `t`'s device, as a pointer.  The
    current stream is the calling thread's own: every launch goes to the
    stream its caller chose, and a kernel's scratch is keyed by it (or by
    the graph under capture, `scratch_key`)."""
    return stream_handle_on(t.device)


def stream_handle_on(dev) -> int:
    import torch

    return torch.cuda.current_stream(dev).cuda_stream


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
