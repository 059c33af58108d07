"""ctypes binding of the native TUM decode library — port of
`tpuslam/data/_tum_native.py`.

The library is the repository's `csrc/tum_decode.cc` (a libpng 16-bit PNG
decoder and the greedy timestamp matcher, behind a plain C interface).
It is built at first use with `g++ -O3 -fPIC -shared … -lpng -lz` (the
flags of `csrc/build.sh`) into `tpuslam_torch/_build/`, under a name that
hashes the source and the flags, so a later process loads it without
building.  Nothing is built or loaded at import time.

`library()` raises when the library cannot be built or loaded (no g++, no
libpng headers, the source missing); `data/tum.py` then decodes with
OpenCV or the numpy codec and says why.  ctypes releases the GIL during
the C call, so the loader's decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "tum_decode.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-fPIC", "-shared")
LIBS = ("-lpng", "-lz")


def build() -> Path:
    """Compile the source into the cached shared library; return its path.
    Returns at once when a library for this exact source exists."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libtum_native_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = ["g++", *FLAGS, "-o", tmp, str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            first = ([ln for ln in proc.stderr.splitlines() if "error" in ln]
                     or [proc.stderr])[0]
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(first.split())}")
        os.replace(tmp, out)      # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _load():
    """(library, None) or (None, why it is unavailable) — the outcome is
    kept, so a failed build is not retried at every call."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {e}"
    P, I = ctypes.POINTER, ctypes.c_int
    lib.tum_png16_header.argtypes = [ctypes.c_char_p, P(I), P(I), P(I)]
    lib.tum_png16_header.restype = I
    lib.tum_png16_decode.argtypes = [ctypes.c_char_p, P(ctypes.c_uint16), I,
                                     I]
    lib.tum_png16_decode.restype = I
    lib.tum_associate.argtypes = [P(ctypes.c_double), I, P(ctypes.c_double),
                                  I, ctypes.c_double, P(ctypes.c_int32)]
    lib.tum_associate.restype = I
    return lib, None


def library() -> ctypes.CDLL:
    """The native library, built and loaded on first call; raises
    RuntimeError with the reason when it is unavailable."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native TUM decoder unavailable ({why})")
    return lib


def decode_png16(path: str) -> np.ndarray:
    """16-bit grayscale PNG -> (H, W) uint16 array (8-bit widened)."""
    lib = library()
    h, w, depth = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.tum_png16_header(path.encode(), ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(depth))
    if rc != 0:
        raise IOError(f"tum_png16_header({path}) failed: {rc}")
    out = np.empty((h.value, w.value), dtype=np.uint16)
    rc = lib.tum_png16_decode(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h.value, w.value)
    if rc != 0:
        raise IOError(f"tum_png16_decode({path}) failed: {rc}")
    return out


def associate_native(ta: np.ndarray, tb: np.ndarray,
                     max_difference: float) -> np.ndarray:
    """Greedy nearest-timestamp matching; returns (len(ta),) int32 of
    indices into tb (−1 = unmatched)."""
    lib = library()
    ta = np.ascontiguousarray(ta, dtype=np.float64)
    tb = np.ascontiguousarray(tb, dtype=np.float64)
    out = np.empty((len(ta),), dtype=np.int32)
    lib.tum_associate(
        ta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ta),
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(tb),
        float(max_difference),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
