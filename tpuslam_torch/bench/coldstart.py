"""Cold-start profile of a fresh process — port of
`tpuslam/bench/coldstart.py`.

What a new PyTorch process pays before its first useful frame, by phase:

  * import_torch, import_tpuslam_torch — the imports, timed in a fresh
    interpreter (this process has them already: the package imports torch
    before any of its code runs);
  * backend_init — the CUDA context and the first allocation, fenced (on
    the CPU, the first allocation);
  * build_or_load — `kernels/_build.build()` (nvcc, on a miss) then
    `library()` (the shared library loaded and bound); null on the CPU,
    which launches no kernel;
  * upload_inputs — the synthetic orbit's depth copied to the device.

`cache_dir` is the kernels' build directory (`_build.BUILD_DIR`), with its
entries and bytes after the call; `cache_hit` says whether the library for
these sources was there before it (null on the CPU).  Each program reports
its first and second run, fenced: `preprocess`, `process_frame`
(`frontend.process_frame_jit`), `scan_superchunk_c8`
(`scan_superchunk_frozen` over 8 frames) and `scan_odometry_f{frames}`.
`total_s` is what those add up to: the phases and the programs' runs
(rendering the inputs and the import probe's own start are left out).

The reference's per-program `trace_lower_s` and `compile_or_load_s` have
no counterpart here: PyTorch traces nothing, and every kernel of every
program is compiled once, for all of them, in `build_or_load`.  The first
run against the second is what is left of a program's cold start.

Run it twice from fresh processes to separate a build (miss) from a load
(hit): `python -m tpuslam_torch.cli bench --coldstart` prints one JSON
object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_IMPORTS = ("import json, time\n"
            "t0 = time.perf_counter()\n"
            "import torch\n"
            "t1 = time.perf_counter()\n"
            "import tpuslam_torch\n"
            "print(json.dumps([t1 - t0, time.perf_counter() - t1]))\n")


def _import_seconds() -> tuple[float, float]:
    """(import torch, import tpuslam_torch) in a fresh interpreter."""
    from tpuslam_torch.kernels import _build

    p = subprocess.run([sys.executable, "-c", _IMPORTS], capture_output=True,
                       text=True, cwd=str(_build._PKG.parent), timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"coldstart: the import probe failed:\n"
                           f"{p.stderr[-2000:]}")
    t_torch, t_pkg = json.loads(p.stdout.strip().splitlines()[-1])
    return t_torch, t_pkg


def profile_coldstart(frames: int = 32, height: int = 480, width: int = 640,
                      device: str = "cuda") -> dict:
    """The profile of the module doc as a dict (seconds)."""
    import torch

    from tpuslam_torch.bench.harness import _device_name, _fence
    from tpuslam_torch.bench.harness import _render_sequence
    from tpuslam_torch.config import SLAMConfig
    from tpuslam_torch.frontend import (
        SuperChunkCarry,
        preprocess,
        process_frame_jit,
        scan_odometry,
        scan_superchunk_frozen,
    )
    from tpuslam_torch.icp import pack_pyramid
    from tpuslam_torch.kernels import _build
    from tpuslam_torch.transfer import resolve_device

    if frames < 8:
        raise ValueError(f"coldstart: frames={frames}, the superchunk "
                         f"program takes 8")
    out: dict = {"phases": {}}
    phases = out["phases"]
    phases["import_torch"], phases["import_tpuslam_torch"] = _import_seconds()

    t0 = time.perf_counter()
    dev = resolve_device(device)
    torch.zeros(1, device=dev)
    _fence(dev)
    phases["backend_init"] = time.perf_counter() - t0
    out["device"] = _device_name(dev)

    out["cache_hit"] = phases["build_or_load"] = None
    if dev.type == "cuda":
        out["cache_hit"] = _build.library_path().is_file()
        t0 = time.perf_counter()
        _build.build()
        _build.library()
        phases["build_or_load"] = time.perf_counter() - t0
    cache = _build.BUILD_DIR
    entries = os.listdir(cache) if cache.is_dir() else []
    out["cache_dir"] = str(cache)
    out["cache_entries"] = len(entries)
    out["cache_bytes"] = sum(os.path.getsize(cache / e) for e in entries
                             if (cache / e).is_file())

    cfg = SLAMConfig(height=height, width=width).validate()
    K, _poses, depths_np = _render_sequence(frames, height, width)
    t0 = time.perf_counter()
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    phases["upload_inputs"] = time.perf_counter() - t0

    # the programs' inputs, made before the programs are timed
    kf_packed = pack_pyramid(preprocess(depths[0], K, cfg), cfg.icp)
    eye = torch.eye(4, device=dev)
    carry = SuperChunkCarry(kf_packed=kf_packed, T_kf_cam=eye,
                            last_delta=eye)
    _fence(dev)
    programs = {
        "preprocess": lambda: preprocess(depths[0], K, cfg),
        "process_frame": lambda: process_frame_jit(depths[1], kf_packed, K,
                                                   eye, eye, cfg),
        "scan_superchunk_c8": lambda: scan_superchunk_frozen(
            depths[:8], K, carry, cfg, 8),
        f"scan_odometry_f{frames}": lambda: scan_odometry(depths, K, cfg),
    }
    out["programs"] = {}
    for name, fn in programs.items():
        rec = {}
        for key in ("first_run_s", "second_run_s"):
            t0 = time.perf_counter()
            fn()
            _fence(dev)
            rec[key] = time.perf_counter() - t0
        out["programs"][name] = rec
    out["total_s"] = (sum(v for v in phases.values() if v is not None)
                      + sum(sum(r.values()) for r in out["programs"].values()))
    return out


def main() -> int:
    print(json.dumps(profile_coldstart()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
