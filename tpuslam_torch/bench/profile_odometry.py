"""Profile the odometry main path of one checkout of the port on a GPU.

    python3 tpuslam_torch/bench/profile_odometry.py [--root DIR] [--tag T]

Imports `tpuslam_torch` from `--root` (default: the checkout this file is
in), so one script measures two commits in one call: unpack the other
commit into a git-ignored directory and run parent, change, change,
parent.  It renders the first `--frames` frames of the 240-frame 640×480
orbit (`run_bench`'s sequence), runs `scan_odometry` over them once to
build and warm up, takes the best of three timed passes on the host clock,
then profiles one pass.  Prints one JSON line: ms a frame, device busy µs
a frame, device operations (kernels, copies, fills) a frame, for each
hand kernel its launches a frame and device µs a launch, and the 16
device operations that take the most time, with the card's name and
power limit.  Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

KERNELS = ("correspond_kernel", "gn_partials_kernel", "gn_epilogue_kernel",
           "gn_step_kernel", "gn_fused_kernel", "ring_nn_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_odometry: no CUDA device", file=sys.stderr)
        return 2
    import tpuslam_torch
    from tpuslam_torch.bench.harness import _intrinsics
    from tpuslam_torch.config import SLAMConfig
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
    from tpuslam_torch.frontend import scan_odometry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    K = _intrinsics(480, 640)
    poses = orbit_trajectory(240)
    d = torch.as_tensor(np.stack([
        render_depth(poses[i], K, 480, 640, seed=i)
        for i in range(args.frames)]).astype(np.float32), device=dev)
    cfg = SLAMConfig(height=480, width=640).validate()
    scan_odometry(d, K, cfg)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        scan_odometry(d, K, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan_odometry(d, K, cfg)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy, ops, kernels, rows = 0.0, 0, {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("slam."):
            continue        # host ops, and spans that cover kernels
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt <= 0:
            continue
        busy += dt
        ops += ev.count
        rows.append((dt, ev.count, ev.key))
        for k in KERNELS:
            if k in ev.key:
                us, n = kernels.get(k, (0.0, 0))
                kernels[k] = (us + dt, n + ev.count)
    f = args.frames
    print(json.dumps({
        "tag": args.tag, "card": card, "package": tpuslam_torch.__file__,
        "frames": f, "ms_per_frame_best_of_3": min(walls) / f * 1e3,
        "ms_per_frame_reps": [w / f * 1e3 for w in walls],
        "device_busy_us_per_frame": busy / f,
        "device_ops_per_frame": ops / f,
        "idle_share_profiled": 1 - busy / wall_us,
        "kernels": {k: {"launches_per_frame": n / f, "device_us_per_launch":
                        us / n} for k, (us, n) in kernels.items()},
        "top": [{"op": key[:80], "per_frame": n / f, "us_per_frame": dt / f}
                for dt, n, key in sorted(rows, reverse=True)[:16]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
