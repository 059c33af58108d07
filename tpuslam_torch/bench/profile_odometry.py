"""Profile the odometry or the map-tracking path of one checkout of the
port on a GPU.

    python3 tpuslam_torch/bench/profile_odometry.py [--root DIR] [--tag T]
        [--mode odometry|map|fps|solve] [--fused]

Imports `tpuslam_torch` from `--root` (default: the checkout this file is
in), so one script measures two commits in one call: unpack the other
commit into a git-ignored directory and run parent, change, change,
parent.  It uses only entry points that every commit of the port since
the map slice has.

`--mode odometry` renders the first `--frames` frames of the 240-frame
640×480 orbit (`run_bench`'s sequence), runs `scan_odometry` over them
once to build and warm up, takes the best of three timed passes on the
host clock, then profiles one pass.  `--fused` runs it with
`ICPConfig.fused_gn=True` (the odometry-orbit-vga-fused cell).

`--mode fps` runs `run_bench` on the whole orbit (240 frames, best of
three passes), with `--fused` the fused cell, and prints its JSON line:
run plain and fused in turns in one call to compare their fps.

`--mode solve` is one outer iteration of the fused ICP loop (two GN
solves, tol 0 so both do the whole work) at level 0 of the orbit's first
frame pair (153,600 source points against a 640×480 table), through
`align_cloud_to_organized` with `fused_gn=True`: CUDA-event ms a run
(three passes of 50 runs), then 50 runs under the profiler for device µs,
device operations and GEMMs a run and each hand kernel's device µs a
launch.  Run on a parent checkout it times that commit's fused solve
whatever its kernels are.

`--mode map` is map-loop-vga (`run_map_bench`'s cell): the 120-frame
640×480 two-lap loop, `SlamSystem.process` per frame with
`track_against_map=True` and `slam_bench_config`, unsharded and then
sharded under a one-rank NCCL group.  Each system takes frames 0-47 to
grow its map, then frames 48-55 are timed on the host clock (each frame
fenced by a synchronize); a second system, run the same way, takes
frames 48-55 under the profiler.

Prints one JSON line a run (for map: one for each of unsharded and
sharded): ms a frame (the best of the timed passes), device busy µs a frame, device operations (kernels,
copies, fills) a frame and fills a frame, for each hand kernel its
launches a frame and device µs a launch, and the 16 device operations
that take the most time, with the card's name and power limit.  Exits 2
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# the hand kernels' symbols in every commit since the map slice
# (gn_fused_kernel before the fused solve became one launch)
KERNELS = ("correspond_kernel", "gn_partials_kernel", "gn_epilogue_kernel",
           "gn_step_kernel", "gn_fused_kernel", "gn_fused_step_kernel",
           "ring_nn_kernel")


def profile_rows(prof):
    """(self device µs, count, name) of each device operation, and the
    busy µs, operations and per-kernel (µs, launches) they sum to."""
    from torch.autograd import DeviceType

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
    return busy, ops, kernels, rows


def report(tag, card, package, frames, walls, wall_us, prof, **extra):
    busy, ops, kernels, rows = profile_rows(prof)
    f = frames
    return {
        "tag": tag, "card": card, "package": package, **extra,
        "frames": f, "ms_per_frame": min(walls) / f * 1e3,
        "ms_per_frame_reps": [w / f * 1e3 for w in walls],
        "device_busy_us_per_frame": busy / f,
        "device_ops_per_frame": ops / f,
        "fills_per_frame": sum(n for _, n, k in rows if "Fill" in k) / f,
        "gemms_per_frame": sum(n for _, n, k in rows
                               if "gemm" in k.lower()) / f,
        "idle_share_profiled": 1 - busy / wall_us,
        "kernels": {k: {"launches_per_frame": n / f, "device_us_per_launch":
                        us / n} for k, (us, n) in kernels.items()},
        "top": [{"op": key[:80], "per_frame": n / f, "us_per_frame": dt / f}
                for dt, n, key in sorted(rows, reverse=True)[:16]],
    }


def odometry(args, card, dev) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.bench.harness import _intrinsics
    from tpuslam_torch.config import ICPConfig, SLAMConfig
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
    from tpuslam_torch.frontend import scan_odometry

    K = _intrinsics(480, 640)
    poses = orbit_trajectory(240)
    d = torch.as_tensor(np.stack([
        render_depth(poses[i], K, 480, 640, seed=i)
        for i in range(args.frames)]).astype(np.float32), device=dev)
    cfg = SLAMConfig(height=480, width=640,
                     icp=ICPConfig(fused_gn=args.fused)).validate()
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
    print(json.dumps(report(args.tag, card, tpuslam_torch.__file__,
                            args.frames, walls, wall_us, prof,
                            mode="odometry", fused=args.fused)), flush=True)


def fps(args, card, dev) -> None:
    import tpuslam_torch
    from tpuslam_torch.bench.harness import run_bench

    r = run_bench(frames=240, height=480, width=640, device=str(dev),
                  fused_gn=args.fused)
    print(json.dumps({"tag": args.tag, "card": card,
                      "package": tpuslam_torch.__file__, "mode": "fps",
                      "fused": args.fused, **r}), flush=True)


SOLVE_RUNS = 50


def solve(args, card, dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.bench.harness import _intrinsics
    from tpuslam_torch.config import ICPConfig, SLAMConfig
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
    from tpuslam_torch.frontend import preprocess
    from tpuslam_torch.icp import (
        align_cloud_to_organized,
        pack_pyramid,
        select_level_source,
    )

    K = _intrinsics(480, 640)
    poses = orbit_trajectory(240)
    d = [torch.as_tensor(render_depth(poses[i], K, 480, 640, seed=i),
                         device=dev) for i in (0, 1)]
    # one outer iteration of two solves; tol 0, so both do the whole work
    cfg = SLAMConfig(height=480, width=640, icp=ICPConfig(
        fused_gn=True, max_iters=2, inner_steps=2, tol_delta=0.0)).validate()
    packed = pack_pyramid(preprocess(d[0], K, cfg), cfg.icp)[0]
    src = select_level_source(preprocess(d[1], K, cfg), 0, cfg.icp)
    T0 = torch.eye(4, device=dev)

    def run():
        return align_cloud_to_organized(src, packed, 480, 640, K, T0, cfg.icp)

    iters = int(run().iters)
    torch.cuda.synchronize()
    event_ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SOLVE_RUNS):
            run()
        stop.record()
        torch.cuda.synchronize()
        event_ms.append(start.elapsed_time(stop) / SOLVE_RUNS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SOLVE_RUNS):
            run()
        torch.cuda.synchronize()
    busy, ops, kernels, rows = profile_rows(prof)
    r = SOLVE_RUNS
    print(json.dumps({
        "tag": args.tag, "card": card, "package": tpuslam_torch.__file__,
        "mode": "solve", "points": src.points.shape[0], "iters": iters,
        "event_ms_per_run": event_ms,
        "device_us_per_run": busy / r, "device_ops_per_run": ops / r,
        "gemms_per_run": sum(n for _, n, k in rows
                             if "gemm" in k.lower()) / r,
        "kernels": {k: {"launches_per_run": n / r,
                        "device_us_per_launch": us / n}
                    for k, (us, n) in kernels.items()},
        "top": [{"op": key[:80], "per_run": n / r, "us_per_run": dt / r}
                for dt, n, key in sorted(rows, reverse=True)[:8]],
    }), flush=True)


MAP_WARM, MAP_FRAMES = 48, 8        # frames 0-47 grow the map; 48-55 count


def track_map(args, card, dev) -> None:
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.bench.harness import _intrinsics, slam_bench_config
    from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
    from tpuslam_torch.dist.mesh import initialize_distributed
    from tpuslam_torch.slam import SlamSystem

    K = _intrinsics(480, 640)
    poses = loop_trajectory(120, cycles=2, radius=0.35)
    last = MAP_WARM + MAP_FRAMES
    d = torch.as_tensor(np.stack([
        render_depth(poses[i], K, 480, 640, seed=i)
        for i in range(last)]).astype(np.float32), device=dev)
    ts = np.arange(last) / 30.0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", world_size=1, rank=0,
                           backend="nccl", timeout_s=60)
    try:
        for sharded in (False, True):
            def warm():
                slam = SlamSystem(K, slam_bench_config(480, 640, False),
                                  enable_loop_closure=True,
                                  track_against_map=True,
                                  sharded_map=sharded, device=dev)
                for i in range(MAP_WARM):
                    slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
                return slam

            slam = warm()
            walls = [0.0]
            for i in range(MAP_WARM, last):
                t0 = time.perf_counter()
                slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
                walls[0] += time.perf_counter() - t0
            slam = warm()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(MAP_WARM, last):
                    slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            print(json.dumps(report(
                args.tag, card, tpuslam_torch.__file__, MAP_FRAMES, walls,
                wall_us, prof, mode="map", sharded=sharded,
                frames_profiled=[MAP_WARM, last - 1])), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--mode", choices=("odometry", "map", "fps", "solve"),
                    default="odometry")
    ap.add_argument("--fused", action="store_true",
                    help="ICPConfig.fused_gn=True (odometry and fps)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("profile_odometry: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    {"odometry": odometry, "map": track_map, "fps": fps, "solve": solve}[
        args.mode](args, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
