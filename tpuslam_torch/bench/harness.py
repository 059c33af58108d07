"""Odometry benchmark — port of the odometry block of
`tpuslam/bench/harness.py` (`run_bench`).

Measures, on one device: full-sequence frame-to-keyframe odometry
throughput (frames/s and ms/frame of `frontend.scan_odometry` on
device-resident depth, best of three timed runs after a warm-up), the
trajectory's ATE against the synthetic ground truth (a speed number from a
diverged tracker means nothing), and the per-ICP-iteration latency of a
fixed 50-iteration finest-level alignment.  Depth is the synthetic
ray-traced orbit at the requested resolution.  Every result names the
device it ran on; timings on a GPU are fenced with
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpuslam_torch.config import Intrinsics, SLAMConfig


def _render_sequence(frames: int, height: int, width: int):
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth

    K = Intrinsics(
        525.0 * width / 640.0,
        525.0 * height / 480.0,
        width / 2 - 0.5,
        height / 2 - 0.5,
    )
    poses = orbit_trajectory(frames)
    depths = np.stack(
        [render_depth(poses[i], K, height, width, seed=i) for i in range(frames)]
    )
    return K, poses, depths.astype(np.float32)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(frames: int = 240, height: int = 480, width: int = 640,
              device: str = "cuda", warmup: int = 1, reps: int = 3) -> dict:
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.frontend import preprocess, scan_odometry
    from tpuslam_torch.icp import align_frames

    dev = torch.device(device)
    cfg = SLAMConfig(height=height, width=width).validate()

    K, gt_poses, depths_np = _render_sequence(frames, height, width)
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)

    result: dict = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "frames": frames,
        "resolution": [height, width],
    }

    # --- full-sequence odometry throughput (the headline number) ---
    t0 = time.perf_counter()
    out = scan_odometry(depths, K, cfg)
    _fence(dev)
    result["first_run_s"] = time.perf_counter() - t0
    for _ in range(warmup):
        scan_odometry(depths, K, cfg)
    _fence(dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = scan_odometry(depths, K, cfg)
        _fence(dev)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    result["fps"] = frames / wall
    result["ms_per_frame"] = wall / frames * 1e3
    result["fps_reps"] = [frames / w for w in walls]

    poses = out[0].cpu().numpy().astype(np.float64)
    result["poses_finite"] = bool(np.all(np.isfinite(poses)))
    result["keyframes"] = int(out[1].sum().item())
    ts = np.arange(frames, dtype=np.float64)
    result["ate_rmse_m"] = ate_rmse(ts, poses, ts, gt_poses)["rmse"]

    # --- per-ICP-iteration latency: a fixed 50-iteration finest-level
    # alignment (tol 0: the loop never exits early) ---
    pyr_a = preprocess(depths[0], K, cfg)
    pyr_b = preprocess(depths[1], K, cfg)
    iter_loops = 50
    one_level = dataclasses.replace(cfg.icp, pyramid_levels=1,
                                    iters_per_level=(iter_loops,),
                                    tol_delta=0.0)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    align_frames((pyr_b[0],), (pyr_a[0],), K, T0, one_level)
    _fence(dev)
    n_align = 5
    t0 = time.perf_counter()
    for _ in range(n_align):
        r = align_frames((pyr_b[0],), (pyr_a[0],), K, T0, one_level)
    _fence(dev)
    result["icp_iter_latency_ms"] = (
        (time.perf_counter() - t0) / n_align / iter_loops * 1e3)
    result["icp_iter_count"] = int(r.iters.item())
    return result
