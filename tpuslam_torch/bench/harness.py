"""Benchmarks of the port — `run_bench` (odometry) and `run_slam_bench`
(the full SLAM system), ports of the odometry block and of `bench_slam` in
`tpuslam/bench/harness.py`.

`run_bench` measures full-sequence frame-to-keyframe odometry throughput
(frames/s and ms/frame of `frontend.scan_odometry` on device-resident
depth, best of three timed runs after a warm-up), the trajectory's ATE
against the synthetic ground truth (a speed number from a diverged tracker
means nothing), and the per-ICP-iteration latency of a fixed 50-iteration
finest-level alignment.  Depth is the synthetic ray-traced orbit at the
requested resolution.

`run_slam_bench` measures what a user of the SLAM system gets:
`SlamSystem.process_chunk` in boundary mode (8-frame chunks, promotion
sub-chunks of 4) over the synthetic two-lap loop, with the backend
synchronous and deferred, each best of `reps` timed passes after one
uncounted pass, plus closures, keyframes and ATE of the best pass.

`run_map_bench` measures frame-to-map tracking: `SlamSystem.process` per
frame with `track_against_map=True` over the same loop, the map unsharded
or sharded (the ring ICP), with its map size, refinement gate share and
every kernel's launches.

Every result names the device it ran on; timings on a GPU are fenced with
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpuslam_torch.config import (
    ICPConfig,
    Intrinsics,
    SLAMConfig,
    VoxelConfig,
)


def _intrinsics(height: int, width: int) -> Intrinsics:
    return Intrinsics(525.0 * width / 640.0, 525.0 * height / 480.0,
                      width / 2 - 0.5, height / 2 - 0.5)


def _render_sequence(frames: int, height: int, width: int,
                     loop_cycles: int = 0):
    """Intrinsics, ground-truth poses and float32 depth of the synthetic
    orbit, or of the `loop_cycles`-lap loop when it is non-zero."""
    from tpuslam_torch.data.synthetic import (
        loop_trajectory,
        orbit_trajectory,
        render_depth,
    )

    K = _intrinsics(height, width)
    poses = (loop_trajectory(frames, cycles=loop_cycles, radius=0.35)
             if loop_cycles else orbit_trajectory(frames))
    depths = np.stack(
        [render_depth(poses[i], K, height, width, seed=i) for i in range(frames)]
    )
    return K, poses, depths.astype(np.float32)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def run_bench(frames: int = 240, height: int = 480, width: int = 640,
              device: str = "cuda", warmup: int = 1, reps: int = 3,
              fused_gn: bool = False, sequence=None) -> dict:
    """Odometry throughput, ATE and ICP-iteration latency (module doc).

    `sequence`: optionally the `_render_sequence` output for these frames
    and size, so several runs share one rendering."""
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.frontend import preprocess, scan_odometry
    from tpuslam_torch.icp import align_frames

    dev = torch.device(device)
    cfg = SLAMConfig(height=height, width=width,
                     icp=ICPConfig(fused_gn=fused_gn)).validate()

    K, gt_poses, depths_np = (sequence if sequence is not None else
                              _render_sequence(frames, height, width))
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)

    result: dict = {
        "device": _device_name(dev),
        "frames": frames,
        "resolution": [height, width],
        "fused_gn": fused_gn,
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


def kernel_counters() -> dict:
    """Every kernel's LaunchCounter, by kernel name."""
    from tpuslam_torch.kernels import (
        correspond,
        gn_epilogue,
        gn_fused,
        gn_partials,
        gn_step,
        ring_nn,
    )

    return {"correspond": correspond.counter,
            "gn_partials": gn_partials.counter,
            "gn_epilogue": gn_epilogue.counter,
            "gn_step": gn_step.counter,
            "gn_fused": gn_fused.counter, "ring_nn": ring_nn.counter}


def slam_bench_config(height: int, width: int,
                      fused_gn: bool) -> SLAMConfig:
    """The SLAM benchmark's config: defaults at this size, lc_min_gap 8
    (the loop promotes ~15 keyframes per lap; the default gap of 20 would
    gate every revisit)."""
    base = SLAMConfig(height=height, width=width,
                      icp=ICPConfig(fused_gn=fused_gn)).validate()
    return base.replace(posegraph=dataclasses.replace(base.posegraph,
                                                      lc_min_gap=8))


def run_slam_bench(frames: int = 120, height: int = 480, width: int = 640,
                   device: str = "cuda", fused_gn: bool = False,
                   cycles: int = 2, reps: int = 3, chunk: int = 8,
                   sequence=None) -> dict:
    """Chunked SLAM throughput (the reference's `bench_slam` boundary
    variants): SlamSystem.process_chunk, boundary mode, `chunk`-frame
    chunks with promotion sub-chunks of 4 (≈ this loop's per-frame
    promotion cadence), `slam_bench_config`, backend synchronous (`sync`)
    and deferred (`deferred`).  Depth is device-resident, as in
    the reference; frames beyond the last full chunk step per frame.
    `sequence` is as in `run_bench` (here the `cycles`-lap loop).
    """
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    dev = torch.device(device)
    cfg = slam_bench_config(height, width, fused_gn)
    K, gt, depths_np = (sequence if sequence is not None else
                        _render_sequence(frames, height, width,
                                         loop_cycles=cycles))
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    ts = np.arange(frames) / 30.0
    full = frames - frames % chunk

    def one_pass(deferred: bool):
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=deferred, chunk_mode="boundary",
                          chunk_sub=4, device=dev)
        _fence(dev)
        t0 = time.perf_counter()
        for i in range(0, full, chunk):
            slam.process_chunk(depths[i:i + chunk], ts[i:i + chunk])
        for i in range(full, frames):
            slam.process(depths[i], timestamp=ts[i])
        slam.finalize()
        _fence(dev)
        return time.perf_counter() - t0, slam

    result: dict = {"device": _device_name(dev), "frames": frames,
                    "resolution": [height, width], "chunk": chunk,
                    "fused_gn": fused_gn}
    for name, deferred in (("sync", False), ("deferred", True)):
        one_pass(deferred)                  # uncounted: first-use costs
        walls, best = [], None
        for _ in range(reps):
            wall, slam = one_pass(deferred)
            if not walls or wall < min(walls):
                best = slam
            walls.append(wall)
        t_est, est = best.trajectory()
        result[name] = {
            "fps": frames / min(walls),
            "fps_reps": [frames / w for w in walls],
            "closures": len(best.closures),
            "closure_pairs": [[c.i, c.j] for c in best.closures],
            "keyframes": len(best.odo.keyframes),
            "ate_rmse_m": ate_rmse(t_est, est, ts, gt,
                                   max_difference=0.005)["rmse"],
            "poses_finite": bool(np.all(np.isfinite(est))),
        }
    return result


def run_map_bench(frames: int = 120, height: int = 480, width: int = 640,
                  sharded: bool = False, device: str = "cuda",
                  cycles: int = 2, warmup: int = 1, sequence=None,
                  voxel: VoxelConfig | None = None) -> dict:
    """Frame-to-map tracking (BASELINE config 4): `SlamSystem.process` per
    frame over the `cycles`-lap loop with `track_against_map=True` and
    `slam_bench_config` (fused_gn off), the map unsharded (VoxelMap +
    align_map_to_frame) or sharded over the default process group's ranks
    (ShardedVoxelMap + the ring ICP, whose hops are the ring_nn kernel).

    One timed pass after `warmup` uncounted ones.  Reports fps, ATE,
    keyframes, map size, the share of map refinements that passed their
    gates, the fusion's dropped points, and every kernel's launches and
    plain-twin calls in the timed pass.  `sequence` is as in `run_bench`;
    `voxel` replaces the config's cloud and map capacities (small runs).
    """
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    dev = torch.device(device)
    cfg = slam_bench_config(height, width, False)
    if voxel is not None:
        cfg = cfg.replace(voxel=voxel)
    K, gt, depths_np = (sequence if sequence is not None else
                        _render_sequence(frames, height, width,
                                         loop_cycles=cycles))
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    ts = np.arange(frames) / 30.0
    counters = kernel_counters()

    def one_pass():
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          track_against_map=True, sharded_map=sharded,
                          device=dev)
        _fence(dev)
        t0 = time.perf_counter()
        for i in range(frames):
            slam.process(depths[i], timestamp=ts[i])
        slam.finalize()
        _fence(dev)
        return time.perf_counter() - t0, slam

    for _ in range(warmup):
        one_pass()
    for c in counters.values():
        c.reset()
    wall, slam = one_pass()
    t_est, est = slam.trajectory()
    refine_ok = [s["ok"] for s in slam.map_refine_stats]
    return {
        "device": _device_name(dev), "frames": frames,
        "resolution": [height, width], "sharded": sharded,
        "fps": frames / wall,
        "ate_rmse_m": ate_rmse(t_est, est, ts, gt,
                               max_difference=0.005)["rmse"],
        "poses_finite": bool(np.all(np.isfinite(est))),
        "keyframes": len(slam.odo.keyframes),
        "closures": len(slam.closures),
        "map_size": slam.map.size(),
        "map_refinements": len(refine_ok),
        "refine_ok_share": float(np.mean(refine_ok)) if refine_ok else 0.0,
        "dropped_total": getattr(slam.map, "dropped_total", 0),
        "launches": {k: c.launches for k, c in counters.items()},
        "plain_calls": {k: c.plain_calls for k, c in counters.items()},
    }
