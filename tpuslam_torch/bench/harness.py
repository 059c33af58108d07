"""Benchmarks of the port — `run_bench` (odometry), `run_slam_bench` (the
full SLAM system), `run_map_bench` (frame-to-map tracking), `bench_loader`
(the TUM loader), `bench_scale` and `bench_pathology`: ports of the
odometry block, `bench_slam`, `bench_loader`, `bench_scale` and
`bench_pathology` of `tpuslam/bench/harness.py`.

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

`bench_scale` is BASELINE config 5's capacity run: 2,000 frames of a
five-lap loop at 320×240 with tight promotion thresholds, a pose graph
that starts at 32 nodes and must double, and a cloud budget of 48.
`bench_pathology` runs the degraded sensor (Kinect z² noise, dropout
holes, 2% pixel dropout) through a fast-rotation burst at 640×480.

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
              fused_gn: bool = False, sequence=None,
              config_path: str | None = None,
              devices: int | None = None) -> dict:
    """Odometry throughput, ATE and ICP-iteration latency (module doc).

    `sequence`: optionally the `_render_sequence` output for these frames
    and size, so several runs share one rendering.  `config_path`: a JSON
    SLAMConfig (partial) in place of the defaults; `fused_gn=True` turns
    the fused solve on over it.  `devices` > 1 (the reference's sharded
    ICP scaling) is not ported."""
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.frontend import preprocess, scan_odometry
    from tpuslam_torch.icp import align_frames
    from tpuslam_torch.slam import _not_ported

    if devices is not None and devices > 1:
        raise _not_ported("multi-device ICP scaling (bench --devices)",
                          "Queue 1 item 16")
    dev = torch.device(device)
    cfg = SLAMConfig()
    if config_path:
        with open(config_path) as f:
            cfg = SLAMConfig.from_json(f.read())
    cfg = cfg.replace(height=height, width=width)
    if fused_gn:
        cfg = cfg.replace(icp=dataclasses.replace(cfg.icp, fused_gn=True))
    cfg = cfg.validate()

    K, gt_poses, depths_np = (sequence if sequence is not None else
                              _render_sequence(frames, height, width))
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)

    result: dict = {
        "device": _device_name(dev),
        "frames": frames,
        "resolution": [height, width],
        "fused_gn": cfg.icp.fused_gn,
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
            "gn_fused": gn_fused.counter, "ring_nn": ring_nn.counter,
            "grid_correspond": correspond.grid_counter,
            "grid_table": correspond.table_counter}


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

    def one_pass(deferred: bool):
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=deferred, chunk_mode="boundary",
                          chunk_sub=4, device=dev)
        _fence(dev)
        t0 = time.perf_counter()
        _run_chunked(slam, depths, ts, chunk)
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
                  voxel: VoxelConfig | None = None,
                  map_track_mode: str = "projective",
                  map_ba: bool = False) -> dict:
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
    `map_track_mode="grid"` refines by the grid probe against a sorted map
    index; with `map_ba` `finalize` ends with map BA, and the result adds
    its stats and the ATE before it (`ate_before_ba_m`, read inside the
    timed pass).
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
                          map_track_mode=map_track_mode, map_ba=map_ba,
                          device=dev)
        _fence(dev)
        t0 = time.perf_counter()
        for i in range(frames):
            slam.process(depths[i], timestamp=ts[i])
        before = slam.trajectory() if map_ba else None
        slam.finalize()
        _fence(dev)
        return time.perf_counter() - t0, slam, before

    for _ in range(warmup):
        one_pass()
    for c in counters.values():
        c.reset()
    wall, slam, before = one_pass()
    t_est, est = slam.trajectory()
    refine_ok = [s["ok"] for s in slam.map_refine_stats]
    extra = {}
    if map_ba:
        extra = {"map_ba": slam.map_ba_stats,
                 "ate_before_ba_m": ate_rmse(*before, ts, gt,
                                             max_difference=0.005)["rmse"]}
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
        "map_track_mode": map_track_mode, **extra,
    }


def bench_loader(height: int, width: int, frames: int = 40) -> dict:
    """Host TUM loader throughput on a sequence written to a temporary
    directory: PNG decode on the loader's thread pool (`decode_fps`, after
    one pass that warms the page cache), the decode-once sidecar's memmap
    stream (`cached_fps`), and the decoder that ran."""
    import tempfile

    from tpuslam_torch.data import tum
    from tpuslam_torch.data.synthetic import write_tum_sequence

    with tempfile.TemporaryDirectory() as root:
        K = Intrinsics(525.0, 525.0, width / 2 - 0.5, height / 2 - 0.5)
        write_tum_sequence(root, frames, K, height, width)
        seq = tum.TumSequence(root, depth_cache=False)
        for _ in seq.frames():         # warm the page cache
            pass
        t0 = time.perf_counter()
        n = sum(1 for _ in seq.frames())
        wall = time.perf_counter() - t0
        for _ in tum.TumSequence(root).frames():     # build + publish
            pass
        t0 = time.perf_counter()
        nc = sum(1 for _ in tum.TumSequence(root).frames())
        wall_c = time.perf_counter() - t0
    return {"decode_fps": n / wall, "cached_fps": nc / wall_c,
            "native": tum.depth_decoder() == "native",
            "decoder": tum.decoder_note()}


def _run_chunked(slam, depths: torch.Tensor, ts: np.ndarray,
                 chunk: int) -> None:
    """Whole chunks through process_chunk, the remainder per frame, then
    finalize (the reference's bench loop)."""
    frames = depths.shape[0]
    full = frames - frames % chunk
    for i in range(0, full, chunk):
        slam.process_chunk(depths[i:i + chunk], ts[i:i + chunk])
    for i in range(full, frames):
        slam.process(depths[i], timestamp=ts[i])
    slam.finalize()


def bench_scale(frames: int = 2000, height: int = 240, width: int = 320,
                chunk: int = 32, chunk_mode: str = "boundary",
                async_backend: bool = True, chunk_sub: int = 1,
                device: str = "cuda") -> dict:
    """BASELINE config 5 at scale on the device (module doc): the five-lap
    loop through `SlamSystem.process_chunk` (boundary chunks of `chunk`,
    the deferred backend, promotion sub-chunks of 1 — this config promotes
    every ~5 frames) on device-resident depth, one pass.  Reports fps, the
    graph's nodes and capacity, keyframes, retained clouds, closures, ATE
    and lost frames."""
    from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    from tpuslam_torch.config import KeyframeConfig, PoseGraphConfig

    dev = torch.device(device)
    K = _intrinsics(height, width)
    # tests/test_config5_scale.py's config with the default ICP: tight
    # promotion (~310 keyframes over 2,000 frames), a cloud budget of 48, a
    # graph that starts at 32 nodes and 64 edges and must double
    cfg = SLAMConfig(
        height=height, width=width,
        keyframe=KeyframeConfig(max_translation=0.015, max_rotation=0.03,
                                max_keyframes=48, sparsify_protect_recent=4),
        posegraph=PoseGraphConfig(max_nodes=32, max_edges=64, gn_iters=15,
                                  solver="auto", dense_max_nodes=256,
                                  lc_min_gap=20, lc_max_dist=0.08,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 12, map_capacity=1 << 15),
    ).validate()
    gt = loop_trajectory(frames, cycles=5)
    t0 = time.perf_counter()
    depths_np = np.stack([render_depth(gt[i], K, height, width, seed=i)
                          for i in range(frames)]).astype(np.float32)
    render_s = time.perf_counter() - t0
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    ts = np.arange(frames) / 30.0
    slam = SlamSystem(K, cfg, enable_loop_closure=True, chunk_mode=chunk_mode,
                      async_backend=async_backend, chunk_sub=chunk_sub,
                      device=dev)
    t0 = time.perf_counter()
    _run_chunked(slam, depths, ts, chunk)
    _fence(dev)
    wall = time.perf_counter() - t0
    t_est, est = slam.trajectory()
    return {
        "device": _device_name(dev),
        "frames": frames,
        "resolution": [height, width],
        "chunk": chunk,
        "chunk_mode": chunk_mode,
        "async_backend": async_backend,
        "fps": frames / wall,
        "wall_s": wall,
        "render_s": render_s,
        "graph_nodes": slam._num_graph_nodes,
        "node_capacity": slam.graph.node_capacity,
        "keyframes": len(slam.odo.keyframes),
        "retained_clouds": sum(1 for r in slam.odo.keyframes
                               if r.cloud is not None),
        "loop_closures": len(slam.closures),
        "ate_rmse_m": ate_rmse(t_est, est, ts, gt,
                               max_difference=0.005)["rmse"],
        "lost_frames": sum(1 for s in slam.odo.stats if s.get("lost")),
        "poses_finite": bool(np.all(np.isfinite(est))),
    }


KINECT_NOISE = 0.0019      # bench_pathology's z² coefficient (the reference's)


def bench_pathology(frames: int = 60, height: int = 480, width: int = 640,
                    device: str = "cuda") -> dict:
    """The degraded-sensor run (module doc) at the device's production
    shapes: Kinect z² noise, 3 dropout holes, 2% pixel dropout, and an
    8-frame burst of 0.05 rad/frame extra yaw halfway; boundary chunks of
    8 with the deferred backend (a chunk that loses tracking replays per
    frame).  One uncounted pass, then the timed one."""
    from tpuslam_torch.data.synthetic import (
        burst_trajectory,
        degrade_depth,
        render_depth,
    )
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    dev = torch.device(device)
    K = _intrinsics(height, width)
    cfg = SLAMConfig(height=height, width=width).validate()
    gt = burst_trajectory(frames, burst_start=frames // 2, burst_len=8,
                          burst_rate=0.05)
    depths_np = np.stack([
        degrade_depth(render_depth(gt[i], K, height, width, seed=i),
                      seed=100 + i, z_noise_coeff=KINECT_NOISE,
                      dropout_holes=3, edge_dropout=0.02)
        for i in range(frames)]).astype(np.float32)
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    ts = np.arange(frames) / 30.0

    def run():
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          chunk_mode="boundary", async_backend=True,
                          device=dev)
        t0 = time.perf_counter()
        _run_chunked(slam, depths, ts, 8)
        _fence(dev)
        return time.perf_counter() - t0, slam

    run()                                         # uncounted: first use
    wall, slam = run()
    t_est, est = slam.trajectory()
    return {
        "device": _device_name(dev),
        "frames": frames,
        "resolution": [height, width],
        "fps": frames / wall,
        "ate_rmse_m": ate_rmse(t_est, est, ts, gt,
                               max_difference=0.005)["rmse"],
        "lost_frames": sum(1 for s in slam.odo.stats if s.get("lost")),
        "loop_closures": len(slam.closures),
        "keyframes": len(slam.odo.keyframes),
        "poses_finite": bool(np.all(np.isfinite(est))),
    }
