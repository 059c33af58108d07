"""Benchmarks of the port — `run_bench` (odometry, with the loader and
`bench_slam` nested), `bench_slam` and `run_slam_bench` (the full SLAM
system), `run_map_bench` (frame-to-map tracking), `bench_loader` (the TUM
loader), `bench_scale` and `bench_pathology`: ports of `run_bench`,
`bench_slam`, `bench_loader`, `bench_scale` and `bench_pathology` of
`tpuslam/bench/harness.py`.

`run_bench` measures full-sequence frame-to-keyframe odometry throughput
(frames/s and ms/frame of `frontend.scan_odometry` on device-resident
depth, best of three timed runs after a warm-up), the trajectory's ATE
against the synthetic ground truth (a speed number from a diverged tracker
means nothing), the same for the boundary-promotion scan
(`frontend.scan_odometry_boundary_jit`, chunks of 8) and the headline
variant chosen from the two by the reference's rule, and the
per-ICP-iteration latency of a fixed 50-iteration finest-level alignment
(one replay of `icp.align_frames_jit` a call).  Depth is the synthetic
ray-traced orbit at the requested resolution.

`bench_slam` is the reference's five variants of the full system over the
synthetic two-lap loop on device-resident depth: per-frame
`SlamSystem.process` with the backend synchronous (`slam_fps`) and on the
worker thread (`slam_fps_async`, `async_gain` = sync wall / worker wall),
boundary chunks of 8 synchronous and deferred (`slam_fps_chunked`,
`slam_fps_chunked_async`, best of 5) and inline chunks of 8 synchronous
(`slam_fps_chunked_inline`), each after one uncounted pass, with each
variant's ATE, closures and keyframes.  `run_slam_bench` is its boundary
pair alone, with more per variant (closure pairs, fps of every pass).

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


def run_bench(frames: int = 120, height: int = 480, width: int = 640,
              device: str = "cuda", warmup: int = 1, reps: int = 3,
              fused_gn: bool = False, sequence=None,
              config_path: str | None = None,
              devices: int | None = None, slam_frames: int | None = 120,
              loader_frames: int | None = 40,
              outputs: dict | None = None) -> dict:
    """Odometry throughput and ATE of the classic and the boundary scan,
    the headline variant, ICP-iteration latency (module doc), then, as the
    reference's, the host loader (`loader`: `bench_loader` on
    `loader_frames` frames) and the full system (`slam`: `bench_slam` on
    `slam_frames` frames, with this config); None leaves either out.

    `sequence`: optionally the `_render_sequence` output for these frames
    and size, so several runs share one rendering.  `config_path`: a JSON
    SLAMConfig (partial) in place of the defaults; `fused_gn=True` turns
    the fused solve on over it.  `devices`: the size of the current
    process group (its mesh, dist/mesh.py; a ValueError otherwise), and
    the result gains the point-sharded ICP's time on it against the
    single-rank `align_frames_jit`, each a replay on the card
    (`spmd_align_ms`, `single_align_ms`,
    `scaling_efficiency`, `n_devices`); with no `devices` a group of more
    than one rank adds them too, as the reference does for its devices.
    `outputs`: a dict that receives the last timed call's outputs of each
    scan, `classic` and `boundary`, each (poses, promotion flags, inlier
    fractions) on the device."""
    from tpuslam_torch.dist.mesh import make_mesh
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.frontend import (
        preprocess,
        scan_odometry,
        scan_odometry_boundary_jit,
    )
    from tpuslam_torch.icp import align_frames_jit

    mesh = make_mesh(device)
    if devices is not None and devices != mesh.size:
        raise ValueError(f"devices={devices}, but the process group has "
                         f"{mesh.size} rank(s): start one process a rank "
                         f"(--coordinator, --num-processes, --process-id)")
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
    result["compile_plus_first_run_s"] = time.perf_counter() - t0
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
    result["fps_per_chip"] = frames / wall
    result["ms_per_frame"] = wall / frames * 1e3
    result["fps_reps"] = [round(frames / w, 1) for w in walls]

    if outputs is not None:
        outputs["classic"] = out
    poses = out[0].cpu().numpy().astype(np.float64)
    result["poses_finite"] = bool(np.all(np.isfinite(poses)))
    result["keyframes"] = int(out[1].sum().item())
    ts = np.arange(frames, dtype=np.float64)
    ate = ate_rmse(ts, poses, ts, gt_poses)["rmse"]
    result["ate_rmse_m"] = ate

    # --- the boundary-promotion scan: keyframe tables in the chunk-level
    # carry (tpuslam/bench/harness.py:467-496); one warm-up call (its
    # first chunk warms the key up, the second captures), best of `reps`,
    # its own ATE guard; with fewer frames than a chunk it is left out and
    # the headline is the classic scan ---
    bchunk = 8
    fb = frames - frames % bchunk
    result["headline_variant"] = "classic"
    result["fps_headline"] = result["fps_per_chip"]
    if fb:
        depths_b = depths[:fb]
        scan_odometry_boundary_jit(depths_b, K, cfg, bchunk)
        _fence(dev)
        walls_b = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out_b = scan_odometry_boundary_jit(depths_b, K, cfg, bchunk)
            _fence(dev)
            walls_b.append(time.perf_counter() - t0)
        wall_b = min(walls_b)
        if outputs is not None:
            outputs["boundary"] = out_b
        result["fps_per_chip_boundary"] = fb / wall_b
        result["ms_per_frame_boundary"] = wall_b / fb * 1e3
        result["fps_reps_boundary"] = [round(fb / w, 1) for w in walls_b]
        ate_b = ate_rmse(ts[:fb], out_b[0].cpu().numpy().astype(np.float64),
                         ts[:fb], np.asarray(gt_poses)[:fb])["rmse"]
        result["ate_rmse_m_boundary"] = ate_b
        if headline_variant(ate, wall / frames, ate_b,
                            wall_b / fb) == "boundary":
            result["headline_variant"] = "boundary"
            result["fps_headline"] = result["fps_per_chip_boundary"]

    # --- per-ICP-iteration latency: a fixed 50-iteration finest-level
    # alignment (tol 0: the loop never exits early), one replay of
    # `align_frames_jit` a call, after the key's warm-up and capture ---
    pyr_a = preprocess(depths[0], K, cfg)
    pyr_b = preprocess(depths[1], K, cfg)
    iter_loops = 50
    one_level = dataclasses.replace(cfg.icp, pyramid_levels=1,
                                    iters_per_level=(iter_loops,),
                                    tol_delta=0.0)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)

    def align_ms(align) -> float:
        """Mean ms of `n_align` calls after two (a key's warm-up, then its
        capture)."""
        for _ in range(2):
            align()
        _fence(dev)
        t0 = time.perf_counter()
        for _ in range(n_align):
            align()
        _fence(dev)
        return (time.perf_counter() - t0) / n_align * 1e3

    n_align = 5
    r = align_frames_jit((pyr_b[0],), (pyr_a[0],), K, T0, one_level)
    result["icp_iter_latency_ms"] = align_ms(
        lambda: align_frames_jit((pyr_b[0],), (pyr_a[0],), K, T0,
                                 one_level)) / iter_loops
    result["icp_iter_count"] = int(r.iters.item())

    # --- the point-sharded ICP over the process group's ranks, replayed
    # against the single-device replay ---
    if devices is not None or mesh.size > 1:
        from tpuslam_torch.dist.sharded_icp import make_aligned_spmd_fn

        fn = make_aligned_spmd_fn(mesh, cfg.icp)
        sharded_ms = align_ms(lambda: fn(pyr_b, pyr_a, K, T0))
        single_ms = align_ms(lambda: align_frames_jit(pyr_b, pyr_a, K, T0,
                                                      cfg.icp))
        result["spmd_align_ms"] = sharded_ms
        result["single_align_ms"] = single_ms
        result["scaling_efficiency"] = single_ms / (sharded_ms * mesh.size)
        result["n_devices"] = mesh.size

    # --- the host loader and the full SLAM system ---
    if loader_frames:
        result["loader"] = bench_loader(height, width, frames=loader_frames)
    if slam_frames:
        result["slam"] = bench_slam(slam_frames, height, width, cfg=cfg,
                                    device=device)
    return result


def headline_variant(ate: float, s_per_frame: float, ate_boundary: float,
                     s_per_frame_boundary: float) -> str:
    """The reference's headline rule (tpuslam/bench/harness.py:489-496):
    the boundary variant wins only when its ATE is below 1 mm and either
    the classic ATE is not or the boundary scan takes less wall time a
    frame."""
    if ate_boundary < 1e-3 and (ate >= 1e-3
                                or s_per_frame_boundary < s_per_frame):
        return "boundary"
    return "classic"


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


def _slam_pass(K, cfg: SLAMConfig, depths: torch.Tensor, ts: np.ndarray,
               chunk: int, **system) -> tuple:
    """One pass of the SLAM system over `depths`, fenced on the host clock:
    per frame (`chunk` 0) or whole chunks and the remainder per frame, then
    `finalize` (which re-raises a backend worker's error).  `system`: the
    SlamSystem's options.  Returns (seconds, the system)."""
    from tpuslam_torch.slam import SlamSystem

    dev = depths.device
    slam = SlamSystem(K, cfg, enable_loop_closure=True, device=dev,
                      **system)
    _fence(dev)
    t0 = time.perf_counter()
    if chunk:
        _run_chunked(slam, depths, ts, chunk)
    else:
        for i in range(depths.shape[0]):
            slam.process(depths[i], timestamp=ts[i])
        slam.finalize()
    _fence(dev)
    return time.perf_counter() - t0, slam


def _best_of(one_pass, reps: int) -> tuple:
    """`reps` timed passes: (their seconds, the system of the fastest)."""
    walls, best = [], None
    for _ in range(reps):
        wall, slam = one_pass()
        if not walls or wall < min(walls):
            best = slam
        walls.append(wall)
    return walls, best


def bench_slam(frames: int = 120, height: int = 480, width: int = 640,
               cfg: SLAMConfig | None = None, cycles: int = 2,
               device: str = "cuda", sequence=None) -> dict:
    """The full system's five variants (module doc) with the reference's
    keys, plus `device`.  `cfg` (default: the defaults) gets this size and
    lc_min_gap 8 (the loop promotes ~15 keyframes a lap; the default gap of
    20 would gate every revisit).  Depth is uploaded once and stays on the
    device (`upload_fps_equiv` is the upload's rate); chunked variants use
    promotion sub-chunks of 4.  `sequence` is as in `run_bench` (here the
    `cycles`-lap loop)."""
    from tpuslam_torch.eval.ate import ate_rmse

    dev = torch.device(device)
    if cfg is None:
        cfg = slam_bench_config(height, width, False)
    else:
        cfg = cfg.replace(height=height, width=width, posegraph=(
            dataclasses.replace(cfg.posegraph, lc_min_gap=8))).validate()
    K, gt, depths_np = (sequence if sequence is not None else
                        _render_sequence(frames, height, width,
                                         loop_cycles=cycles))
    _fence(dev)
    t0 = time.perf_counter()
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    upload_s = time.perf_counter() - t0
    ts = np.arange(frames) / 30.0
    chunk = 8
    variants = {   # name: (chunk, SlamSystem options, timed passes)
        "sync": (0, {"async_backend": False}, 3),
        "async": (0, {"async_backend": True}, 3),
        "chunked": (chunk, {"async_backend": False,
                            "chunk_mode": "boundary"}, 5),
        "chunked_async": (chunk, {"async_backend": True,
                                  "chunk_mode": "boundary"}, 5),
        "chunked_inline": (chunk, {"async_backend": False,
                                   "chunk_mode": "inline"}, 3),
    }
    walls, best = {}, {}
    for name, (c, system, reps) in variants.items():
        def one_pass():
            return _slam_pass(K, cfg, depths, ts, c, chunk_sub=4, **system)

        one_pass()                          # uncounted: first-use costs
        walls[name], best[name] = _best_of(one_pass, reps)

    def ate(slam) -> float:
        t_est, est = slam.trajectory()
        return ate_rmse(t_est, est, ts, gt, max_difference=0.005)["rmse"]

    def fps(name) -> float:
        return frames / min(walls[name])

    return {
        "device": _device_name(dev),
        "slam_fps": fps("sync"),
        "slam_fps_async": fps("async"),
        "async_gain": min(walls["sync"]) / min(walls["async"]),
        "slam_fps_chunked": fps("chunked"),
        "slam_fps_chunked_async": fps("chunked_async"),
        "slam_fps_chunked_inline": fps("chunked_inline"),
        "slam_fps_reps": {name: [frames / w for w in walls[name]]
                          for name in variants},
        "upload_fps_equiv": frames / upload_s,
        "chunk": chunk,
        "slam_ate_rmse_m": ate(best["sync"]),
        "slam_chunked_ate_rmse_m": ate(best["chunked"]),
        "slam_chunked_async_ate_rmse_m": ate(best["chunked_async"]),
        "slam_chunked_inline_ate_rmse_m": ate(best["chunked_inline"]),
        "loop_closures": len(best["sync"].closures),
        "loop_closures_chunked": len(best["chunked"].closures),
        "loop_closures_chunked_async": len(best["chunked_async"].closures),
        "loop_closures_chunked_inline": len(best["chunked_inline"].closures),
        "keyframes": len(best["sync"].odo.keyframes),
        "keyframes_chunked": len(best["chunked"].odo.keyframes),
        "frames": frames,
    }


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

    dev = torch.device(device)
    cfg = slam_bench_config(height, width, fused_gn)
    K, gt, depths_np = (sequence if sequence is not None else
                        _render_sequence(frames, height, width,
                                         loop_cycles=cycles))
    depths = torch.as_tensor(depths_np, device=dev)
    _fence(dev)
    ts = np.arange(frames) / 30.0

    result: dict = {"device": _device_name(dev), "frames": frames,
                    "resolution": [height, width], "chunk": chunk,
                    "fused_gn": fused_gn}
    for name, deferred in (("sync", False), ("deferred", True)):
        def one_pass():
            return _slam_pass(K, cfg, depths, ts, chunk,
                              async_backend=deferred, chunk_mode="boundary",
                              chunk_sub=4)

        one_pass()                          # uncounted: first-use costs
        walls, best = _best_of(one_pass, reps)
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
