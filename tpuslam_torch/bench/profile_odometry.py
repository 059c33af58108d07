"""Profile the odometry or the map-tracking path of one checkout of the
port on a GPU.

    python3 tpuslam_torch/bench/profile_odometry.py [--root DIR] [--tag T]
        [--mode odometry|map|fps|solve|grid|posegraph|slam] [--fused]

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
sharded under a one-rank NCCL group.  Each runs `run_map_bench` once
after MAP_BENCH_WARMUP uncounted passes (`map_loop_vga`: fps, ATE,
keyframes, closures, refinement ok share, dropped points); then a system
takes frames 0-47 to grow its map and frames 48-55 are timed on the host
clock (each frame fenced by a synchronize); a second one times frames
48-55 by stage (`stages_ms`: tracking, fusion, the loop-closure attempt
and the map refinement, each fenced, and the rest); a third takes frames
48-55 under the profiler.

`--mode grid` measures the grid probe and map-grid-vga through
`build_grid_index`, `grid_correspond_at_pose` and `run_map_bench(...,
map_track_mode="grid", map_ba=True)` (after MAP_BENCH_WARMUP uncounted
passes), which every commit since the grid slice has.  One probe at
chip_smoke.py's phase-3 shapes (16,384 queries
against a 131,072-row index of three planes, ~150 points to a 0.25 m
cell), its queries in random order and sorted by voxel key (the order a
frame cloud leaves voxel_downsample in): CUDA-event ms a launch (three
passes of 50) and device µs a launch (20 under the profiler); the index
build the same way (its device µs: every device operation of a build);
then map-grid-vga: `run_map_bench` once (fps, ATE, and a SHA-256 of the
poses after map BA, read at `finalize`, so that two commits' bits can be
compared, with the refinement ok share and dropped points), a second
system that times frames 48-55 by stage (`stages_ms`, as `--mode map`,
with the index build) and a third that takes frames 0-47 and then frames
48-55 under the profiler (the probe's device µs and launches there).

`--mode posegraph` times the pose-graph solve alone through
`posegraph.optimize`, and `--mode slam` the per-frame SLAM system (sync
and with the worker thread, `async_gain`) and the deferred boundary
chunks, with every loop-closure attempt timed (their docstrings); both
use only entry points the worker-thread slice has.

Prints one JSON line a run (for map: one for each of unsharded and
sharded): ms a frame (the best of the timed passes), device busy µs a frame, device operations (kernels,
copies, fills) a frame and fills a frame, for each hand kernel its
launches a frame and device µs a launch, and the 16 device operations
that take the most time, with the card's name and power limit.  Exits 2
without a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

# the hand kernels' symbols in every commit since the map slice
# (gn_fused_kernel before the fused solve became one launch)
KERNELS = ("correspond_kernel", "gn_partials_kernel", "gn_epilogue_kernel",
           "gn_step_kernel", "gn_fused_kernel", "gn_fused_step_kernel",
           "ring_nn_kernel", "grid_correspond_kernel", "grid_table_")


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
        for k in sorted(KERNELS, key=len, reverse=True):
            if k in ev.key:     # the longest name: grid_correspond holds
                us, n = kernels.get(k, (0.0, 0))   # correspond's
                kernels[k] = (us + dt, n + ev.count)
                break
    return busy, ops, kernels, rows


def report(tag, card, package, frames, walls, prof, **extra):
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan_odometry(d, K, cfg)
        torch.cuda.synchronize()
    print(json.dumps(report(args.tag, card, tpuslam_torch.__file__,
                            args.frames, walls, prof,
                            mode="odometry", fused=args.fused)), flush=True)


def fps(args, card, dev) -> None:
    import tpuslam_torch
    from tpuslam_torch.bench.harness import run_bench

    # the odometry block alone (a checkout whose run_bench also runs the
    # loader and the SLAM system is told to leave them out)
    extra = {k: None for k in ("slam_frames", "loader_frames")
             if k in inspect.signature(run_bench).parameters}
    r = run_bench(frames=240, height=480, width=640, device=str(dev),
                  fused_gn=args.fused, **extra)
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


POSEGRAPH_RUNS = 10


def synthetic_graph(dev, nodes: int, seed: int = 0):
    """A bucketed pose graph over the first `nodes` poses of a two-lap
    loop (a node every 8 frames of a 16-keyframe lap), each off by ~1 cm,
    odometry edges from the true poses and a loop edge from each node of
    the second lap to its twin of the first, weight 2."""
    import numpy as np

    from tpuslam_torch.backend.posegraph import GraphHost
    from tpuslam_torch.config import PoseGraphConfig
    from tpuslam_torch.data.synthetic import loop_trajectory

    gt = loop_trajectory(8 * nodes, cycles=max(1, nodes // 16),
                         radius=0.35)[::8]
    rng = np.random.default_rng(seed)
    host = GraphHost(PoseGraphConfig(), device=dev)
    for k in range(nodes):
        T = gt[k].copy()
        T[:3, 3] += rng.normal(scale=0.01, size=3)
        host.add_node(T.astype(np.float32))
        if k:
            host.add_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k])
        if k >= 16:
            host.add_edge(k - 16, k, np.linalg.inv(gt[k - 16]) @ gt[k],
                          weight=2.0)
    return host


def posegraph_cases(dev) -> dict:
    """Graphs of the 32-node bucket that the dense solve's kernel is held
    to its twin on, by name: synthetic_graph's loops of 15, 19, 24 and 32
    nodes; 19 nodes with a fused attempt's four candidate edges (a loop
    closure, one 0.3 m off, whose weighted norm passes the Huber width,
    and two zero-weight repeats of the first); every node rotated by
    ±0.06, ±0.13 and ±1.56 rad about x, so that the first round's residual
    rotations fall below, above and near π past the Taylor switch at
    θ² = 0.0625; and a candidate pose with a NaN, at weight 0 and at 2
    (the guard leaves every pose as it was)."""
    import numpy as np
    import torch

    from tpuslam_torch.geom import se3

    cases = {f"loop {n}": synthetic_graph(dev, n).graph(bucketed=True)
             for n in (15, 19, 24, 32)}
    host = synthetic_graph(dev, 19)
    g = host.graph(bucketed=True)
    rng = np.random.default_rng(1)

    def closure(i, j, noise):
        T = np.linalg.inv(host._poses[i]) @ host._poses[j]
        T[:3, 3] += rng.normal(scale=noise, size=3)
        return T.astype(np.float32)

    cand_T = np.stack([closure(0, 17, 0.02), closure(2, 18, 0.3),
                       closure(0, 17, 0.0), closure(0, 17, 0.0)])

    def with_candidates(T, w):
        return g._replace(
            edge_i=torch.cat([g.edge_i, torch.tensor(
                [0, 2, 0, 0], dtype=torch.int32, device=dev)]),
            edge_j=torch.cat([g.edge_j, torch.tensor(
                [17, 18, 17, 17], dtype=torch.int32, device=dev)]),
            edge_T=torch.cat([g.edge_T, torch.as_tensor(T, device=dev)]),
            edge_weight=torch.cat([g.edge_weight, torch.tensor(
                w, dtype=torch.float32, device=dev)]))

    cases["candidates"] = with_candidates(cand_T, [2.0, 2.0, 0.0, 0.0])
    for ang in (0.06, 0.13, 1.56):
        turn = torch.stack([se3.exp(torch.tensor(
            [0.0, 0.0, 0.0, ang * (-1) ** k, 0.0, 0.0], device=dev))
            for k in range(g.poses.shape[0])])
        live = g.node_mask[:, None, None]
        cases[f"rotated {ang}"] = g._replace(
            poses=torch.where(live, turn @ g.poses, g.poses))
    bad = cand_T.copy()
    bad[2, 0, 0] = np.nan
    cases["nan candidate, weight 0"] = with_candidates(bad,
                                                       [2.0, 2.0, 0.0, 0.0])
    cases["nan candidate, weight 2"] = with_candidates(bad,
                                                       [2.0, 2.0, 2.0, 0.0])
    return cases


def posegraph(args, card, dev) -> None:
    """The pose-graph solve alone: `posegraph.optimize` (the entry point of
    SlamSystem._optimize and the grid attempt) on a 15-node graph (the
    32-node bucket, dense: a slam-loop-vga attempt's) and a 400-node one
    (512, CG: scale-loop-qvga's), one solve at a time on the host clock
    with its readback, after two calls (where the checkout has graphs: the
    warm-up and the capture), and the small one's device time and
    operations under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.backend.posegraph import optimize
    from tpuslam_torch.config import PoseGraphConfig

    cfg = PoseGraphConfig()
    out = {"tag": args.tag, "card": card, "package": tpuslam_torch.__file__,
           "mode": "posegraph"}
    for nodes, runs in ((15, POSEGRAPH_RUNS), (400, 3)):
        host = synthetic_graph(dev, nodes)
        g = host.graph(bucketed=True)

        def run():
            poses, _ = optimize(g, cfg, live_nodes=nodes)
            return poses.cpu()            # the caller's one readback

        t0 = time.perf_counter()
        run()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run()
        second_s = time.perf_counter() - t0
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy = ops = None
        if nodes < 256:        # the CG solve's ~159k operations: unprofiled
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            busy, ops, _, _ = profile_rows(prof)
        out[f"nodes_{nodes}"] = {
            "bucket": [g.poses.shape[0], g.edge_i.shape[0]],
            "first_call_s": first_s, "second_call_s": second_s,
            "ms_per_solve": walls,
            "ms_per_solve_mean": sum(walls) / len(walls),
            "device_us_per_solve": busy, "device_ops_per_solve": ops}
    print(json.dumps(out), flush=True)


def slam(args, card, dev) -> None:
    """slam-perframe-vga and slam-loop-vga deferred: `bench_slam`'s loop
    (120 frames 640×480, two laps, `slam_bench_config`), per frame sync,
    per frame with the worker thread, and boundary chunks of 8 (sub-chunks
    of 4) deferred: an uncounted pass each, then 2 timed passes (fps, the
    reference's `async_gain` = sync wall / worker wall, closures, ATE);
    then one more pass of each with every attempt that did device work
    timed on the host clock: `_dispatch_closure_attempt` between two
    synchronizes of the calling thread's stream (the worker's own on the
    worker)."""
    import numpy as np
    import torch

    import tpuslam_torch
    from tpuslam_torch.bench.harness import (
        _render_sequence,
        _slam_pass,
        slam_bench_config,
    )
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    frames = 120
    cfg = slam_bench_config(480, 640, args.fused)
    K, gt, d_np = _render_sequence(frames, 480, 640, loop_cycles=2)
    d = torch.as_tensor(d_np, device=dev)
    ts = np.arange(frames) / 30.0
    variants = {"sync": (0, {"async_backend": False}),
                "worker": (0, {"async_backend": True}),
                "deferred": (8, {"async_backend": True,
                                 "chunk_mode": "boundary"})}
    out = {"tag": args.tag, "card": card, "package": tpuslam_torch.__file__,
           "mode": "slam", "fused": args.fused}
    walls = {}
    for name, (chunk, system) in variants.items():
        _slam_pass(K, cfg, d, ts, chunk, chunk_sub=4, **system)
        runs = [_slam_pass(K, cfg, d, ts, chunk, chunk_sub=4, **system)
                for _ in range(2)]
        walls[name] = [w for w, _ in runs]
        s = runs[-1][1]
        t_est, est = s.trajectory()
        out[name] = {"fps": frames / min(walls[name]),
                     "wall_s": walls[name], "closures": len(s.closures),
                     "keyframes": len(s.odo.keyframes),
                     "ate_m": ate_rmse(t_est, est, ts, gt,
                                       max_difference=0.005)["rmse"]}
    out["async_gain"] = min(walls["sync"]) / min(walls["worker"])
    orig = SlamSystem._dispatch_closure_attempt
    for name, (chunk, system) in variants.items():
        spans = []

        def timed(self, *a, spans=spans, **kw):
            stream = torch.cuda.current_stream(dev)
            stream.synchronize()
            t0 = time.perf_counter()
            r = orig(self, *a, **kw)
            stream.synchronize()
            if r is not None:
                spans.append((time.perf_counter() - t0) * 1e3)
            return r

        SlamSystem._dispatch_closure_attempt = timed
        try:
            _slam_pass(K, cfg, d, ts, chunk, chunk_sub=4, **system)
        finally:
            SlamSystem._dispatch_closure_attempt = orig
        out[name]["attempts"] = len(spans)
        out[name]["attempt_ms_mean"] = (sum(spans) / len(spans)
                                        if spans else None)
        out[name]["attempt_ms_max"] = max(spans) if spans else None
    print(json.dumps(out), flush=True)


MAP_WARM, MAP_FRAMES = 48, 8        # frames 0-47 grow the map; 48-55 count
# run_map_bench's uncounted passes: a captured program's key warms up at
# its first call and captures at its second, so after two passes the
# timed one replays every key a pass meets (keys met once a pass
# included: the loop-closure attempts, map BA at finalize)
MAP_BENCH_WARMUP = 2
# the map path's stages, each fenced: (owner's attribute, method); "" is
# the SlamSystem itself
MAP_STAGES = (("odo", "process"), ("map", "insert"), ("map", "build_index"),
              ("", "_attempt_loop_closure"), ("", "_refine_against_map"))


def staged_frames(slam, d, ts, lo: int, hi: int) -> dict:
    """Frames lo..hi-1 through `slam`, each stage of MAP_STAGES fenced by
    a synchronize before and after (so the spans are the host's and the
    device's time of each): ms by stage, the whole (`wall`) and what lies
    outside the stages (`rest`).  `build_index` runs inside
    `_refine_against_map` (grid mode) and is not subtracted again."""
    import torch

    spans: dict = {}
    owners = []
    for attr, name in MAP_STAGES:
        owner = getattr(slam, attr) if attr else slam
        fn = getattr(owner, name, None)
        if fn is None:
            continue

        def fenced(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spans[_name] = spans.get(_name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
        setattr(owner, name, fenced)
        owners.append((owner, name))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(lo, hi):
            slam.process(d[i], timestamp=ts[i])
        torch.cuda.synchronize()
    finally:
        for owner, name in owners:
            delattr(owner, name)
    wall = (time.perf_counter() - t0) * 1e3
    outer = sum(v for k, v in spans.items() if k != "build_index")
    return {**spans, "wall": wall, "rest": wall - outer}


def map_cell(r: dict) -> dict:
    """`run_map_bench`'s result, less its launch tables."""
    return {k: v for k, v in r.items() if k not in ("launches",
                                                    "plain_calls")}


def track_map(args, card, dev) -> None:
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.bench.harness import (
        _render_sequence,
        run_map_bench,
        slam_bench_config,
    )
    from tpuslam_torch.dist.mesh import initialize_distributed
    from tpuslam_torch.slam import SlamSystem

    seq = _render_sequence(120, 480, 640, loop_cycles=2)
    K, _, d_np = seq
    last = MAP_WARM + MAP_FRAMES
    d = torch.as_tensor(d_np[:last], device=dev)
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

            cell = map_cell(run_map_bench(120, 480, 640, sharded=sharded,
                                          device=str(dev), sequence=seq,
                                          warmup=MAP_BENCH_WARMUP))
            slam = warm()
            walls = [0.0]
            for i in range(MAP_WARM, last):
                t0 = time.perf_counter()
                slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
                walls[0] += time.perf_counter() - t0
            stages = staged_frames(warm(), d, ts, MAP_WARM, last)
            slam = warm()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(MAP_WARM, last):
                    slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
            print(json.dumps(report(
                args.tag, card, tpuslam_torch.__file__, MAP_FRAMES, walls,
                prof, mode="map", sharded=sharded,
                frames_profiled=[MAP_WARM, last - 1], map_loop_vga=cell,
                stages_ms=stages)), flush=True)
    finally:
        # graphs holding NCCL kernels go before the group (ring_map's name
        # for it: a parent checkout has it there too)
        from tpuslam_torch.dist.ring_map import drop_graphs

        drop_graphs()
        dist.destroy_process_group()


GRID_N, GRID_M, GRID_CELL = 16384, 131072, 0.25


def grid_inputs(dev):
    """chip_smoke.py's phase-3 probe inputs: three orthogonal 4 m planes
    of GRID_M points (a tenth masked), GRID_N queries 2 cm off random
    target points (one outside the grid, one with nothing near), and a
    small pose."""
    import numpy as np
    import torch

    from tpuslam_torch.geom import se3
    from tpuslam_torch.geom.cloud import PointCloud

    m, n = GRID_M, GRID_N
    rng = np.random.default_rng(0)
    k = m // 3
    uv = rng.uniform(-2.0, 2.0, (m, 2))
    pts = np.zeros((m, 3))
    nrm = np.zeros((m, 3))
    pts[:k, 0:2], nrm[:k, 2], pts[:k, 2] = uv[:k], 1.0, -2.0
    pts[k:2 * k, 1:3], nrm[k:2 * k, 0] = uv[k:2 * k], 1.0
    pts[k:2 * k, 0] = -2.0
    pts[2 * k:, 0:3:2], nrm[2 * k:, 1] = uv[2 * k:], 1.0
    pts[2 * k:, 1] = -2.0
    mask = rng.uniform(size=m) > 0.1
    target = PointCloud(*(torch.as_tensor(a, device=dev) for a in (
        pts.astype(np.float32), nrm.astype(np.float32), mask)))
    rng = np.random.default_rng(1)
    pick = torch.as_tensor(rng.integers(0, m, n), device=dev)
    x = target.points[pick] + torch.as_tensor(
        rng.normal(scale=0.02, size=(n, 3)).astype(np.float32), device=dev)
    x[0] += 1000.0
    x[1] = torch.tensor([1.0, 1.0, 1.0], device=dev)
    xm = torch.as_tensor(rng.uniform(size=n) > 0.05, device=dev)
    T = se3.exp(torch.tensor([0.004, -0.003, 0.002, 0.01, -0.01, 0.005],
                             device=dev))
    return target, x, xm, T


def event_and_device_us(fn, symbol=None, runs=50):
    """(CUDA-event ms a call over three passes of `runs`, device µs a call
    over 20 calls under the profiler: of the kernels whose name holds
    `symbol`, or of every device operation when it is None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    event_ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        stop.record()
        torch.cuda.synchronize()
        event_ms.append(start.elapsed_time(stop) / runs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    _, _, _, rows = profile_rows(prof)
    us = sum(dt for dt, _, key in rows if symbol is None or symbol in key)
    return event_ms, us / 20


def grid(args, card, dev) -> None:
    import hashlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.bench.harness import (
        _render_sequence,
        run_map_bench,
        slam_bench_config,
    )
    from tpuslam_torch.config import VoxelConfig
    from tpuslam_torch.geom.voxel import voxel_keys
    from tpuslam_torch.kernels import correspond, gn_epilogue
    from tpuslam_torch.slam import SlamSystem

    target, x, xm, T = grid_inputs(dev)
    index = correspond.build_grid_index(target, GRID_CELL)
    carry = gn_epilogue.init_carry(T, 12)
    vc = VoxelConfig()
    hi, lo, _ = voxel_keys(x, torch.ones_like(xm), vc.voxel_size, vc.origin,
                           vc.extent)
    order = torch.sort(hi.long() * 2 ** 31 + lo.long(), stable=True).indices
    probe = {}
    for name, (xq, xmq) in {"random": (x, xm), "voxel_key": (
            x[order].contiguous(), xm[order].contiguous())}.items():
        out = correspond.correspondence_buffers(GRID_N, dev)
        ms, us = event_and_device_us(
            lambda xq=xq, xmq=xmq, out=out: correspond.grid_correspond_at_pose(
                xq, xmq, index, GRID_CELL, carry, out=out),
            "grid_correspond_kernel")
        probe[name] = {"event_ms": ms, "device_us": us,
                       "matches": int(out.w.sum())}
    ms, us = event_and_device_us(
        lambda: correspond.build_grid_index(target, GRID_CELL), runs=20)
    index_build = {"event_ms": ms, "device_us": us}

    seq = _render_sequence(120, 480, 640, loop_cycles=2)
    poses = {}
    finalize = SlamSystem.finalize

    def recording_finalize(self, *a, **kw):
        out = finalize(self, *a, **kw)
        poses["est"] = np.ascontiguousarray(self.trajectory()[1])
        return out
    SlamSystem.finalize = recording_finalize
    try:
        r = run_map_bench(120, 480, 640, device=str(dev), sequence=seq,
                          map_track_mode="grid", map_ba=True,
                          warmup=MAP_BENCH_WARMUP)
    finally:
        SlamSystem.finalize = finalize
    K, _, d_np = seq
    d = torch.as_tensor(d_np[:MAP_WARM + MAP_FRAMES], device=dev)
    ts = np.arange(d.shape[0]) / 30.0

    def warm():
        slam = SlamSystem(K, slam_bench_config(480, 640, False),
                          enable_loop_closure=True, track_against_map=True,
                          map_track_mode="grid", map_ba=True, device=dev)
        for i in range(MAP_WARM):
            slam.process(d[i], timestamp=ts[i])
        torch.cuda.synchronize()
        return slam

    stages = staged_frames(warm(), d, ts, MAP_WARM, MAP_WARM + MAP_FRAMES)
    slam = warm()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(MAP_WARM, MAP_WARM + MAP_FRAMES):
            slam.process(d[i], timestamp=ts[i])
        torch.cuda.synchronize()
    busy, _, kernels, _ = profile_rows(prof)
    us, launches = kernels.get("grid_correspond_kernel", (0.0, 0))
    print(json.dumps({
        "tag": args.tag, "card": card, "package": tpuslam_torch.__file__,
        "mode": "grid", "shape": [GRID_N, GRID_M],
        "has_table": getattr(index, "table", None) is not None,
        "probe": probe, "index_build": index_build,
        "map_grid_vga": {
            **map_cell(r), "launches": r["launches"], "stages_ms": stages,
            "poses_sha256": hashlib.sha256(poses["est"].tobytes()).hexdigest(),
            "frames_profiled": [MAP_WARM, MAP_WARM + MAP_FRAMES - 1],
            "grid_correspond_device_us": us,
            "grid_correspond_launches": launches,
            "device_busy_us": busy,
            "kernels_device_us": {k: v[0] for k, v in kernels.items()}},
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--mode", choices=("odometry", "map", "fps", "solve",
                                       "grid", "posegraph", "slam"),
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
    {"odometry": odometry, "map": track_map, "fps": fps, "solve": solve,
     "grid": grid, "posegraph": posegraph, "slam": slam}[args.mode](
        args, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
