"""The command line — port of `tpuslam/cli.py`:

    python -m tpuslam_torch.cli <subcommand> ... [--device cuda|cpu]

Subcommands:
  run_odometry   — frame-to-keyframe odometry over a TUM sequence
  run_slam       — odometry + pose graph + loop closure
  bench          — throughput benchmarks (bench/harness.py)
  make_synthetic — write a synthetic TUM-format sequence
  eval           — ATE/RPE of a trajectory file vs groundtruth

Every flag of the reference is accepted, plus `--device` (default
`cuda`; `cpu` runs the plain PyTorch twins).  `--async-backend` defers a
boundary chunk's loop-closure attempt to the next chunk's readback, and
with `--chunk-mode inline` (or per frame) runs the attempts on a worker
thread, on a CUDA stream of its own on the card.  `bench --coldstart`
prints the cold-start profile (bench/coldstart.py).  `bench --devices N`
runs in each of N processes started with `--coordinator`,
`--num-processes N` and `--process-id` (one process a GPU, each with its
own `--device cuda:K`; NCCL on the GPU, gloo with `--device cpu`).

Per-frame JSONL records (pose-free: frame, timestamp, ms, ICP iterations,
rms, inlier fraction, promotion, loss) go to --log-jsonl; one JSON summary
line (frames, keyframes, fps, fps_steady, closures, graph nodes, retained
clouds, map BA's cost and counts with --map-ba, ATE) goes to stdout; the depth decoder in use goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sequence", required=True, help="TUM sequence directory")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--config", default=None, help="JSON config file (SLAMConfig)")
    p.add_argument("--intrinsics", default=None, metavar="FX,FY,CX,CY",
                   help="override camera intrinsics (otherwise: the "
                        "sequence's intrinsics.txt if present, else guessed "
                        "from the freiburg1/2/3 sequence name)")
    p.add_argument("--traj-out", default=None, help="write TUM trajectory here")
    p.add_argument("--log-jsonl", default=None, help="per-frame JSONL metrics")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--checkpoint", default=None, help="write checkpoints here")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--viz-dir", default=None,
                   help="write trajectory/map PNG artifacts here (needs "
                        "matplotlib)")
    p.add_argument("--track-against-map", action="store_true",
                   help="refine every frame against the voxel map")
    p.add_argument("--map-track-mode", default="projective",
                   choices=("projective", "grid"),
                   help="frame-to-map association: reverse projective "
                        "(default) or grid-hash index probe")
    p.add_argument("--sharded-map", action="store_true",
                   help="shard the voxel map over the process group's ranks: "
                        "all-to-all fusion + ring frame-to-map tracking")
    p.add_argument("--map-ba", action="store_true",
                   help="final Schur-complement map bundle adjustment over "
                        "all keyframes (backend/map_ba.py)")
    p.add_argument("--progress", action="store_true",
                   help="print a live per-frame status line to stderr")
    p.add_argument("--async-backend", action="store_true",
                   help="boundary chunks: defer each chunk's loop-closure "
                        "attempt to the next chunk's readback; inline chunks "
                        "or per frame: run the attempts in a worker thread "
                        "(its own CUDA stream) overlapped with tracking")
    p.add_argument("--chunk", type=int, default=0,
                   help="process frames in chunks of this size (one readback "
                        "per chunk; run_slam only — backend work runs at "
                        "chunk boundaries, remainder frames step per frame)")
    p.add_argument("--upload-raw", action="store_true",
                   help="upload depth as raw uint16 counts, divided by "
                        "depth_scale on the device: 2 bytes/px and a "
                        "trajectory bit-equal to the float32 upload")
    p.add_argument("--upload-f16", action="store_true",
                   help="upload depth as float16 metres (~1.5 mm "
                        "quantization at 3 m; prefer --upload-raw for uint16 "
                        "sources)")
    p.add_argument("--lc-descriptor", action="store_true",
                   help="pose-free loop-closure candidates from depth "
                        "descriptors (drift-robust revisit proposal)")
    p.add_argument("--chunk-sub", type=int, default=8,
                   help="boundary-mode sub-chunk size: the keyframe-"
                        "promotion cadence floor; 1 reproduces per-frame "
                        "promotion while keeping one readback per --chunk")
    p.add_argument("--chunk-mode", default="boundary",
                   choices=("boundary", "inline"),
                   help="chunk promotion semantics (with --chunk): "
                        "'boundary' tracks each chunk against a frozen "
                        "keyframe and promotes at sub-chunk boundaries; "
                        "'inline' promotes mid-chunk like per-frame stepping")
    _add_runtime(p)


def _add_runtime(p: argparse.ArgumentParser) -> None:
    """The device and the multi-process launch flags (one process per GPU,
    the same program; the caller names the rendezvous)."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain PyTorch twins)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (starts torch.distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


@contextlib.contextmanager
def _distributed(args):
    """The default process group for the run, when --coordinator names
    one; NCCL on a GPU, gloo on the CPU."""
    if not getattr(args, "coordinator", None):
        yield
        return
    import torch
    import torch.distributed as dist

    from tpuslam_torch.dist.mesh import initialize_distributed

    backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
    initialize_distributed("tcp://" + args.coordinator, args.num_processes,
                           args.process_id, backend=backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _load_config(path):
    from tpuslam_torch.config import SLAMConfig

    if path is None:
        return SLAMConfig().validate()
    with open(path) as f:
        return SLAMConfig.from_json(f.read()).validate()


def _run_pipeline(args, use_slam: bool) -> int:
    import dataclasses

    import torch

    from tpuslam_torch.config import Intrinsics
    from tpuslam_torch.data import tum
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.frontend import Odometry, prefetch_to_device
    from tpuslam_torch.slam import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from tpuslam_torch.utils.metrics import JsonlLogger

    if args.viz_dir:
        from tpuslam_torch.viz import _plt

        _plt()            # no matplotlib: fail before the run, not after it
    cfg = _load_config(args.config)
    if args.lc_descriptor:
        cfg = cfg.replace(posegraph=dataclasses.replace(
            cfg.posegraph, lc_descriptor=True))
    seq = tum.TumSequence(args.sequence)
    if args.intrinsics:
        try:
            vals = [float(v) for v in args.intrinsics.split(",")]
        except ValueError:
            vals = []
        if len(vals) != 4 or vals[0] <= 0 or vals[1] <= 0:
            raise ValueError(
                f"--intrinsics must be FX,FY,CX,CY with FX,FY > 0 "
                f"(got {args.intrinsics!r})")
        K = Intrinsics(*vals)
    else:
        K = seq.intrinsics
    chunk = int(args.chunk or 0)
    if chunk > 1 and not use_slam:
        raise ValueError("--chunk requires run_slam")
    system = (
        SlamSystem(K, cfg,
                   track_against_map=args.track_against_map,
                   map_ba=args.map_ba,
                   map_track_mode=args.map_track_mode,
                   async_backend=args.async_backend,
                   sharded_map=args.sharded_map,
                   chunk_mode=args.chunk_mode,
                   chunk_sub=args.chunk_sub,
                   device=args.device)
        if use_slam
        else Odometry(K, cfg, keep_keyframe_clouds=False, device=args.device)
    )
    odo = system.odo if use_slam else system
    start = args.start
    if args.resume:
        start = load_checkpoint(args.resume, system)
        print(f"resumed at frame {start}", file=sys.stderr)
    print(f"depth decoder: {tum.decoder_note()}"
          + ("; depth_cache.npy is valid, no PNG is decoded"
             if seq.cached(cfg.depth_scale) else ""), file=sys.stderr)

    logger = JsonlLogger(args.log_jsonl) if args.log_jsonl else None
    t_start = time.perf_counter()
    n_done = 0
    # everything before the SECOND batch pays one-time costs (the kernels'
    # build and load, the allocator's first blocks): fps_steady leaves it out
    t_steady = {"t": None, "frames": 0}

    def after_frames(frames_done, per_frame_ms):
        nonlocal n_done
        if t_steady["t"] is None:
            t_steady["t"] = time.perf_counter()     # end of first batch
        else:
            t_steady["frames"] += len(frames_done)
        frame_base = odo.frame_idx - len(frames_done)
        stat_base = len(odo.stats) - len(frames_done)
        for k, frame in enumerate(frames_done):
            n_done += 1
            if logger:
                logger.write(frame=frame_base + k, timestamp=frame.timestamp,
                             ms=per_frame_ms, **odo.stats[stat_base + k])
        if args.checkpoint and (n_done % args.checkpoint_every
                                < len(frames_done)):
            save_checkpoint(args.checkpoint, system, odo.frame_idx)
        if args.progress:
            s = odo.stats[-1]
            print(f"\rframe {odo.frame_idx - 1}  {per_frame_ms:6.1f} ms  "
                  f"inl {s.get('inliers', 0):.2f}  kf {len(odo.keyframes)}",
                  end="", file=sys.stderr)

    frame_iter = seq.frames(depth_scale=cfg.depth_scale, start=start,
                            stop=args.stop, raw=args.upload_raw)
    if args.upload_f16 and not args.upload_raw:
        frame_iter = (f._replace(depth=f.depth.astype(np.float16))
                      for f in frame_iter)
    stream = prefetch_to_device(frame_iter, device=odo.device)
    if chunk > 1:
        # one readback per chunk; a remainder steps per frame.  The
        # prefetched depths are stacked on the device.
        buf: list = []

        def flush():
            if not buf:
                return
            t0 = time.perf_counter()
            if len(buf) == chunk:
                system.process_chunk(torch.stack([f.depth for f in buf]),
                                     [f.timestamp for f in buf])
            else:
                for f in buf:
                    system.process(f.depth, f.timestamp)
            ms = (time.perf_counter() - t0) * 1e3 / len(buf)
            after_frames(buf, ms)
            buf.clear()

        for frame in stream:
            buf.append(frame)
            if len(buf) == chunk:
                flush()
        flush()
    else:
        for frame in stream:
            t0 = time.perf_counter()
            system.process(frame.depth, frame.timestamp)
            after_frames([frame], (time.perf_counter() - t0) * 1e3)
    if args.progress:
        print(file=sys.stderr)
    wall = time.perf_counter() - t_start     # the reference's: to the last frame
    if use_slam:
        # drain the deferred backend, final loop-closure pass and global
        # optimization before the trajectory is read
        system.finalize()
        ts, poses = system.trajectory()
    else:
        ts = np.asarray(odo.timestamps)
        poses = np.stack(odo.trajectory)
    if args.traj_out:
        tum.write_trajectory(args.traj_out, ts, poses)

    summary = {
        "frames": int(len(ts)),
        "keyframes": len(odo.keyframes),
        "fps": len(ts) / wall if wall > 0 else 0.0,
        "wall_s": wall,
    }
    if t_steady["t"] is not None and t_steady["frames"] > 0:
        steady_wall = wall - (t_steady["t"] - t_start)
        if steady_wall > 0:
            summary["fps_steady"] = t_steady["frames"] / steady_wall
    if use_slam:
        summary["loop_closures"] = len(system.closures)
        summary["graph_nodes"] = system.graph.num_nodes
        # bounded by KeyframeConfig.max_keyframes + protected anchors
        summary["retained_clouds"] = sum(
            1 for r in odo.keyframes if r.cloud is not None)
        if system.map_ba_stats is not None:
            summary["map_ba"] = system.map_ba_stats
    if seq.groundtruth:
        gt_ts, gt_poses = [], []
        for i in range(len(seq)):
            T = seq.gt_pose(i)
            if T is not None:
                gt_ts.append(seq.depth_list[i][0])
                gt_poses.append(T)
        try:
            m = ate_rmse(ts, poses, np.asarray(gt_ts), np.asarray(gt_poses))
            summary["ate_rmse_m"] = m["rmse"]
            summary["ate_pairs"] = m["num_pairs"]
        except ValueError as e:
            summary["ate_error"] = str(e)
    if args.viz_dir:
        from tpuslam_torch.viz import write_run_report

        gt_for_viz = None
        if seq.groundtruth:
            gt_for_viz = [T for T in (seq.gt_pose(i) for i in range(len(seq)))
                          if T is not None]
        summary["viz_files"] = write_run_report(args.viz_dir, system,
                                                gt_for_viz)
    print(json.dumps(summary))
    if logger:
        logger.close()
    return 0


def cmd_run_odometry(args) -> int:
    with _distributed(args):
        return _run_pipeline(args, use_slam=False)


def cmd_run_slam(args) -> int:
    with _distributed(args):
        return _run_pipeline(args, use_slam=True)


def cmd_make_synthetic(args) -> int:
    from tpuslam_torch.config import Intrinsics
    from tpuslam_torch.data.synthetic import write_tum_sequence

    K = Intrinsics(args.fx, args.fx, args.width / 2 - 0.5,
                   args.height / 2 - 0.5)
    write_tum_sequence(args.out, args.frames, K, args.height, args.width,
                       noise=args.noise, rgb=args.rgb)
    print(json.dumps({"out": args.out, "frames": args.frames}))
    return 0


def cmd_eval(args) -> int:
    from tpuslam_torch.data.tum import read_trajectory
    from tpuslam_torch.eval.ate import ate_rmse, rpe

    est_ts, est = read_trajectory(args.trajectory)
    gt_ts, gt = read_trajectory(args.groundtruth)
    print(json.dumps({
        "ate": ate_rmse(est_ts, est, gt_ts, gt),
        "rpe": rpe(est_ts, est, gt_ts, gt),
    }))
    return 0


def cmd_bench(args) -> int:
    from tpuslam_torch.bench.harness import (
        bench_pathology,
        bench_scale,
        run_bench,
    )
    if args.coldstart:
        from tpuslam_torch.bench.coldstart import profile_coldstart

        print(json.dumps(profile_coldstart(
            frames=min(args.frames, 32), height=args.height,
            width=args.width, device=args.device)))
        return 0
    with _distributed(args):
        if args.scale:
            result = bench_scale(frames=args.frames, height=args.height,
                                 width=args.width, device=args.device)
        elif args.pathology:
            result = bench_pathology(frames=args.frames, height=args.height,
                                     width=args.width, device=args.device)
        else:
            # the odometry block, the loader and, as the reference's,
            # the full system: on --frames frames (the reference's fixed
            # 120 is the default)
            result = run_bench(frames=args.frames, height=args.height,
                               width=args.width, config_path=args.config,
                               devices=args.devices, device=args.device,
                               slam_frames=args.frames)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpuslam_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run_odometry", help="frame-to-keyframe odometry")
    _add_common(p)
    p.set_defaults(fn=cmd_run_odometry)

    p = sub.add_parser("run_slam", help="full SLAM with loop closure")
    _add_common(p)
    p.set_defaults(fn=cmd_run_slam)

    p = sub.add_parser("make_synthetic", help="write synthetic TUM sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--fx", type=float, default=160.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--rgb", action="store_true",
                   help="also write rgb/ PNGs + rgb.txt")
    p.set_defaults(fn=cmd_make_synthetic)

    p = sub.add_parser("eval", help="evaluate a trajectory file")
    p.add_argument("--trajectory", required=True)
    p.add_argument("--groundtruth", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--config", default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="time the point-sharded ICP over the process "
                        "group's ranks (must equal --num-processes)")
    p.add_argument("--scale", action="store_true",
                   help="run the BASELINE config-5 capacity benchmark "
                        "instead (multi-lap loop, tight promotion, tiny "
                        "initial graph capacity; pass --frames 2000 "
                        "--height 240 --width 320 for the recorded run)")
    p.add_argument("--pathology", action="store_true",
                   help="run the degraded-sensor benchmark instead (Kinect "
                        "z²-noise + dropout holes + rotation burst)")
    p.add_argument("--coldstart", action="store_true",
                   help="cold-start profile of a fresh process: imports, "
                        "CUDA context, the kernels' build or load, upload, "
                        "and each program's first and second run "
                        "(--frames capped at 32)")
    _add_runtime(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: invalid JSON in config/trajectory file: {e}",
              file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
