"""Write the reference's full-width results for the port to be held to.

    JAX_PLATFORMS=cpu python tests/torch_reference_poses.py [OUT.npz]
        [--jobs N] [--keep DIR]

Runs the JAX package (`tpuslam`) on the CPU and writes
`tpuslam_torch/bench/data/reference_vga.npz` (or OUT.npz), which the port
reads with numpy alone.  Each pass runs in a process of its own, `--jobs`
(default 4) at a time.  Every pass mirrors, option by option, the port's
runner that `chip_smoke.py` drives at full width (`tpuslam_torch/bench/
harness.py`), on the inputs that runner renders:

  * `orbit_{classic,boundary,fused}_*`: the 240-frame 640×480 orbit of
    `bench.py` at the defaults, `run_bench`'s scans: the classic scan
    (`scan_odometry_jit`), the boundary scan (chunks of 8) and the classic
    scan with `fused_gn=True`: poses, promotion flags, inlier fractions;
  * `loop_<variant>_*`: the 120-frame 640×480 two-lap loop of
    `bench_slam` / `run_slam_bench` at `loop_config` (lc_min_gap 8):
    `per_frame` (backend synchronous), `chunked` (boundary chunks of 8,
    `chunk_sub=4`, synchronous), `deferred` (the same, `async_backend=
    True`), `fused_chunked` (`chunked` with `fused_gn=True`),
    `fused_deferred` (`deferred` with `fused_gn=True`), `chunked_inline`
    (inline chunks of 8, synchronous) and `worker` (per frame with the
    backend on the worker thread: `async_backend=True`, inline mode);
  * `cli_slam_*` and `cli_odometry_*`: the reference's own CLI
    (`tpuslam.cli.main`) on that loop written to disk by its own
    `write_tum_sequence` (16-bit PNG depth, TUM's layout) and read back:
    `run_slam --config <loop_config> --chunk 8 --chunk-sub 4
    --async-backend --upload-raw` and `run_odometry --config
    <loop_config>`, the poses caught at full precision where the CLI
    writes its trajectory file, the keyframes and closures from the
    system it made; `cli_slam_depth_sha256` is each decoded depth PNG's
    sha256 (uint16 counts), so a reader checks that its own writer made
    the same input;
  * `drift_{off,on}_*`: slam-drift-vga, that loop deferred with 0.012 m of
    world-anchor bias before every chunk but the first, `drift_config`'s
    gates, `lc_descriptor` off / on;
  * `map_projective_*`, `map_grid_*` and `map_sharded_*`: `run_map_bench`
    over that loop, `track_against_map=True` per frame then `finalize`;
    the grid pass with `map_track_mode="grid"` and `map_ba=True`; the
    sharded pass with `sharded_map=True` (the ring on one device; no short
    run: its pass takes ~10 min on a CPU, `map_sharded_seconds`);
  * `scale_*`: `bench_scale`, 2,000 frames 320×240, chunks of 32;
  * `pathology_*`: `bench_pathology`, 60 degraded 640×480 frames.

For every SLAM pass: per-frame poses (`trajectory()`), the keyframes'
frame indices, the closure pairs (i, j), the ATE (`max_difference=0.005`;
the CLI passes: the CLI's own summary) and the pass's seconds, with the
extras of `record`.  `<prefix>_short_*`
is the same pass over the first SHORT[prefix] frames of the same inputs
(rendered at the full length and cut), then `finalize`: the port's CPU
tests run those.

For each run of SPREAD_RUNS the reference is rerun with `voxel.origin`
moved by each of SPREAD_DELTAS m: `<p>_spread` is the per-frame maximum
over those runs of the largest pose-element difference from the unmoved
run, `<p>_span_keyframes` / `<p>_span_closures` the least and greatest
counts over all five runs, `<p>_ate_max_m` the largest ATE of the five,
and `<p>_stable` whether the largest spread is at most STABLE_SPREAD with
keyframes and closure pairs equal in all five runs.  The worker pass
(`loop_worker`, and its short run) is perturbed in its timing instead:
it is rerun with the worker never behind (tracking waits after each
frame for every attempt queued), with each of its attempts delayed by
each of WORKER_DELAYS s, and with every attempt held until `finalize`
(the attempt `finalize` makes on the main thread is never delayed); its
spread is over those eight runs, and it adds `<p>_closure_union` (every
closure pair of the eight) and `<p>_keyframes_fixed` (their keyframes
equal).  Its short run is the shortest prefix of the loop on which the
undelayed run closes a loop (WORKER_SHORT).  The grid pass adds
`<p>_spread_before_ba` (its poses before map BA) and `<p>_span_map_ba_obs`
/ `<p>_span_map_ba_cost` (map BA's observation count and final cost, least
and greatest of the five).  A pass without a spread (the whole scale
run's is left out: see SPREAD_RUNS) is held as a stable one.

The pathology pass keeps no map and closes no loop, so a moved voxel
origin does not perturb it: its depth is moved by each of PATHOLOGY_ULPS
float32 ulps instead, and `pathology_rounding_spread` is the per-frame
maximum of those runs' pose difference.  It is not a spread of the rule
above: it makes no pass chaotic, and only the port's CPU pathology test
reads it.

`--keep DIR` keeps each job's result in DIR and runs only the jobs whose
result is missing there and whose pass OUT does not hold yet: where OUT
was written from the same `tpuslam` files (their blob hashes) and the
same configs, its entries of a pass are kept as they are.  So, after a
pass is added here, `--jobs N --keep DIR` runs that pass alone; delete OUT
first to rerun every pass (after a change to how this script drives a
pass; after a change to `tpuslam` nothing is kept anyway).

Not a test module and not part of the test run: tests/
test_torch_reference_file.py checks the file is current and holds the
orbit and the synchronous loop passes; test_torch_reference_passes.py and
test_torch_reference_map.py and test_torch_reference_cli.py hold the
port's short runs to it on the CPU;
chip_smoke.py holds the card's full-width runs to it.  Rerun it when a
default of `tpuslam.config` or the synthetic scene changes (the first of
those tests fails on a stale file).
"""

import argparse
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUT = ROOT / "tpuslam_torch" / "bench" / "data" / "reference_vga.npz"
HEIGHT, WIDTH = 480, 640
ORBIT_FRAMES = 240          # bench.py's default
LOOP_FRAMES = 120           # bench_slam's default
LOOP_CYCLES = 2
CHUNK = 8                   # the boundary scan's and bench_slam's chunk
CHUNK_SUB = 4               # bench_slam's promotion sub-chunk
ATE_MAX_DIFFERENCE = 0.005  # bench_slam's association window
DRIFT_PER_CHUNK = 0.012     # m a chunk, tests/test_descriptor_lc.py:33
SCALE_FRAMES, SCALE_HEIGHT, SCALE_WIDTH = 2000, 240, 320
SCALE_CYCLES, SCALE_CHUNK = 5, 32
PATHOLOGY_FRAMES = 60
KINECT_NOISE = 0.0019       # bench_pathology's z² coefficient
WORKER_SHORT = 59           # the worker's first closure (module doc)
SHORT = {"loop_deferred": 24, "loop_fused_chunked": 24, "drift_off": 24,
         "drift_on": 24, "map_projective": 24, "map_grid": 24, "scale": 200,
         "pathology": 60, "loop_chunked_inline": 24,
         "loop_fused_deferred": 24, "loop_worker": WORKER_SHORT,
         "cli_slam": 24, "cli_odometry": 24}
# the runs rerun for the reference's own spread: the map, grid and drift
# passes and their short runs, and the scale pass's short run (one whole
# scale run takes 19-62 min on an 8-core CPU, past the ~15 min a spread run
# may take: its spread is left out)
SPREAD_RUNS = ("map_projective", "map_projective_short", "map_grid",
               "map_grid_short", "drift_on", "drift_on_short", "scale_short",
               "loop_worker", "loop_worker_short")
SPREAD_DELTAS = (-2e-4, -1e-4, 1e-4, 2e-4)
# the worker pass's reruns: the worker never behind (-inf: tracking waits
# after each frame until every queued attempt is committed, as if each took
# no time), each worker attempt delayed by these seconds (a frame of this
# loop takes ~0.3 s here: the last two put the worker a frame or more
# behind its tracking), then every one held until finalize (inf) --
# together they bracket any speed a worker can have against its tracking
WORKER_DELAYS = (0.002, 0.010, 0.050, 0.25, 1.0)
# the pathology pass (its own short run) is rerun with its depth moved by
# these ulps (module doc): the rounding-level difference a backend makes
# (the port's transform is 1 ulp from XLA's in ~28% of points)
PATHOLOGY_ULPS = (-2, -1, 1, 2)
STABLE_SPREAD = 1e-4


def perturbations(prefix: str) -> list:
    """(job suffix, delta) of each rerun of a spread run or of the
    pathology pass."""
    if prefix.startswith("pathology"):
        return [(f"@{u:+d}ulp", u) for u in PATHOLOGY_ULPS]
    if prefix.startswith("loop_worker"):
        return [("@never_behind", -np.inf)] + [
            (f"@{1e3 * d:g}ms", d) for d in WORKER_DELAYS] + [
            ("@finalize", np.inf)]
    return [(f"@{d:+.0e}", d) for d in SPREAD_DELTAS]


# ---- configs: each the port's runner's, built from `tpuslam.config` ----

def orbit_config(fused: bool = False):
    """`run_bench`'s config: the defaults at 640×480 (`fused_gn` on for
    the fused scan)."""
    from tpuslam.config import SLAMConfig

    cfg = SLAMConfig().replace(height=HEIGHT, width=WIDTH)
    if fused:
        cfg = cfg.replace(icp=dataclasses.replace(cfg.icp, fused_gn=True))
    return cfg


def loop_config(fused: bool = False):
    """`slam_bench_config`: the defaults at 640×480, lc_min_gap 8 (also
    `run_map_bench`'s)."""
    from tpuslam.config import ICPConfig, SLAMConfig

    cfg = SLAMConfig(height=HEIGHT, width=WIDTH, icp=ICPConfig(
        fused_gn=fused))
    return cfg.replace(posegraph=dataclasses.replace(cfg.posegraph,
                                                     lc_min_gap=8))


def drift_config(lc_descriptor: bool):
    """slam-drift-vga's config (`harness.drift_config`): `loop_config`
    with tests/test_descriptor_lc.py's loop-closure gates."""
    base = loop_config()
    return base.replace(
        keyframe=dataclasses.replace(base.keyframe, verify_level=1),
        posegraph=dataclasses.replace(
            base.posegraph, lc_min_gap=3, lc_max_dist=0.02,
            lc_max_residual=0.05, lc_min_inliers=0.3,
            lc_descriptor=lc_descriptor))


def scale_config():
    """`bench_scale`'s config: tests/test_config5_scale.py's at 320×240."""
    from tpuslam.config import (
        KeyframeConfig,
        PoseGraphConfig,
        SLAMConfig,
        VoxelConfig,
    )

    return SLAMConfig(
        height=SCALE_HEIGHT, width=SCALE_WIDTH,
        keyframe=KeyframeConfig(max_translation=0.015, max_rotation=0.03,
                                max_keyframes=48, sparsify_protect_recent=4),
        posegraph=PoseGraphConfig(max_nodes=32, max_edges=64, gn_iters=15,
                                  solver="auto", dense_max_nodes=256,
                                  lc_min_gap=20, lc_max_dist=0.08,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 12, map_capacity=1 << 15))


def pathology_config():
    """`bench_pathology`'s config: the defaults at 640×480."""
    from tpuslam.config import SLAMConfig

    return SLAMConfig(height=HEIGHT, width=WIDTH)


def configs() -> dict:
    """Every pass's config as `SLAMConfig.to_json` (the file keeps them)."""
    return {"orbit": orbit_config(), "orbit_fused": orbit_config(True),
            "loop": loop_config(), "loop_fused": loop_config(True),
            "cli": loop_config(),
            "drift_off": drift_config(False), "drift_on": drift_config(True),
            "scale": scale_config(), "pathology": pathology_config()}


def moved(cfg, delta: float):
    """`cfg` with its voxel grid's origin moved by `delta` m."""
    return cfg.replace(voxel=dataclasses.replace(
        cfg.voxel, origin=cfg.voxel.origin + delta))


# ---- inputs: each rendered as the port's runner renders it ----

def intrinsics(height: int, width: int):
    from tpuslam.config import Intrinsics

    return Intrinsics(525.0 * width / 640.0, 525.0 * height / 480.0,
                      width / 2 - 0.5, height / 2 - 0.5)


def loop_inputs(frames: int):
    """K, ground truth and depth of the first `frames` frames of the
    120-frame 640×480 two-lap loop."""
    from tpuslam.data.synthetic import loop_trajectory, render_depth

    K = intrinsics(HEIGHT, WIDTH)
    gt = loop_trajectory(LOOP_FRAMES, cycles=LOOP_CYCLES, radius=0.35)
    return K, gt[:frames], np.stack(
        [render_depth(gt[i], K, HEIGHT, WIDTH, seed=i)
         for i in range(frames)]).astype(np.float32)


def scale_inputs(frames: int):
    from tpuslam.data.synthetic import loop_trajectory, render_depth

    K = intrinsics(SCALE_HEIGHT, SCALE_WIDTH)
    gt = loop_trajectory(SCALE_FRAMES, cycles=SCALE_CYCLES)
    return K, gt[:frames], np.stack(
        [render_depth(gt[i], K, SCALE_HEIGHT, SCALE_WIDTH, seed=i)
         for i in range(frames)]).astype(np.float32)


def pathology_inputs(frames: int):
    from tpuslam.data.synthetic import (
        burst_trajectory,
        degrade_depth,
        render_depth,
    )

    K = intrinsics(HEIGHT, WIDTH)
    gt = burst_trajectory(PATHOLOGY_FRAMES, burst_start=PATHOLOGY_FRAMES // 2,
                          burst_len=8, burst_rate=0.05)
    return K, gt[:frames], np.stack([
        degrade_depth(render_depth(gt[i], K, HEIGHT, WIDTH, seed=i),
                      seed=100 + i, z_noise_coeff=KINECT_NOISE,
                      dropout_holes=3, edge_dropout=0.02)
        for i in range(frames)]).astype(np.float32)


# ---- loops: the port's runners' loops over the reference's system ----

def run_chunked(slam, d, ts, chunk: int) -> None:
    """Whole chunks through process_chunk, the remainder per frame, then
    finalize (`harness._run_chunked`)."""
    full = d.shape[0] - d.shape[0] % chunk
    for i in range(0, full, chunk):
        slam.process_chunk(d[i:i + chunk], ts[i:i + chunk])
    for i in range(full, d.shape[0]):
        slam.process(d[i], timestamp=ts[i])
    slam.finalize()


def drive_drifted(slam, d, ts, chunk: int = CHUNK) -> None:
    """`harness.drive_drifted` over every frame, then finalize."""
    bias = np.eye(4, dtype=np.float32)
    bias[2, 3] = DRIFT_PER_CHUNK
    for i in range(0, d.shape[0], chunk):
        if i > 0:
            slam.odo.T_world_kf = bias @ slam.odo.T_world_kf.astype(
                np.float32)
        slam.process_chunk(d[i:i + chunk], ts[i:i + chunk])
    slam.finalize()


def record(slam, ts, gt) -> dict:
    """A SLAM pass's result: poses, keyframe frame indices, closure pairs,
    ATE, lost flags, graph nodes."""
    from tpuslam.eval.ate import ate_rmse

    t_est, est = slam.trajectory()
    return {
        "poses": np.asarray(est, np.float64),
        "keyframes": np.asarray([k.index for k in slam.odo.keyframes],
                                np.int64),
        "closures": np.asarray([(c.i, c.j) for c in slam.closures],
                               np.int64).reshape(-1, 2),
        "ate_rmse_m": np.float64(ate_rmse(
            t_est, est, ts, gt, max_difference=ATE_MAX_DIFFERENCE)["rmse"]),
        "lost": np.asarray([bool(s.get("lost")) for s in slam.odo.stats]),
        "graph_nodes": np.int64(slam._num_graph_nodes),
    }


def ulp_moved(d: np.ndarray, ulps: int) -> np.ndarray:
    """Depth with every valid pixel moved by `ulps` float32 ulps (zeros,
    the missing pixels, stay zero)."""
    out = d.copy()
    for _ in range(abs(ulps)):
        out = np.nextafter(out, np.float32(np.inf if ulps > 0 else -np.inf),
                           dtype=np.float32)
    out[~(d > 0)] = d[~(d > 0)]
    return out


def delay_worker(slam, delay: float) -> None:
    """Delay each loop-closure attempt of `slam`'s worker thread by `delay`
    s (inf: hold each until `finalize` is called; -inf: none, but tracking
    waits after each frame until every attempt queued so far is
    committed, so the worker is never behind).  The attempt `finalize`
    makes on the main thread runs at once."""
    attempt, finalize, process = (slam._attempt_loop_closure, slam.finalize,
                                  slam.process)
    released, committed = threading.Event(), threading.Condition()
    count = {"queued": 0, "done": 0}
    put = slam._backend_queue.put

    def counted(item, *a, **k):
        if item is not None:
            with committed:
                count["queued"] += 1
        put(item, *a, **k)

    def delayed():
        if threading.current_thread() is not slam._backend_thread:
            return attempt()
        try:
            if delay == np.inf:
                released.wait()
            elif delay > 0:
                time.sleep(delay)
            return attempt()
        finally:
            with committed:
                count["done"] += 1
                committed.notify_all()

    def waiting(*a, **k):
        out = process(*a, **k)
        with committed:
            committed.wait_for(lambda: count["done"] == count["queued"])
        return out

    def releasing():
        released.set()
        finalize()

    slam._backend_queue.put = counted
    slam._attempt_loop_closure = delayed
    slam.finalize = releasing
    if delay == -np.inf:
        slam.process = waiting


def run_pass(name: str, frames: int, delta: float = 0.0) -> dict:
    """One SLAM pass of the reference (module doc) over its first `frames`
    frames, the voxel origin moved by `delta` m (the pathology pass: its
    depth moved by `delta` ulps; the worker pass: its attempts delayed by
    `delta` s)."""
    import jax.numpy as jnp

    from tpuslam.slam import SlamSystem

    if name.startswith("cli_"):
        return run_cli(name, frames)
    if name == "scale":
        K, gt, d = scale_inputs(frames)
    elif name == "pathology":
        K, gt, d = pathology_inputs(frames)
        d, delta = ulp_moved(d, int(delta)), 0.0
    else:
        K, gt, d = loop_inputs(frames)
    dev = jnp.asarray(d)
    ts = np.arange(frames) / 30.0
    extra: dict = {}
    t0 = time.perf_counter()
    if name.startswith("map_"):
        grid = name == "map_grid"
        slam = SlamSystem(K, moved(loop_config(), delta),
                          enable_loop_closure=True, track_against_map=True,
                          map_track_mode="grid" if grid else "projective",
                          map_ba=grid, sharded_map=name == "map_sharded")
        for i in range(frames):
            slam.process(dev[i], timestamp=ts[i])
        if grid:
            extra["poses_before_ba"] = slam.trajectory()[1]
        slam.finalize()
        extra["map_size"] = np.int64(slam.map.size())
        extra["refine_ok"] = np.asarray(
            [s["ok"] for s in slam.map_refine_stats])
        if grid:
            ba = slam.map_ba_stats or {}
            extra["map_ba_num_obs"] = np.int64(ba.get("num_obs", -1))
            extra["map_ba_cost"] = np.float64(ba.get("cost", np.nan))
    elif name.startswith("drift_"):
        slam = SlamSystem(K, moved(drift_config(name == "drift_on"), delta),
                          enable_loop_closure=True, async_backend=True,
                          chunk_mode="boundary", chunk_sub=CHUNK_SUB)
        drive_drifted(slam, dev, ts)
    elif name == "scale":
        slam = SlamSystem(K, moved(scale_config(), delta),
                          enable_loop_closure=True, chunk_mode="boundary",
                          async_backend=True, chunk_sub=1)
        run_chunked(slam, dev, ts, SCALE_CHUNK)
    elif name == "pathology":
        slam = SlamSystem(K, moved(pathology_config(), delta),
                          enable_loop_closure=True, chunk_mode="boundary",
                          async_backend=True)
        run_chunked(slam, dev, ts, CHUNK)
    elif name == "loop_worker":
        slam = SlamSystem(K, loop_config(), enable_loop_closure=True,
                          async_backend=True, chunk_mode="inline",
                          chunk_sub=CHUNK_SUB)
        if delta:
            delay_worker(slam, delta)
        run_chunked(slam, dev, ts, 1 << 30)
    else:
        cfg = moved(loop_config(name in ("loop_fused_chunked",
                                         "loop_fused_deferred")), delta)
        if name == "loop_per_frame":
            slam = SlamSystem(K, cfg, enable_loop_closure=True,
                              async_backend=False)
            run_chunked(slam, dev, ts, 1 << 30)
        else:
            slam = SlamSystem(
                K, cfg, enable_loop_closure=True,
                async_backend=name in ("loop_deferred",
                                       "loop_fused_deferred"),
                chunk_mode=("inline" if name == "loop_chunked_inline"
                            else "boundary"), chunk_sub=CHUNK_SUB)
            run_chunked(slam, dev, ts, CHUNK)
    seconds = time.perf_counter() - t0
    return {**record(slam, ts, gt), **extra, "seconds": np.float64(seconds)}


def depth_hashes(seq: str, frames: int) -> np.ndarray:
    """sha256 of each of the first `frames` depth PNGs of the TUM sequence
    `seq`, decoded to uint16 counts by the reference's loader."""
    from tpuslam.data.tum import TumSequence

    return np.asarray([
        hashlib.sha256(np.ascontiguousarray(f.depth, "<u2").tobytes())
        .hexdigest()
        for f in TumSequence(seq).frames(stop=frames, raw=True)])


def run_cli(name: str, frames: int) -> dict:
    """The reference's CLI (`cli_slam`: run_slam, `cli_odometry`:
    run_odometry) over the first `frames` frames of the loop written to
    disk by its own writer (module doc).  The poses are the ones the CLI
    hands to `write_trajectory`; the keyframes and closures those of the
    system it made."""
    from contextlib import redirect_stdout

    import tpuslam.frontend
    import tpuslam.slam
    from tpuslam import cli
    from tpuslam.data import tum
    from tpuslam.data.synthetic import loop_trajectory, write_tum_sequence

    made, written = [], {}
    slam_cls, odo_cls = tpuslam.slam.SlamSystem, tpuslam.frontend.Odometry
    write_trajectory = tum.write_trajectory

    def kept(cls):
        class Kept(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)
        return Kept

    def capture(path, ts, poses):
        written["poses"] = np.array(poses)
        write_trajectory(path, ts, poses)

    with tempfile.TemporaryDirectory() as tmp:
        seq, cfg_path = f"{tmp}/seq", f"{tmp}/cfg.json"
        write_tum_sequence(seq, LOOP_FRAMES, intrinsics(HEIGHT, WIDTH),
                           HEIGHT, WIDTH, poses=loop_trajectory(
                               LOOP_FRAMES, cycles=LOOP_CYCLES, radius=0.35))
        with open(cfg_path, "w") as f:
            f.write(loop_config().to_json())
        argv = (["run_slam", "--sequence", seq, "--config", cfg_path,
                 "--chunk", str(CHUNK), "--chunk-sub", str(CHUNK_SUB),
                 "--async-backend", "--upload-raw"]
                if name == "cli_slam" else
                ["run_odometry", "--sequence", seq, "--config", cfg_path])
        argv += ["--stop", str(frames), "--traj-out", f"{tmp}/traj.txt"]
        buf = io.StringIO()
        tpuslam.slam.SlamSystem = kept(slam_cls)
        tpuslam.frontend.Odometry = kept(odo_cls)
        tum.write_trajectory = capture
        t0 = time.perf_counter()
        try:
            with redirect_stdout(buf):
                rc = cli.main(argv)
        finally:
            tpuslam.slam.SlamSystem, tpuslam.frontend.Odometry = (slam_cls,
                                                                  odo_cls)
            tum.write_trajectory = write_trajectory
        seconds = time.perf_counter() - t0
        if rc:
            raise RuntimeError(f"{' '.join(argv)}: exit {rc}")
        hashes = depth_hashes(seq, frames)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    system = made[-1]
    odo = system.odo if name == "cli_slam" else system
    out = {"poses": np.asarray(written["poses"], np.float64),
           "keyframes": np.asarray([k.index for k in odo.keyframes],
                                   np.int64),
           "closures": np.asarray([(c.i, c.j) for c in getattr(
               system, "closures", [])], np.int64).reshape(-1, 2),
           "ate_rmse_m": np.float64(summary["ate_rmse_m"]),
           "lost": np.asarray([bool(s.get("lost")) for s in odo.stats]),
           "depth_sha256": hashes, "seconds": np.float64(seconds)}
    if name == "cli_slam":
        out["graph_nodes"] = np.int64(system._num_graph_nodes)
    return out


def run_orbit() -> dict:
    """`run_bench`'s three scans of the 240-frame orbit."""
    import jax.numpy as jnp

    from tpuslam.bench.harness import _render_sequence
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.frontend import scan_odometry_boundary_jit, scan_odometry_jit

    K, gt, depths = _render_sequence(ORBIT_FRAMES, HEIGHT, WIDTH)
    d = jnp.asarray(depths)
    ts = np.arange(ORBIT_FRAMES, dtype=np.float64)
    out = {}
    for name, run in (
            ("classic", lambda: scan_odometry_jit(d, K, orbit_config())),
            ("boundary", lambda: scan_odometry_boundary_jit(
                d, K, orbit_config(), CHUNK)),
            ("fused", lambda: scan_odometry_jit(d, K, orbit_config(True)))):
        t0 = time.perf_counter()
        poses, promote, inliers = (np.asarray(a) for a in run())
        out[f"orbit_{name}_seconds"] = np.float64(time.perf_counter() - t0)
        out[f"orbit_{name}_poses"] = poses
        out[f"orbit_{name}_promote"] = promote
        out[f"orbit_{name}_inliers"] = inliers
        out[f"orbit_{name}_keyframes"] = np.nonzero(promote)[0].astype(
            np.int64)
        out[f"orbit_{name}_closures"] = np.zeros((0, 2), np.int64)
        n = poses.shape[0]
        out[f"orbit_{name}_ate_rmse_m"] = np.float64(ate_rmse(
            ts[:n], poses.astype(np.float64), ts[:n], gt[:n])["rmse"])
    return out


# ---- jobs: one process each ----

def jobs() -> list:
    """(job name, pass, frames, origin delta) of every run the file
    needs."""
    out = [("orbit", "orbit", ORBIT_FRAMES, 0.0)]
    full = {"loop_per_frame": LOOP_FRAMES, "loop_chunked": LOOP_FRAMES,
            **{p: LOOP_FRAMES for p in ("loop_deferred", "loop_fused_chunked",
                                        "loop_fused_deferred",
                                        "loop_chunked_inline", "loop_worker",
                                        "cli_slam", "cli_odometry",
                                        "drift_off", "drift_on",
                                        "map_projective", "map_grid",
                                        "map_sharded")},
            "scale": SCALE_FRAMES, "pathology": PATHOLOGY_FRAMES}
    for p, n in full.items():
        lengths = {p: n}
        if p in SHORT and SHORT[p] != n:
            lengths[f"{p}_short"] = SHORT[p]
        for prefix, frames in lengths.items():
            out.append((prefix, p, frames, 0.0))
            if prefix in SPREAD_RUNS or prefix == "pathology":
                out += [(prefix + sfx, p, frames, d)
                        for sfx, d in perturbations(prefix)]
    return out


def run_job(name: str, into: Path) -> None:
    spec = {j[0]: j for j in jobs()}[name]
    _, p, frames, delta = spec
    rec = run_orbit() if p == "orbit" else run_pass(p, frames, delta)
    np.savez(into / f"{name}.npz", **rec,
             blobs=np.asarray(json.dumps(reference_blobs())))


def pose_spread(base: dict, runs: list, key: str = "poses") -> np.ndarray:
    """Per frame, the largest pose-element difference of `runs` from
    `base`."""
    return np.max([np.abs(r[key] - base[key]).max(axis=(1, 2))
                   for r in runs], axis=0)


def span(values) -> np.ndarray:
    """The least and greatest of `values`."""
    return np.asarray([min(values), max(values)])


def spread(base: dict, runs: list, prefix: str) -> dict:
    """The reference's own spread over the moved-origin runs, or over the
    worker's delayed runs (module doc)."""
    every = [base] + runs
    diff = pose_spread(base, runs)
    kfs = [r["keyframes"].size for r in every]
    cls = [r["closures"].shape[0] for r in every]
    same_kf = all(np.array_equal(r["keyframes"], base["keyframes"])
                  for r in runs)
    same = same_kf and all(np.array_equal(r["closures"], base["closures"])
                           for r in runs)
    out = {}
    if prefix.startswith("loop_worker"):
        union = sorted({tuple(c) for r in every
                        for c in r["closures"].tolist()})
        out = {f"{prefix}_closure_union": np.asarray(
                   union, np.int64).reshape(-1, 2),
               f"{prefix}_keyframes_fixed": np.bool_(same_kf)}
    if "map_ba_num_obs" in base:
        out = {f"{prefix}_spread_before_ba": pose_spread(
                   base, runs, "poses_before_ba"),
               f"{prefix}_span_map_ba_obs": span(
                   [int(r["map_ba_num_obs"]) for r in every]),
               f"{prefix}_span_map_ba_cost": span(
                   [float(r["map_ba_cost"]) for r in every])}
    return {**out, f"{prefix}_spread": diff,
            f"{prefix}_span_keyframes": span(kfs).astype(np.int64),
            f"{prefix}_span_closures": span(cls).astype(np.int64),
            f"{prefix}_spread_ates": np.asarray(
                [r["ate_rmse_m"] for r in every], np.float64),
            f"{prefix}_ate_max_m": np.float64(max(r["ate_rmse_m"]
                                                  for r in every)),
            f"{prefix}_spread_seconds": np.float64(sum(r["seconds"]
                                                       for r in runs)),
            f"{prefix}_stable": np.bool_(float(diff.max()) <= STABLE_SPREAD
                                         and same)}


def blob_hash(path: Path) -> str:
    """git's blob hash of a file (`git hash-object`)."""
    data = path.read_bytes()
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def reference_blobs() -> dict:
    """{path in the repo: blob hash} of every imported `tpuslam` file."""
    pkg = ROOT / "tpuslam"
    out = {}
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and Path(f).resolve().is_relative_to(pkg):
            p = Path(f).resolve()
            out[str(p.relative_to(ROOT))] = blob_hash(p)
    return dict(sorted(out.items()))


def owner(key: str, prefixes) -> str | None:
    """The pass whose entry `key` is: the longest of `prefixes` it starts
    with (`loop_chunked_inline_poses` is loop_chunked_inline's, not
    loop_chunked's)."""
    return max((p for p in prefixes if key.startswith(p + "_")), key=len,
               default=None)


def kept_passes(path: Path) -> dict:
    """The entries of the passes that the file at `path` holds, by pass,
    where it was written from today's `tpuslam` files and configs (module
    doc, `--keep`); {} otherwise."""
    if not path.exists():
        return {}
    with np.load(path) as z:
        old = {k: z[k] for k in z.files}
    now = {k: c.to_json() for k, c in configs().items()}
    was = json.loads(str(old["configs"]))
    blobs = json.loads(str(old["reference_blobs"]))
    if any(was[k] != now[k] for k in was.keys() & now.keys()) or any(
            not (ROOT / f).exists() or blob_hash(ROOT / f) != b
            for f, b in blobs.items()):
        return {}
    names = {j[0] for j in jobs() if "@" not in j[0]}
    short = json.loads(str(old["short_frames"]))
    out: dict = {}
    for k, v in old.items():
        p = owner(k, names)
        if p is not None and short.get(p.removesuffix("_short")) == SHORT.get(
                p.removesuffix("_short")):
            out.setdefault(p, {})[k] = v
    out["blobs"] = blobs
    return {p: e for p, e in out.items()
            if p == "blobs" or f"{p}_poses" in e or p == "orbit"}


def main(argv) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=str(OUT))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--keep", help="a directory for each job's result; a "
                    "job whose result is there already is not run again")
    ap.add_argument("--job", help=argparse.SUPPRESS)
    ap.add_argument("--into", help=argparse.SUPPRESS)
    args = ap.parse_args(argv[1:])
    if args.job:
        run_job(args.job, Path(args.into))
        return 0

    t_all = time.perf_counter()
    kept = kept_passes(Path(args.out)) if args.keep else {}
    todo = [j for j in jobs() if j[0].split("@")[0] not in kept]
    if kept:
        print(f"kept from {args.out}: {', '.join(sorted(kept))}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if args.keep:
            tmp = args.keep
            os.makedirs(tmp, exist_ok=True)

        def one(job):
            if (Path(tmp) / f"{job[0]}.npz").exists():
                return 0.0
            t0 = time.perf_counter()
            done = subprocess.run([sys.executable, __file__, "--job", job[0],
                                   "--into", tmp], capture_output=True,
                                  text=True)
            if done.returncode:
                raise RuntimeError(f"job {job[0]}: exit {done.returncode}\n"
                                   f"{done.stderr[-4000:]}")
            s = time.perf_counter() - t0
            print(f"job {job[0]}: {s:.1f} s", flush=True)
            return s

        # the longest first, so the pool ends together
        order = sorted(todo, key=lambda j: -j[2] * {
            "map_grid": 4, "map_sharded": 40}.get(j[1], 1))
        with ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(one, order))
        runs = {j[0]: dict(np.load(Path(tmp) / f"{j[0]}.npz"))
                for j in todo}
    blobs: dict = kept.pop("blobs", {})
    for rec in runs.values():
        blobs.update(json.loads(str(rec.pop("blobs"))))
    out: dict = {}
    for entries in kept.values():
        out.update(entries)
    # the CLI passes read one sequence: one copy of its depth hashes
    hashes = {n: rec.pop("depth_sha256") for n, rec in runs.items()
              if "depth_sha256" in rec}
    for n, h in hashes.items():
        if n.split("@")[0] != "cli_slam":
            want = hashes.get("cli_slam", out.get("cli_slam_depth_sha256"))
            assert want is not None and (h == want[:h.size]).all(), n
    if "cli_slam" in hashes:
        out["cli_slam_depth_sha256"] = hashes["cli_slam"]
    for name, rec in runs.items():
        if "@" in name:
            continue
        if name == "orbit":
            out.update(rec)
            continue
        out.update({f"{name}_{k}": v for k, v in rec.items()})
        moved_runs = [runs.get(name + sfx) for sfx, _ in perturbations(name)]
        if name in SPREAD_RUNS:
            out.update(spread(rec, moved_runs, name))
        elif name == "pathology":
            out["pathology_rounding_spread"] = pose_spread(rec, moved_runs)
    # the pathology pass is its own short run
    for k in [k for k in out if k.startswith("pathology_")
              and "pathology" in runs]:
        out[k.replace("pathology_", "pathology_short_", 1)] = out[k]
    for k in ("scale_poses", "scale_short_poses"):   # the capacity run's
        out[k] = out[k].astype(np.float32)
    out.update(
        height=np.int64(HEIGHT), width=np.int64(WIDTH),
        orbit_frames=np.int64(ORBIT_FRAMES), loop_frames=np.int64(LOOP_FRAMES),
        loop_cycles=np.int64(LOOP_CYCLES), chunk=np.int64(CHUNK),
        chunk_sub=np.int64(CHUNK_SUB),
        ate_max_difference=np.float64(ATE_MAX_DIFFERENCE),
        drift_per_chunk=np.float64(DRIFT_PER_CHUNK),
        short_frames=np.asarray(json.dumps(SHORT)),
        spread_deltas=np.asarray(SPREAD_DELTAS, np.float64),
        pathology_ulps=np.asarray(PATHOLOGY_ULPS, np.int64),
        stable_spread=np.float64(STABLE_SPREAD),
        orbit_config=np.asarray(orbit_config().to_json()),
        loop_config=np.asarray(loop_config().to_json()),
        configs=np.asarray(json.dumps({k: c.to_json()
                                       for k, c in configs().items()})),
        reference_blobs=np.asarray(json.dumps(dict(sorted(blobs.items())))),
        jax_version=np.asarray(jax.__version__),
        seconds=np.float64(time.perf_counter() - t_all))
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    summary = {"out": str(path), "bytes": path.stat().st_size,
               "seconds": float(out["seconds"])}
    for name in sorted(runs):
        if "@" in name or name == "orbit":
            continue
        summary[name] = {
            "seconds": float(out[f"{name}_seconds"]),
            "keyframes": int(out[f"{name}_keyframes"].size),
            "closures": int(out[f"{name}_closures"].shape[0]),
            "ate_rmse_m": float(out[f"{name}_ate_rmse_m"])}
        if f"{name}_stable" in out:
            summary[name].update(
                stable=bool(out[f"{name}_stable"]),
                spread=float(out[f"{name}_spread"].max()),
                spread_seconds=float(out[f"{name}_spread_seconds"]))
    if "pathology" in summary:
        summary["pathology"]["rounding_spread"] = float(
            out["pathology_rounding_spread"].max())
    if "orbit" in runs:
        summary["orbit"] = {s: float(out[f"orbit_{s}_seconds"])
                            for s in ("classic", "boundary", "fused")}
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
