"""Drive the PyTorch port's main paths on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):
  1. device   — require a CUDA device; print its name and power limit
  2. build    — build the ten CUDA kernels from tpuslam_torch/csrc (one
                nvcc per source, in parallel), with ptxas's registers,
                stack frames and spills
  3. kernels  — each kernel against its plain PyTorch twin at the main
                paths' shapes (all three levels of a 640×480 frame pair;
                correspond and gn_step from the untransformed source and
                the carry's pose, correspond bit-equal and writing nothing
                after DONE; gn_partials at the carry's pose, as the ring
                ICP calls it, the same bits on a second launch, also at
                the ring's 16,384 points; gn_fused's one-launch solve on its
                first solve of an outer iteration and with T_gate ≠ T_res:
                per-block Σvalid exact, the carry within gn_step's
                tolerances, the gate buffer bit-equal, the same bits again,
                nothing written after DONE;
                ring_nn at 16,384 frame points × 131,072
                map rows, about half of them invalid: the ring ICP's hop
                with the pose, the first hop's start and the last hop's
                gates bit-equal to its twin in score, row, x, q, n and w,
                four hops over four shards against one hop, DONE, a NaN
                point, an all-invalid shard, the tickets back at zero;
                grid_correspond at 16,384 queries against a
                131,072-row index with ~150 points to a cell, posed and
                pose-less bit-equal in q, n, w, idx, nothing written after
                DONE, a query outside the grid and one without a
                candidate), with each one's time beside its twin's and
                its bound and its device µs of one full launch at level 0
                (ring_nn: one full hop; grid_correspond: one full probe)
                under torch.profiler; at level 0
                gn_step against the unmerged pair (gn_partials at the
                carry's pose + gn_epilogue) in turns, by CUDA events and
                under torch.profiler, on grids of 132 and 264 blocks;
                torch.searchsorted of the probe's 16,384 × 27 cell keys
                into the index's sorted keys as the grid table's library
                time, and with the gather of each key's first row as the
                library route of the table's work (set against the probe
                with its build amortized in phase 12b)
 3b. graphs   — the captured programs (tpuslam_torch/graphs.py) at
                640×480: scan_odometry (plain and fused), process_frame_jit,
                scan_chunk, scan_superchunk_frozen (sub 8 and 4), the dense
                pose-graph solve at 32 and 256 nodes, the CG solve at 512,
                fused_attempt_jit (B = 4, 3 live), the map programs, and
                scan_odometry_boundary_jit, align_frames_jit (a
                pyramid pair; run_bench's 50 one-level iterations),
                align_clouds_jit, the verification batches
                (_verify_pairs_jit, _verify_projective_pairs_jit) and
                relocalization's (_batch_verify_jit,
                _batch_verify_projective_jit), the grid index build (and
                its replay after an insert against a fresh build), the
                sharded fusion and the point-sharded ICP, and the
                distributed programs (optimize_pose_graph_spmd on the
                32-node bucket, optimize_map_ba_spmd on map BA's problem,
                the batched aligner on 4 pairs) on a one-rank
                NCCL group, each run eagerly
                against a key's first call (the warm-up), its second (the
                capture and a replay) and a replay: every output bit-equal;
                each one's capture seconds, eager and replayed ms, device
                operations a replayed call, the pool memory the capture
                added and its hand kernels' launches a replay; a changed K
                gets a graph of its own.  Every later phase runs through
                the graphs, and its launch checks count the replays
  4. uint16   — raw uint16 depth divided on the device is bit-equal to
                host-divided float32 depth
 4b. preprocess — the one-launch pyramid (csrc/preprocess.cu) against its
                eager twin on the same CUDA tensors at 640×480, 3 levels,
                from float32, float16 and uint16 depth: every level's
                points, normals and mask bit-equal (as int32); its device
                time (50 calls in one CUDA graph, by CUDA events) and its
                time as the host issues it, each beside the twin's, its
                byte bound and its device µs of one full launch; then the
                dense pose-graph solve's kernel (csrc/posegraph_dense.cu)
                against its twin at the 32-node bucket (posegraph_phase:
                poses within TOL_POSE, padding bit-equal), timed at 15 and
                19 live nodes beside the twin's captured solve replayed,
                with its bound by operations; then the warm start's kernel
                (csrc/warm_start.cu) against its eager twin over motions
                that reach each branch of se3's log and exp and 64 seeded
                ones (warm_start_phase: bit-equal, and the same bits on a
                second launch), its device time and the twin's (50 calls
                in one CUDA graph each), the twin's device operations a
                call, the byte bound and the device µs of one full launch
  5. small    — a 12-frame 120×160 scan on the GPU against the same scan
                through the plain twins on the CPU (the twins are held to
                the JAX reference by tests/test_torch_*.py)
  6. main     — tpuslam_torch.bench.harness.run_bench: 240 frames at
                640×480, default config; ATE < 1 mm for the classic and
                the boundary scan, the headline variant, the replayed ICP
                iteration latency beside the eager one; both scans held to
                the reference's (tpuslam_torch/bench/data/reference_vga.npz,
                written by tests/torch_reference_poses.py): promotion
                flags equal, poses within 1e-4; every kernel of the
                path launched (correspond, gn_step; not the standalone
                gn_partials or gn_epilogue), no plain twin called; then one
                scan of the orbit counted for launches a frame
  7. fused    — the same with ICPConfig.fused_gn=True: gn_fused carries
                tracking, one launch a solve (no standalone gn_epilogue or
                gn_partials); fps beside phase 6's; launches a frame; the
                classic scan held to the reference's (`orbit_fused`:
                flags equal, poses within 1e-4)
  8. small slam — SlamSystem on the 48-frame 120×160 two-lap loop
                (boundary chunks, deferred backend, fused_gn False and
                True) on the GPU against the CPU twins: same keyframes and
                closure pairs, poses within 1e-4; then the drifted loop of
                tests/test_descriptor_lc.py with lc_descriptor (sync): the
                same keyframes and closure pairs, poses within 1e-4, every
                descriptor a numpy array
  9. slam     — run_slam_bench: 120 frames at 640×480, boundary chunks,
                backend sync and deferred, fused_gn False and True; ATE
                < 1 mm, ≥ 1 closure, every kernel launched, no twin called,
                no standalone gn_epilogue or gn_partials; every pass held
                to the reference's (reference_vga.npz): unfused
                synchronous to `loop_chunked`, unfused deferred to
                `loop_deferred`, fused synchronous to
                `loop_fused_chunked`, fused deferred to
                `loop_fused_deferred` (keyframes and closure pairs equal,
                poses within 1e-3)
 9b. drift    — slam-drift-vga: SlamSystem on phase 9's 120-frame 640×480
                loop, boundary chunks of 8 (sub-chunks of 4), the deferred
                backend, 0.012 m of world-anchor drift injected before
                every chunk (tests/test_descriptor_lc.py:62-78) and that
                test's gates (lc_max_dist 0.02 m); lc_descriptor off and
                on: on closes ≥ 1 loop and more than off, ATE on < 0.5 ×
                ATE off, every descriptor a numpy array, correspond and
                gn_step launched, no twin called; fps of both beside
                phase 9's deferred fps; each pass held to the reference's
                (`drift_off`, `drift_on`)
 9c. fallback — the grid-hash verification fallbacks at full width: the
                drift run with descriptors saved after 24 frames under
                verify_level=2 and resumed at verify_level=1 (tables of
                two shapes), run on: ≥ 1 closure verified by the grid
                attempt, grid_correspond and gn_step launched, no twin
                called, each grid attempt's time on the host clock and
                its probe launches; then relocalize with K=None (2
                candidates × 2 guesses) against its CPU twin: the same
                keyframe, T within 1e-4
 10. profile  — device time by kernel over a few odometry frames (device
                µs a launch of each kernel of the path, averaged over all
                its launches, those after DONE included; fewer GEMMs than
                associations: the association's transform is in its
                kernel), plain and fused (the fused orbit runs no more
                GEMMs than the plain one and no standalone epilogue); one
                SLAM chunk's stages on the host clock, the
                promotion pack's cost, and the next chunk under
                torch.profiler
 11. small map — SlamSystem(track_against_map=True) on a 16-frame 120×160
                loop, unsharded and sharded (one rank, no process group),
                on the GPU against the CPU twins: same keyframes, map size
                and refinement gates, poses within 1e-4; then
                map_track_mode="grid" with map_ba=True: at 0.1 m map
                voxels the same keyframes, gates, control points and
                observations, BA's cost within a relative 1e-4, poses
                within 1e-4; at 0.02 m the
                GPU's last refinement and its map BA replayed on the CPU
                twins with the same inputs (iterations equal, T within
                1e-4; BA's counts equal, cost within a relative 1e-4, poses
                within 1e-4)
 12. map      — run_map_bench: frame-to-map tracking, 120 frames at
                640×480, unsharded and sharded, under a one-rank NCCL
                group; ATE < 0.02 m, refinement ok share > 0.5, no point
                dropped, every kernel of the path launched (ring_nn on the
                sharded map), no twin called; then a few frames' stages on
                the host clock and under torch.profiler (fewer GEMMs than
                associations unsharded and than ring hops sharded: neither
                the association nor the ring's solves transform the points
                outside a kernel; sharded: fewer extra fills than ring
                hops, which allocate and fill nothing); each pass held to
                the reference's (`map_projective`, `map_sharded`: the ring
                on one device)
 12b. grid    — the grid path: run_map_bench with
                map_track_mode="grid" and map BA, 120 frames at 640×480
                (ATE < 0.02 m, refinement ok share > 0.5, map BA over
                > 100 observations, ATE after BA < max(1.5 × before,
                0.02 m), grid_correspond, correspond and gn_step launched,
                no twin called; fps beside phase 12's unsharded fps); then
                frames 40-47's stages on the host clock (refinement, index
                build, insert), frames 48-55 under torch.profiler (device
                busy, grid_correspond's device µs a launch) and map BA's
                time, one probe launch; the probe with its table build
                amortized over this run's probes an index against phase
                3's library route; the pass held to the reference's
                (`map_grid`, with map BA's observations and cost where it
                is stable; its poses before BA logged)
 13. cli      — the user's entry point, `python -m tpuslam_torch.cli`, in
                process: a 120-frame 640×480 two-lap sequence written in
                TUM's layout (each decoded depth PNG's sha256 equal to the
                reference writer's, `cli_slam_depth_sha256`), run_slam with
                chunks of 8 (sub-chunks of 4), the deferred backend,
                --upload-raw and a checkpoint every 48 frames (ATE < 1 mm,
                ≥ 1 closure, correspond and gn_step launched, no twin
                called; fps and fps_steady beside phase 9's deferred fps);
                the same with the float32 upload and no checkpoint (the
                same trajectory bits; its fps is decode and upload without
                the saves); a resume from the checkpoint (within 1e-5 of
                the uninterrupted run); each of the three held to the
                reference CLI's own run (`cli_slam`: keyframes and closure
                pairs equal, poses within 1e-3); run_odometry, held to
                `cli_odometry` (keyframes equal, poses within 1e-4); eval of the
                written trajectory (its ATE); run_slam --track-against-map
                --sharded-map on the first 48 frames (one rank, no process
                group: ring_nn, gn_partials, gn_epilogue launched);
                run_slam --track-against-map --map-track-mode grid --map-ba
                on the first 48 frames (map BA in the summary, ATE < 0.02 m,
                grid_correspond launched); run_slam --lc-descriptor on the
                whole sequence (chunks of 8, deferred; ATE < 1 mm, ≥ 1
                closure, correspond and gn_step launched, no twin called);
                bench_loader's decode and cached fps with the decoder; and
                each decoder's fps on a PNG of each row filter (OpenCV
                writes them), after a byte-exact decode
 14. scale    — bench_scale: BASELINE config 5, 2,000 frames at 320×240,
                chunks of 32 (graph_nodes > 256 = keyframes, retained clouds
                ≤ 48 + 24, ≥ 2 closures, ATE < 0.02 m), held to the
                reference's pass on the CPU (`scale`)
 15. pathology — bench_pathology: 60 degraded frames at 640×480 with a
                rotation burst (ATE < 0.04 m, no frame lost), held to the
                reference's pass on the CPU (`pathology`)
 16. dist     — the distributed stages (dist/sharded_icp, backend/distba,
                backend/map_ba's landmark-sharded BA, dist/batch_eval),
                each held to its single-device call on the card: first on
                one rank of an NCCL group (align_frames_spmd of phase 6's
                first 640×480 pair at 3 levels: correspond, gn_partials
                and gn_epilogue launched, no twin called, T within 1e-5,
                iterations within ±3; the pose graph, map BA and batched
                alignment on the one-rank mesh; run_bench(devices=1) over
                phase 6's orbit), then on 4 gloo ranks sharing the card,
                each a process of tpuslam_torch/bench/dist_ranks.py on
                cuda:0 with the kernels this run built (any rank failing
                or over its limit fails the phase): the sharded ICP of the
                same pair (~38k of the 153,600 level-0 points a rank; T
                within 1e-5, iterations ±3), optimize_pose_graph_spmd on
                phase 14's final graph (poses within 5e-4),
                optimize_map_ba_spmd on phase 12b's map BA problem (poses
                and map within 5e-5, dropped observations printed), the
                batched aligner on 8 pairs of the orbit, 2 a rank (each
                within 2e-4 of its own alignment), and run_bench on 24
                frames with devices=4 (its times labelled as one shared
                card, not scaling); every rank's results equal, each
                stage's launches per rank, no twin called
 17. backend   — the worker-thread backend and the cold start: (a) gn_step,
                gn_fused and correspond at level 0 (153,600 points) and
                ring_nn at 16,384 × 131,072, and the graphs of
                process_frame_jit and the 32-node pose-graph solve, 100
                launches or replays each on each of two streams at once,
                each stream with inputs of its own
                (tpuslam_torch/bench/two_streams.py): every result
                bit-equal to the same launch alone, every ticket zero
                after; (b) bench_slam: 120 frames at 640×480, its five
                variants (per frame sync and with the worker thread,
                boundary chunks sync and deferred, inline chunks), each
                after an uncounted pass: every pass held to the
                reference's (reference_vga.npz: `loop_per_frame`,
                `loop_worker`, `loop_chunked`, `loop_deferred`,
                `loop_chunked_inline`; keyframes and closure pairs equal,
                poses within 1e-3, the largest error and the first frame
                over it printed; the worker's four passes by the rule of
                its spread over the worker's timing, every closure pair in
                the union of the reference's timed runs); ATE
                per frame and inline < 1 mm,
                each worker pass's ATE < max(2 × per frame, 0.02 m), ≥ 1
                closure in every pass of the worker and every variant,
                correspond and gn_step launched, no twin called, the
                worker streams (not the main stream) launched gn_step and
                correspond, no worker error; closures and ATEs beside the
                reference's on the CPU (the file's); (c) inline chunks of
                8 with the worker on the 48-frame 120×160 two-lap loop on
                the card against the same run synchronous through the CPU
                twins (the same keyframes, closures ≥ max(1, CPU // 2),
                ATE < 0.02 m); (d) `python -m tpuslam_torch.cli bench
                --coldstart` twice, each a fresh process: both load the
                library phase 2 built (cache_hit), beside phase 2's build
A pass that parts from the reference's is logged where it ran and fails
the script at its end (a `[holds]` line lists every hold), after every
phase has run.  Then one JSON line with the kernels, and last a JSON line
with the device.
No JAX is imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL_PARTIALS_REL = 1e-4     # order of summation differs (blocks vs chunks)
TOL_EPILOGUE_T = 1e-5       # FMA contraction / libm differences
TOL_EPILOGUE_H_REL = 1e-6
TOL_SMALL_POSE = 1e-4       # GPU kernels vs CPU twins over 12 frames
TOL_SLAM_POSE = 1e-4        # GPU vs CPU twins, 48-frame SLAM loop
TOL_MAP_POSE = 1e-4         # GPU vs CPU twins, 16-frame map-tracking loop
TOL_MAP_BA_COST_REL = 1e-4  # GPU vs CPU twins, map BA's cost
# a voxel-boundary point may fuse one voxel over when two keyframe poses
# differ in their last float32 bits (the GN sums' order differs)
TOL_MAP_SIZE_REL = 1e-3
MAP_ATE_M = 0.02            # tests/test_slam.py's bound for map tracking
TOL_RESUME = 1e-5           # tests/test_fault_recovery.py's resume bound
SCALE_ATE_M = 0.02          # tests/test_config5_scale.py:70-82
PATHOLOGY_ATE_M = 0.04      # tests/test_pathology.py:108

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense).
# A kernel's bound is the larger of its bytes over the memory rate (each
# input read once, each output written once) and its float32 operations
# over the non-tensor float32 rate (an FMA counts as two).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float32 operations a point (a score cell for ring_nn), counted from the
# kernels' arithmetic
OPS_CORRESPOND = 30       # projection, rounding, bounds, ‖x−q‖², n·n_src
OPS_ROTATE = 15           # n_rot = R n: 9 products and 6 sums
OPS_GN_PARTIALS = 86      # residual, Huber, Jacobian, 27 products, 30 sums
OPS_GN_FUSED = 166        # gate and residual transforms, gates, row index,
                          # the above
OPS_EPILOGUE_SOLVE = 300  # 6×7 elimination, trust region, SE(3) exp
OPS_TRANSFORM = 18        # x = R p + t: 9 products and 9 sums
OPS_RING_NN_CELL = 6      # (2x)·q as a product and two FMAs, then cst − g
OPS_GRID_CELL = 3         # cell coordinate: a subtraction, a divide, floor
OPS_GRID_STEP = 2         # a binary-search step: a compare and a halving
OPS_GRID_CANDIDATE = 10   # a slot: key compare, 3 differences, 3 squares,
                          # 2 sums, the < against the best
OPS_TABLE_ROW = 2         # the table build: a row's key against the invalid
                          # key and its predecessor's
OPS_TABLE_RUN = 3         # a run's insert: the hash's product and shift,
                          # the compare-and-swap; plus a compare a row counted


def log(msg: str) -> None:
    print(msg, flush=True)


def fixtures(name: str):
    """A module of fixtures in tests/ by its name (torch_posegraph_cases:
    `synthetic_graph`, `posegraph_cases`; torch_warm_start_cases), loaded
    by its file path: the GPU host has another package named `tests` on its
    path, which hides this repository's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for this work, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_rows(prof) -> list:
    """(self device µs, count, name) of each kernel a profile saw, largest
    first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("slam."):
            # host ops (their device time is their kernels'), and the
            # slam.* spans' copies on the device timeline, which cover
            # kernels counted on their own
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, ev.count, ev.key))
    return sorted(rows, reverse=True)


# each kernel's symbol, as the profiler names it
KERNEL_SYMBOLS = {"correspond": "correspond_kernel",
                  "gn_partials": "gn_partials_kernel",
                  "gn_epilogue": "gn_epilogue_kernel",
                  "gn_step": "gn_step_kernel",
                  "gn_fused": "gn_fused_step_kernel",
                  "ring_nn": "ring_nn_kernel",
                  "grid_correspond": "grid_correspond_kernel",
                  "grid_table": "grid_table_",  # its fill and insert
                  "preprocess": "preprocess_kernel",
                  "posegraph_dense": "posegraph_dense_kernel",
                  "warm_start": "warm_start_kernel"}


def count_ops(rows, word: str) -> int:
    """Launches of the device operations whose name holds `word` (any
    case) in `device_rows`' rows."""
    return sum(cnt for _, cnt, key in rows if word.lower() in key.lower())


def per_launch_us(rows, name: str):
    """(device µs a launch, launches) of one kernel in `device_rows`'
    rows, or None when the profile did not see it."""
    hits = [(dt, cnt) for dt, cnt, key in rows if KERNEL_SYMBOLS[name] in key]
    if not hits:
        return None
    cnt = sum(h[1] for h in hits)
    return sum(h[0] for h in hits) / cnt, cnt


def full_launch_us(fn, name: str):
    """Device µs of one launch of `name` by fn() (20 launches under
    torch.profiler), or None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    hit = per_launch_us(device_rows(prof), name)
    return hit[0] if hit else None


def fmt_us(v) -> str:
    return "not measured" if v is None else f"{v:.3f}"


def gn_step_ab(card: str, pts, corr, carry, nvs, icp) -> dict:
    """Level 0: one GN solve as gn_step (grids of 132 and 264 blocks)
    against the unmerged pair gn_partials + gn_epilogue at the same
    inputs (the partials at the carry's pose, as the ring ICP launches
    them), timed in turns by CUDA events (forward, then back) and each
    under torch.profiler for its device time a solve."""
    from torch.profiler import ProfilerActivity, profile

    from tpuslam_torch.kernels import gn_epilogue, gn_partials, gn_step

    # is_last False: DONE is never set, so every timed launch does the work
    mid = (nvs, icp.huber_delta, icp.damping, icp.damping_abs,
           icp.max_trans_step, icp.max_rot_step, False, icp.inner_steps, 12,
           icp.tol_delta ** 2)
    sc = carry.clone()
    T = carry[gn_epilogue.T_SLICE]

    def partials():
        return gn_partials.gn_reduce_partials_at_pose(
            pts, corr.q, corr.n, corr.w, T, icp.huber_delta, done=carry)

    one_row = partials().sum(0, keepdim=True)
    fns = {
        # the epilogue on this solve's sums as one row: its fold is
        # trivial, so this is the solve's own time (plus a launch)
        "solve alone": lambda: gn_epilogue.gn_epilogue(
            one_row, carry, *mid[:1], *mid[2:]),
        "pair": lambda: gn_epilogue.gn_epilogue(partials(), carry, *mid[:1],
                                                *mid[2:]),
        "gn_step/132": lambda: gn_step.gn_step(pts, corr.q, corr.n, corr.w,
                                               sc, *mid, blocks=132),
        "gn_step/264": lambda: gn_step.gn_step(pts, corr.q, corr.n, corr.w,
                                               sc, *mid, blocks=264),
    }
    order = list(fns)
    event_ms = {k: [] for k in order}
    for seq in (order, order[::-1]):
        for k in seq:
            event_ms[k].append(time_ms(fns[k]))
    device_us = {}
    for k in order:
        fns[k]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fns[k]()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        # a launch's device time, summed over the variant's kernels (the
        # profiler may miss a launch of the 20, so per launch, not per 20)
        device_us[k] = sum(dt / cnt for dt, cnt, _ in rows)
        log(f"[gn_step a/b] {k}: event ms {event_ms[k][0]:.5f}, "
            f"{event_ms[k][1]:.5f}; device {device_us[k]:.3f} us a solve ("
            + ", ".join(f"{key[:40]} {dt / cnt:.3f} us, {cnt} launches"
                        for dt, cnt, key in rows) + f") ({card})")
    return {"event_ms": event_ms, "device_us": device_us}


def partials_at_ring_size(card: str, pts, corr, carry, icp) -> dict:
    """gn_partials at the ring ICP's size on one rank: the first
    VoxelConfig().capacity (16,384) points of level 0, 64 blocks of one
    point a thread, against its twin, timed beside it and its bound."""
    from tpuslam_torch.config import VoxelConfig
    from tpuslam_torch.kernels import gn_epilogue, gn_partials

    n = VoxelConfig().capacity
    args = (pts[:n], corr.q[:n], corr.n[:n], corr.w[:n],
            carry[gn_epilogue.T_SLICE], icp.huber_delta)
    pk = gn_partials.gn_reduce_partials_at_pose(*args, done=carry)
    pr = gn_partials.gn_reduce_partials_at_pose_reference(*args)
    torch.cuda.synchronize()
    fk, fr = gn_partials.fold_partials(pk), gn_partials.fold_partials(pr)
    rel = max(rel_err(a, b) for a, b in zip(fk, fr))
    check(rel <= TOL_PARTIALS_REL, f"gn_partials at {n} points: rel {rel}")

    def fn():
        gn_partials.gn_reduce_partials_at_pose(*args, done=carry)
    ms = time_ms(fn)
    plain_ms = time_ms(
        lambda: gn_partials.gn_reduce_partials_at_pose_reference(*args))
    full_us = full_launch_us(fn, "gn_partials")
    b = bound(nbytes(*args[:4], pk) + 12 * 4,
              (OPS_GN_PARTIALS + OPS_TRANSFORM) * n)
    log(f"[kernels] gn_partials at the ring's size N={n} ({pk.shape[0]} "
        f"blocks): kernel {ms:.5f} ms, device {fmt_us(full_us)} us a full "
        f"launch, plain {plain_ms:.5f} ms, bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']}, rel {rel:.3e} ({card})")
    return {"n": n, "ms": ms, "plain_ms": plain_ms,
            "device_us_full_launch": full_us, **b}


def fenced_spans(spans: dict, owner, names) -> None:
    """Replace each method `name` of `owner` by a copy that adds its time,
    fenced by a synchronize on each side, to spans[name]."""
    for name in names:
        fn = getattr(owner, name)

        def run(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            spans[_name] = spans.get(_name, 0.0) + (time.perf_counter() - t)
            return out
        setattr(owner, name, run)


def same_bits(a, b) -> bool:
    """Equal, with NaN where the other has NaN (the NaN query's x)."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def ring_nn_phase(dev, card: str) -> dict:
    """ring_nn against its twins at the map path's shapes: VoxelConfig
    .capacity frame points against a map_capacity-row shard of which about
    half the rows are invalid (a map filling up), one point NaN.  The ring
    ICP's hop (`ring_correspond_hop`: the pose, the first hop's start, the
    last hop's gates) as one hop and as four, DONE and an all-invalid
    shard."""
    from tpuslam_torch.config import ICPConfig, VoxelConfig
    from tpuslam_torch.geom import se3
    from tpuslam_torch.kernels import gn_epilogue, ring_nn

    n, m = VoxelConfig().capacity, VoxelConfig().map_capacity
    radius = ICPConfig().max_corr_dist
    rng = np.random.default_rng(0)
    q = rng.uniform(-2.0, 2.0, (m, 3)).astype(np.float32)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = rng.uniform(size=m) > 0.5
    x = (q[rng.integers(0, m, n)]
         + rng.normal(scale=0.02, size=(n, 3))).astype(np.float32)
    x[7] = np.nan
    x = torch.as_tensor(x, device=dev)
    mask = torch.as_tensor(rng.uniform(size=n) > 0.05, device=dev)
    shard = ring_nn.pack_cloud_rows(torch.as_tensor(q, device=dev),
                                    torch.as_tensor(nrm, device=dev),
                                    torch.as_tensor(valid, device=dev))
    T = se3.exp(torch.tensor([0.004, -0.003, 0.002, 0.01, -0.01, 0.005],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 12)

    def ring(parts, state, twin=False):
        for s, part in enumerate(parts):
            flags = (s == 0, s == len(parts) - 1, radius)
            if twin:
                ring_nn.ring_correspond_hop_reference(x, mask, part, state,
                                                      T, *flags)
            else:
                ring_nn.ring_correspond_hop(x, mask, part, state, carry,
                                            *flags)
        return state

    sk = ring((shard,), ring_nn.ring_state(n, dev))
    st = ring((shard,), ring_nn.ring_state(n, dev), twin=True)
    torch.cuda.synchronize()
    fin = torch.isfinite(st.score)
    err = float((sk.score[fin] - st.score[fin]).abs().max())
    check(all(same_bits(a, b) for a, b in zip(sk, st)),
          f"ring_nn: hop not bit-equal to its twin (score err {err})")
    check(float(sk.score[7]) == float("inf") and not bool(sk.row[7].any())
          and float(sk.w[7]) == 0.0, "ring_nn: a NaN query must keep +inf, "
          "a zero row and no match")
    check(bool((sk.row[fin, 6] == 1.0).all()), "ring_nn: an invalid row won")
    check(0.3 < float(sk.w.mean()) < 1.0, f"ring_nn: w mean {sk.w.mean()}")
    tickets, _ = ring_nn._scratch(dev, 1, 1)
    check(not bool(tickets.any()), "ring_nn: tickets left non-zero")
    # the ring's merge rule: four hops over four shards = one over the map
    h4 = ring(tuple(shard[s * m // 4:(s + 1) * m // 4] for s in range(4)),
              ring_nn.ring_state(n, dev))
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(h4, sk)),
          "ring_nn: four hops over four shards differ from one hop")
    # DONE set: nothing is written
    hd = ring_nn.ring_state(n, dev)
    for t_ in hd:
        t_.fill_(3.0)
    for s in range(2):
        ring_nn.ring_correspond_hop(x, mask, shard, hd,
                                    gn_epilogue.init_carry(T, 0), s == 0,
                                    s == 1, radius)
    torch.cuda.synchronize()
    check(all(bool((t_ == 3.0).all()) for t_ in hd),
          "ring_nn: DONE did not stop the hop")
    # an all-invalid shard: scores near 1e30, rows with valid = 0, no match
    dead = shard.clone()
    dead[:, 6] = 0.0
    hz = ring((dead,), ring_nn.ring_state(n, dev))
    hzt = ring((dead,), ring_nn.ring_state(n, dev), twin=True)
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(hz, hzt))
          and bool((hz.score[fin] > 9e29).all())
          and not bool(hz.row[:, 6].any()) and not bool(hz.w.any()),
          "ring_nn: all-invalid shard")

    state = ring_nn.ring_state(n, dev)

    def hop():
        ring_nn.ring_correspond_hop(x, mask, shard, state, carry, True, True,
                                    radius)
    ms = time_ms(hop)
    plain_ms = time_ms(lambda: ring((shard,), st, twin=True), reps=3)
    full_us = full_launch_us(hop, "ring_nn")
    # the rows a query needs are the valid ones: an invalid row never wins
    # over a valid one
    b = bound(nbytes(x, mask, shard) + nbytes(*state) + 12 * 4,
              OPS_RING_NN_CELL * n * int(valid.sum()) + OPS_TRANSFORM * n)
    log(f"[kernels] ring_nn {n} queries × {m} rows ({int(valid.sum())} "
        f"valid), the ring ICP's hop (pose, first and last): kernel "
        f"{ms:.5f} ms, device {fmt_us(full_us)} us a full hop, plain "
        f"{plain_ms:.5f} ms, bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']} ({b['bound_ms'] / ms:.3f} of it), bit-equal in "
        f"score, row, x, q, n, w ({int(sk.w.sum())} matches); 4 hops = 1 "
        f"hop, DONE, NaN query, all-invalid shard and zero tickets hold "
        f"({card})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "device_us_full_launch": full_us, **b}


def grid_surface(dev, m: int, seed: int = 0):
    """A room corner of m rows (floor and two walls, 4 m a side, 10% of
    the rows masked out): ~150 points to a 0.25 m cell, as a map of
    0.02 m voxels holds, so the probe's 16-slot cut is the common case."""
    from tpuslam_torch.geom.cloud import PointCloud

    rng = np.random.default_rng(seed)
    k = m // 3
    uv = rng.uniform(-2.0, 2.0, (m, 2))
    pts = np.zeros((m, 3))
    nrm = np.zeros((m, 3))
    pts[:k, 0:2], nrm[:k, 2] = uv[:k], 1.0                     # floor z=-2
    pts[:k, 2] = -2.0
    pts[k:2 * k, 1:3], nrm[k:2 * k, 0] = uv[k:2 * k], 1.0     # wall x=-2
    pts[k:2 * k, 0] = -2.0
    pts[2 * k:, 0:3:2], nrm[2 * k:, 1] = uv[2 * k:], 1.0      # wall y=-2
    pts[2 * k:, 1] = -2.0
    mask = rng.uniform(size=m) > 0.1
    return PointCloud(*(torch.as_tensor(a, device=dev) for a in (
        pts.astype(np.float32), nrm.astype(np.float32), mask)))


def grid_probe_work(x, index) -> tuple:
    """(cells searched, slots scanned, index bytes needed) of the kernel on
    these queries: an in-grid cell is one binary search, then up to 16
    slots of its key (the scan stops at the first other key).  The bytes
    the probe needs from the index are, for each distinct cell it scans,
    the key and the 32-byte row of its first min(count, 16) slots; masked
    rows (sorted last) and a crowded cell's later rows are never read, and
    the binary searches' key reads are left out (a lower bound)."""
    from tpuslam_torch.kernels import correspond

    c = correspond._cell_coords(x, index.origin, index.cell)
    searched = scanned = 0
    touched = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = c + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                      device=x.device)
                ok = torch.all((cc >= 0) & (cc < 256), dim=-1)
                key = (cc[:, 0] << 16) | (cc[:, 1] << 8) | cc[:, 2]
                cnt = (torch.searchsorted(index.keys, key, right=True)
                       - torch.searchsorted(index.keys, key))
                searched += int(ok.sum())
                scanned += int(torch.where(ok, cnt.clamp(max=16), 0).sum())
                touched.append(key[ok & (cnt > 0)])
    cells = torch.unique(torch.cat(touched))
    rows = int((torch.searchsorted(index.keys, cells, right=True)
                - torch.searchsorted(index.keys, cells)).clamp(max=16).sum())
    row_bytes = index.rows.shape[1] * index.rows.element_size()
    return searched, scanned, rows * (row_bytes + index.keys.element_size())


def table_build_us(fn, builds: int = 20):
    """Device µs of one table build by fn() (its fill and its insert, over
    `builds` builds under torch.profiler), or None when none was seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(builds):
            fn()
        torch.cuda.synchronize()
    us = sum(dt for dt, _, key in device_rows(prof)
             if KERNEL_SYMBOLS["grid_table"] in key)
    return us / builds if us else None


def table_check(index, tag: str) -> int:
    """The index's table on the card against cell_runs_reference: its
    filled entries read back, then every valid key and the absent
    neighbours of the occupied cells looked up on the host by the probe's
    rule.  Returns the number of cells."""
    from tpuslam_torch.kernels import correspond

    runs = [t.cpu().long() for t in correspond.cell_runs_reference(
        index.keys)]
    table = index.table.cpu()
    got = correspond.cell_table_entries(table)
    check(all(torch.equal(a.long(), b) for a, b in zip(got, runs)),
          f"grid_table {tag}: the table's entries differ from the runs")
    s, c = correspond.cell_table_lookup(table, runs[0])
    check(torch.equal(s, runs[1]) and torch.equal(c, runs[2]),
          f"grid_table {tag}: a valid key's lookup differs from its run")
    near = torch.unique(torch.cat([runs[0] + d for d in (
        1, -1, 256, -256, 65536, -65536)] + [torch.tensor([0, 1 << 24])]))
    absent = near[~torch.isin(near, runs[0])][:8192]
    s, c = correspond.cell_table_lookup(table, absent)
    check(not bool(c.any()) and not bool(s.any()),
          f"grid_table {tag}: an absent key was found")
    return int(runs[0].numel())


def grid_correspond_phase(dev, card: str):
    """grid_correspond against its twins at the grid path's shapes:
    VoxelConfig.capacity queries (a frame's cloud) against a
    map_capacity-row index with ~150 points to a cell (grid_surface), one
    query outside the grid and one with no candidate; posed (the carry's
    pose) and pose-less (map BA's call) bit-equal in q, n, w, idx, with the
    queries in random order and sorted by voxel key (the path's order);
    nothing written after DONE.  The index's table against
    cell_runs_reference at 131,072 rows, all rows masked and one row.
    Returns the probe's and the table build's stats."""
    from tpuslam_torch.config import ICPConfig, VoxelConfig
    from tpuslam_torch.geom import se3
    from tpuslam_torch.geom.cloud import PointCloud
    from tpuslam_torch.geom.voxel import voxel_keys
    from tpuslam_torch.kernels import correspond, gn_epilogue

    vc = VoxelConfig()
    n, m = vc.capacity, vc.map_capacity
    radius = ICPConfig().max_corr_dist
    target = grid_surface(dev, m)
    index = correspond.build_grid_index(target, radius)
    keys = index.keys[index.keys != correspond._INVALID_KEY]
    per_cell = torch.unique_consecutive(keys, return_counts=True)[1]
    cells = table_check(index, f"{m} rows")
    edge = {"all rows masked": PointCloud(target.points, target.normals,
                                          torch.zeros_like(target.mask)),
            "one row": PointCloud(target.points[:1], target.normals[:1],
                                  torch.ones_like(target.mask[:1]))}
    rng = np.random.default_rng(1)
    pick = torch.as_tensor(rng.integers(0, m, n), device=dev)
    x = (target.points[pick] + torch.as_tensor(
        rng.normal(scale=0.02, size=(n, 3)).astype(np.float32), device=dev))
    x[0] += 1000.0                                  # outside the grid
    x[1] = torch.tensor([1.0, 1.0, 1.0], device=dev)  # nothing within 0.75 m
    xm = torch.as_tensor(rng.uniform(size=n) > 0.05, device=dev)
    for tag, cloud in edge.items():
        ei = correspond.build_grid_index(cloud, radius, origin=index.origin)
        found = table_check(ei, tag)
        check(found == (0 if tag == "all rows masked" else 1),
              f"grid_table {tag}: {found} cells")
        ek = correspond.grid_hash_correspond(x, xm, ei, radius)
        er = correspond.grid_hash_correspond_reference(x, xm, ei, radius)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(ek, er)),
              f"grid_correspond {tag}: not bit-equal to its twin")
    T = se3.exp(torch.tensor([0.004, -0.003, 0.002, 0.01, -0.01, 0.005],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 12)
    # the path's order: a frame cloud leaves voxel_downsample sorted by
    # voxel key
    hi, lo, _ = voxel_keys(x, torch.ones_like(xm), vc.voxel_size, vc.origin,
                           vc.extent)
    order = torch.sort(hi.long() * 2 ** 31 + lo.long(), stable=True).indices
    orders = {"random": (x, xm),
              "voxel-key": (x[order].contiguous(), xm[order].contiguous())}
    res = {}
    for name, (xq, xmq) in orders.items():
        ck = correspond.grid_correspond_at_pose(xq, xmq, index, radius, carry)
        cr = correspond.grid_correspond_at_pose_reference(xq, xmq, index,
                                                          radius, T)
        xt = se3.transform_points_ordered(T, xq)
        uk = correspond.grid_hash_correspond(xt, xmq, index, radius)
        ur = correspond.grid_hash_correspond_reference(xt, xmq, index, radius)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(ck, cr)),
              f"grid_correspond ({name} order): posed launch not bit-equal "
              f"to its twin")
        check(all(torch.equal(a, b) for a, b in zip(uk, ur))
              and all(torch.equal(a, b) for a, b in zip(uk, ck)),
              f"grid_correspond ({name} order): pose-less launch not "
              f"bit-equal to its twin or to the posed one")
        res[name] = (ck, cr, uk, ur, xt)
    ck, cr, uk, ur, xt = res["random"]
    check(all(torch.equal(a[order], b) for a, b in zip(ck,
                                                       res["voxel-key"][0])),
          "grid_correspond: the voxel-key order's matches are not the "
          "random order's, permuted")
    out = correspond.correspondence_buffers(n, dev)
    for t_ in out:
        t_.fill_(7)
    correspond.grid_correspond_at_pose(x, xm, index, radius,
                                       gn_epilogue.init_carry(T, 0), out=out)
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max())
              for k, t in ((ck, cr), (uk, ur)) for a, b in zip(k, t))
    check(all(bool((t_ == 7).all()) for t_ in out),
          "grid_correspond: wrote after DONE")
    check(not bool(ck.w[:2].any()) and not bool(ck.q[:2].any())
          and not bool(ck.n[:2].any()) and not bool(ck.idx[:2].any()),
          "grid_correspond: a query without a candidate must give q = n = 0,"
          " idx = 0, w = 0")
    check(bool(torch.isfinite(ck.q).all()) and 0.5 < float(ck.w.mean()) < 1,
          f"grid_correspond: w mean {float(ck.w.mean())}")

    times = {}
    for name, (xq, xmq) in orders.items():
        def launch(xq=xq, xmq=xmq):
            correspond.grid_correspond_at_pose(xq, xmq, index, radius, carry,
                                               out=out)
        times[name] = (time_ms(launch),
                       full_launch_us(launch, "grid_correspond"))
    ms, full_us = times["random"]
    plain_ms = time_ms(lambda: correspond.grid_correspond_at_pose_reference(
        x, xm, index, radius, T), reps=3)
    searched, scanned, index_bytes = grid_probe_work(xt, index)
    steps = int(np.ceil(np.log2(m + 1)))
    b = bound(nbytes(x, xm, index.origin, *ck) + index_bytes + 12 * 4,
              (OPS_TRANSFORM + 3 * OPS_GRID_CELL) * n
              + OPS_GRID_STEP * steps * searched
              + OPS_GRID_CANDIDATE * scanned)
    crowded = float((per_cell > 16).float().mean())
    log(f"[kernels] grid_correspond {n} queries × {m} rows ({keys.numel()} "
        f"valid, {int(per_cell.max())} at most and "
        f"{float(per_cell.float().mean()):.1f} on average to a cell, "
        f"{crowded:.3f} of the cells above 16), posed: kernel {ms:.5f} ms, "
        f"device {fmt_us(full_us)} us a full launch, plain {plain_ms:.5f} ms,"
        f" bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
        f"({b['bound_ms'] / ms:.4f} of it; {searched / n:.1f} cells searched "
        f"and {scanned / n:.1f} slots scanned a query, {index_bytes} bytes "
        f"of the index needed), bit-equal posed and pose-less in q, n, w, "
        f"idx (max abs err {err}, {int(ck.w.sum())} matches); DONE, the "
        f"out-of-grid and the unmatched query hold ({card})")
    ms_v, us_v = times["voxel-key"]
    log(f"[kernels] grid_correspond, the same queries in voxel-key order: "
        f"kernel {ms_v:.5f} ms, device {fmt_us(us_v)} us a full launch "
        f"(random order {ms:.5f} ms, {fmt_us(full_us)} us), bit-equal "
        f"posed and pose-less ({card})")

    # the table build: a fill and an insert a sorted row
    def build_table():
        correspond.with_cell_table(index)
    table_ms = time_ms(build_table)
    table_us = table_build_us(build_table)
    table_plain_ms = time_ms(
        lambda: correspond.cell_runs_reference(index.keys), reps=20)
    # the reference's call for this function: jnp.searchsorted of each
    # query's 27 cell keys into the sorted keys; torch.searchsorted is one
    # PyTorch call for it
    c = correspond._cell_coords(xt, index.origin, index.cell)
    near = torch.stack([c + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                         device=dev)
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)], dim=1).reshape(-1, 3)
    near_keys = ((near[:, 0] << 16) | (near[:, 1] << 8)
                 | near[:, 2]).to(index.keys.dtype)
    library_ms = time_ms(lambda: torch.searchsorted(index.keys, near_keys))

    # the library route of the table and its lookups: each query's 27 cell
    # keys searched, and the row at each key's first slot gathered (the
    # probe's scan of a run and its choice of the nearest row left out)
    def searched_and_gathered():
        pos = torch.searchsorted(index.keys, near_keys)
        return index.rows.index_select(0, pos.clamp(max=m - 1))
    library_probe_ms = time_ms(searched_and_gathered)
    size = index.table.shape[0]
    runs = correspond.cell_runs_reference(index.keys)[2]
    tb = bound(nbytes(index.keys, index.table),
               OPS_TABLE_ROW * m + OPS_TABLE_RUN * cells
               + int(runs.sum()))
    log(f"[kernels] grid_table {m} rows, {cells} cells, {size} entries "
        f"({nbytes(index.table)} bytes): kernel {table_ms:.5f} ms, device "
        f"{fmt_us(table_us)} us a build (fill + insert), plain (the runs by "
        f"unique_consecutive) {table_plain_ms:.5f} ms, bound "
        f"{tb['bound_ms']:.5f} ms by {tb['bound_by']}, torch.searchsorted "
        f"of {near_keys.numel()} cell keys into {index.keys.numel()} sorted "
        f"keys {library_ms:.5f} ms, with the gather of each key's first "
        f"row {library_probe_ms:.5f} ms; entries and lookups "
        f"equal to cell_runs_reference at {m} rows, all rows masked and one "
        f"row ({card})")
    return ({"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
             "device_us_full_launch": full_us, "ms_voxel_order": ms_v,
             "device_us_full_launch_voxel_order": us_v, **b},
            {"ms": table_ms, "plain_ms": table_plain_ms, "max_abs_err": 0.0,
             "library_ms": library_ms,
             "searchsorted_gather_ms": library_probe_ms,
             "device_us_full_launch": table_us, "table_bytes":
             nbytes(index.table), "cells": cells, **tb})


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype, shape and bits (NaN equal to the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(view[a.element_size()])
        b = b.contiguous().view(view[b.element_size()])
    return bool(torch.equal(a, b))


def wall_ms(fn, reps: int, sync_each: bool) -> float:
    """Mean host-clock ms of fn() after a warm-up call: the call and its
    device work (`sync_each`: one call at a time, as a caller that reads
    the result back; else back to back, as a loop issues them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if sync_each:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_ops(fn) -> int:
    """Operations the device ran for one fn() (kernels, copies, fills)
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)


def graph_row(name, call, reps, sync_each, profiled, covers,
              card: str) -> dict:
    """One captured program (graphs_phase): the eager run against a key's
    first call (the warm-up), its second (the capture and a replay) and
    its third (a replay), bit-equal in every output; the capture's
    seconds, replayed against eager ms, the device's operations a call,
    the pool memory the capture added and the kernels a replay launches.
    `call(eager)` runs it; `reps` calls are timed (0: the single calls),
    one at a time with `sync_each`; `profiled` counts its device
    operations under the profiler."""
    from tpuslam_torch import graphs

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [t.clone() for t in graphs.flatten(fn())[0]]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t_prog = time.perf_counter()
    before = {e["id"] for e in graphs.stats()}
    ref, eager_one = timed(lambda: call(True))
    # a key's first call warms up, its second captures and replays, its
    # third replays
    runs = [timed(lambda: call(False)) for _ in range(3)]
    for tag, (got, _) in zip(("first call", "capture", "replay"), runs):
        check(len(got) == len(ref) and all(
            bits_equal(a, b) for a, b in zip(got, ref)),
            f"graphs {name}: the {tag} is not bit-equal to the eager run")
    new = [e for e in graphs.stats() if e["id"] not in before]
    check(all(e["captured"] for e in new),
          f"graphs {name}: not captured {new}")
    if reps:
        eager_ms = wall_ms(lambda: call(True), reps, sync_each)
        replay_ms = wall_ms(lambda: call(False), reps, sync_each)
    else:
        eager_ms, replay_ms = eager_one, runs[2][1]
    row = {"program": name, "covers": covers,
           "graphs": [e["program"] for e in new],
           "warm_up_s": sum(e["warm_up_s"] for e in new),
           "capture_s": sum(e["capture_s"] for e in new),
           "calls_ms": [r[1] for r in runs], "eager_ms": eager_ms,
           "replay_ms": replay_ms,
           "device_ops_replayed": (device_ops(lambda: call(False))
                                   if profiled else None),
           "pool_mib": sum(e["pool_mib"] for e in new),
           "kernel_launches_a_replay": [e["kernel_launches"] for e in new],
           "outputs": len(ref),
           "check_s": time.perf_counter() - t_prog}
    log(f"[graphs] {name} ({covers}): the first call, the capture and a "
        f"replay bit-equal to the eager run in {len(ref)} outputs; "
        f"capture {row['capture_s']:.3f} s "
        f"({', '.join(row['graphs']) or 'an earlier graph'}); calls "
        + ", ".join(f"{ms:.3f}" for ms in row["calls_ms"])
        + f" ms; eager {eager_ms:.3f} ms, replayed {replay_ms:.3f} ms; "
        f"device ops a replayed call {row['device_ops_replayed']} "
        f"(its copies in and out included); pool "
        f"{row['pool_mib']:.3f} MiB; hand-kernel launches a replay "
        f"{row['kernel_launches_a_replay']}; checked in "
        f"{row['check_s']:.3f} s ({card})")
    return row


MAP_GRAPH_KFS = tuple(range(0, 24, 2))   # graphs_phase's map keyframes


def map_graph_rows(dev, card: str, K, gt, d) -> list:
    """The map-tracking programs at map-loop-vga's widths (graphs_phase):
    a map of 131,072 rows fused from the loop's even frames at their true
    poses, frame 11 refined against it (projective, grid, and the ring on
    a one-rank NCCL group) from a warm start 1 cm off, the fusion of one
    more keyframe, a promotion's bundle, packing and frame cloud, and map
    BA over the 12 keyframes (cell 2 × map voxel control points, 512
    points a keyframe: `refine_map_ba`'s problem).  Each row as
    `graph_row`.  Then the stale-input check: after a replay, a keyframe
    fused in (the fusion replayed) and the index rebuilt, the next replay
    of each refinement equals the eager one against the new map and
    differs from the one before."""
    import torch.distributed as dist

    from tpuslam_torch import graphs, mapping
    from tpuslam_torch import slam as slam_mod
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.backend.posegraph import GraphHost
    from tpuslam_torch.bench.harness import slam_bench_config
    from tpuslam_torch.dist.batch_eval import make_batched_aligner
    from tpuslam_torch.dist.map_fusion import make_fuse_fn
    from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh
    from tpuslam_torch.dist.ring_map import make_ring_align_fn
    from tpuslam_torch.dist.sharded_icp import make_aligned_spmd_fn
    from tpuslam_torch.frontend import (
        _kf_cloud_jit,
        pack_pyramid_jit,
        preprocess,
        promote_bundle_jit,
    )
    from tpuslam_torch.geom.voxel import voxel_downsample
    from tpuslam_torch.icp import Frame
    from tpuslam_torch.kernels.correspond import (
        build_grid_index,
        build_grid_index_jit,
    )

    height, width = d.shape[1:]
    cfg = slam_bench_config(height, width, False)
    icp, v = cfg.icp, cfg.voxel

    def pose(T):
        return torch.as_tensor(np.asarray(T, dtype=np.float32), device=dev)

    def fuse(map_cloud, cloud, T, eager=False):
        return mapping.fuse_jit(map_cloud, cloud, T, v.map_capacity,
                                v.map_voxel_size, v.origin, v.extent,
                                eager=eager)

    clouds = [promote_bundle_jit(d[i], K, cfg, False, eager=True)[2]
              for i in MAP_GRAPH_KFS]
    vmap = mapping.VoxelMap(v, device=dev)
    for c, i in zip(clouds, MAP_GRAPH_KFS):
        vmap.cloud = fuse(vmap.cloud, c, pose(gt[i]), eager=True)
    cell = float(icp.max_corr_dist)
    index = build_grid_index_jit(vmap.cloud, cell, eager=True)
    pyr = preprocess(d[11], K, cfg)
    frame_cloud = _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity, v.origin,
                                v.extent, eager=True)
    T0 = np.asarray(gt[11], dtype=np.float32).copy()
    T0[:3, 3] += 0.01
    T0 = pose(T0)
    extra = promote_bundle_jit(d[13], K, cfg, False, eager=True)[2]
    ctrl = voxel_downsample(vmap.cloud, 2.0 * v.map_voxel_size, 4096,
                            origin=v.origin, extent=v.extent)
    host = GraphHost(cfg.posegraph, device=dev)
    for k, i in enumerate(MAP_GRAPH_KFS):
        host.add_node(np.asarray(gt[i], dtype=np.float32))
        if k:
            j = MAP_GRAPH_KFS[k - 1]
            host.add_edge(k - 1, k, np.linalg.inv(gt[j]) @ gt[i])
    stride = max(1, v.capacity // 512)
    prob = map_ba.build_map_ba_problem(
        pose(np.stack([gt[i] for i in MAP_GRAPH_KFS])),
        torch.stack([c.points[::stride][:512] for c in clouds]),
        torch.stack([c.mask[::stride][:512] for c in clouds]), ctrl.points,
        ctrl.normals, ctrl.mask, max_dist=cell)
    graph = host.graph(bucketed=True)
    n_map = int(vmap.cloud.count())
    initialize_distributed(f"tcp://localhost:{free_port()}", world_size=1,
                           rank=0, backend="nccl", timeout_s=60)
    try:
        mesh = make_mesh(dev)
        ring = make_ring_align_fn(mesh, icp)
        fuse_sharded = make_fuse_fn(mesh, v, v.capacity)[0]
        spmd = make_aligned_spmd_fn(mesh, icp)
        pyr10 = preprocess(d[10], K, cfg)
        # the distributed programs: the 32-node bucket's graph of
        # graphs_phase, this map BA problem, and frames 10-13 each against
        # the one before, batched
        g32 = fixtures("torch_posegraph_cases").synthetic_graph(
            dev, 24).graph(bucketed=True)
        batched = make_batched_aligner(mesh, icp)
        pyrs = [preprocess(d[i], K, cfg) for i in range(9, 14)]
        src, dst = (tuple(Frame(*(torch.stack([p[li][k] for p in ps])
                                  for k in range(3)))
                          for li in range(len(pyr)))
                    for ps in (pyrs[1:], pyrs[:-1]))
        T0s = torch.eye(4, device=dev).repeat(4, 1, 1)
        programs = {
            "_refine_projective_jit": (
                lambda e: slam_mod._refine_projective_jit(
                    vmap.cloud, pyr[0], K, T0, icp, eager=e), 10, True, True,
                f"one refinement against {n_map} map points"),
            "_kf_cloud_jit": (
                lambda e: _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity,
                                        v.origin, v.extent, eager=e), 10,
                True, True, "one frame cloud"),
            "_refine_grid_jit": (
                lambda e: slam_mod._refine_grid_jit(frame_cloud, index, T0,
                                                    icp, eager=e), 10, True,
                True, "one refinement, the index built"),
            "ring_align (one NCCL rank)": (
                lambda e: ring(frame_cloud, vmap.cloud, T0, eager=e), 5,
                True, True, "one refinement"),
            "_fuse": (lambda e: fuse(vmap.cloud, extra, pose(gt[13]),
                                     eager=e), 10, True, True,
                      "one keyframe fused"),
            "promote_bundle_jit": (
                lambda e: promote_bundle_jit(d[13], K, cfg, False, eager=e),
                10, True, True, "one promotion"),
            "promote_bundle_jit with_desc": (
                lambda e: promote_bundle_jit(d[13], K, cfg, True, eager=e),
                5, True, True, "one promotion"),
            "pack_pyramid_jit": (
                lambda e: pack_pyramid_jit(pyr, cfg, eager=e), 10, True, True,
                "one pyramid"),
            "optimize_map_ba": (
                lambda e: map_ba.optimize_map_ba(
                    graph, prob, cfg.posegraph, huber_delta=icp.huber_delta,
                    eager=e), 2, True, True,
                f"{len(clouds)} keyframes, {prob.obs_w.shape[0]} "
                f"observations, {ctrl.points.shape[0]} control rows"),
            # the index build, the sharded fusion and ICP
            "build_grid_index": (
                lambda e: build_grid_index_jit(vmap.cloud, cell, eager=e),
                10, True, True,
                f"an index of {v.map_capacity} rows, the table built"),
            "fuse_sharded (one NCCL rank)": (
                lambda e: fuse_sharded(vmap.cloud, extra, pose(gt[13]),
                                       eager=e), 10, True, True,
                "one keyframe fused: all-to-all and all-reduce"),
            "align_frames_spmd (one NCCL rank)": (
                lambda e: spmd(pyr, pyr10, K, pose(np.eye(4)), eager=e), 10,
                True, True, "one pyramid pair: an all-reduce a solve"),
            # the distributed programs
            "optimize_pose_graph_spmd (one NCCL rank)": (
                lambda e: optimize_pose_graph_spmd(g32, cfg.posegraph, mesh,
                                                   eager=e), 3, True, True,
                "one solve, 32-node bucket: an all-reduce a round"),
            "optimize_map_ba_spmd (one NCCL rank)": (
                lambda e: map_ba.optimize_map_ba_spmd(
                    graph, prob, cfg.posegraph, mesh,
                    huber_delta=icp.huber_delta, eager=e), 2, True, True,
                "optimize_map_ba's problem: an all-reduce a round, then "
                "the map's all-gather"),
            "batched_align_frames (one NCCL rank)": (
                lambda e: batched(src, dst, K, T0s, eager=e), 5, True, True,
                "4 pyramid pairs, then one all-gather"),
        }
        rows = [graph_row(name, *spec, card)
                for name, spec in programs.items()]

        # stale inputs: each refinement replayed, a keyframe fused in (the
        # fusion replayed) and the index rebuilt; the next replay is the
        # eager refinement against the new map
        refines = {
            "projective": lambda e: slam_mod._refine_projective_jit(
                vmap.cloud, pyr[0], K, T0, icp, eager=e),
            "grid": lambda e: slam_mod._refine_grid_jit(
                frame_cloud, index, T0, icp, eager=e),
            "ring": lambda e: ring(frame_cloud, vmap.cloud, T0, eager=e)[1],
        }
        before = {k: f(False).clone() for k, f in refines.items()}
        grown = fuse(vmap.cloud, extra, pose(gt[13]), eager=True)
        vmap.insert(extra, gt[13])
        check(bits_equal(vmap.cloud.points, grown.points)
              and bits_equal(vmap.cloud.mask, grown.mask),
              "graphs stale inputs: the replayed fusion is not the eager "
              "one")
        old_keys = index.keys.clone()
        index = vmap.build_index(cell=cell)      # a replay of the build
        fresh = build_grid_index(vmap.cloud, cell)
        check(all(bits_equal(a, b) for a, b in zip(
            graphs.flatten(index)[0], graphs.flatten(fresh)[0]))
            and not torch.equal(index.keys, old_keys),
            "graphs stale inputs: the index build's replay after an insert "
            "is not a fresh eager build of the new map")
        for k, f in refines.items():
            after = f(False).clone()
            eager = f(True)
            check(bits_equal(after, eager),
                  f"graphs stale inputs: the {k} replay after an insert is "
                  f"not the eager refinement against the new map")
            check(not torch.equal(after, before[k]),
                  f"graphs stale inputs: the {k} replay did not see the "
                  f"insert")
        log(f"[graphs] stale inputs: after a keyframe fused in (the "
            f"fusion replayed, bit-equal to eager) and the index rebuilt "
            f"(its build replayed, bit-equal to a fresh eager build), "
            f"the projective, grid and ring replays equal their eager "
            f"refinements against the new map of {int(vmap.cloud.count())} "
            f"points and differ from the replays before ({card})")
    finally:
        # the graphs that hold NCCL collectives go before their group
        graphs.clear()
        dist.destroy_process_group()
    return rows


def graphs_phase(dev, card: str, height: int = 480,
                 width: int = 640) -> dict:
    """Each captured program (tpuslam_torch/graphs.py) at full width: the
    eager run against a key's first call (the warm-up), its second (the
    capture and a replay) and its third (a replay), bit-equal in every
    output; the capture's seconds, replayed against eager ms, the device's
    operations a call and the pool memory the capture added; a changed K
    gets a graph of its own.  Returns the table."""
    from tpuslam_torch import graphs
    from tpuslam_torch.backend import loopclosure, posegraph, relocalize
    from tpuslam_torch.bench.harness import _render_sequence
    from tpuslam_torch.config import SLAMConfig
    from tpuslam_torch.frontend import (
        SuperChunkCarry,
        initial_state,
        preprocess,
        process_frame_jit,
        promote_bundle_jit,
        scan_chunk,
        scan_odometry,
        scan_odometry_boundary_jit,
        scan_superchunk_frozen,
    )
    from tpuslam_torch.icp import align_clouds_jit, align_frames_jit
    from tpuslam_torch.icp import pack_pyramid

    graphs.clear()
    frames = 24
    K, gt, d_np = _render_sequence(frames, height, width, loop_cycles=2)
    d = torch.as_tensor(d_np, device=dev)
    cfg = SLAMConfig(height=height, width=width).validate()
    cfg_f = cfg.replace(icp=dataclasses.replace(cfg.icp, fused_gn=True))
    eye = torch.eye(4, device=dev)
    st0 = initial_state(d[0], K, cfg)
    carry0 = SuperChunkCarry(kf_packed=st0.kf_packed, T_kf_cam=eye,
                             last_delta=eye)
    pg = cfg.posegraph
    # loops of keyframe poses, each off by ~1 cm, with loop edges: the
    # 32-, 256- and 512-node buckets (dense, dense, CG)
    synthetic_graph = fixtures("torch_posegraph_cases").synthetic_graph
    g32, g256, g512 = (synthetic_graph(dev, n).graph(bucketed=True)
                       for n in (24, 200, 400))
    # the fused attempt: 3 live revisit candidates padded to 4, tables at
    # verify_level 1, the j sides' voxel clouds
    lvl = cfg.keyframe.verify_level
    pairs = [(0, 12), (3, 15), (0, 15)]
    padded = pairs + pairs[:1]
    tables = [pack_pyramid(preprocess(d[i], K, cfg), cfg.icp)[lvl]
              for i, _ in padded]
    clouds = [promote_bundle_jit(d[j], K, cfg, False)[2] for _, j in padded]
    T_inits = torch.as_tensor(np.stack([
        (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)
        for i, j in padded]), device=dev)
    cand_i = torch.as_tensor([i for i, _ in padded], dtype=torch.int32,
                             device=dev)
    cand_j = torch.as_tensor([j for _, j in padded], dtype=torch.int32,
                             device=dev)
    h, w = height >> lvl, width >> lvl

    # the verification batches' i sides (clouds), two frames of the loop
    # for the alignments, and run_bench's 50-iteration one-level config
    clouds_i = [promote_bundle_jit(d[i], K, cfg, False)[2]
                for i, _ in padded]
    pyr_a, pyr_b = (preprocess(d[i], K, cfg) for i in (0, 1))
    one_level = dataclasses.replace(cfg.icp, pyramid_levels=1,
                                    iters_per_level=(50,), tol_delta=0.0)
    K_lvl = K.scaled(1.0 / 2 ** lvl)

    def attempt(eager):
        return loopclosure.fused_attempt_jit(
            tables, [c.points for c in clouds], [c.normals for c in clouds],
            [c.mask for c in clouds], K.scaled(1.0 / 2 ** lvl), T_inits,
            len(pairs), g32, cand_i, cand_j, h, w, cfg.icp, pg, True,
            2.0, eager=eager)

    # name → (call(eager), timed calls, one call at a time, profiled, what
    # a call covers); the CG solve (~159k device operations) is timed from
    # single calls and not profiled (the profiler takes minutes over it)
    programs = {
        "scan_odometry": (lambda e: scan_odometry(d, K, cfg, eager=e), 2,
                          False, True, f"{frames} frames"),
        "scan_odometry fused_gn": (
            lambda e: scan_odometry(d, K, cfg_f, eager=e), 2, False, True,
            f"{frames} frames"),
        "process_frame_jit": (lambda e: process_frame_jit(
            d[5], st0.kf_packed, K, eye, eye, cfg, eager=e), 20, False,
            True, "1 frame"),
        "scan_chunk": (lambda e: scan_chunk(d[1:9], K, st0, cfg, eager=e),
                       3, False, True, "8 frames"),
        "scan_superchunk_frozen sub 8": (
            lambda e: scan_superchunk_frozen(d[1:17], K, carry0, cfg, 8,
                                             eager=e), 3, False, True,
            "16 frames"),
        "scan_superchunk_frozen sub 4": (
            lambda e: scan_superchunk_frozen(d[1:17], K, carry0, cfg, 4,
                                             eager=e), 3, False, True,
            "16 frames"),
        "optimize_pose_graph 32": (lambda e: posegraph.optimize_pose_graph(
            g32, pg, eager=e), 3, True, True, "one solve"),
        "optimize_pose_graph 256": (lambda e: posegraph.optimize_pose_graph(
            g256, pg, eager=e), 2, True, True, "one solve"),
        "optimize_pose_graph_cg 512": (
            lambda e: posegraph.optimize_pose_graph_cg(
                g512, pg, cg_iters=int(pg.cg_iters), cg_tol=float(pg.cg_tol),
                eager=e), 0, True, False, "one solve"),
        "fused_attempt_jit": (attempt, 3, True, True,
                              "one attempt, B=4, 3 live"),
        # the reference's last compiled programs
        "scan_odometry_boundary_jit": (
            lambda e: scan_odometry_boundary_jit(d, K, cfg, 8, eager=e), 2,
            False, True, f"{frames} frames, 3 chunks"),
        "align_frames_jit": (
            lambda e: align_frames_jit(pyr_b, pyr_a, K, eye, cfg.icp,
                                       eager=e), 10, True, True,
            "one pyramid pair, the target packed"),
        "align_frames_jit 50 iterations": (
            lambda e: align_frames_jit((pyr_b[0],), (pyr_a[0],), K, eye,
                                       one_level, eager=e), 10, True, True,
            "run_bench's icp_iter_latency_ms call"),
        "align_clouds_jit": (
            lambda e: align_clouds_jit(clouds[0], clouds_i[0], T_inits[0],
                                       cfg.icp, eager=e), 10, True, True,
            "one pair of keyframe clouds, the index built"),
        "_verify_pairs_jit": (
            lambda e: loopclosure.verify_batch_grid(
                clouds_i, clouds, T_inits, len(pairs), cfg.icp, eager=e), 5,
            True, True, "B=4, 3 live, 3 indexes built"),
        "_verify_projective_pairs_jit": (
            lambda e: loopclosure.verify_batch(
                tables, [c.points for c in clouds],
                [c.normals for c in clouds], [c.mask for c in clouds], K_lvl,
                T_inits, len(pairs), h, w, cfg.icp, eager=e), 5, True, True,
            "B=4, 3 live"),
        "_batch_verify_jit": (
            lambda e: relocalize._batch_verify_jit(clouds[1], clouds_i,
                                                   T_inits, cfg.icp,
                                                   eager=e), 5, True, True,
            "B=4, 4 indexes built"),
        "_batch_verify_projective_jit": (
            lambda e: relocalize._batch_verify_projective_jit(
                clouds[1], tables, K_lvl, T_inits, h, w, cfg.icp, eager=e),
            5, True, True, "B=4"),
    }

    table = [graph_row(name, *spec, card)
             for name, spec in programs.items()]
    table += map_graph_rows(dev, card, K, gt, d)
    # a changed K never replays a stale graph: a key of its own, its
    # replay bit-equal to the eager run at that K
    K2 = K._replace(fx=K.fx * 1.01)
    n0 = len(graphs.stats())
    ref = graphs.flatten(process_frame_jit(d[5], st0.kf_packed, K2, eye,
                                           eye, cfg, eager=True))[0]
    for _ in range(3):
        got = graphs.flatten(process_frame_jit(d[5], st0.kf_packed, K2, eye,
                                               eye, cfg))[0]
        check(all(bits_equal(a, b) for a, b in zip(got, ref)),
              "graphs: a changed K replayed a stale graph")
    check(len(graphs.stats()) == n0 + 1, "graphs: a changed K shared a key")
    log(f"[graphs] a changed K captured a graph of its own, bit-equal to "
        f"the eager run; {len(graphs.stats())} graphs held, "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 20:.1f} MiB reserved "
        f"({card})")
    graphs.clear()
    return {"programs": table}


def map_config():
    """tests/test_torch_map_slam.py's reduced map-tracking config."""
    from tpuslam_torch.config import (
        ICPConfig,
        KeyframeConfig,
        PoseGraphConfig,
        SLAMConfig,
        VoxelConfig,
    )
    return SLAMConfig(
        height=120, width=160,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                                  lc_min_gap=3, lc_max_dist=0.6,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 11, map_capacity=1 << 13),
        map_refine_min_inliers=100)


def small_map_phase(dev, counters) -> None:
    """Map tracking on a 16-frame 120×160 loop: GPU kernels vs CPU twins,
    unsharded and sharded on a one-rank mesh without a process group; then
    the grid refinement with map BA (grid_map_ba_small)."""
    from tpuslam_torch.config import Intrinsics
    from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
    from tpuslam_torch.slam import SlamSystem

    K = Intrinsics(160.0, 160.0, 79.5, 59.5)
    cfg = map_config()
    frames = 16
    gt = loop_trajectory(frames, cycles=1, radius=0.35)
    d_np = np.stack([render_depth(gt[i], K, 120, 160, seed=i)
                     for i in range(frames)]).astype(np.float32)

    def run(device, sharded):
        slam = SlamSystem(K, cfg, enable_loop_closure=False,
                          track_against_map=True, sharded_map=sharded,
                          device=device)
        d = torch.as_tensor(d_np, device=device)
        for i in range(frames):
            slam.process(d[i], timestamp=i / 30.0)
        return ([r.index for r in slam.odo.keyframes], slam.map.size(),
                [s["ok"] for s in slam.map_refine_stats],
                slam.trajectory()[1])

    for sharded in (False, True):
        for c in counters.values():
            c.reset()
        kg, sg, og, eg = run(dev, sharded)
        launches = {k: c.launches for k, c in counters.items()}
        plain = {k: c.plain_calls for k, c in counters.items()}
        kc, sc, oc, ec = run("cpu", sharded)
        err = float(np.abs(eg - ec).max())
        tag = f"small map sharded={sharded}"
        check(kg == kc and len(kg) >= 4, f"{tag}: keyframes {kg} vs {kc}")
        check(abs(sg - sc) <= TOL_MAP_SIZE_REL * sc,
              f"{tag}: map size {sg} vs {sc}")
        check(og == oc and np.mean(og) > 0.5, f"{tag}: gates {og} vs {oc}")
        check(err <= TOL_MAP_POSE, f"{tag}: pose err {err}")
        check(not sharded or launches["ring_nn"] > 0,
              f"{tag}: ring_nn not launched {launches}")
        check(all(v == 0 for v in plain.values()),
              f"{tag}: twins called on the GPU {plain}")
        log(f"[small map] sharded={sharded}: GPU vs CPU twins identical "
            f"keyframes ({len(kg)}) and gates ({sum(og)}/{len(og)} ok), map "
            f"size {sg} vs {sc}, pose max err {err:.3e}; launches {launches}")
    grid_map_ba_small(dev, counters, K, d_np)


def grid_map_ba_small(dev, counters, K, d_np) -> None:
    """map_track_mode="grid" with map BA on the 16-frame loop, GPU vs the
    CPU twins.  The whole run at 0.1 m map voxels (a cell holds a few
    points: the probe is the exact nearest neighbour, and the run does not
    hinge on the last bit of a point): the same keyframes, gates and
    control points, map size to TOL_MAP_SIZE_REL, the same observations,
    BA's cost within TOL_MAP_BA_COST_REL, poses within TOL_MAP_POSE.  Then,
    at the default 0.02 m (cells far above 16 points, where a one-voxel
    difference between the two runs' clouds moves a refinement by
    1e-4-1e-3), the GPU run's last refinement (a graph's replay, first
    held bit-equal to its eager run on the card) and its BA replayed
    through the CPU twins on the same inputs: iterations and convergence
    equal, T within TOL_EPILOGUE_T × 10; BA's counts equal, cost within
    TOL_MAP_BA_COST_REL, poses within TOL_MAP_POSE."""
    import dataclasses as dc

    import tpuslam_torch.slam as slam_mod
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.backend.posegraph import PoseGraph
    from tpuslam_torch.geom.cloud import PointCloud
    from tpuslam_torch.icp import align_to_index, flat_icp_scalars
    from tpuslam_torch.kernels.correspond import GridIndex
    from tpuslam_torch.slam import SlamSystem

    base = map_config()
    frames = d_np.shape[0]

    def run(device, cfg, record=None):
        slam = SlamSystem(K, cfg, enable_loop_closure=False,
                          track_against_map=True, map_track_mode="grid",
                          map_ba=True, device=device)
        d = torch.as_tensor(d_np, device=device)
        for i in range(frames):
            slam.process(d[i], timestamp=i / 30.0)
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes], slam.map.size(),
                [s["ok"] for s in slam.map_refine_stats],
                slam.trajectory()[1], slam.map_ba_stats)

    cfg = base.replace(voxel=dc.replace(base.voxel, map_voxel_size=0.1))
    for c in counters.values():
        c.reset()
    kg, sg, og, eg, bg = run(dev, cfg)
    launches = {k: c.launches for k, c in counters.items()}
    plain = {k: c.plain_calls for k, c in counters.items()}
    kc, sc, oc, ec, bc = run("cpu", cfg)
    err = float(np.abs(eg - ec).max())
    tag = "small map grid + map BA"
    check(kg == kc and len(kg) >= 4, f"{tag}: keyframes {kg} vs {kc}")
    check(abs(sg - sc) <= TOL_MAP_SIZE_REL * sc, f"{tag}: map {sg} vs {sc}")
    check(og == oc and np.mean(og) > 0.5, f"{tag}: gates {og} vs {oc}")
    check(bg["num_control"] == bc["num_control"]
          and bg["num_obs"] == bc["num_obs"]
          and abs(bg["cost"] - bc["cost"])
          <= TOL_MAP_BA_COST_REL * bc["cost"],
          f"{tag}: map BA {bg} vs {bc}")
    check(err <= TOL_MAP_POSE, f"{tag}: pose err {err}")
    check(launches["grid_correspond"] > 0 and launches["gn_step"] > 0,
          f"{tag}: launches {launches}")
    check(all(v == 0 for v in plain.values()), f"{tag}: plain {plain}")
    log(f"[small map] grid + map BA, 0.1 m map voxels: GPU vs CPU twins "
        f"identical keyframes ({len(kg)}) and gates ({sum(og)}/{len(og)} "
        f"ok), map size {sg} vs {sc}, map BA {bg} vs {bc}, pose max err "
        f"{err:.3e}; launches {launches}")

    # the default map voxels: the last refinement and BA, replayed
    seen = {}
    names = ("_refine_grid_jit", "build_map_ba_problem", "optimize_map_ba")
    saved = {n: getattr(slam_mod, n) for n in names}

    def recorder(name):
        def rec(*a, **kw):
            out = saved[name](*a, **kw)
            seen[name] = (a, kw, out)
            return out
        return rec

    for n in names:
        setattr(slam_mod, n, recorder(n))
    try:
        _, _, _, _, bg = run(dev, base)
    finally:
        for n, fn in saved.items():
            setattr(slam_mod, n, fn)

    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if isinstance(v, (PointCloud, PoseGraph, GridIndex)):
            return type(v)(*(cpu(f) for f in v))
        return v

    # the run's last refinement was a replay: the same inputs eagerly on
    # the card give its bits, and its iterations to hold to the CPU twins
    (cloud, index, T0, icp), _, flat = seen["_refine_grid_jit"]
    rg = align_to_index(cloud, index, T0, icp)
    check(bits_equal(flat_icp_scalars(rg), flat),
          f"{tag}: the last refinement's replay is not its eager run")
    rc = align_to_index(cpu(cloud), cpu(index), cpu(T0), icp)
    t_err = float((rg.T.cpu() - rc.T).abs().max())
    check(int(rg.iters) == int(rc.iters)
          and bool(rg.converged) == bool(rc.converged)
          and t_err <= 10 * TOL_EPILOGUE_T,
          f"{tag}: the last refinement replayed on the CPU: iters "
          f"{int(rg.iters)} vs {int(rc.iters)}, T err {t_err}")
    args, kw, _ = seen["build_map_ba_problem"]
    (graph, _, pg_cfg), okw, (gposes, _, _) = seen["optimize_map_ba"]
    prob = map_ba.build_map_ba_problem(*(cpu(a) for a in args),
                                       **{k: cpu(v) for k, v in kw.items()})
    poses, _, cost = map_ba.optimize_map_ba(cpu(graph), prob, pg_cfg, **okw)
    ba_err = float((poses - gposes.cpu()).abs().max())
    num_obs = int(float(prob.obs_w.sum()))
    check(num_obs == bg["num_obs"]
          and abs(float(cost) - bg["cost"])
          <= TOL_MAP_BA_COST_REL * abs(bg["cost"])
          and ba_err <= TOL_MAP_POSE,
          f"{tag}: BA replayed on the CPU: obs {num_obs} vs {bg['num_obs']},"
          f" cost {float(cost)} vs {bg['cost']}, pose err {ba_err}")
    log(f"[small map] grid + map BA, 0.02 m map voxels: the GPU's last "
        f"refinement on the CPU twins: iters {int(rc.iters)} equal, T err "
        f"{t_err:.3e}; its BA on the CPU twins: obs {num_obs} equal, cost "
        f"{float(cost):.6e} vs {bg['cost']:.6e}, pose err {ba_err:.3e}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


MAP_GRAPH_PROGRAMS = ("_refine_projective_jit", "_refine_grid_jit",
                      "ring_align", "_kf_cloud_jit", "_fuse",
                      "promote_bundle_jit", "pack_pyramid_jit",
                      "optimize_map_ba", "process_frame_jit")


def log_map_graphs(tag: str, card: str) -> None:
    """The map path's captured programs so far: keys, captured ones,
    replays, capture seconds and pool MiB, by program."""
    from tpuslam_torch import graphs

    by = {}
    for e in graphs.stats():
        if e["program"] in MAP_GRAPH_PROGRAMS:
            k = by.setdefault(e["program"], [0, 0, 0, 0.0, 0.0])
            k[0] += 1
            k[1] += e["captured"]
            k[2] += e["replays"]
            k[3] += e["capture_s"]
            k[4] += e["pool_mib"]
    log(f"[map graphs] {tag}: " + "; ".join(
        f"{p} {k[0]} keys, {k[1]} captured, {k[2]} replays, capture "
        f"{k[3]:.3f} s, pool {k[4]:.1f} MiB" for p, k in by.items())
        + f" ({card})")


def map_phase(dev, card: str, counters, loop, slam_ate: float,
              ref: dict) -> dict:
    """Frame-to-map tracking at 640×480, unsharded and sharded, under a
    one-rank NCCL group; each pass held to the reference's
    (`map_projective`, `map_sharded`).  Returns the path's launches (both
    runs) by kernel, and the unsharded fps."""
    import torch.distributed as dist

    from tpuslam_torch.bench.harness import (
        pass_result,
        run_map_bench,
        slam_bench_config,
    )
    from tpuslam_torch.dist.mesh import initialize_distributed
    from tpuslam_torch.dist.ring_map import drop_graphs as drop_ring_graphs
    from tpuslam_torch.slam import SlamSystem

    initialize_distributed(f"tcp://localhost:{free_port()}", world_size=1,
                           rank=0, backend="nccl", timeout_s=60)
    try:
        total = dict.fromkeys(counters, 0)
        fps = {}
        for sharded in (False, True):
            for c in counters.values():
                c.reset()
            out: dict = {}
            r = run_map_bench(120, 480, 640, sharded=sharded, device="cuda",
                              sequence=loop, outputs=out)
            launches = {k: c.launches for k, c in counters.items()}
            plain = {k: c.plain_calls for k, c in counters.items()}
            for k, v in launches.items():
                total[k] += v
            tag = f"map sharded={sharded}"
            fps[sharded] = r["fps"]
            log(f"[map] {json.dumps(r)}")
            log(f"[map] sharded={sharded}: fps {r['fps']:.3f}, ATE "
                f"{r['ate_rmse_m']:.4e} m (run_slam_bench's: {slam_ate:.4e} m)"
                f", keyframes {r['keyframes']}, closures {r['closures']}, map "
                f"size {r['map_size']}, refine ok share "
                f"{r['refine_ok_share']:.4f} of {r['map_refinements']}, "
                f"dropped {r['dropped_total']} ({card})")
            log(f"[map] sharded={sharded} launches {launches} plain calls "
                f"{plain}")
            name = "map_sharded" if sharded else "map_projective"
            ok = [x["ok"] for x in out["slam"].map_refine_stats]
            hold_pass(ref, name, pass_result(
                out["slam"], np.arange(120) / 30.0, loop[1]), "map", card)
            log(f"[map] sharded={sharded}: map size {r['map_size']} (the "
                f"reference on the CPU: {int(ref[f'{name}_map_size'])}), "
                f"gates {sum(ok)}/{len(ok)} ok (the reference's "
                f"{int(ref[f'{name}_refine_ok'].sum())}/"
                f"{ref[f'{name}_refine_ok'].size}) ({card})")
            del out
            check(r["poses_finite"], f"{tag}: non-finite poses")
            check(r["ate_rmse_m"] < MAP_ATE_M, f"{tag}: ATE {r['ate_rmse_m']}")
            check(r["refine_ok_share"] > 0.5,
                  f"{tag}: refine ok share {r['refine_ok_share']}")
            check(r["dropped_total"] == 0, f"{tag}: dropped points")
            # the ring ICP reduces, all-reduces, then solves: the
            # standalone gn_partials and gn_epilogue run only there
            ring = ("ring_nn", "gn_partials", "gn_epilogue")
            need = ("correspond", "gn_step") + (ring if sharded else ())
            check(all(launches[k] > 0 for k in need),
                  f"{tag}: launches {launches}")
            check(sharded or all(launches[k] == 0 for k in ring),
                  f"{tag}: ring kernels ran unsharded {launches}")
            check(launches["grid_correspond"] == 0,
                  f"{tag}: the grid probe ran in projective mode {launches}")
            check(all(v == 0 for v in plain.values()),
                  f"{tag}: plain calls {plain}")
            log_map_graphs(f"map sharded={sharded}", card)

        # where a frame's time goes, after the map has grown over 40
        # frames: stages on the host clock (8 frames), then 8 frames under
        # torch.profiler
        from torch.profiler import ProfilerActivity, profile

        K, _, d_np = loop
        d = torch.as_tensor(d_np, device=dev)
        ts = np.arange(d.shape[0]) / 30.0
        fills = {}
        for sharded in (False, True):
            slam = SlamSystem(K, slam_bench_config(480, 640, False),
                              enable_loop_closure=True,
                              track_against_map=True, sharded_map=sharded,
                              device=dev)
            for i in range(40):
                slam.process(d[i], timestamp=ts[i])
            spans: dict = {}
            fenced_spans(spans, slam.odo, ("process",))
            fenced_spans(spans, slam.map, ("insert",))
            fenced_spans(spans, slam, ("_attempt_loop_closure",
                                       "_refine_against_map"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(40, 48):
                slam.process(d[i], timestamp=ts[i])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            staged = sum(spans.values()) * 1e3
            log(f"[map stages] sharded={sharded}, frames 40-47: {wall:.3f} ms;"
                + ", ".join(f" {n} {v * 1e3:.3f} ms" for n, v in spans.items())
                + f"; the rest {wall - staged:.3f} ms ({card})")
            for n in ("_attempt_loop_closure", "_refine_against_map"):
                delattr(slam, n)
            delattr(slam.odo, "process")
            delattr(slam.map, "insert")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(48, 56):
                    slam.process(d[i], timestamp=ts[i])
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            rows = device_rows(prof)
            busy = sum(r[0] for r in rows)
            log(f"[map profile] sharded={sharded}, frames 48-55: wall "
                f"{wall_us:.1f} us (profiled), device busy {busy:.1f} us "
                f"({card})")
            for dt, cnt, key in rows[:10]:
                log(f"[map profile]   {dt:10.1f} us  {cnt:6d}x  {key[:90]}")
            # unsharded, the association's transform is inside its kernel:
            # fewer GEMMs than associations (each used to bring two); the
            # ring's hops allocate and fill nothing (each outer iteration
            # used to fill three buffers): the sharded frames' fills exceed
            # the unsharded ones' by fewer than one a hop
            fills[sharded] = count_ops(rows, "fill")
            gemms = count_ops(rows, "gemm")
            hit = per_launch_us(rows, "ring_nn" if sharded else "correspond")
            launched = hit[1] if hit else 0
            log(f"[map profile] sharded={sharded}: {fills[sharded]} fills, "
                f"{gemms} GEMMs, {launched} "
                f"{'ring hops' if sharded else 'associations'}"
                + (f", ring_nn {hit[0]:.3f} us a hop on average" if sharded
                   and hit else "") + f" ({card})")
            check(launched > 0, f"map profile sharded={sharded}: no launch")
            # the ring's solves transform nothing outside the kernel either
            check(gemms < launched,
                  f"map profile sharded={sharded}: {gemms} GEMMs against "
                  f"{launched} launches")
            check(not sharded or fills[True] - fills[False] < launched,
                  f"map profile: {fills} fills against {launched} hops")
        return total, fps[False]
    finally:
        # the ring's graphs hold NCCL collectives: they go before the group
        drop_ring_graphs()
        dist.destroy_process_group()


def grid_phase(dev, card: str, counters, loop, map_fps: float,
               probe: dict, table: dict, ref: dict) -> dict:
    """The grid path at full width (phase 12b): run_map_bench's 120 frames
    at 640×480 with map_track_mode="grid" and map BA at the end
    (unsharded).  `probe` and `table` are phase 3's stats of the probe and
    the table build: the table is set against the library route of equal
    work on this run's probes an index.  The timed pass is held to the
    reference's (`map_grid`).  Returns the timed pass's launches by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tpuslam_torch.bench.harness import (
        pass_result,
        run_map_bench,
        slam_bench_config,
    )
    from tpuslam_torch.kernels import correspond
    from tpuslam_torch.slam import SlamSystem

    out: dict = {}
    r = run_map_bench(120, 480, 640, device="cuda", sequence=loop,
                      map_track_mode="grid", map_ba=True, outputs=out)
    launches, plain = r["launches"], r["plain_calls"]
    ba = r["map_ba"] or {}
    hold_pass(ref, "map_grid", {
        **pass_result(out["slam"], np.arange(120) / 30.0, loop[1]),
        "poses_before_ba": out["before_ba"][1],
        "map_ba_num_obs": ba.get("num_obs", -1),
        "map_ba_cost": ba.get("cost", float("nan"))}, "grid", card)
    log(f"[grid] map size {r['map_size']} (the reference on the CPU: "
        f"{int(ref['map_grid_map_size'])}) ({card})")
    del out
    log(f"[grid] {json.dumps(r)}")
    log(f"[grid] fps {r['fps']:.3f} (projective, phase 12 unsharded: "
        f"{map_fps:.3f}), ATE {r['ate_rmse_m']:.4e} m (before map BA "
        f"{r['ate_before_ba_m']:.4e}), keyframes {r['keyframes']}, closures "
        f"{r['closures']}, map size {r['map_size']}, refine ok share "
        f"{r['refine_ok_share']:.4f} of {r['map_refinements']}, map BA {ba};"
        f" grid_correspond {launches['grid_correspond'] / 120:.3f} launches "
        f"a frame ({card})")
    log(f"[grid] launches {launches} plain calls {plain}")
    check(r["poses_finite"], "grid: non-finite poses")
    check(r["ate_rmse_m"] < MAP_ATE_M, f"grid: ATE {r['ate_rmse_m']}")
    check(r["refine_ok_share"] > 0.5,
          f"grid: refine ok share {r['refine_ok_share']}")
    check(ba.get("num_obs", 0) > 100, f"grid: map BA {ba}")
    # tests/test_slam.py:90-107: BA must not blow up the trajectory
    check(r["ate_rmse_m"] < max(1.5 * r["ate_before_ba_m"], MAP_ATE_M),
          f"grid: ATE after map BA {r['ate_rmse_m']} against "
          f"{r['ate_before_ba_m']} before")
    check(all(launches[k] > 0 for k in ("grid_correspond", "grid_table",
                                        "correspond", "gn_step")),
          f"grid: launches {launches}")
    check(all(v == 0 for v in plain.values()), f"grid: plain {plain}")
    log_map_graphs("grid", card)
    # equal work: the probe with its table, the build amortized over the
    # probes an index on this path, against the library's searches and
    # gather of the same 27 cells a query (phase 3's shapes)
    per_build = launches["grid_correspond"] / launches["grid_table"]
    amortized = table["ms"] / per_build
    log(f"[grid] the table against the library on equal work: "
        f"{per_build:.3f} probes an index build on this path; the probe "
        f"(voxel-key order) {probe['ms_voxel_order']:.5f} ms + the build "
        f"{table['ms']:.5f} ms / {per_build:.3f} = "
        f"{probe['ms_voxel_order'] + amortized:.5f} ms a probe with its "
        f"table, of which the table {amortized:.5f} ms; torch.searchsorted "
        f"of the 27 cell keys a query with the gather of each key's first "
        f"row {table['searchsorted_gather_ms']:.5f} ms (its scan and "
        f"choice of the nearest row not counted), the search alone "
        f"{table['library_ms']:.5f} ms ({card})")

    # frames 40-47 on the host clock, each stage fenced: the refinement
    # (which includes the index build after a keyframe), the index build,
    # the map insert; frames 48-55 under torch.profiler; then map BA
    K, _, d_np = loop
    d = torch.as_tensor(d_np, device=dev)
    ts = np.arange(d.shape[0]) / 30.0
    slam = SlamSystem(K, slam_bench_config(480, 640, False),
                      enable_loop_closure=True, track_against_map=True,
                      map_track_mode="grid", map_ba=True, device=dev)
    for i in range(40):
        slam.process(d[i], timestamp=ts[i])
    spans: dict = {}
    fenced_spans(spans, slam.odo, ("process",))
    fenced_spans(spans, slam.map, ("insert", "build_index"))
    fenced_spans(spans, slam, ("_attempt_loop_closure",
                               "_refine_against_map"))
    with_cell_table = correspond.with_cell_table
    fenced_spans(spans, correspond, ("with_cell_table",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(40, 48):
            slam.process(d[i], timestamp=ts[i])
        torch.cuda.synchronize()
    finally:
        correspond.with_cell_table = with_cell_table
    wall = (time.perf_counter() - t0) * 1e3
    outer = sum(v for n, v in spans.items()
                if n not in ("build_index", "with_cell_table")) * 1e3
    log(f"[grid stages] frames 40-47: {wall:.3f} ms;"
        + ", ".join(f" {n} {v * 1e3:.3f} ms" for n, v in spans.items())
        + f" (build_index inside _refine_against_map, the table build "
        f"with_cell_table inside build_index); the rest "
        f"{wall - outer:.3f} ms ({card})")
    for n in ("_attempt_loop_closure", "_refine_against_map"):
        delattr(slam, n)
    delattr(slam.odo, "process")
    for n in ("insert", "build_index"):
        delattr(slam.map, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(48, 56):
            slam.process(d[i], timestamp=ts[i])
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r_[0] for r_ in rows)
    hit = per_launch_us(rows, "grid_correspond")
    log(f"[grid profile] frames 48-55: wall {wall_us:.1f} us (profiled), "
        f"device busy {busy:.1f} us; "
        + (f"grid_correspond {hit[0]:.3f} us a launch, {hit[1]} launches"
           if hit else "grid_correspond: not seen") + f" ({card})")
    for dt, cnt, key in rows[:10]:
        log(f"[grid profile]   {dt:10.1f} us  {cnt:6d}x  {key[:90]}")
    check(hit is not None, "grid profile: no grid_correspond launch")
    correspond.grid_counter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ran = slam.refine_map_ba()
    torch.cuda.synchronize()
    log(f"[grid] map BA over {slam._num_graph_nodes} keyframes after frame "
        f"55: {(time.perf_counter() - t0) * 1e3:.3f} ms on the host clock, "
        f"{correspond.grid_counter.launches} probe launch, stats "
        f"{slam.map_ba_stats} ({card})")
    check(ran and correspond.grid_counter.launches == 1,
          "grid: map BA did not run through one probe launch")
    return launches


def drift_phase(dev, card: str, counters, loop, deferred_fps: float,
                ref: dict):
    """slam-drift-vga (phase 9b): run_slam_bench's 120-frame 640×480
    two-lap loop, boundary chunks of 8, the deferred backend, the drift
    injected before every chunk; descriptor proposal off and on.  Returns
    the descriptor run's launches.  Each pass is held to the reference's
    (`drift_off`, `drift_on`)."""
    from tpuslam_torch.bench.harness import (
        DRIFT_PER_CHUNK,
        drift_config,
        drive_drifted,
        pass_result,
    )
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    K, gt, d_np = loop
    d = torch.as_tensor(d_np, device=dev)
    ts = np.arange(d.shape[0]) / 30.0
    res = {}
    for on in (False, True):
        slam = SlamSystem(K, drift_config(on), enable_loop_closure=True,
                          async_backend=True, chunk_mode="boundary",
                          chunk_sub=4, device=dev)
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive_drifted(slam, d, ts, 0, d.shape[0])
        slam.finalize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        plain = {k: c.plain_calls for k, c in counters.items()}
        t_est, est = slam.trajectory()
        res[on] = {
            "fps": d.shape[0] / wall, "closures": len(slam.closures),
            "closure_pairs": [[c.i, c.j] for c in slam.closures],
            "keyframes": len(slam.odo.keyframes),
            "ate_rmse_m": ate_rmse(t_est, est, ts, gt,
                                   max_difference=0.005)["rmse"],
            "poses_finite": bool(np.all(np.isfinite(est))),
            "launches": launches, "plain_calls": plain}
        descs = [r.desc for r in slam.odo.keyframes if r.cloud is not None]
        log(f"[drift] lc_descriptor={on}: {json.dumps(res[on])}")
        hold_pass(ref, f"drift_{'on' if on else 'off'}",
                  pass_result(slam, ts, gt), "drift", card)
        check(res[on]["poses_finite"], f"drift {on}: non-finite poses")
        check(launches["correspond"] > 0 and launches["gn_step"] > 0,
              f"drift {on}: launches {launches}")
        check(all(v == 0 for v in plain.values()),
              f"drift {on}: plain calls {plain}")
        if on:
            check(descs and all(isinstance(x, np.ndarray) for x in descs),
                  "drift: a descriptor is not a numpy array: "
                  f"{sorted({type(x).__name__ for x in descs})}")
        else:
            check(all(x is None for x in descs), "drift off: descriptors")
    off, on = res[False], res[True]
    log(f"[drift] 120 frames 640×480, {DRIFT_PER_CHUNK} m of drift a chunk: "
        f"closures off {off['closures']} / on {on['closures']}, ATE off "
        f"{off['ate_rmse_m']:.4e} m / on {on['ate_rmse_m']:.4e} m, fps off "
        f"{off['fps']:.3f} / on {on['fps']:.3f} (one pass each; "
        f"run_slam_bench deferred, phase 9: {deferred_fps:.3f}) ({card})")
    check(on["closures"] >= 1, "drift: the descriptor run closed no loop")
    check(on["ate_rmse_m"] < 0.5 * off["ate_rmse_m"],
          f"drift: ATE on {on['ate_rmse_m']} not below half of off "
          f"{off['ate_rmse_m']}")
    check(off["closures"] < on["closures"],
          f"drift: off closed {off['closures']}, on {on['closures']}")
    return on["launches"]


def fallback_phase(dev, card: str, counters, loop) -> dict:
    """The grid-hash verification fallbacks at full width (phase 9c):
    slam-drift-vga with descriptors saved after 24 frames under
    verify_level=2 and resumed at verify_level=1 (the attempts then hold
    tables of two shapes), then one relocalization with K=None on the card
    against its CPU twin.  Returns the resumed run's launches."""
    import tempfile

    from tpuslam_torch.backend.relocalize import relocalize
    from tpuslam_torch.bench.harness import drift_config, drive_drifted
    from tpuslam_torch.geom import se3
    from tpuslam_torch.slam import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    K, _, d_np = loop
    d = torch.as_tensor(d_np, device=dev)
    ts = np.arange(d.shape[0]) / 30.0
    cut = 24

    def new(level):
        return SlamSystem(K, drift_config(True, level),
                          enable_loop_closure=True, async_backend=True,
                          chunk_mode="boundary", chunk_sub=4, device=dev)

    writer = new(2)
    drive_drifted(writer, d, ts, 0, cut)
    slam = new(1)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(f"{tmp}/l2.npz", writer, writer.odo.frame_idx)
        check(load_checkpoint(f"{tmp}/l2.npz", slam) == cut,
              "fallback: resume frame")
    # each grid attempt, fenced on the host clock (and inside it the
    # verification and the pose-graph solve), its probe launches, and the
    # closures its drain accepts
    import tpuslam_torch.slam as slam_mod

    grid = {"ms": [], "probes": [], "packed": [], "closures": 0,
            "verify_ms": [], "solve_ms": []}
    real_chain = slam._chain_attempt_fallback
    real_drain = slam._drain_closure_attempt
    probe = counters["grid_correspond"]
    stages = {"verify_batch_grid": "verify_ms", "optimize": "solve_ms"}

    def chain(*a):
        saved = {n: getattr(slam_mod, n) for n in stages}
        spans: dict = {}
        fenced_spans(spans, slam_mod, stages)
        torch.cuda.synchronize()
        n0, t0 = probe.launches, time.perf_counter()
        try:
            out = real_chain(*a)
            torch.cuda.synchronize()
        finally:
            for n, fn in saved.items():
                setattr(slam_mod, n, fn)
        grid["ms"].append((time.perf_counter() - t0) * 1e3)
        for n, key in stages.items():
            grid[key].append(spans.get(n, 0.0) * 1e3)
        grid["probes"].append(probe.launches - n0)
        grid["packed"].append(out)
        return out

    def drain(p, flat=None):
        n0 = len(slam.closures)
        out = real_drain(p, flat)
        if any(p.packed is x for x in grid["packed"]):
            grid["closures"] += len(slam.closures) - n0
        return out

    slam._chain_attempt_fallback = chain
    slam._drain_closure_attempt = drain
    for c in counters.values():
        c.reset()
    drive_drifted(slam, d, ts, cut, d.shape[0])
    slam.finalize()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    plain = {k: c.plain_calls for k, c in counters.items()}
    levels = sorted({r.verify.level for r in slam.odo.keyframes
                     if r.verify is not None})
    def ms(key):
        return ", ".join(f"{v:.3f}" for v in grid[key])

    log(f"[fallback] resumed at frame {cut} (verify_level 2 → 1, table "
        f"levels {levels}): {len(slam.closures)} closures, "
        f"{len(grid['ms'])} grid attempts accepting {grid['closures']}; "
        f"an attempt {ms('ms')} ms on the host clock (the verification "
        f"{ms('verify_ms')} ms, the pose-graph solve {ms('solve_ms')} ms), "
        f"grid_correspond launches an attempt {grid['probes']} ({card})")
    log(f"[fallback] launches {launches} plain calls {plain}")
    check(levels == [1, 2], f"fallback: table levels {levels}")
    check(grid["closures"] >= 1,
          f"fallback: the grid attempt verified no closure ({grid['ms']})")
    check(all(launches[k] > 0 for k in ("grid_correspond", "gn_step")),
          f"fallback: launches {launches}")
    check(all(v == 0 for v in plain.values()),
          f"fallback: plain calls {plain}")

    # relocalization without tables: keyframe 1's cloud seen from an
    # offset pose (tests/test_reloc.py), two candidates from two guesses
    kfs = slam.odo.keyframes
    T_off = se3.exp(torch.tensor([0.02, -0.015, 0.01, 0.01, -0.01, 0.008],
                                 device=dev))
    q = kfs[1].cloud.transform(T_off)
    T_last = kfs[1].T_world_kf.astype(np.float64) @ np.linalg.inv(
        T_off.cpu().numpy().astype(np.float64))
    cpu_kfs = [r._replace(
        cloud=None if r.cloud is None else type(r.cloud)(
            *(t.cpu() for t in r.cloud)),
        verify=None) for r in kfs]
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rg = relocalize(q, kfs, T_last, slam.cfg.icp, slam.cfg.posegraph,
                    max_candidates=2, K=None)
    reloc_ms = (time.perf_counter() - t0) * 1e3
    probes = counters["grid_correspond"].launches
    plain = {k: c.plain_calls for k, c in counters.items()}
    rc = relocalize(type(q)(*(t.cpu() for t in q)), cpu_kfs, T_last,
                    slam.cfg.icp, slam.cfg.posegraph, max_candidates=2,
                    K=None)
    check(rg is not None and rc is not None, f"reloc: {rg} / {rc}")
    err = float(np.abs(rg.T_kf_cam - rc.T_kf_cam).max())
    log(f"[fallback] relocalize K=None, ≤ 2 candidates × 2 guesses: keyframe "
        f"{rg.kf_id} (CPU twin {rc.kf_id}), T max err {err:.3e}, "
        f"{reloc_ms:.3f} ms on the host clock, {probes} grid_correspond "
        f"launches ({card})")
    check(rg.kf_id == rc.kf_id, f"reloc: keyframe {rg.kf_id} vs {rc.kf_id}")
    check(err <= TOL_SLAM_POSE, f"reloc: T err {err}")
    check(probes > 0 and all(v == 0 for v in plain.values()),
          f"reloc: probes {probes}, plain calls {plain}")
    return launches


def host_libraries() -> dict:
    """Which of the depth decoders' and viz's dependencies this host has:
    OpenCV, PIL, matplotlib (imports) and libpng's headers (g++ -E)."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "PIL", "matplotlib")}
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input="#include <png.h>\n", text=True,
                              capture_output=True, timeout=60)
        have["png.h"] = proc.returncode == 0
    except OSError:
        have["png.h"] = False
    return have


def png_filter_rates(reps: int = 3) -> dict:
    """Decode fps on this host of a 640×480 16-bit depth PNG whose rows all
    use one filter, by decoder; OpenCV writes the five filters, so without
    it the rates are not measured ({})."""
    import tempfile
    import zlib

    try:
        import cv2
    except ImportError:
        return {}
    from tpuslam_torch.bench.harness import _intrinsics
    from tpuslam_torch.data import tum
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth

    counts = np.round(render_depth(orbit_trajectory(2)[1],
                                   _intrinsics(480, 640), 480, 640)
                      * 5000.0).astype(np.uint16)
    names = [d for d in tum.DECODERS
             if d != "native" or tum.depth_decoder() == "native"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for code, filt in enumerate(("NONE", "SUB", "UP", "AVG", "PAETH")):
            path = f"{tmp}/{filt}.png"
            cv2.imwrite(path, counts, [cv2.IMWRITE_PNG_FILTER,
                                       getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")])
            # each row's first byte is its filter type (one IDAT stream)
            data = open(path, "rb").read()
            idat, pos = b"", 8
            while pos < len(data):
                n = int.from_bytes(data[pos:pos + 4], "big")
                if data[pos + 4:pos + 8] == b"IDAT":
                    idat += data[pos + 8:pos + 8 + n]
                pos += 12 + n
            rows = set(zlib.decompress(idat)[::1 + 640 * 2])
            check(rows <= {0, code} and (code in rows or code == 0),
                  f"png {filt}: OpenCV wrote row filters {rows}")
            out[filt] = {}
            for name in names:
                dec = tum._DECODE[name]
                check(np.array_equal(dec(path), counts),
                      f"png {filt}: {name} decoded other counts")
                t0 = time.perf_counter()
                for _ in range(reps):
                    dec(path)
                out[filt][name] = reps / (time.perf_counter() - t0)
    return out


def graph_closures(system) -> list:
    """The loop-closure pairs of a SlamSystem's pose graph in the order they
    were added: its edges of the closure weight (a system that has made no
    relocalization has no other such edge)."""
    from tpuslam_torch.slam import LC_EDGE_WEIGHT

    g = system.graph
    n = g.num_edges
    return [(int(i), int(j)) for i, j, w in zip(
        g._edge_i[:n], g._edge_j[:n], g._edge_w[:n]) if w == LC_EDGE_WEIGHT]


def cli_phase(card: str, counters, slam_fps: float, ref: dict) -> dict:
    """The user's entry point at full width (module doc, phase 13), its
    runs held to the reference CLI's (`ref`, the file's arrays).  Returns
    the kernels' launches, {"run_slam": …, "sharded": …, "grid": …}:
    run_slam (the main path), the sharded run and the grid run."""
    import hashlib
    import io
    import tempfile
    from contextlib import redirect_stdout

    from tpuslam_torch import cli
    from tpuslam_torch.bench.harness import (
        _intrinsics,
        bench_loader,
        slam_bench_config,
    )
    from tpuslam_torch.data import tum
    from tpuslam_torch.data.synthetic import (
        loop_trajectory,
        write_tum_sequence,
    )
    from tpuslam_torch.frontend import Odometry
    from tpuslam_torch.slam import SlamSystem

    def counts():
        return ({k: c.launches for k, c in counters.items()},
                {k: c.plain_calls for k, c in counters.items()})

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = cli.main(list(argv))
        check(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
        return (json.loads(buf.getvalue().strip().splitlines()[-1]),
                time.perf_counter() - t0)

    def held(prefix, summary, path, made, tol=TOL_REF_LOOP_M):
        """A CLI run held to the reference CLI's: the poses written to
        `path` at full precision, the keyframes of the system `made` (a
        LastInstance) and its closure pairs as its pose graph holds them
        (`graph_closures`: a resumed system's `closures` are only those it
        found after the checkpoint, its graph has them all)."""
        system = made.made
        odo = getattr(system, "odo", system)
        closures = []
        if odo is not system:
            closures = graph_closures(system)
            own = [(c.i, c.j) for c in system.closures]
            check(not system.relocalizations and (not own or closures[
                -len(own):] == own), f"cli {prefix}: the graph's loop edges "
                  f"{closures} against the system's closures {own}")
        hold_pass(ref, prefix, {
            "poses": written[path],
            "keyframes": [k.index for k in odo.keyframes],
            "closures": closures, "ate_rmse_m": summary["ate_rmse_m"]},
            "cli", card, tol)

    # the poses each run writes, to compare bits (the file holds 6 digits)
    written = {}
    write_trajectory = tum.write_trajectory

    def capture(path, ts, poses):
        written[path] = np.array(poses)
        write_trajectory(path, ts, poses)

    log(f"[cli] depth decoder: {tum.decoder_note()}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        seq, cfg_path, ck = f"{tmp}/seq", f"{tmp}/cfg.json", f"{tmp}/ck.npz"
        t0 = time.perf_counter()
        write_tum_sequence(seq, 120, _intrinsics(480, 640), 480, 640,
                           poses=loop_trajectory(120, cycles=2, radius=0.35))
        log(f"[cli] wrote 120 frames 640×480 in TUM's layout in "
            f"{time.perf_counter() - t0:.3f} s")
        # the reference's CLI read the same depth: each decoded PNG's hash
        hashes = [hashlib.sha256(np.ascontiguousarray(f.depth, "<u2")
                                 .tobytes()).hexdigest()
                  for f in tum.TumSequence(seq).frames(raw=True)]
        want = ref["cli_slam_depth_sha256"].tolist() if (
            "cli_slam_depth_sha256" in ref) else None
        log(f"[cli] the decoded depth PNGs' sha256 against the reference "
            f"writer's: {'equal' if hashes == want else 'DIFFER'} "
            f"({len(hashes)} frames)")
        check(hashes == want, "cli: the written sequence decodes to other "
              "depth than the reference's")
        with open(cfg_path, "w") as f:
            f.write(slam_bench_config(480, 640, False).to_json())
        common = ("run_slam", "--sequence", seq, "--config", cfg_path,
                  "--chunk", "8", "--chunk-sub", "4", "--async-backend")
        traj = {k: f"{tmp}/{k}.txt" for k in ("raw", "f32", "resumed", "odo",
                                              "sharded", "grid")}
        tum.write_trajectory = capture
        try:
            for c in counters.values():
                c.reset()
            with LastInstance(SlamSystem) as made:
                raw, wall = run(*common, "--upload-raw", "--checkpoint", ck,
                                "--checkpoint-every", "48", "--traj-out",
                                traj["raw"], "--log-jsonl",
                                f"{tmp}/log.jsonl")
            launches, plain = counts()
            held("cli_slam", raw, traj["raw"], made)
            out["run_slam"] = launches
            log(f"[cli] run_slam --upload-raw: {json.dumps(raw)}")
            log(f"[cli] run_slam --upload-raw: fps {raw['fps']:.3f}, "
                f"fps_steady {raw.get('fps_steady', float('nan')):.3f} "
                f"(run_slam_bench deferred, phase 9: {slam_fps:.3f}), ATE "
                f"{raw['ate_rmse_m']:.4e} m, closures {raw['loop_closures']}, "
                f"keyframes {raw['keyframes']}, {wall:.3f} s in all ({card})")
            log(f"[cli] run_slam launches {launches} plain calls {plain}")
            check(raw["frames"] == 120, f"cli: {raw['frames']} frames")
            check(raw["ate_rmse_m"] < 1e-3, f"cli: ATE {raw['ate_rmse_m']}")
            check(raw["loop_closures"] >= 1, "cli: no closure")
            check(launches["correspond"] > 0 and launches["gn_step"] > 0,
                  f"cli: launches {launches}")
            check(all(v == 0 for v in plain.values()), f"cli: plain {plain}")

            # no checkpoint: the fps of decode and upload alone, and the
            # saves' drains must not change the trajectory either
            with LastInstance(SlamSystem) as made:
                f32, wall = run(*common, "--traj-out", traj["f32"])
            held("cli_slam", f32, traj["f32"], made)
            same = np.array_equal(written[traj["raw"]], written[traj["f32"]])
            log(f"[cli] run_slam float32 upload, no checkpoint: fps "
                f"{f32['fps']:.3f}, "
                f"fps_steady {f32.get('fps_steady', float('nan')):.3f}, "
                f"ATE {f32['ate_rmse_m']:.4e} m; trajectory bit-equal to "
                f"--upload-raw: {same} ({card})")
            check(same, "cli: --upload-raw differs from the float32 upload")

            with LastInstance(SlamSystem) as made:
                res, wall = run(*common, "--upload-raw", "--resume", ck,
                                "--traj-out", traj["resumed"])
            held("cli_slam", res, traj["resumed"], made)
            err = float(np.abs(written[traj["resumed"]]
                               - written[traj["raw"]]).max())
            log(f"[cli] resumed from the checkpoint at frame 96 "
                f"({os.path.getsize(ck) / 2 ** 20:.2f} MiB): "
                f"{json.dumps(res)}; pose max err vs the uninterrupted run "
                f"{err:.3e}")
            check(err <= TOL_RESUME, f"cli: resume err {err}")

            with LastInstance(Odometry) as made:
                odo, wall = run("run_odometry", "--sequence", seq,
                                "--config", cfg_path, "--traj-out",
                                traj["odo"])
            held("cli_odometry", odo, traj["odo"], made, TOL_REF_ORBIT)
            log(f"[cli] run_odometry: fps {odo['fps']:.3f}, ATE "
                f"{odo['ate_rmse_m']:.4e} m, keyframes {odo['keyframes']} "
                f"({card})")
            check(odo["ate_rmse_m"] < 1e-3, f"cli odometry: ATE "
                  f"{odo['ate_rmse_m']}")

            ev, _ = run("eval", "--trajectory", traj["raw"], "--groundtruth",
                        f"{seq}/groundtruth.txt")
            d_ate = abs(ev["ate"]["rmse"] - raw["ate_rmse_m"])
            log(f"[cli] eval of the run_slam trajectory file: ATE "
                f"{ev['ate']['rmse']:.4e} m (run_slam's summary "
                f"{raw['ate_rmse_m']:.4e} m; the file holds 6 decimals)")
            check(d_ate <= 1e-6, f"cli eval: ATE differs by {d_ate}")

            for c in counters.values():
                c.reset()
            sh, wall = run("run_slam", "--sequence", seq, "--config",
                           cfg_path, "--stop", "48", "--track-against-map",
                           "--sharded-map", "--traj-out", traj["sharded"])
            launches, plain = counts()
            out["sharded"] = launches
            log(f"[cli] run_slam --track-against-map --sharded-map, 48 "
                f"frames: fps {sh['fps']:.3f}, ATE {sh['ate_rmse_m']:.4e} m "
                f"({card}); launches {launches} plain calls {plain}")
            check(sh["ate_rmse_m"] < MAP_ATE_M, f"cli sharded: ATE "
                  f"{sh['ate_rmse_m']}")
            check(all(launches[k] > 0 for k in ("ring_nn", "gn_partials",
                                                "gn_epilogue")),
                  f"cli sharded: launches {launches}")
            check(all(v == 0 for v in plain.values()),
                  f"cli sharded: plain {plain}")

            for c in counters.values():
                c.reset()
            gr, wall = run("run_slam", "--sequence", seq, "--config",
                           cfg_path, "--stop", "48", "--track-against-map",
                           "--map-track-mode", "grid", "--map-ba",
                           "--traj-out", traj["grid"])
            launches, plain = counts()
            out["grid"] = launches
            log(f"[cli] run_slam --track-against-map --map-track-mode grid "
                f"--map-ba, 48 frames: fps {gr['fps']:.3f}, ATE "
                f"{gr['ate_rmse_m']:.4e} m, map BA {gr.get('map_ba')} "
                f"({card}); launches {launches} plain calls {plain}")
            check("map_ba" in gr and gr["map_ba"]["num_obs"] > 100,
                  f"cli grid: map BA {gr.get('map_ba')}")
            check(gr["ate_rmse_m"] < MAP_ATE_M, f"cli grid: ATE "
                  f"{gr['ate_rmse_m']}")
            check(all(launches[k] > 0 for k in ("grid_correspond",
                                                "correspond", "gn_step")),
                  f"cli grid: launches {launches}")
            check(all(v == 0 for v in plain.values()),
                  f"cli grid: plain {plain}")

            for c in counters.values():
                c.reset()
            lc, wall = run(*common, "--lc-descriptor", "--traj-out",
                           f"{tmp}/lc.txt")
            launches, plain = counts()
            out["lc_descriptor"] = launches
            log(f"[cli] run_slam --lc-descriptor: fps {lc['fps']:.3f}, ATE "
                f"{lc['ate_rmse_m']:.4e} m, closures {lc['loop_closures']} "
                f"({card}); launches {launches} plain calls {plain}")
            check(lc["ate_rmse_m"] < 1e-3, f"cli lc-descriptor: ATE "
                  f"{lc['ate_rmse_m']}")
            check(lc["loop_closures"] >= 1, "cli lc-descriptor: no closure")
            check(launches["correspond"] > 0 and launches["gn_step"] > 0,
                  f"cli lc-descriptor: launches {launches}")
            check(all(v == 0 for v in plain.values()),
                  f"cli lc-descriptor: plain {plain}")
        finally:
            tum.write_trajectory = write_trajectory
    loader = bench_loader(480, 640)
    log(f"[cli] bench_loader 640×480, 40 frames: {json.dumps(loader)} "
        f"({card})")
    rates = png_filter_rates()
    log(f"[cli] depth PNG decode fps on this host by row filter, 640×480 "
        f"16-bit, one thread: "
        f"{json.dumps(rates) if rates else 'not measured (no OpenCV)'}")
    return out


def scale_phase(card: str, counters, ref: dict) -> None:
    """bench_scale at its own config (phase 14), held to the reference's
    pass (`scale`)."""
    from tpuslam_torch.bench.harness import bench_scale, pass_result
    from tpuslam_torch.data.synthetic import loop_trajectory

    for c in counters.values():
        c.reset()
    out: dict = {}
    r = bench_scale(outputs=out)
    launches = {k: c.launches for k, c in counters.items()}
    plain = {k: c.plain_calls for k, c in counters.items()}
    log(f"[scale] {json.dumps(r)}")
    log(f"[scale] {r['frames']} frames {r['resolution']}: fps {r['fps']:.3f},"
        f" graph nodes {r['graph_nodes']} (capacity {r['node_capacity']}), "
        f"keyframes {r['keyframes']}, retained clouds "
        f"{r['retained_clouds']}, closures {r['loop_closures']}, ATE "
        f"{r['ate_rmse_m']:.4e} m, lost {r['lost_frames']} ({card}); "
        f"{ref_outcome(ref, 'scale')}")
    log(f"[scale] launches {launches} plain calls {plain}")
    hold_pass(ref, "scale", pass_result(
        out["slam"], np.arange(r["frames"]) / 30.0,
        loop_trajectory(r["frames"], cycles=5)), "scale", card)
    del out
    check(r["graph_nodes"] > 256, f"scale: {r['graph_nodes']} nodes")
    check(r["keyframes"] == r["graph_nodes"], "scale: keyframes ≠ nodes")
    check(r["retained_clouds"] <= 48 + 24,
          f"scale: {r['retained_clouds']} clouds")
    check(r["loop_closures"] >= 2, f"scale: {r['loop_closures']} closures")
    check(r["ate_rmse_m"] < SCALE_ATE_M, f"scale: ATE {r['ate_rmse_m']}")
    check(r["poses_finite"], "scale: non-finite poses")
    check(launches["correspond"] > 0 and launches["gn_step"] > 0,
          f"scale: launches {launches}")
    check(all(v == 0 for v in plain.values()), f"scale: plain {plain}")


def pathology_phase(card: str, counters, ref: dict) -> None:
    """bench_pathology at its own size (phase 15), held to the reference's
    pass (`pathology`)."""
    from tpuslam_torch.bench.harness import bench_pathology, pass_result
    from tpuslam_torch.data.synthetic import burst_trajectory

    for c in counters.values():
        c.reset()
    out: dict = {}
    r = bench_pathology(outputs=out)
    plain = {k: c.plain_calls for k, c in counters.items()}
    log(f"[pathology] {json.dumps(r)}")
    log(f"[pathology] {r['frames']} frames {r['resolution']}: fps "
        f"{r['fps']:.3f}, ATE {r['ate_rmse_m']:.4e} m, lost "
        f"{r['lost_frames']}, closures {r['loop_closures']}, keyframes "
        f"{r['keyframes']} ({card}); {ref_outcome(ref, 'pathology')}")
    n = r["frames"]
    hold_pass(ref, "pathology", pass_result(
        out["slam"], np.arange(n) / 30.0,
        burst_trajectory(n, burst_start=n // 2, burst_len=8,
                         burst_rate=0.05)), "pathology", card)
    del out
    check(r["ate_rmse_m"] < PATHOLOGY_ATE_M,
          f"pathology: ATE {r['ate_rmse_m']}")
    check(r["lost_frames"] == 0, f"pathology: {r['lost_frames']} lost")
    check(all(v == 0 for v in plain.values()), f"pathology: plain {plain}")


DIST_WORLD = 4             # gloo ranks sharing the one card
DIST_BATCH = 8             # the batched aligner's pairs, 2 a rank
DIST_BENCH_FRAMES = 24     # run_bench's frames on each of the 4 ranks
DIST_TIMEOUT_S = 420       # the 4 ranks' limit (each, and the gloo group)
TOL_DIST_ICP_T = 1e-5      # tests/test_dist.py:67-71
TOL_DIST_ICP_ITERS = 3
TOL_DIST_PG = 5e-4         # tests/test_dist.py:101-103
TOL_DIST_BA = 5e-5         # tests/test_map_ba.py:194-197
TOL_DIST_BATCH = 2e-4      # tests/test_batch_eval.py


class LastInstance:
    """Keeps the last instance of `cls` made inside the `with` block (a
    phase's SlamSystem, whose final state a later phase reads)."""

    def __init__(self, cls):
        self.cls, self.made = cls, None

    def __enter__(self):
        init = self.init = self.cls.__init__
        keep = self

        def wrapped(obj, *a, **k):
            init(obj, *a, **k)
            keep.made = obj
        self.cls.__init__ = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.init


def dist_phase(dev, card: str, counters, orbit, pg_in, ba_in) -> dict:
    """The distributed stages (phase 16): one rank under an NCCL group,
    then four gloo ranks on the one card (module doc).  `orbit` is phase
    6's sequence; `pg_in` (graph, PoseGraphConfig) phase 14's final graph;
    `ba_in` (graph, problem, PoseGraphConfig, huber) phase 12b's map BA.
    Returns the path kernels' launches: the one-rank sharded ICP, and each
    gloo rank's sharded ICP and batched alignment."""
    import tempfile
    from pathlib import Path

    import torch.distributed as dist

    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.backend.map_ba import (
        optimize_map_ba,
        optimize_map_ba_spmd,
        partition_observations,
    )
    from tpuslam_torch.backend.posegraph import optimize_pose_graph
    from tpuslam_torch.bench import dist_ranks
    from tpuslam_torch.bench.harness import run_bench
    from tpuslam_torch.config import SLAMConfig
    from tpuslam_torch.dist.batch_eval import make_batched_aligner
    from tpuslam_torch.dist.mesh import (
        drop_graphs,
        initialize_distributed,
        make_mesh,
    )
    from tpuslam_torch.dist.sharded_icp import align_frames_spmd
    from tpuslam_torch.frontend import preprocess
    from tpuslam_torch.icp import Frame, align_frames

    K, gt, d_np = orbit
    frames, height, width = d_np.shape
    cfg = SLAMConfig(height=height, width=width).validate()
    d = torch.as_tensor(d_np[:DIST_BATCH + 1], device=dev)
    pyrs = [preprocess(d[i], K, cfg) for i in range(DIST_BATCH + 1)]
    eye = torch.eye(4, device=dev)
    pg_graph, pg_cfg = pg_in
    ba_graph, ba_prob, ba_cfg, ba_huber = ba_in
    ring = ("correspond", "gn_partials", "gn_epilogue")

    def fenced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def stack(ps):
        return tuple(Frame(*(torch.stack([p[li][k] for p in ps])
                             for k in range(3))) for li in range(len(ps[0])))

    # the single-device results on the card, which the ranks are held to
    icp_ref, icp_ms = fenced(lambda: align_frames(pyrs[1], pyrs[0], K, eye,
                                                  cfg.icp))
    pg_ref, pg_ms = fenced(lambda: optimize_pose_graph(pg_graph, pg_cfg)[0])
    ba_ref, ba_ms = fenced(lambda: optimize_map_ba(
        ba_graph, ba_prob, ba_cfg, huber_delta=ba_huber))
    batch_ref = [align_frames(pyrs[b + 1], pyrs[b], K, eye, cfg.icp)
                 for b in range(DIST_BATCH)]
    n_live = int((pg_graph.node_mask).sum())
    log(f"[dist] single device: align_frames {icp_ms:.3f} ms ({int(icp_ref.iters)}"
        f" iterations at level 0); optimize_pose_graph {pg_ms:.3f} ms "
        f"({n_live} nodes of {pg_graph.poses.shape[0]}, "
        f"{int((pg_graph.edge_weight > 0).sum())} edges, {pg_cfg.gn_iters} "
        f"rounds); optimize_map_ba {ba_ms:.3f} ms "
        f"({int((ba_prob.obs_w > 0).sum())} observations, "
        f"{ba_prob.map_points.shape[0]} control points) ({card})")

    # ---- 16.1: one rank, NCCL ----
    initialize_distributed(f"tcp://localhost:{free_port()}", world_size=1,
                           rank=0, backend="nccl", timeout_s=60)
    try:
        mesh = make_mesh(dev)
        for c in counters.values():
            c.reset()
        res1, ms1 = fenced(lambda: align_frames_spmd(pyrs[1], pyrs[0], K,
                                                     eye, cfg.icp, mesh))
        one = {k: c.launches for k, c in counters.items()}
        plain = {k: c.plain_calls for k, c in counters.items()}
        _res, warm1 = fenced(lambda: align_frames_spmd(pyrs[1], pyrs[0], K,
                                                       eye, cfg.icp, mesh))
        err1 = float((res1.T - icp_ref.T).abs().max())
        log(f"[dist] one NCCL rank: align_frames_spmd {ms1:.3f} ms (the "
            f"first, with NCCL's set-up), {warm1:.3f} ms the next, T "
            f"within {err1:.3e} of align_frames, iterations "
            f"{int(res1.iters)} / {int(icp_ref.iters)} ({card})")
        log(f"[dist] one NCCL rank launches {one} plain calls {plain}")
        check(all(one[k] > 0 for k in ring), f"dist one rank: {one}")
        check(all(v == 0 for v in plain.values()),
              f"dist one rank: plain calls {plain}")
        check(err1 <= TOL_DIST_ICP_T, f"dist one rank: T {err1}")
        check(abs(int(res1.iters) - int(icp_ref.iters)) <= TOL_DIST_ICP_ITERS,
              "dist one rank: iterations")
        (pg1, _c), pg1_ms = fenced(lambda: optimize_pose_graph_spmd(
            pg_graph, pg_cfg, mesh))
        (bp1, bm1, _bc), ba1_ms = fenced(lambda: optimize_map_ba_spmd(
            ba_graph, ba_prob, ba_cfg, mesh, huber_delta=ba_huber))
        res_b, batch1_ms = fenced(lambda: make_batched_aligner(mesh, cfg.icp)(
            stack(pyrs[1:]), stack(pyrs[:-1]), K,
            eye.repeat(DIST_BATCH, 1, 1)))
        errs = {"pose_graph": float((pg1 - pg_ref).abs().max()),
                "map_ba_poses": float((bp1 - ba_ref[0]).abs().max()),
                "map_ba_map": float((bm1 - ba_ref[1]).abs().max()),
                "batch": max(float((res_b.T[b] - r.T).abs().max())
                             for b, r in enumerate(batch_ref))}
        log(f"[dist] one NCCL rank: optimize_pose_graph_spmd {pg1_ms:.3f} ms"
            f", optimize_map_ba_spmd {ba1_ms:.3f} ms, batched aligner "
            f"{batch1_ms:.3f} ms ({DIST_BATCH} pairs); max errors {errs} "
            f"({card})")
        check(errs["pose_graph"] <= TOL_DIST_PG, f"dist one rank: {errs}")
        check(max(errs["map_ba_poses"], errs["map_ba_map"]) <= TOL_DIST_BA,
              f"dist one rank: {errs}")
        check(errs["batch"] <= TOL_DIST_BATCH, f"dist one rank: {errs}")
        rb = run_bench(frames, height, width, device=str(dev),
                       sequence=orbit, devices=1, slam_frames=None,
                       loader_frames=None)
        log(f"[dist] one NCCL rank run_bench({frames}, {height}, {width}, "
            f"devices=1): "
            f"spmd_align_ms {rb['spmd_align_ms']:.4f}, single_align_ms "
            f"{rb['single_align_ms']:.4f}, scaling_efficiency "
            f"{rb['scaling_efficiency']:.4f}, n_devices {rb['n_devices']}, "
            f"fps {rb['fps_per_chip']:.3f} ({card})")
        check(rb["n_devices"] == 1 and rb["spmd_align_ms"] > 0,
              f"dist one rank: run_bench {rb}")
    finally:
        # run_bench's sharded ICP graph holds NCCL collectives
        drop_graphs()
        dist.destroy_process_group()

    # ---- 16.2: four gloo ranks sharing the card ----
    with tempfile.TemporaryDirectory() as tmp:
        inp = Path(tmp) / "in.npz"
        dist_ranks.pack_inputs(
            inp, icp=(pyrs[1], pyrs[0], K, eye, cfg),
            pg=(pg_graph, SLAMConfig(posegraph=pg_cfg), 0.5),
            ba=(ba_graph, ba_prob, SLAMConfig(posegraph=ba_cfg), ba_huber,
                0.5),
            batch=(stack(pyrs[1:]), stack(pyrs[:-1]), K,
                   eye.repeat(DIST_BATCH, 1, 1), cfg),
            bench=(K, gt[:DIST_BENCH_FRAMES], d_np[:DIST_BENCH_FRAMES]))
        t0 = time.perf_counter()
        outs = dist_ranks.run(DIST_WORLD, inp, tmp, device=str(dev),
                              backend="gloo", timeout_s=DIST_TIMEOUT_S)
        wall = time.perf_counter() - t0
    kernels = [str(k) for k in outs[0]["kernels"]]
    log(f"[dist] {DIST_WORLD} gloo ranks on {dev}: {wall:.3f} s from spawn "
        f"to exit ({card})")
    for key in [k for k in outs[0] if not k.endswith(("_ms", "_launches",
                                                      "_plain", "json"))
                and k not in ("kernels", "jax_imported")]:
        check(all(np.array_equal(o[key], outs[0][key]) for o in outs),
              f"dist: {key} differs between ranks")
    check(not any(bool(o["jax_imported"]) for o in outs), "dist: JAX")
    launches = {}
    for r, o in enumerate(outs):
        per = {st: dict(zip(kernels, o[f"{st}_launches"].tolist()))
               for st in dist_ranks.STAGES}
        plain = {st: dict(zip(kernels, o[f"{st}_plain"].tolist()))
                 for st in dist_ranks.STAGES}
        log(f"[dist] rank {r}: " + ", ".join(
            f"{st} {float(o[f'{st}_ms']):.3f} ms" for st in dist_ranks.STAGES)
            + f" ({card}); launches " + json.dumps(
                {st: {k: v for k, v in p.items() if v}
                 for st, p in per.items()}))
        check(all(per["icp"][k] > 0 for k in ring),
              f"dist rank {r}: sharded ICP launches {per['icp']}")
        check(per["icp"]["gn_step"] == 0, f"dist rank {r}: {per['icp']}")
        check(all(per["batch"][k] > 0 for k in ("correspond", "gn_step")),
              f"dist rank {r}: batch launches {per['batch']}")
        check(all(v == 0 for p in plain.values() for v in p.values()),
              f"dist rank {r}: plain calls {plain}")
        launches[r] = per
    o = outs[0]
    icp_err = float(np.abs(o["icp_T"] - icp_ref.T.cpu().numpy()).max())
    pg_err = float(np.abs(o["pg_poses"] - pg_ref.cpu().numpy()).max())
    ba_err = (float(np.abs(o["ba_poses"] - ba_ref[0].cpu().numpy()).max()),
              float(np.abs(o["ba_map"] - ba_ref[1].cpu().numpy()).max()))
    batch_err = [float(np.abs(o["batch_T"][b] - r.T.cpu().numpy()).max())
                 for b, r in enumerate(batch_ref)]
    dropped = int(o["ba_dropped"])
    log(f"[dist] {DIST_WORLD} ranks against the single device: sharded ICP T"
        f" {icp_err:.3e} (iterations {int(o['icp_iters'])} / "
        f"{int(icp_ref.iters)}), pose graph {pg_err:.3e}, map BA poses "
        f"{ba_err[0]:.3e} map {ba_err[1]:.3e} (dropped {dropped} of "
        f"{int((ba_prob.obs_w > 0).sum())}; "
        f"{partition_observations(ba_prob, DIST_WORLD)[1]} control points a "
        f"rank), batch max {max(batch_err):.3e}")
    check(icp_err <= TOL_DIST_ICP_T, f"dist: sharded ICP T {icp_err}")
    check(abs(int(o["icp_iters"]) - int(icp_ref.iters)) <= TOL_DIST_ICP_ITERS,
          "dist: sharded ICP iterations")
    check(pg_err <= TOL_DIST_PG, f"dist: pose graph {pg_err}")
    check(max(ba_err) <= TOL_DIST_BA, f"dist: map BA {ba_err}")
    check(max(batch_err) <= TOL_DIST_BATCH, f"dist: batch {batch_err}")
    for r, o in enumerate(outs):
        rb = json.loads(str(o["bench_json"]))
        log(f"[dist] rank {r} run_bench({DIST_BENCH_FRAMES}, {height}, "
            f"{width}, devices={DIST_WORLD}), {DIST_WORLD} gloo ranks "
            f"time-sharing one"
            f" card: not a scaling figure: spmd_align_ms "
            f"{rb['spmd_align_ms']:.4f}, single_align_ms "
            f"{rb['single_align_ms']:.4f}, scaling_efficiency "
            f"{rb['scaling_efficiency']:.4f}, fps {rb['fps_per_chip']:.3f}, "
            f"ATE {rb['ate_rmse_m']:.3e} m ({card})")
        check(rb["n_devices"] == DIST_WORLD and rb["ate_rmse_m"] < 1e-3,
              f"dist rank {r}: run_bench {rb}")
    return {"nccl_one_rank_icp": one,
            "gloo_rank_icp": [launches[r]["icp"] for r in range(DIST_WORLD)],
            "gloo_rank_batch": [launches[r]["batch"]
                                for r in range(DIST_WORLD)]}


SLAM_ATE_M = 1e-3           # the reference's SLAM gate
ASYNC_ATE_FLOOR_M = 0.02    # tests/test_async_backend.py:34
CHUNKED_ATE_M = 0.02        # tests/test_chunked_slam.py:120


# the reference's full-width results (tests/torch_reference_poses.py runs
# tpuslam on the CPU and writes them): every pass below that a phase runs,
# held by `harness.hold_to_reference`'s rule.  A stable pass keeps the
# reference's keyframes and closure pairs with every pose within its
# tolerance; a chaotic one (the reference's own poses move when its voxel
# origin moves by up to 2e-4 m) stays within twice that spread, its ATE
# within the reference's largest + 1 mm, its counts inside the reference's
# spans, and map BA's observation count and cost within twice the
# reference's own reach from its unmoved run.  The rule and these
# tolerances were fixed before any card run held a pass to them (the
# chaotic map BA check before its spans were measured).
TOL_REF_ORBIT = 1e-4        # the card's orbit poses against the reference's
TOL_REF_LOOP_M = 1e-3       # the reference's SLAM gate (PERF.md §2)
HOLDS: list = []            # every hold's report, with its phase's tag
HOLD_FAILURES: list = []    # every hold that failed; main fails at its end


def hold_pass(ref: dict, prefix: str, got: dict, tag: str, card: str,
              tol: float = TOL_REF_LOOP_M) -> dict:
    """One pass held to the reference's `prefix` pass: one log line with
    the largest pose error and its frame, the first frame over the limit,
    keyframes and closures equal or where they part, stable or chaotic
    with the reference's spread, and the card (the worker pass:
    `hold_worker_to_reference`).  A failure is kept in
    HOLD_FAILURES (main fails at its end, after every phase has logged its
    holds).  Returns the report."""
    from tpuslam_torch.bench.harness import (
        REFERENCE_FILE,
        describe_hold,
        hold_to_reference,
        hold_worker_to_reference,
    )

    path = os.path.relpath(REFERENCE_FILE)
    if f"{prefix}_poses" not in ref:
        log(f"[{tag}] hold {prefix}: FAILS: no such pass in {path} ({card})")
        HOLD_FAILURES.append(f"{tag}: {prefix}: not in the file")
        return {}
    hold = (hold_worker_to_reference if prefix.startswith("loop_worker")
            else hold_to_reference)
    rep = hold(ref, prefix, got, tol)
    HOLDS.append((tag, rep))
    log(f"[{tag}] hold {describe_hold(rep)} ({path}; {card})")
    if rep["failures"]:
        HOLD_FAILURES.append(f"{tag}: {prefix}: {rep['failures']}")
    return rep


def orbit_got(out, gt) -> dict:
    """One of run_bench's orbit scans (poses, promotion flags, inlier
    fractions on the card) for `hold_pass`, with run_bench's ATE."""
    from tpuslam_torch.eval.ate import ate_rmse

    poses, promote, inliers = (t.cpu().numpy() for t in out)
    ts = np.arange(poses.shape[0], dtype=np.float64)
    return {"poses": poses, "keyframes": np.nonzero(promote)[0].tolist(),
            "closures": [], "promote": promote, "inliers": inliers,
            "ate_rmse_m": ate_rmse(ts, poses.astype(np.float64), ts,
                                   np.asarray(gt)[:poses.shape[0]])["rmse"]}


def ref_outcome(ref: dict, prefix: str) -> str:
    """The reference's pass on the CPU in a few words, for a log line."""
    if f"{prefix}_poses" not in ref:
        return f"the reference's {prefix}: not in the file"
    extra = "".join(
        f", {k.replace('_', ' ')} {int(np.sum(ref[f'{prefix}_{k}']))}"
        for k in ("graph_nodes", "lost") if f"{prefix}_{k}" in ref)
    return (f"the reference on the CPU: {ref[f'{prefix}_closures'].shape[0]}"
            f" closures, {ref[f'{prefix}_keyframes'].size} keyframes, ATE "
            f"{float(ref[f'{prefix}_ate_rmse_m']):.4e} m{extra}")


class PassLog:
    """Every pass `bench/harness._slam_pass` makes inside the `with`
    block: (chunk, the SlamSystem's options, seconds, the system), each
    system's `finalize` seconds by id (with the worker: the join of the
    attempts still queued when the last frame was tracked), and the host
    seconds of each loop-closure attempt by system id (on the worker: its
    share of the interpreter beside tracking)."""

    def __enter__(self):
        from tpuslam_torch.bench import harness
        from tpuslam_torch.slam import SlamSystem

        self.harness, self.made, self.finalize_s = harness, [], {}
        self.attempt_s: dict = {}
        run = self.run = harness._slam_pass
        fin = self.fin = SlamSystem.finalize
        attempt = self.attempt = SlamSystem._attempt_loop_closure

        def logged(K, cfg, depths, ts, chunk, **system):
            wall, slam = run(K, cfg, depths, ts, chunk, **system)
            self.made.append((chunk, system, wall, slam))
            return wall, slam

        def timed(slam):
            t0 = time.perf_counter()
            try:
                fin(slam)
            finally:
                self.finalize_s[id(slam)] = time.perf_counter() - t0

        def timed_attempt(slam, after=None):
            t0 = time.perf_counter()
            try:
                return attempt(slam, after=after)
            finally:
                self.attempt_s.setdefault(id(slam), []).append(
                    time.perf_counter() - t0)
        harness._slam_pass = logged
        SlamSystem.finalize = timed
        SlamSystem._attempt_loop_closure = timed_attempt
        return self

    def __exit__(self, *exc):
        from tpuslam_torch.slam import SlamSystem

        self.harness._slam_pass = self.run
        SlamSystem.finalize = self.fin
        SlamSystem._attempt_loop_closure = self.attempt

    def split(self) -> dict:
        """Per variant, means over every pass made: seconds of a pass, of
        its frames (the pass less finalize), of its finalize, the attempts
        a pass and one attempt's milliseconds."""
        by: dict = {}
        for chunk, system, wall, slam in self.made:
            name = ("per_frame" if not chunk else system.get(
                "chunk_mode", "inline")) + (
                "_async" if system.get("async_backend") else "_sync")
            fin = self.finalize_s[id(slam)]
            att = self.attempt_s.get(id(slam), [])
            by.setdefault(name, []).append(
                (wall, wall - fin, fin, len(att),
                 1e3 * float(np.mean(att)) if att else 0.0))
        return {k: [float(np.mean(c)) for c in zip(*v)]
                for k, v in by.items()}


def coldstart_runs(card: str, build_line: str) -> list:
    """`python -m tpuslam_torch.cli bench --coldstart` twice, each a fresh
    process after phase 2's build: both load the library (a hit)."""
    runs = []
    for k in range(2):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "tpuslam_torch.cli",
                            "bench", "--coldstart"], capture_output=True,
                           text=True, timeout=600,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        check(p.returncode == 0, f"coldstart run {k}: exit {p.returncode}\n"
              f"{p.stderr[-3000:]}")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        log(f"[backend] coldstart run {k} (a fresh process, "
            f"{time.perf_counter() - t0:.3f} s on the host clock): "
            f"{json.dumps(r)} ({card})")
        check(r["cache_hit"] is True, f"coldstart run {k}: cache miss")
        check(r["device"] == torch.cuda.get_device_name(0),
              f"coldstart run {k}: device {r['device']}")
        runs.append(r)
    log(f"[backend] the cold start's miss is phase 2's build: {build_line}")
    return runs


def backend_phase(dev, card: str, counters, loop, build_line: str,
                  ref: dict) -> dict:
    """Phase 17 (module doc): the kernels on two streams, bench_slam's five
    variants at 640×480 with the worker thread's attempts on a stream of
    their own (its per-frame and chunked synchronous passes held to the
    reference's results `ref`), inline chunks with the worker against the
    CPU twins, and the cold start twice.  Returns the main path's launches
    (17b) and the worker streams' share."""
    from tpuslam_torch.bench.harness import bench_slam, pass_result
    from tpuslam_torch.bench.two_streams import check_two_streams
    from tpuslam_torch.config import (
        ICPConfig,
        Intrinsics,
        KeyframeConfig,
        PoseGraphConfig,
        SLAMConfig,
        VoxelConfig,
    )
    from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.slam import SlamSystem

    # (a) four kernels on two streams at once, against each launch alone
    t0 = time.perf_counter()
    two = check_two_streams(dev)
    log(f"[backend] two streams: {json.dumps(two)} ({card})")
    check(two["tickets_zero"], "two streams: a ticket left non-zero")
    for name, k in two["kernels"].items():
        check(k["mismatches"] == 0 and k["launches_per_stream"] >= 100,
              f"two streams: {name} {k}")
    log(f"[backend] (a) took {time.perf_counter() - t0:.3f} s")

    # (b) bench_slam at full width: the main path of this phase
    t0 = time.perf_counter()
    main_stream = torch.cuda.current_stream(dev).cuda_stream
    for c in counters.values():
        c.reset()
    with PassLog() as passes:
        r = bench_slam(120, 480, 640, device="cuda", sequence=loop)
    launches = {k: c.launches for k, c in counters.items()}
    plain = {k: c.plain_calls for k, c in counters.items()}
    by_stream = {k: dict(c.by_stream) for k, c in counters.items()}
    log(f"[backend] bench_slam {json.dumps(r)}")
    K_l, gt_l, _ = loop
    ts = np.arange(120) / 30.0
    workers = [s for c, o, w, s in passes.made
               if c == 0 and o.get("async_backend")]
    check(len(workers) == 4, f"backend: {len(workers)} worker passes")
    for _, _, _, s in passes.made:
        check(s._backend_error is None and s._backend_thread is None,
              "backend: a worker error or a worker left running")
    w_ate = [ate_rmse(*s.trajectory(), ts, gt_l, max_difference=0.005)["rmse"]
             for s in workers]
    w_closures = [len(s.closures) for s in workers]
    w_handles = {s._worker_stream.cuda_stream for s in workers}
    on_workers = {k: sum(n for h, n in v.items() if h in w_handles)
                  for k, v in by_stream.items()}
    log(f"[backend] per frame: sync {r['slam_fps']:.3f} fps, worker "
        f"{r['slam_fps_async']:.3f} fps, async_gain {r['async_gain']:.4f}; "
        f"chunked {r['slam_fps_chunked']:.3f}, chunked deferred "
        f"{r['slam_fps_chunked_async']:.3f}, inline "
        f"{r['slam_fps_chunked_inline']:.3f} fps; upload "
        f"{r['upload_fps_equiv']:.1f} fps-equivalent ({card})")
    log(f"[backend] closures: per frame {r['loop_closures']}, the worker's "
        f"passes {w_closures}, inline {r['loop_closures_chunked_inline']}, "
        f"boundary {r['loop_closures_chunked']}, deferred "
        f"{r['loop_closures_chunked_async']}; ATE per frame "
        f"{r['slam_ate_rmse_m']:.4e} m, the worker's "
        f"{', '.join(f'{a:.4e}' for a in w_ate)}, inline "
        f"{r['slam_chunked_inline_ate_rmse_m']:.4e}, boundary "
        f"{r['slam_chunked_ate_rmse_m']:.4e}, deferred "
        f"{r['slam_chunked_async_ate_rmse_m']:.4e}; keyframes "
        f"{r['keyframes']} / {r['keyframes_chunked']}; per frame "
        f"{ref_outcome(ref, 'loop_per_frame')}; the worker "
        f"{ref_outcome(ref, 'loop_worker')}; boundary "
        f"{ref_outcome(ref, 'loop_chunked')}; deferred "
        f"{ref_outcome(ref, 'loop_deferred')}; inline "
        f"{ref_outcome(ref, 'loop_chunked_inline')}")
    log(f"[backend] launches {launches}, on the worker streams "
        f"{on_workers}, plain calls {plain}")
    log("[backend] seconds a pass (all passes of a variant): " + "; ".join(
        f"{k} {w:.4f} = frames {f:.4f} + finalize {z:.4f}, {n:.2f} "
        f"attempts of {a:.3f} ms" for k, (w, f, z, n, a)
        in passes.split().items()) + f" ({card})")
    check(r["slam_ate_rmse_m"] < SLAM_ATE_M,
          f"backend: per-frame ATE {r['slam_ate_rmse_m']}")
    check(r["slam_chunked_inline_ate_rmse_m"] < SLAM_ATE_M,
          f"backend: inline ATE {r['slam_chunked_inline_ate_rmse_m']}")
    bound_w = max(2 * r["slam_ate_rmse_m"], ASYNC_ATE_FLOOR_M)
    check(all(a < bound_w for a in w_ate), f"backend: worker ATE {w_ate}")
    check(min(w_closures) >= 1 and all(r[k] >= 1 for k in (
        "loop_closures", "loop_closures_chunked",
        "loop_closures_chunked_async", "loop_closures_chunked_inline")),
          f"backend: a variant closed no loop ({w_closures})")
    check(launches["correspond"] > 0 and launches["gn_step"] > 0,
          f"backend: launches {launches}")
    check(all(v == 0 for v in plain.values()), f"backend: plain {plain}")
    check(main_stream not in w_handles and on_workers["gn_step"] > 0
          and on_workers["correspond"] > 0,
          f"backend: the worker streams launched {on_workers}")
    # every pass, the uncounted ones too, against the reference's of its
    # variant: per frame synchronous and with the worker, boundary chunks
    # synchronous and deferred, inline chunks
    for c, o, _, s in passes.made:
        worker = bool(o.get("async_backend"))
        name = (("worker" if worker else "per_frame") if not c
                else "chunked_inline" if o.get("chunk_mode") == "inline"
                else "deferred" if worker else "chunked")
        hold_pass(ref, f"loop_{name}", pass_result(s, ts, gt_l), "backend",
                  card)
    log(f"[backend] (b) took {time.perf_counter() - t0:.3f} s")

    # (c) inline chunks of 8 with the worker on the card against the same
    # run synchronous through the CPU twins (tests/test_chunked_slam.py)
    t0 = time.perf_counter()
    Ks = Intrinsics(160.0, 160.0, 79.5, 59.5)
    cfg_c = SLAMConfig(
        height=120, width=160,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                                  lc_min_gap=3, lc_max_dist=0.6,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15))
    gt_c = loop_trajectory(48, cycles=2, radius=0.35)
    d_c = np.stack([render_depth(gt_c[i], Ks, 120, 160, seed=i)
                    for i in range(48)]).astype(np.float32)
    ts_c = np.arange(48) / 30.0

    def inline(device, worker: bool):
        slam = SlamSystem(Ks, cfg_c, async_backend=worker,
                          chunk_mode="inline", device=device)
        d = torch.as_tensor(d_c, device=device)
        for i in range(0, 48, 8):
            slam.process_chunk(d[i:i + 8], ts_c[i:i + 8])
        slam.finalize()
        return slam

    card_c, cpu_c = inline(dev, True), inline("cpu", False)
    kg = [x.index for x in card_c.odo.keyframes]
    kc = [x.index for x in cpu_c.odo.keyframes]
    ate_c = ate_rmse(*card_c.trajectory(), ts_c, gt_c,
                     max_difference=0.005)["rmse"]
    log(f"[backend] inline chunks of 8, 48 frames 120×160: the worker on "
        f"the card {len(card_c.closures)} closures, ATE {ate_c:.4e} m; the "
        f"CPU twins synchronous {len(cpu_c.closures)} closures; keyframes "
        f"{len(kg)} {'equal' if kg == kc else 'DIFFER'}")
    check(kg == kc, f"backend small: keyframes {kg} vs {kc}")
    check(len(card_c.closures) >= max(1, len(cpu_c.closures) // 2),
          f"backend small: closures {len(card_c.closures)} vs "
          f"{len(cpu_c.closures)}")
    check(ate_c < CHUNKED_ATE_M, f"backend small: ATE {ate_c}")
    log(f"[backend] (c) took {time.perf_counter() - t0:.3f} s")

    # (d) the cold start, twice from fresh processes
    t0 = time.perf_counter()
    coldstart_runs(card, build_line)
    log(f"[backend] (d) took {time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "worker_streams": on_workers}


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms: `reps` calls captured into one CUDA
    graph, its replay timed by CUDA events (no host gap between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del g
    return ms


def preprocess_phase(dev, card: str, K, depths_np, cfg) -> dict:
    """Phase 4b: the pyramid kernel against its eager twin, bit for bit,
    and its time beside the twin's and its byte bound."""
    from tpuslam_torch.kernels import preprocess as pp

    raw = np.round(depths_np * cfg.depth_scale).astype(np.uint16)
    inputs = [torch.as_tensor(d, device=dev) for d in depths_np]
    inputs += [t.to(torch.float16) for t in inputs]
    inputs += [torch.as_tensor(r, device=dev) for r in raw]
    for t in inputs:
        got, want = pp.preprocess(t, K, cfg), pp.preprocess_reference(t, K,
                                                                       cfg)
        torch.cuda.synchronize()
        for li, (g, w) in enumerate(zip(got, want)):
            for name, a, b in zip(g._fields, g, w):
                check(bits_equal(a, b), f"preprocess {t.dtype} level {li} "
                      f"{name}: not bit-equal to the eager twin")
    d0 = inputs[0]
    pyr = pp.preprocess(d0, K, cfg)
    n_bytes = nbytes(d0) + sum(nbytes(*f) for f in pyr)
    stats = {
        # device time: 50 calls captured in one CUDA graph, replayed
        "ms": graph_ms(lambda: pp.preprocess(d0, K, cfg)),
        "plain_ms": graph_ms(lambda: pp.preprocess_reference(d0, K, cfg)),
        # as the host issues them, one call after another
        "eager_ms": time_ms(lambda: pp.preprocess(d0, K, cfg)),
        "plain_eager_ms": time_ms(
            lambda: pp.preprocess_reference(d0, K, cfg)),
        **bound(n_bytes, 0.0), "bytes": n_bytes,
        "pixels": sum(f.mask.numel() for f in pyr),
        "device_us_full_launch": full_launch_us(
            lambda: pp.preprocess(d0, K, cfg), "preprocess"),
        "bit_equal_inputs": len(inputs), "levels": len(pyr)}
    log(f"[preprocess] {json.dumps(stats)} ({card})")
    return stats


# Floating-point operations of the dense pose-graph solve, counted from
# csrc/posegraph_dense.cu: an edge's residual (~300), float64 Jacobian
# (~830) and 6 × 6 block (~540) with the assembly's adds (~230) a round;
# the Cholesky of the live 6n rows (6n)³/3, its two triangular solves
# 2(6n)², and ~200 a node for exp and the product.
POSEGRAPH_FLOPS_EDGE = 1900
POSEGRAPH_FLOPS_NODE = 200


def posegraph_solve_flops(live: int, edges: int, iters: int) -> float:
    m = 6 * live
    return iters * (edges * POSEGRAPH_FLOPS_EDGE + m ** 3 / 3 + 2 * m * m
                    + POSEGRAPH_FLOPS_NODE * live)


def posegraph_phase(dev, card: str) -> dict:
    """Phase 4b, the pose graph: the dense solve's kernel at the 32-node
    bucket against its twin on the card over `posegraph_cases` (poses
    within TOL_POSE, padding bit-equal, a second launch bit-equal); then at
    15 and 19 live nodes (synthetic_graph's loop, 64 edges) and with a
    fused attempt's four candidates (68 edges): the kernel's device time
    (50 launches in one CUDA graph), the twin's (one solve captured and
    replayed: what `optimize_pose_graph 32` replayed before the kernel),
    `optimize_pose_graph` as the host issues it (the entry point's
    replay), the bound by operations and the device µs of one launch."""
    from tpuslam_torch.backend import posegraph
    from tpuslam_torch.config import PoseGraphConfig
    from tpuslam_torch.kernels import posegraph_dense as pd

    cfg = PoseGraphConfig()
    mod = fixtures("torch_posegraph_cases")
    synthetic_graph = mod.synthetic_graph
    cases = mod.posegraph_cases(dev)
    worst = 0.0
    for name, g in cases.items():
        got = pd.launch(*g, cfg, 0.5)
        again = pd.launch(*g, cfg, 0.5)
        want = posegraph.optimize_dense_reference(g, cfg, 0.5)
        torch.cuda.synchronize()
        live = int(g.node_mask.sum())
        err = float((got[0] - want[0]).abs().max())
        worst = max(worst, err)
        check(bits_equal(got[0], again[0]) and bits_equal(got[1], again[1]),
              f"posegraph_dense {name}: a second launch differs")
        check(bits_equal(got[0][live:], g.poses[live:].contiguous()),
              f"posegraph_dense {name}: padding poses moved")
        check(err <= pd.TOL_POSE, f"posegraph_dense {name}: poses {err} "
              f"from the twin's (limit {pd.TOL_POSE})")
    rows = {}
    for label, g, live in (
            ("15 live", synthetic_graph(dev, 15).graph(bucketed=True), 15),
            ("19 live", synthetic_graph(dev, 19).graph(bucketed=True), 19),
            ("19 live + 4 candidates", cases["candidates"], 19)):
        edges = g.edge_i.shape[0]
        flops = posegraph_solve_flops(live, edges, cfg.gn_iters)
        rows[label] = {
            "bucket": [g.poses.shape[0], edges],
            "ms": graph_ms(lambda: pd.launch(*g, cfg, 0.5)),
            "plain_replay_ms": graph_ms(
                lambda: posegraph.optimize_dense_reference(g, cfg, 0.5), 1),
            "entry_ms": time_ms(lambda: posegraph.optimize_pose_graph(g, cfg),
                                reps=20),
            **bound(nbytes(*g), flops), "flops": flops,
            "device_us_full_launch": full_launch_us(
                lambda: pd.launch(*g, cfg, 0.5), "posegraph_dense")}
    stats = {"cases": len(cases), "worst_pose_err": worst,
             "tol_pose": pd.TOL_POSE, "rows": rows}
    log(f"[posegraph] {json.dumps(stats)} ({card})")
    return stats


def warm_start_phase(dev, card: str) -> dict:
    """Phase 4b, the warm start: the kernel against its eager twin on the
    card over `warm_start_cases` (every branch of se3's log and exp) and
    64 seeded motions at the configuration's γ = 0.5: bit-equal (its
    elementwise steps op for op, its small products in the order cuBLAS
    sums the twin's), the same bits on a second launch; then its device
    time (50 calls in one CUDA graph), the twin's (50 calls in one graph,
    what a frame's warm start cost before the kernel) and the twin's
    device operations a call, the bound by bytes (two poses in, one out)
    and the device µs of one full launch."""
    from tpuslam_torch.kernels import warm_start as ws

    mod = fixtures("torch_warm_start_cases")
    cases = {**mod.warm_start_cases(), **mod.random_cases(64)}
    gamma = 0.5
    for name, pair in cases.items():
        T, D = (torch.as_tensor(a, device=dev) for a in pair)
        got = ws.warm_start(T, D, gamma)
        again = ws.warm_start(T, D, gamma)
        want = ws.warm_start_reference(T, D, gamma)
        torch.cuda.synchronize()
        check(bits_equal(got, again), f"warm_start {name}: a second launch "
              "differs")
        check(bits_equal(got, want), f"warm_start {name}: not bit-equal to "
              f"the eager twin ({float((got - want).abs().max())} apart)")
    T, D = (torch.as_tensor(a, device=dev)
            for a in cases["log exact, exp series"])
    out = ws.warm_start(T, D, gamma)
    n_bytes = nbytes(T, D, out)
    stats = {
        "cases_bit_equal": len(cases),
        "ms": graph_ms(lambda: ws.warm_start(T, D, gamma)),
        "plain_ms": graph_ms(lambda: ws.warm_start_reference(T, D, gamma)),
        "plain_device_ops": device_ops(
            lambda: ws.warm_start_reference(T, D, gamma)),
        **bound(n_bytes, 0.0), "bytes": n_bytes,
        "device_us_full_launch": full_launch_us(
            lambda: ws.warm_start(T, D, gamma), "warm_start")}
    log(f"[warm_start] {json.dumps(stats)} ({card})")
    return stats


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from tpuslam_torch.bench.harness import (
        _render_sequence,
        drive_drifted,
        kernel_counters,
        pass_result,
        reference_results,
        run_bench,
        run_slam_bench,
        slam_bench_config,
    )
    from tpuslam_torch.config import ICPConfig, KeyframeConfig, SLAMConfig
    from tpuslam_torch.frontend import preprocess, scan_odometry
    from tpuslam_torch.geom import se3
    from tpuslam_torch.icp import (
        pack_pyramid,
        select_level_source,
    )
    from tpuslam_torch.kernels import (
        _build,
        correspond,
        gn_epilogue,
        gn_fused,
        gn_partials,
        gn_step,
    )
    counters = kernel_counters()
    frame_kernels = ("correspond", "gn_partials", "gn_epilogue", "gn_step",
                     "gn_fused")

    def reset_counts() -> None:
        for c in counters.values():
            c.reset()

    def read_counts():
        return ({k: c.launches for k, c in counters.items()},
                {k: c.plain_calls for k, c in counters.items()})

    dev = torch.device("cuda:0")
    card = gpu_line()
    log(f"[device] {card}")
    log(f"[device] host libraries: {json.dumps(host_libraries())}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    build_line = (f"[build] {path.name} in {time.perf_counter() - t0:.3f} s "
                  f"({card})")
    log(build_line)

    # ---- 3. kernels vs plain twins at the main path's shapes ----
    cfg = SLAMConfig()
    icp = cfg.icp
    K, _, depths_np = _render_sequence(2, 480, 640)
    d = torch.as_tensor(depths_np, device=dev)
    pyr_a = preprocess(d[0], K, cfg)
    pyr_b = preprocess(d[1], K, cfg)
    packed = pack_pyramid(pyr_a, icp)
    T = se3.exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.006, 0.003],
                             device=dev))
    # the fused step's residual pose: one GN update past the gate pose
    T_res = se3.exp(torch.tensor([0.002, 0.001, -0.002, 0.001, 0.0, -0.001],
                                 device=dev)) @ T
    carry = gn_epilogue.init_carry(T, 12)
    stats = {k: {} for k in frame_kernels}
    step_ab = ring_partials = None
    for li in range(icp.pyramid_levels - 1, -1, -1):
        K_l = K.scaled(1.0 / 2 ** li)
        src = select_level_source(pyr_b, li, icp)
        h, w, _ = pyr_b[li].points.shape
        # the ICP loop's association: the untransformed source and the
        # carry's pose, the transform in the kernel
        pts, nrm = src.points.contiguous(), src.normals.contiguous()
        args = (pts, src.mask, nrm, packed[li], h, w, K_l, icp.max_corr_dist,
                icp.normal_dot_min)
        ck = correspond.projective_correspond_at_pose(*args, carry)
        cr = correspond.projective_correspond_at_pose_reference(*args, T)
        torch.cuda.synchronize()
        check(torch.equal(ck.q, cr.q) and torch.equal(ck.n, cr.n),
              f"correspond level {li}: q/n not bit-equal")
        check(torch.equal(ck.idx, cr.idx), f"correspond level {li}: flat")
        w_mis = float((ck.w != cr.w).float().mean())
        check(w_mis == 0.0, f"correspond level {li}: w mismatch {w_mis}")
        c_err = max(float((ck.q - cr.q).abs().max()),
                    float((ck.n - cr.n).abs().max()),
                    float((ck.w - cr.w).abs().max()))
        # after DONE the kernel writes nothing into the given buffers
        out = correspond.correspondence_buffers(pts.shape[0], dev)
        for t_ in out:
            t_.fill_(7)
        correspond.projective_correspond_at_pose(
            *args, gn_epilogue.init_carry(T, 0), out=out)
        torch.cuda.synchronize()
        check(all(bool((t_ == 7).all()) for t_ in out),
              f"correspond level {li}: wrote after DONE")

        # gn_partials as the ring ICP calls it: the untransformed points and
        # the carry's pose, which the kernel applies (in the association's
        # order); the same bits on a second launch
        ts = gn_epilogue.T_SLICE
        pargs = (pts, ck.q, ck.n, ck.w, carry[ts], icp.huber_delta)
        pk = gn_partials.gn_reduce_partials_at_pose(*pargs, done=carry)
        pr = gn_partials.gn_reduce_partials_at_pose_reference(*pargs)
        pa = gn_partials.gn_reduce_partials_at_pose(*pargs, done=carry)
        done_c = gn_epilogue.init_carry(T, 0)
        pd = gn_partials.gn_reduce_partials_at_pose(
            pts, ck.q, ck.n, ck.w, done_c[ts], icp.huber_delta, done=done_c)
        torch.cuda.synchronize()
        fk = gn_partials.fold_partials(pk)
        fr = gn_partials.fold_partials(pr)
        p_rel = max(rel_err(a, b) for a, b in zip(fk, fr))
        check(p_rel <= TOL_PARTIALS_REL,
              f"gn_partials level {li}: rel err {p_rel}")
        check(torch.equal(pk, pa),
              f"gn_partials level {li}: not the same bits again")
        check(bool((pd == 0).all()), f"gn_partials level {li}: DONE rows")
        p_err = max(float((a - b).abs().max()) for a, b in zip(fk, fr))

        nvs = torch.sum(src.mask.to(torch.float32))
        eargs = (pk, carry, nvs, icp.damping, icp.damping_abs,
                 icp.max_trans_step, icp.max_rot_step, True, icp.inner_steps,
                 12, icp.tol_delta ** 2)
        ek_carry, ek_step = gn_epilogue.gn_epilogue(*eargs)
        er_carry, er_step = gn_epilogue.gn_epilogue_reference(*eargs)
        torch.cuda.synchronize()
        t_err = float((ek_step[gn_epilogue.STEP_T]
                       - er_step[gn_epilogue.STEP_T]).abs().max())
        h_rel = rel_err(ek_step[gn_epilogue.STEP_H],
                        er_step[gn_epilogue.STEP_H])
        check(t_err <= TOL_EPILOGUE_T, f"gn_epilogue level {li}: T {t_err}")
        check(h_rel <= TOL_EPILOGUE_H_REL, f"gn_epilogue level {li}: H {h_rel}")
        check(float((ek_carry[gn_epilogue.T_SLICE]
                     - er_carry[gn_epilogue.T_SLICE]).abs().max())
              <= TOL_EPILOGUE_T, f"gn_epilogue level {li}: carry T")
        check(float(ek_carry[gn_epilogue.IT]) == float(er_carry[gn_epilogue.IT])
              and float(ek_carry[gn_epilogue.DONE])
              == float(er_carry[gn_epilogue.DONE]),
              f"gn_epilogue level {li}: carry it/done")

        # gn_step: the same solve from the untransformed source, the pose
        # taken from the carry, which it updates in place
        sargs = (nvs, icp.huber_delta, icp.damping, icp.damping_abs,
                 icp.max_trans_step, icp.max_rot_step, True, icp.inner_steps,
                 12, icp.tol_delta ** 2)
        sk = gn_step.gn_step(pts, ck.q, ck.n, ck.w, carry.clone(), *sargs)
        sr = gn_step.gn_step_reference(pts, ck.q, ck.n, ck.w, carry, *sargs)
        torch.cuda.synchronize()
        s_err = float((sk[ts] - sr[ts]).abs().max())
        s_hrel = rel_err(sk[gn_epilogue.H_SLICE], sr[gn_epilogue.H_SLICE])
        check(s_err <= TOL_EPILOGUE_T, f"gn_step level {li}: T {s_err}")
        check(s_hrel <= TOL_EPILOGUE_H_REL,
              f"gn_step level {li}: H rel {s_hrel}")
        check(all(float(sk[i]) == float(sr[i]) for i in (
            gn_epilogue.IT, gn_epilogue.DONE, gn_epilogue.NUM_INLIERS)),
              f"gn_step level {li}: it/done/Σvalid")
        again = gn_step.gn_step(pts, ck.q, ck.n, ck.w, carry.clone(), *sargs)
        dc = gn_epilogue.init_carry(T, 0)
        d_before = dc.clone()
        gn_step.gn_step(pts, ck.q, ck.n, ck.w, dc, *sargs)
        torch.cuda.synchronize()
        check(torch.equal(again, sk), f"gn_step level {li}: not reproducible")
        check(torch.equal(dc.view(torch.int32), d_before.view(torch.int32)),
              f"gn_step level {li}: wrote the carry after DONE")
        step_carry = carry.clone()
        step_mid = sargs[:6] + (False,) + sargs[7:]

        # each kernel as the main path launches it, and its twin (is_last
        # False for gn_step: DONE is never set, every launch does the work)
        launch = {
            "correspond": lambda: correspond.projective_correspond_at_pose(
                *args, carry, out=out),
            "gn_partials": lambda: gn_partials.gn_reduce_partials_at_pose(
                *pargs, done=carry),
            "gn_epilogue": lambda: gn_epilogue.gn_epilogue(*eargs),
            "gn_step": lambda: gn_step.gn_step(pts, ck.q, ck.n, ck.w,
                                               step_carry, *step_mid),
        }
        times = {
            "correspond": (
                time_ms(launch["correspond"]),
                time_ms(lambda: correspond.projective_correspond_at_pose_reference(
                    *args, T))),
            "gn_partials": (
                time_ms(launch["gn_partials"]),
                time_ms(lambda: gn_partials
                        .gn_reduce_partials_at_pose_reference(*pargs))),
            "gn_epilogue": (
                time_ms(launch["gn_epilogue"]),
                time_ms(lambda: gn_epilogue.gn_epilogue_reference(*eargs),
                        reps=20)),
            "gn_step": (
                time_ms(launch["gn_step"]),
                time_ms(lambda: gn_step.gn_step_reference(
                    pts, ck.q, ck.n, ck.w, carry, *sargs), reps=20)),
        }
        # the fused solve, one launch: on the first solve of an outer
        # iteration (gate pose = the carry's T, stored in the gate buffer;
        # the buffer starts NaN and must not be read) and on a later one
        # (gate pose from the buffer, the carry one update past it)
        fsrc = (pts, nrm, src.mask.contiguous(), packed[li])
        fgeo = (K_l, w, h, icp.max_corr_dist, icp.normal_dot_min,
                icp.huber_delta, nvs, icp.damping, icp.damping_abs,
                icp.max_trans_step, icp.max_rot_step)
        ftail = (True, icp.inner_steps, 12, icp.tol_delta ** 2)
        nb = gn_step.num_blocks(pts.shape[0])
        _, scratch_rows = gn_step.scratch(dev)
        g_err, g_hrel, g_valid = 0.0, 0.0, 0.0
        for first in (True, False):
            fc0 = gn_epilogue.init_carry(T if first else T_res, 12)
            fg0 = (torch.full((12,), float("nan"), device=dev) if first
                   else T[:3].reshape(12).clone())
            fck, fgk = fc0.clone(), fg0.clone()
            gn_fused.gn_fused_step(*fsrc, fck, fgk, first, *fgeo, *ftail)
            kernel_valid = scratch_rows[:nb, 28].clone()
            fcr, fgr = gn_fused.gn_fused_step_reference(
                *fsrc, fc0, fg0, first, *fgeo, *ftail)
            twin_rows = gn_fused.fused_rows(*fsrc, T[:3], fc0[ts].reshape(4, 4),
                                            *fgeo[:6], nb)
            torch.cuda.synchronize()
            tag = f"gn_fused level {li} is_first={first}"
            # the row index and w are bit-equal: each block's Σvalid is
            check(torch.equal(kernel_valid, twin_rows[:, 28]),
                  f"{tag}: per-block validity counts differ")
            e = float((fck[ts] - fcr[ts]).abs().max())
            hr = rel_err(fck[gn_epilogue.H_SLICE], fcr[gn_epilogue.H_SLICE])
            check(e <= TOL_EPILOGUE_T, f"{tag}: T {e}")
            check(hr <= TOL_EPILOGUE_H_REL, f"{tag}: H rel {hr}")
            check(all(float(fck[i]) == float(fcr[i]) for i in (
                gn_epilogue.IT, gn_epilogue.DONE, gn_epilogue.NUM_INLIERS)),
                  f"{tag}: it/done/Σvalid")
            check(torch.equal(fgk, fgr) and torch.equal(fgk, T[:3].reshape(12)),
                  f"{tag}: gate buffer")
            g_err, g_hrel = max(g_err, e), max(g_hrel, hr)
            g_valid = float(fck[gn_epilogue.NUM_INLIERS])
        check(g_valid > 0.3 * float(nvs), f"gn_fused level {li}: Σvalid "
              f"{g_valid} of {float(nvs)}")
        # the same bits again; after DONE nothing is written, and the
        # ticket is back at 0
        again = gn_epilogue.init_carry(T_res, 12)
        gn_fused.gn_fused_step(*fsrc, again, T[:3].reshape(12).clone(), False,
                               *fgeo, *ftail)
        fd, fdg = gn_epilogue.init_carry(T, 0), torch.full((12,), 3.0,
                                                           device=dev)
        fd_before = fd.clone()
        for first in (True, False):
            gn_fused.gn_fused_step(*fsrc, fd, fdg, first, *fgeo, *ftail)
        torch.cuda.synchronize()
        check(torch.equal(again, fck),
              f"gn_fused level {li}: not the same bits again")
        check(torch.equal(fd.view(torch.int32), fd_before.view(torch.int32))
              and bool((fdg == 3.0).all()),
              f"gn_fused level {li}: wrote after DONE")
        check(int(gn_step.scratch(dev)[0]) == 0, "gn_fused: ticket left")
        # timed as the loop launches it: is_last False, so DONE is never set
        fused_carry, fused_gate = carry.clone(), gn_fused.gate_buffer(dev)
        fmid = ftail[1:]
        launch["gn_fused"] = lambda: gn_fused.gn_fused_step(
            *fsrc, fused_carry, fused_gate, True, *fgeo, False, *fmid)
        times["gn_fused"] = (
            time_ms(launch["gn_fused"]),
            time_ms(lambda: gn_fused.gn_fused_step_reference(
                *fsrc, carry, fused_gate, True, *fgeo, False, *fmid),
                    reps=20))
        flat = gn_fused.association_rows_ordered(T, pts, K_l, h, w)
        # device time of one full launch (the profile's averages over a
        # frame, phase 10, include the launches after DONE, which return
        # at once)
        full_us = {k: full_launch_us(fn, k) for k, fn in launch.items()}
        errs = {"correspond": c_err, "gn_partials": p_err,
                "gn_epilogue": t_err, "gn_step": s_err, "gn_fused": g_err}
        # a table row is read once for each distinct pixel gathered
        row_bytes = packed[li].element_size() * packed[li].shape[1]
        bounds = {
            "correspond": bound(
                nbytes(pts, src.mask, nrm, ck.q, ck.n, ck.w, ck.idx)
                + 12 * 4 + row_bytes * torch.unique(ck.idx).numel(),
                (OPS_TRANSFORM + OPS_ROTATE + OPS_CORRESPOND) * pts.shape[0]),
            "gn_partials": bound(nbytes(pts, ck.q, ck.n, ck.w, pk) + 12 * 4,
                                 (OPS_GN_PARTIALS + OPS_TRANSFORM)
                                 * pts.shape[0]),
            "gn_epilogue": bound(
                nbytes(pk, nvs, ek_step) + 2 * nbytes(carry),
                pk.shape[0] * gn_partials.NUM_SUMS + OPS_EPILOGUE_SOLVE),
            "gn_step": bound(
                nbytes(pts, ck.q, ck.n, ck.w, nvs) + 2 * nbytes(carry),
                (OPS_GN_PARTIALS + OPS_TRANSFORM) * pts.shape[0]
                + OPS_EPILOGUE_SOLVE),
            # the carry read and written, the gate pose written
            "gn_fused": bound(
                nbytes(pts, nrm, src.mask, nvs) + 2 * nbytes(carry) + 12 * 4
                + row_bytes * torch.unique(flat).numel(),
                OPS_GN_FUSED * pts.shape[0] + OPS_EPILOGUE_SOLVE),
        }
        for name, (ms, plain_ms) in times.items():
            stats[name][li] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": errs[name], "n": pts.shape[0],
                               "device_us_full_launch": full_us[name],
                               **bounds[name]}
            log(f"[kernels] {name} level {li} N={pts.shape[0]}: kernel "
                f"{ms:.5f} ms, device {fmt_us(full_us[name])} us a full "
                f"launch, plain {plain_ms:.5f} ms, bound "
                f"{bounds[name]['bound_ms']:.5f} ms by "
                f"{bounds[name]['bound_by']}, max_abs_err "
                f"{errs[name]:.3e} ({card})")
        log(f"[kernels] level {li}: w mismatch share {w_mis}, partials rel "
            f"{p_rel:.3e}, epilogue T {t_err:.3e} H rel {h_rel:.3e}, "
            f"gn_step T {s_err:.3e} H rel {s_hrel:.3e} (same bits again, "
            f"nothing written after DONE), gn_partials the same bits again, "
            f"gn_fused T {g_err:.3e} H rel "
            f"{g_hrel:.3e} Σvalid {g_valid:.0f} (per block equal, gate "
            f"buffer equal, same bits again, nothing written after DONE)")
        if li == 0:
            step_ab = gn_step_ab(card, pts, ck, carry, nvs, icp)
            ring_partials = partials_at_ring_size(card, pts, ck, carry, icp)
    ring_stats = ring_nn_phase(dev, card)
    grid_stats, table_stats = grid_correspond_phase(dev, card)

    # ---- 3b. the captured programs: eager against replayed ----
    t0 = time.perf_counter()
    graph_table = graphs_phase(dev, card)
    log(f"[graphs] {json.dumps(graph_table)}")
    log(f"[graphs] phase took {time.perf_counter() - t0:.3f} s")

    # ---- 4. uint16 divide ----
    raw = np.round(depths_np * cfg.depth_scale).astype(np.uint16)
    host = raw.astype(np.float32) / np.float32(cfg.depth_scale)
    for i in range(raw.shape[0]):
        pu = preprocess(torch.as_tensor(raw[i], device=dev), K, cfg)
        pf = preprocess(torch.as_tensor(host[i], device=dev), K, cfg)
        for a, b in zip(pu, pf):
            check(all(torch.equal(u, v) for u, v in zip(a, b)),
                  "uint16 preprocess is not bit-equal to float32")
    log(f"[uint16] device divide bit-equal to host-divided float32 "
        f"({raw.shape[0]} frames, 3 levels)")

    # ---- 4b. the pyramid kernel against its eager twin ----
    pre_stats = preprocess_phase(dev, card, K, depths_np, cfg)
    pre_stats["posegraph"] = posegraph_phase(dev, card)
    pre_stats["warm_start"] = warm_start_phase(dev, card)

    # ---- 5. small scan: GPU kernels vs CPU twins ----
    from tpuslam_torch.config import Intrinsics
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth

    Ks = Intrinsics(160.0, 160.0, 79.5, 59.5)
    cfg_s = SLAMConfig(
        height=120, width=160,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.03, max_rotation=0.15))
    gt_s = orbit_trajectory(12)
    ds = np.stack([render_depth(gt_s[i], Ks, 120, 160, seed=i)
                   for i in range(12)])
    pg, fg, ig = scan_odometry(torch.as_tensor(ds, device=dev), Ks, cfg_s)
    pc, fc, ic = scan_odometry(torch.as_tensor(ds), Ks, cfg_s)
    small_err = float((pg.cpu() - pc).abs().max())
    check(torch.equal(fg.cpu(), fc), "small scan: promote flags differ")
    check(small_err <= TOL_SMALL_POSE, f"small scan: pose err {small_err}")
    log(f"[small] 12×120×160 scan GPU vs CPU twins: pose max err "
        f"{small_err:.3e}, promotions {int(fc.sum())} identical")

    # ---- 6. main path of the odometry slice (unfused) ----
    orbit = _render_sequence(240, 480, 640)
    reset_counts()
    scans: dict = {}
    res = run_bench(frames=240, height=480, width=640, device="cuda",
                    sequence=orbit, slam_frames=None, loader_frames=None,
                    outputs=scans)
    launches, plain = read_counts()
    log(f"[main] {json.dumps(res)}")
    ref = reference_results()
    for scan in ("classic", "boundary"):
        hold_pass(ref, f"orbit_{scan}", orbit_got(scans[scan], orbit[1]),
                  "main", card, TOL_REF_ORBIT)
    del scans
    # the ICP iteration latency op by op, beside run_bench's replayed one
    from tpuslam_torch.icp import align_frames_jit

    K_o, _, d_o = orbit
    d_o = torch.as_tensor(d_o[:2], device=dev)
    cfg_o = SLAMConfig(height=480, width=640).validate()
    pa_o, pb_o = (preprocess(d_o[i], K_o, cfg_o)[0] for i in (0, 1))
    one_level = dataclasses.replace(cfg_o.icp, pyramid_levels=1,
                                    iters_per_level=(50,), tol_delta=0.0)
    eager_iter_ms = wall_ms(lambda: align_frames_jit(
        (pb_o,), (pa_o,), K_o, torch.eye(4, device=dev), one_level,
        eager=True), 5, False) / 50
    log(f"[main] fps {res['fps_per_chip']:.3f}, ms/frame "
        f"{res['ms_per_frame']:.4f}, ATE {res['ate_rmse_m']:.3e} m; boundary fps "
        f"{res['fps_per_chip_boundary']:.3f}, ms/frame "
        f"{res['ms_per_frame_boundary']:.4f}, ATE "
        f"{res['ate_rmse_m_boundary']:.3e} m; headline "
        f"{res['headline_variant']} {res['fps_headline']:.3f} fps; "
        f"icp_iter_latency_ms {res['icp_iter_latency_ms']:.5f} replayed "
        f"(align_frames_jit), {eager_iter_ms:.5f} op by op ({card})")
    log(f"[main] launches {launches} plain calls {plain}")
    check(res["poses_finite"], "main: non-finite poses")
    check(res["ate_rmse_m"] < 1e-3, f"main: ATE {res['ate_rmse_m']} ≥ 1 mm")
    check(res["ate_rmse_m_boundary"] < 1e-3,
          f"main: boundary ATE {res['ate_rmse_m_boundary']} ≥ 1 mm")
    check(res["icp_iter_count"] == 50,
          f"main: {res['icp_iter_count']} ICP iterations, not 50")
    check(all(launches[k] > 0 for k in ("correspond", "gn_step")),
          f"main: launches {launches}")
    check(launches["gn_partials"] == launches["gn_epilogue"] == 0,
          f"main: the standalone GN kernels ran {launches}")
    check(all(v == 0 for v in plain.values()), f"main: plain calls {plain}")
    # launches a frame on the orbit: one scan of the 240 frames
    d_o = torch.as_tensor(orbit[2], device=dev)
    reset_counts()
    scan_odometry(d_o, K_o, SLAMConfig(height=480, width=640).validate())
    torch.cuda.synchronize()
    odo_launches, _ = read_counts()
    per_frame_odo = {k: v / d_o.shape[0] for k, v in odo_launches.items()}
    check(odo_launches["gn_step"] == 2 * odo_launches["correspond"] > 0,
          f"main: gn_step {odo_launches}")
    log(f"[main] launches a frame on the orbit (one scan, "
        f"{d_o.shape[0]} frames): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_frame_odo.items()))
    del d_o

    # ---- 7. fused odometry: gn_fused carries tracking ----
    reset_counts()
    scans = {}
    res_f = run_bench(frames=240, height=480, width=640, device="cuda",
                      fused_gn=True, sequence=orbit, slam_frames=None,
                      loader_frames=None, outputs=scans)
    launches_f, plain_f = read_counts()
    log(f"[fused] {json.dumps(res_f)}")
    hold_pass(ref, "orbit_fused", orbit_got(scans["classic"], orbit[1]),
              "fused", card, TOL_REF_ORBIT)
    del scans
    log(f"[fused] fps {res_f['fps_per_chip']:.3f} (unfused, phase 6: "
        f"{res['fps_per_chip']:.3f}), ms/frame {res_f['ms_per_frame']:.4f} "
        f"(unfused {res['ms_per_frame']:.4f}), icp_iter_latency_ms "
        f"{res_f['icp_iter_latency_ms']:.5f} (unfused "
        f"{res['icp_iter_latency_ms']:.5f}), ATE {res_f['ate_rmse_m']:.3e} m"
        f" ({card})")
    log(f"[fused] launches {launches_f} plain calls {plain_f}")
    check(res_f["poses_finite"], "fused: non-finite poses")
    check(res_f["ate_rmse_m"] < 1e-3,
          f"fused: ATE {res_f['ate_rmse_m']} ≥ 1 mm")
    # one launch a solve: no standalone reduction or epilogue
    check(launches_f["gn_fused"] > 0
          and launches_f["gn_epilogue"] == launches_f["gn_partials"] == 0,
          f"fused: launches {launches_f}")
    check(all(v == 0 for v in plain_f.values()),
          f"fused: plain calls {plain_f}")
    d_o = torch.as_tensor(orbit[2], device=dev)
    reset_counts()
    scan_odometry(d_o, K_o, SLAMConfig(
        height=480, width=640, icp=ICPConfig(fused_gn=True)).validate())
    torch.cuda.synchronize()
    fused_launches, _ = read_counts()
    per_frame_fused = {k: v / d_o.shape[0] for k, v in fused_launches.items()}
    log("[fused] launches a frame on the orbit (one scan): " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_frame_fused.items()))
    check(fused_launches["gn_epilogue"] == fused_launches["correspond"] == 0,
          f"fused: launches {fused_launches}")
    del d_o               # the orbit stays for phase 16

    # ---- 8. small slam: GPU kernels vs CPU twins on the 48-frame loop ----
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.slam import SlamSystem

    cfg_l = SLAMConfig(          # tests/test_chunked_slam.py's config
        height=120, width=160,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                                  lc_min_gap=3, lc_max_dist=0.6,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15))
    gt_l = loop_trajectory(48, cycles=2, radius=0.35)
    d_l = np.stack([render_depth(gt_l[i], Ks, 120, 160, seed=i)
                    for i in range(48)]).astype(np.float32)
    ts_l = np.arange(48) / 30.0

    def slam_loop(device, fused: bool):
        cfg_f = cfg_l.replace(icp=dataclasses.replace(cfg_l.icp,
                                                      fused_gn=fused))
        slam = SlamSystem(Ks, cfg_f, chunk_mode="boundary",
                          async_backend=True, device=device)
        d = torch.as_tensor(d_l, device=device)
        for i in range(0, 48, 8):
            slam.process_chunk(d[i:i + 8], ts_l[i:i + 8])
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes],
                [(c.i, c.j) for c in slam.closures], slam.trajectory()[1])

    for fused in (False, True):
        kg, cg, eg = slam_loop(dev, fused)
        kc, cc, ec = slam_loop("cpu", fused)
        err = float(np.abs(eg - ec).max())
        check(kg == kc, f"small slam fused={fused}: keyframes {kg} vs {kc}")
        check(cg == cc and len(cc) >= 1,
              f"small slam fused={fused}: closures {cg} vs {cc}")
        check(err <= TOL_SLAM_POSE, f"small slam fused={fused}: pose {err}")
        log(f"[small slam] fused_gn={fused}: GPU vs CPU twins identical "
            f"keyframes ({len(kg)}) and closure pairs ({len(cg)}), pose max "
            f"err {err:.3e}")

    # the drifted loop of tests/test_descriptor_lc.py: descriptor proposal
    cfg_d = cfg_l.replace(
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8)),
        posegraph=dataclasses.replace(
            cfg_l.posegraph, gn_iters=20, lc_max_dist=0.02,
            lc_descriptor=True))

    def drifted_loop(device):
        slam = SlamSystem(Ks, cfg_d, chunk_mode="boundary", device=device)
        drive_drifted(slam, torch.as_tensor(d_l, device=device), ts_l, 0, 48)
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes],
                [(c.i, c.j) for c in slam.closures], slam.trajectory()[1],
                [r.desc for r in slam.odo.keyframes])

    from tpuslam_torch.frontend import host_descriptor


    kg, cg, eg, dg = drifted_loop(dev)
    kc, cc, ec, dc_ = drifted_loop("cpu")
    err = float(np.abs(eg - ec).max())
    check(all(isinstance(x, np.ndarray) for x in dg if x is not None),
          "small slam drifted: a descriptor is not a numpy array")
    d_err = max(float(np.abs(host_descriptor(a) - host_descriptor(b)).max())
                for a, b in zip(dg, dc_) if a is not None)
    check(kg == kc, f"small slam drifted: keyframes {kg} vs {kc}")
    check(cg == cc and len(cc) >= 1,
          f"small slam drifted: closures {cg} vs {cc}")
    check(err <= TOL_SLAM_POSE, f"small slam drifted: pose {err}")
    log(f"[small slam] drifted, lc_descriptor: GPU vs CPU twins identical "
        f"keyframes ({len(kg)}) and closure pairs {cg}, pose max err "
        f"{err:.3e}, descriptor max err {d_err:.3e}")

    # ---- 9. slam: the full system at 640×480 (this slice's main path) ----
    loop = _render_sequence(120, 480, 640, loop_cycles=2)
    reset_counts()
    slam_res = {}
    for fused in (False, True):
        before, _ = read_counts()
        with PassLog() as passes:
            r = run_slam_bench(120, 480, 640, device="cuda", fused_gn=fused,
                               reps=3, sequence=loop)
        after, _ = read_counts()
        # every pass, the uncounted one too: the synchronous passes are
        # bench_slam's chunked variant, the deferred ones its chunked_async
        for _, o, _, s in passes.made:
            name = "loop_" + ("fused_" if fused else "") + (
                "deferred" if o.get("async_backend") else "chunked")
            hold_pass(ref, name, pass_result(s, np.arange(120) / 30.0,
                                          loop[1]), "slam", card)
        del passes
        slam_res[fused] = r
        ran = {k: after[k] - before[k] for k in after}
        log(f"[slam] {json.dumps(r)}")
        for mode in ("sync", "deferred"):
            m = r[mode]
            log(f"[slam] fused_gn={fused} {mode}: fps {m['fps']:.3f} (reps "
                f"{', '.join(f'{v:.3f}' for v in m['fps_reps'])}), closures "
                f"{m['closures']}, keyframes {m['keyframes']}, ATE "
                f"{m['ate_rmse_m']:.3e} m ({card})")
            check(m["poses_finite"], f"slam {fused} {mode}: non-finite")
            check(m["ate_rmse_m"] < 1e-3,
                  f"slam {fused} {mode}: ATE {m['ate_rmse_m']} ≥ 1 mm")
            check(m["closures"] >= 1, f"slam {fused} {mode}: no closure")
        check(r["sync"]["closure_pairs"] == r["deferred"]["closure_pairs"],
              f"slam fused={fused}: sync and deferred closures differ")
        need = ("gn_fused",) if fused else ("correspond", "gn_step")
        check(all(ran[k] > 0 for k in need),
              f"slam fused={fused}: launches {ran}")
        check(ran["gn_partials"] == ran["gn_epilogue"] == 0,
              f"slam fused={fused}: standalone GN kernels ran {ran}")
        log(f"[slam] fused_gn={fused} launches {ran}")
    launches_slam, plain_slam = read_counts()
    log(f"[slam] launches {launches_slam} plain calls {plain_slam}")
    check(all(launches_slam[k] > 0 for k in frame_kernels
              if k not in ("gn_partials", "gn_epilogue")),
          f"slam: launches {launches_slam}")
    check(all(v == 0 for v in plain_slam.values()),
          f"slam: plain calls {plain_slam}")

    # ---- 9b-9c. pose-free loop closure and the grid-hash fallbacks ----
    t0 = time.perf_counter()
    launches_drift = drift_phase(dev, card, counters, loop,
                                 slam_res[False]["deferred"]["fps"], ref)
    log(f"[drift] phase took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    launches_fallback = fallback_phase(dev, card, counters, loop)
    log(f"[fallback] phase took {time.perf_counter() - t0:.3f} s")

    # ---- 10. profile ----
    from torch.profiler import ProfilerActivity, profile

    odo_us: dict = {}
    fused_us: dict = {}
    gemms_by: dict = {}

    d8 = torch.as_tensor(depths_np, device=dev)
    d8 = d8[[0, 1] * 4]
    for fused in (False, True):
        cfg_p = cfg.replace(icp=dataclasses.replace(cfg.icp, fused_gn=fused))
        scan_odometry(d8, K, cfg_p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            scan_odometry(d8, K, cfg_p)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        if busy > 0:
            gemms_by[fused] = count_ops(rows, "gemm")
            log(f"[profile] fused_gn={fused}, 8 frames: wall {wall_us:.1f} us "
                f"(profiled), device busy {busy:.1f} us, device ops "
                f"{sum(r[1] for r in rows)}, GEMMs {gemms_by[fused]} "
                f"({card})")
            for dt, cnt, key in rows[:15]:
                log(f"[profile]   {dt:10.1f} us  {cnt:6d}x  {key[:90]}")
            if fused:
                # each fused solve is one launch: no standalone epilogue,
                # and no GEMM in the loop (no more than the plain orbit's,
                # none of which is the loop's)
                fused_us = {k: per_launch_us(rows, k) for k in KERNEL_SYMBOLS}
                log("[profile] device us a launch, fused odometry: "
                    + ", ".join(f"{k} {v[0]:.3f} ({v[1]}x)"
                                for k, v in fused_us.items() if v is not None))
                check(fused_us["gn_fused"] is not None
                      and fused_us["gn_epilogue"] is None,
                      f"profile fused: launches {fused_us}")
                check(gemms_by[True] <= gemms_by.get(False, 0),
                      f"profile: the fused orbit ran {gemms_by}")
            else:
                odo_us = {k: per_launch_us(rows, k) for k in KERNEL_SYMBOLS}
                log("[profile] device us a launch, odometry: " + ", ".join(
                    f"{k} {v[0]:.3f} ({v[1]}x)" for k, v in odo_us.items()
                    if v is not None))
                # the association transforms inside its kernel: fewer GEMMs
                # than associations (each used to bring two)
                gemms = count_ops(rows, "gemm")
                assoc = odo_us["correspond"][1] if odo_us["correspond"] else 0
                log(f"[profile] odometry: {gemms} GEMM launches, {assoc} "
                    f"associations")
                check(assoc > 0 and gemms < assoc,
                      f"profile: {gemms} GEMMs against {assoc} associations")
        else:
            log("[profile] device time: not measured (profiler saw no "
                "kernels)")

    # steady-state SLAM chunks (deferred backend, fused_gn False) after the
    # first closures, the previous chunk's attempt draining through each
    # chunk's readback: one timed by stage, the next under the profiler
    K_loop, _, d_loop = loop
    d_loop = torch.as_tensor(d_loop, device=dev)
    slam = SlamSystem(K_loop, slam_bench_config(480, 640, False),
                      async_backend=True, chunk_mode="boundary", chunk_sub=4,
                      device=dev)
    ts = np.arange(120) / 30.0
    for i in range(0, 64, 8):
        slam.process_chunk(d_loop[i:i + 8], ts[i:i + 8])
    # chunk 64-71 on the host clock, each stage fenced by a synchronize
    # (the profiler's own cost inflates host spans several-fold): the
    # scan, the promotion bundles, the attempt's dispatch and drain; the
    # rest of the chunk is host bookkeeping
    import tpuslam_torch.slam as slam_mod

    spans: dict = {}
    saved = {n: getattr(slam_mod, n) for n in (
        "scan_superchunk_frozen", "promote_bundle_jit", "fuse_readbacks_jit")}
    fenced_spans(spans, slam_mod, saved)
    fenced_spans(spans, slam, ("_dispatch_closure_attempt",
                               "_drain_closure_attempt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.process_chunk(d_loop[64:72], ts[64:72])
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    for n, fn in saved.items():
        setattr(slam_mod, n, fn)
    for n in ("_dispatch_closure_attempt", "_drain_closure_attempt"):
        delattr(slam, n)
    staged = sum(spans.values()) * 1e3
    log(f"[chunk stages] frames 64-71: {chunk_ms:.3f} ms; " + ", ".join(
        f"{n} {v * 1e3:.3f} ms" for n, v in spans.items())
        + f"; host bookkeeping {chunk_ms - staged:.3f} ms ({card})")
    # the promotion pack the boundary scan pays at every sub-chunk (it
    # packs unconditionally and selects with torch.where on the device)
    pyr_l = preprocess(d_loop[64], K_loop, slam.cfg)
    old = pack_pyramid(pyr_l, slam.cfg.icp)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    pack_ms = time_ms(lambda: tuple(
        torch.where(flag, n, o)
        for n, o in zip(pack_pyramid(pyr_l, slam.cfg.icp), old)), reps=20)
    log(f"[chunk stages] pack + select of one sub-chunk's keyframe: "
        f"{pack_ms:.5f} ms ({card})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        slam.process_chunk(d_loop[72:80], ts[72:80])
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"[profile chunk] frames 72-79: wall {wall_us:.1f} us (profiled), "
        f"device busy {busy:.1f} us, attempt "
        f"pending after: {slam._pending_attempt is not None} ({card})")
    for ev in prof.key_averages():
        if ev.key.startswith("slam."):
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0)
            log(f"[profile chunk]   {ev.key:20s} {ev.count:3d}x host "
                f"{ev.cpu_time_total:10.1f} us, device {dev_us:10.1f} us")
    for dt, cnt, key in rows[:12]:
        log(f"[profile chunk]   {dt:10.1f} us  {cnt:6d}x  {key[:90]}")
    del d_loop

    # ---- 11. small map: GPU kernels vs CPU twins ----
    small_map_phase(dev, counters)

    # ---- 12. map: frame-to-map tracking (the projective and ring paths) ----
    launches_map, map_fps = map_phase(dev, card, counters, loop,
                                      slam_res[False]["sync"]["ate_rmse_m"],
                                      ref)

    # ---- 12b. grid: the grid path at full width (this slice's path) ----
    import tpuslam_torch.slam as slam_module

    t0 = time.perf_counter()
    ba_calls = []
    optimize_map_ba = slam_module.optimize_map_ba

    def keep_ba(graph, prob, pg_cfg, huber_delta):
        ba_calls.append((graph, prob, pg_cfg, huber_delta))
        return optimize_map_ba(graph, prob, pg_cfg, huber_delta=huber_delta)
    slam_module.optimize_map_ba = keep_ba     # phase 16 re-solves its BA
    try:
        launches_grid = grid_phase(dev, card, counters, loop, map_fps,
                                   grid_stats, table_stats, ref)
    finally:
        slam_module.optimize_map_ba = optimize_map_ba
    log(f"[grid] phase took {time.perf_counter() - t0:.3f} s")

    # ---- 13-15. the CLI (this slice's main path), scale, pathology ----
    t0 = time.perf_counter()
    launches_cli = cli_phase(card, counters,
                             slam_res[False]["deferred"]["fps"], ref)
    log(f"[cli] phase took {time.perf_counter() - t0:.3f} s")
    for name, fn in (("scale", scale_phase), ("pathology", pathology_phase)):
        t0 = time.perf_counter()
        with LastInstance(SlamSystem) as scale_slam:
            fn(card, counters, ref)
        if name == "scale":           # phase 16 re-solves its final graph
            scale_graph = (scale_slam.made.graph.graph(),
                           scale_slam.made.cfg.posegraph)
        log(f"[{name}] phase took {time.perf_counter() - t0:.3f} s")
    del scale_slam

    # ---- 16. dist: the distributed stages, one NCCL rank, 4 gloo ranks ----
    t0 = time.perf_counter()
    # 12b's first BA is run_map_bench's at finalize (all keyframes)
    launches_dist = dist_phase(dev, card, counters, orbit, scale_graph,
                               ba_calls[0])
    log(f"[dist] phase took {time.perf_counter() - t0:.3f} s")
    del orbit, ba_calls, scale_graph

    # ---- 17. backend: the worker thread's stream, bench_slam, cold start --
    t0 = time.perf_counter()
    backend = backend_phase(dev, card, counters, loop, build_line, ref)
    log(f"[backend] phase took {time.perf_counter() - t0:.3f} s")
    del loop

    # ---- result lines ----
    sources = {
        "correspond": ("tpuslam_torch/csrc/correspond.cu",
                       "tpuslam/kernels/correspond.py:100"),
        "gn_partials": ("tpuslam_torch/csrc/gn_partials.cu",
                        "tpuslam/kernels/pallas_gn.py:37"),
        "gn_epilogue": ("tpuslam_torch/csrc/gn_epilogue.cu",
                        "tpuslam/kernels/pallas_epilogue.py:187"),
        "gn_step": ("tpuslam_torch/csrc/gn_step.cu",
                    "tpuslam/kernels/pallas_gn.py:37 + "
                    "tpuslam/kernels/pallas_epilogue.py:187 "
                    "(the GN step of tpuslam/icp.py:129-139)"),
        "gn_fused": ("tpuslam_torch/csrc/gn_fused.cu",
                     "tpuslam/kernels/gn_fused.py:160"),
        "ring_nn": ("tpuslam_torch/csrc/ring_nn.cu",
                    "tpuslam/kernels/pallas_ring.py:100"),
        "grid_correspond": ("tpuslam_torch/csrc/grid_correspond.cu",
                            "tpuslam/kernels/correspond.py:220 (XLA, not "
                            "Pallas: grid_hash_correspond)"),
        "grid_table": ("tpuslam_torch/csrc/grid_correspond.cu",
                       "tpuslam/kernels/correspond.py:246 (XLA, not "
                       "Pallas: the searchsorted of grid_hash_correspond)"),
    }
    # timings at level 0 (ring_nn: its own phase, one full hop; gn_partials
    # also at the ring's size, `ring_size`); launches on the map path (phase
    # 12), or for gn_fused, which that path does not run, on the SLAM path
    # with fused_gn (phase 9); beside them launches a frame on the odometry
    # orbit (phase 6; gn_fused: the fused orbit, phase 7), device µs a
    # launch there averaged over all launches (phase 10) and device µs of
    # one full launch at level 0 (phase 3).
    # grid_correspond: its own phase's timing (16,384 × 131,072), launches
    # on the grid path (phase 12b).
    # No single PyTorch call computes the other functions (the probe: no
    # call takes a truncated 27-cell scan with its tie rule), so their
    # library_ms is null; the grid table stands in for the reference's
    # searchsorted, and its library_ms is torch.searchsorted's (phase 3).
    summary = {k: dict(stats[k][0], max_abs_err=max(
        v["max_abs_err"] for v in stats[k].values())) for k in frame_kernels}
    summary["ring_nn"] = ring_stats
    summary["grid_correspond"] = grid_stats
    summary["grid_table"] = table_stats
    odo_launch = dict(per_frame_odo, gn_fused=per_frame_fused["gn_fused"])
    odo_dev = dict(odo_us, gn_fused=fused_us.get("gn_fused"))
    kernels = []
    for name, (src_path, replaces) in sources.items():
        s = summary[name]
        launches, path = ((launches_grid[name], "grid (phase 12b)")
                          if name.startswith("grid_") else
                          (launches_slam[name], "slam (phase 9)")
                          if name == "gn_fused" else
                          (launches_map[name], "map (phase 12)"))
        kernels.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": launches, "path": path,
            "grid_launches_per_frame": launches_grid[name] / 120,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
            "odometry_launches_per_frame": odo_launch.get(name, 0.0),
            "odometry_device_us_per_launch": (
                odo_dev[name][0] if odo_dev.get(name) else None),
            "device_us_full_launch": s["device_us_full_launch"],
            # the probe in the path's query order; the table's size
            **{k: s[k] for k in ("ms_voxel_order",
                                 "device_us_full_launch_voxel_order",
                                 "table_bytes") if k in s},
            # the CLI's launches (phase 13): run_slam, and the sharded run
            "cli_launches": {"run_slam": launches_cli["run_slam"][name],
                             "sharded": launches_cli["sharded"][name],
                             "grid": launches_cli["grid"][name]},
            # the pose-free loop closure paths (phases 9b, 9c and 13):
            # slam-drift-vga with descriptors, its resumed grid-fallback
            # run, and run_slam --lc-descriptor
            "verify_launches": {
                "drift": launches_drift[name],
                "grid_fallback": launches_fallback[name],
                "cli_lc_descriptor": launches_cli["lc_descriptor"][name]},
            **({"ring_size": ring_partials} if name == "gn_partials" else {}),
            # the distributed stages (phase 16): the sharded ICP on one
            # NCCL rank, and on each of 4 gloo ranks sharing the card with
            # their batched alignment
            "dist_launches": {
                "nccl_one_rank_icp": launches_dist["nccl_one_rank_icp"][name],
                "gloo_rank_icp": [p[name] for p in
                                  launches_dist["gloo_rank_icp"]],
                "gloo_rank_batch": [p[name] for p in
                                    launches_dist["gloo_rank_batch"]]},
            # bench_slam's five variants (phase 17), and of those the
            # launches on the worker threads' streams
            "backend_launches": {
                "bench_slam": backend["launches"][name],
                "worker_streams": backend["worker_streams"][name]},
        })
    log(json.dumps({"gn_step_ab": step_ab}))
    log("[holds] " + json.dumps([
        {"phase": tag, "pass": r["prefix"], "stable": r["stable"],
         "err_max": r["err_max"], "limit": r["limit"],
         "spread": r["spread"], "ate_rmse_m": r["ate_rmse_m"],
         "keyframes_equal": r["keyframes_part"] is None,
         "closures_equal": r["closures_part"] is None,
         "held": not r["failures"]} for tag, r in HOLDS]) + f" ({card})")
    log(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.3f} s "
        f"({card})")
    check(not HOLD_FAILURES, f"{len(HOLD_FAILURES)} of {len(HOLDS)} passes "
          f"part from the reference's: " + " | ".join(HOLD_FAILURES))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"preprocess": pre_stats}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
