"""The port's SLAM system (tpuslam_torch/slam.py) against the reference's
on the 48-frame two-lap loop of tests/test_chunked_slam.py, 8-frame chunks.

For boundary sync, boundary deferred and inline sync, with `fused_gn`
False and True, the port must take the reference's keyframe decisions
(same frame indices) and accept the same closure pairs in the same order,
and its trajectory must stay within 1e-4 m and 1e-4 rad per frame of the
reference's (float32 ICP on two libraries).

One reference run serves both boundary modes of a `fused_gn` setting: the
reference's deferred run is byte-identical to its sync run (its own
tests/test_chunked_slam.py holds it to that).  The inline fused case is
held to the reference's inline unfused run: the reference's fused and
unfused runs take the same keyframes and closures on this loop, and its
fused step matches the unfused one to 1e-6 (tests/test_gn_fused.py);
compiling a fourth reference configuration would double this file's time.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuslam.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam.data.synthetic import loop_trajectory, render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.slam import SlamSystem as PSlam

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
CFG = SLAMConfig(
    height=H, width=W,
    icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                  max_corr_dist=0.25, huber_delta=0.05),
    keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
    posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                              lc_min_gap=3, lc_max_dist=0.6,
                              lc_max_residual=0.05, lc_min_inliers=0.3),
    voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15),
)
FRAMES = 48
CHUNK = 8
POSE_TOL = 1e-4


def with_fused(cfg, fused: bool):
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp,
                                                             fused_gn=fused))


def drive(slam, depths):
    ts = np.arange(FRAMES) / 30.0
    for i in range(0, FRAMES, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    slam.finalize()
    return slam


def summary(slam):
    _, est = slam.trajectory()
    return ([r.index for r in slam.odo.keyframes],
            [(c.i, c.j) for c in slam.closures], est)


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES)]).astype(np.float32)
    return gt, depths


@pytest.fixture(scope="module")
def reference(loop):
    _, depths = loop
    runs = {}
    for mode, fused in (("boundary", False), ("boundary", True),
                        ("inline", False)):
        runs[mode, fused] = summary(drive(
            RSlam(K, with_fused(CFG, fused), enable_loop_closure=True,
                  chunk_mode=mode), depths))
    return runs


CASES = [(mode, asy, fused) for fused in (False, True)
         for mode, asy in (("boundary", False), ("boundary", True),
                           ("inline", False))]


@pytest.mark.parametrize("mode,deferred,fused", CASES,
                         ids=[f"{m}-{'deferred' if a else 'sync'}-"
                              f"{'fused' if f else 'plain'}"
                              for m, a, f in CASES])
def test_slam_matches_reference(loop, reference, mode, deferred, fused):
    gt, depths = loop
    slam = drive(PSlam(PIntrinsics(*K),
                       config_from_reference(with_fused(CFG, fused)),
                       enable_loop_closure=True, chunk_mode=mode,
                       async_backend=deferred, device="cpu"), depths)
    kf, closures, est = summary(slam)
    r_kf, r_closures, r_est = reference[mode, fused and mode == "boundary"]
    assert kf == r_kf
    assert closures == r_closures and len(closures) >= 1
    assert slam._pending_attempt is None
    np.testing.assert_allclose(est[:, :3, 3], r_est[:, :3, 3],
                               atol=POSE_TOL)
    np.testing.assert_allclose(est[:, :3, :3], r_est[:, :3, :3],
                               atol=POSE_TOL)
    gt_ts = np.arange(FRAMES) / 30.0
    ts, _ = slam.trajectory()
    assert ate_rmse(ts, est, gt_ts, gt, max_difference=0.005)["rmse"] < 0.02


def test_lost_chunk_replays_and_relocalizes_like_reference(loop):
    """Two blank frames mid-chunk: the boundary chunk commits nothing and
    replays per frame (Odometry, loss accounting, relocalization), as
    tests/test_chunked_slam.py::test_boundary_lost_replays_per_frame
    drives the reference."""
    _, depths = loop
    depths = depths.copy()
    depths[18:20] = 0.0

    def run(slam):
        drive(slam, depths)
        kf, closures, est = summary(slam)
        return (kf, closures, est, [r.kf_id for r in slam.relocalizations],
                [bool(s.get("lost")) for s in slam.odo.stats])

    r = run(RSlam(K, CFG, enable_loop_closure=True, chunk_mode="boundary"))
    p = run(PSlam(PIntrinsics(*K), config_from_reference(CFG),
                  enable_loop_closure=True, chunk_mode="boundary",
                  device="cpu"))
    assert p[0] == r[0] and p[1] == r[1]
    assert p[3] == r[3] and p[4] == r[4] and any(p[4])
    np.testing.assert_allclose(p[2], r[2], atol=POSE_TOL)
    assert np.all(np.isfinite(p[2]))


def test_slam_bench_runs_small_on_cpu():
    from tpuslam_torch.bench.harness import run_slam_bench

    res = run_slam_bench(frames=20, height=120, width=160, device="cpu",
                         reps=1)
    assert res["device"] == "cpu" and res["frames"] == 20
    for mode in ("sync", "deferred"):
        m = res[mode]
        assert m["poses_finite"] and m["keyframes"] >= 2 and m["fps"] > 0
        assert m["ate_rmse_m"] < 0.02
    assert res["sync"]["closure_pairs"] == res["deferred"]["closure_pairs"]


def test_not_ported_options_raise():
    """The inline-mode worker thread (once raising) constructs a worker,
    which `finalize` joins; in boundary mode async means the deferred
    drain and starts none; descriptor proposal (once raising) constructs."""
    cfg = config_from_reference(CFG)
    pk = PIntrinsics(*K)
    slam = PSlam(pk, cfg, async_backend=True, chunk_mode="inline",
                 device="cpu")
    thread = slam._backend_thread
    assert thread is not None and thread.is_alive()
    slam.finalize()
    assert slam._backend_thread is None and not thread.is_alive()
    assert PSlam(pk, cfg, async_backend=True, chunk_mode="boundary",
                 device="cpu")._backend_thread is None
    slam = PSlam(pk, dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, lc_descriptor=True)), device="cpu")
    assert slam.cfg.posegraph.lc_descriptor


@pytest.mark.parametrize("lc_descriptor", [False, True],
                         ids=["proximity", "descriptor"])
def test_chunk_paths_read_back_once_per_chunk(loop, monkeypatch,
                                              lc_descriptor):
    """A boundary chunk on a seeded system reads the device back once,
    and the deferred backend's attempt rides that same readback; with
    descriptor proposal too, which reads the descriptors from host memory
    (their copies started at promotion)."""
    _, depths = loop
    cfg = config_from_reference(CFG)
    cfg = dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, lc_descriptor=lc_descriptor))
    slam = PSlam(PIntrinsics(*K), cfg, chunk_mode="boundary",
                 async_backend=True, device="cpu")
    ts = np.arange(FRAMES) / 30.0
    for i in range(0, 32, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    assert slam._pending_attempt is not None
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    import tpuslam_torch.backend.loopclosure as plc

    proposals = []
    real_propose = plc.propose_descriptor_candidates

    def counting_propose(*a, **kw):
        proposals.append(real_propose(*a, **kw))
        return proposals[-1]

    monkeypatch.setattr(plc, "propose_descriptor_candidates",
                        counting_propose)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    slam.process_chunk(depths[32:40], ts[32:40])
    assert len(reads) == 1
    assert len(proposals) == int(lc_descriptor)
    assert all(isinstance(r.desc, np.ndarray) == lc_descriptor
               for r in slam.odo.keyframes)
