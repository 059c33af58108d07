"""The port's SLAM system with frame-to-map tracking against the
reference's, on the loop of tests/test_slam.py at reduced capacities
(frame clouds 2,048 points, map 8,192 rows).

Unsharded (`track_against_map=True`: VoxelMap + align_map_to_frame) and
sharded (`sharded_map=True` on a one-rank mesh: ShardedVoxelMap + the
ring ICP through the ring_nn twin; the reference on a one-device mesh, so
both hold the whole map in one shard) must take the same keyframes, build
maps of the same size to 0.1% (a point on a voxel boundary may land one
voxel over when the keyframe poses differ in their last float32 bits),
pass the same map refinements, and keep every pose within 1e-4 of the
reference's (float32 ICP on two libraries).
"""

import numpy as np
import pytest
import torch

import tpuslam.dist.mesh as rmesh
from tests.test_slam import loop_trajectory
from tpuslam.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam.data.synthetic import render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.dist.map_fusion import ShardedVoxelMap
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.mapping import VoxelMap
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
    voxel=VoxelConfig(capacity=1 << 11, map_capacity=1 << 13),
    map_refine_min_inliers=100,
)
FRAMES = 16
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(30)[:FRAMES]
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES)]).astype(np.float32)
    return gt, depths


def run(slam, depths):
    for i in range(FRAMES):
        slam.process(depths[i], timestamp=i / 30.0)
    _, est = slam.trajectory()
    return ([r.index for r in slam.odo.keyframes], slam.map.size(),
            [s["ok"] for s in slam.map_refine_stats], est)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded-one-rank"])
def test_map_tracking_matches_reference(loop, monkeypatch, sharded):
    gt, depths = loop
    monkeypatch.setattr(rmesh, "make_mesh", lambda: rmesh.Mesh(
        np.asarray(rmesh.jax.devices()[:1]), axis_names=(rmesh.SHARD_AXIS,)))
    ref = RSlam(K, CFG, enable_loop_closure=False, track_against_map=True,
                sharded_map=sharded)
    port = PSlam(PIntrinsics(*K), config_from_reference(CFG),
                 enable_loop_closure=False, track_against_map=True,
                 sharded_map=sharded, device="cpu")
    assert isinstance(port.map, ShardedVoxelMap if sharded else VoxelMap)
    r_kf, r_size, r_ok, r_est = run(ref, depths)
    p_kf, p_size, p_ok, p_est = run(port, depths)
    assert p_kf == r_kf and len(p_kf) >= 4
    # a voxel-boundary point may fall one voxel over under poses that
    # differ in the last float32 bits
    assert abs(p_size - r_size) <= 1e-3 * r_size
    assert p_ok == r_ok and np.mean(p_ok) > 0.5
    np.testing.assert_allclose(p_est[:, :3, 3], r_est[:, :3, 3],
                               atol=POSE_TOL)
    np.testing.assert_allclose(p_est[:, :3, :3], r_est[:, :3, :3],
                               atol=POSE_TOL)
    if sharded:
        assert port.map.dropped_total == 0
    ts = np.arange(FRAMES) / 30.0
    assert ate_rmse(ts, p_est, ts, gt, max_difference=0.005)["rmse"] < 0.02


def test_chunks_step_per_frame_with_map_tracking(loop):
    """process_chunk steps per frame when the map refines every frame, so
    a chunked run is the per-frame run."""
    _, depths = loop
    cfg = config_from_reference(CFG)
    a = PSlam(PIntrinsics(*K), cfg, enable_loop_closure=False,
              track_against_map=True, chunk_mode="boundary", device="cpu")
    b = PSlam(PIntrinsics(*K), cfg, enable_loop_closure=False,
              track_against_map=True, device="cpu")
    for i in range(0, 8, 4):
        a.process_chunk(depths[i:i + 4], np.arange(i, i + 4) / 30.0)
    for i in range(8):
        b.process(depths[i], timestamp=i / 30.0)
    assert len(a.map_refine_stats) == len(b.map_refine_stats) == 8 - 2
    np.testing.assert_array_equal(a.trajectory()[1], b.trajectory()[1])


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_map_bench_runs_small_on_cpu(sharded):
    from tpuslam_torch.bench.harness import run_map_bench
    from tpuslam_torch.config import VoxelConfig as PVoxelConfig

    res = run_map_bench(frames=20, height=120, width=160, sharded=sharded,
                        device="cpu", warmup=0,
                        voxel=PVoxelConfig(capacity=1 << 10,
                                           map_capacity=1 << 12))
    assert res["device"] == "cpu" and res["sharded"] == sharded
    assert res["poses_finite"] and res["ate_rmse_m"] < 0.02
    assert res["map_refinements"] > 0 and res["refine_ok_share"] > 0.5
    assert res["dropped_total"] == 0 and 0 < res["map_size"] <= 1 << 12
    # on the CPU every kernel's work is its plain twin's
    assert not any(res["launches"].values())
    assert (res["plain_calls"]["ring_nn"] > 0) == sharded
    assert res["plain_calls"]["correspond"] > 0
