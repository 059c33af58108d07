"""The port's odometry (tpuslam_torch/frontend.py) against the reference on
the 12-frame synthetic orbit of tests/test_odometry.py.  `scan_odometry`
runs against the reference's kernel path in interpret mode
(TPUSLAM_FORCE_PALLAS=1), the boundary scan and the host-driven `Odometry`
against its plain path.  Promotion flags and keyframe indices must be
identical, poses within 1e-4 and ATE within 1e-5 m of the reference's; a
restart from the reference's mid-sequence state
(interop.scan_state_from_numpy) must reproduce the reference's following
frames."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.frontend as rf
import tpuslam_torch.frontend as pf
from tpuslam.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam.data.synthetic import orbit_trajectory, render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.interop import config_from_reference, scan_state_from_numpy

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
PK = PIntrinsics(*K)
H, W = 120, 160
F = 12
CFG = SLAMConfig(
    height=H, width=W,
    icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                  max_corr_dist=0.25, huber_delta=0.05),
    keyframe=KeyframeConfig(max_translation=0.10, max_rotation=0.15),
)
# tight thresholds so keyframes promote along the orbit
CFG_PROMOTE = dataclasses.replace(
    CFG, keyframe=KeyframeConfig(max_translation=0.02, max_rotation=0.15))


@pytest.fixture(scope="module")
def sequence():
    poses = orbit_trajectory(F)
    depths = np.stack([render_depth(poses[i], K, H, W, seed=i)
                       for i in range(F)])
    return poses, depths


def ate(est, gt):
    ts = np.arange(len(gt)) / 30.0
    return ate_rmse(ts, np.asarray(est, np.float64), ts, gt,
                    max_difference=0.005)["rmse"]


@pytest.mark.parametrize("cfg", [CFG, CFG_PROMOTE], ids=["orbit", "promote"])
def test_scan_odometry_matches_reference(sequence, monkeypatch, cfg):
    monkeypatch.setenv("TPUSLAM_FORCE_PALLAS", "1")
    gt, depths = sequence
    rp, rpr, ri = rf.scan_odometry(jnp.asarray(depths), K, cfg)
    pp, ppr, pi = pf.scan_odometry(torch.as_tensor(depths), PK,
                                   config_from_reference(cfg))
    np.testing.assert_array_equal(ppr.numpy(), np.asarray(rpr))
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), atol=1e-4)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ri), atol=1e-4)
    assert abs(ate(pp.numpy(), gt) - ate(rp, gt)) <= 1e-5
    assert ate(pp.numpy(), gt) < 1e-3
    if cfg is CFG_PROMOTE:
        assert int(ppr.sum()) >= 2


def test_restart_from_reference_state(sequence, monkeypatch):
    """Start the port mid-sequence from the reference's ScanState."""
    monkeypatch.setenv("TPUSLAM_FORCE_PALLAS", "1")
    gt, depths = sequence
    cfg = CFG_PROMOTE
    k = 5
    d = jnp.asarray(depths)
    init = rf.ScanState(
        kf_packed=rf.pack_pyramid(rf.preprocess(d[0], K, cfg), cfg.icp),
        T_world_kf=jnp.eye(4), T_kf_cam=jnp.eye(4), last_delta=jnp.eye(4))
    mid, _ = rf.scan_chunk(d[:k], K, init, cfg)
    _, rows = rf.scan_chunk(d[k:], K, mid, cfg)
    rows = np.asarray(rows)
    state = scan_state_from_numpy(
        [np.asarray(t) for t in mid.kf_packed], np.asarray(mid.T_world_kf),
        np.asarray(mid.T_kf_cam), np.asarray(mid.last_delta), "cpu")
    pp, ppr, pi = pf.scan_odometry(torch.as_tensor(depths[k:]), PK,
                                   config_from_reference(cfg), state=state)
    world = rows[:, rf.FlatChunk.WORLD_T].reshape(-1, 4, 4)
    np.testing.assert_allclose(pp.numpy(), world, atol=1e-4)
    np.testing.assert_array_equal(ppr.numpy(),
                                  rows[:, rf.FlatChunk.PROMOTE] > 0.5)
    np.testing.assert_allclose(pi.numpy(),
                               rows[:, rf.FlatChunk.INLIER_FRACTION],
                               atol=1e-4)


def test_scan_odometry_boundary_matches_reference(sequence):
    """Boundary promotion over 4-frame chunks: the chunk's LAST frame
    becomes the keyframe when any of its frames flags promotion."""
    gt, depths = sequence
    rp, rpr, ri = rf.scan_odometry_boundary(jnp.asarray(depths), K,
                                            CFG_PROMOTE, chunk=4)
    pp, ppr, pi = pf.scan_odometry_boundary(
        torch.as_tensor(depths), PK, config_from_reference(CFG_PROMOTE),
        chunk=4)
    np.testing.assert_array_equal(ppr.numpy(), np.asarray(rpr))
    assert int(ppr.sum()) >= 2
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), atol=1e-4)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ri), atol=1e-4)
    assert ate(pp.numpy(), gt) < 1e-3


def test_track_step_matches_reference(sequence):
    """One frame against a keyframe pyramid packed per call."""
    _, depths = sequence
    pcfg = config_from_reference(CFG_PROMOTE)
    ra, rb = (rf.preprocess(jnp.asarray(depths[i]), K, CFG_PROMOTE)
              for i in (0, 3))
    pa, pb = (pf.preprocess(torch.as_tensor(depths[i]), PK, pcfg)
              for i in (0, 3))
    r = rf.track_step_jit(ra, rb, K, jnp.eye(4), CFG_PROMOTE)
    p = pf.track_step(pa, pb, PK, torch.eye(4), pcfg)
    assert bool(p.promote) == bool(r.promote) and bool(p.lost) == bool(r.lost)
    assert int(p.icp.iters) == int(r.icp.iters)
    np.testing.assert_allclose(p.T_kf_cam.numpy(), np.asarray(r.T_kf_cam),
                               atol=5e-5)


def test_odometry_process_matches_reference(sequence):
    """The host-driven per-frame loop (`Odometry.process`): the same
    keyframes (frame indices, poses), iteration counts and trajectory."""
    gt, depths = sequence
    r = rf.Odometry(K, CFG_PROMOTE)
    p = pf.Odometry(PK, config_from_reference(CFG_PROMOTE), device="cpu")
    for i in range(F):
        r.process(depths[i], timestamp=i / 30.0)
        p.process(depths[i], timestamp=i / 30.0)
    assert [k.index for k in p.keyframes] == [k.index for k in r.keyframes]
    assert len(p.keyframes) >= 2
    assert [s["iters"] for s in p.stats] == [s["iters"] for s in r.stats]
    for a, b in zip(p.keyframes, r.keyframes):
        np.testing.assert_allclose(a.T_world_kf, b.T_world_kf, atol=1e-4)
        assert a.verify.packed.shape == tuple(b.verify.packed.shape)
        # the two preprocesses agree to 1e-5, not bit for bit, so a point
        # on a voxel face can fall on either side: occupied voxels ±2
        assert abs(int(a.cloud.mask.sum()) - int(np.sum(b.cloud.mask))) <= 2
    np.testing.assert_allclose(np.stack(p.trajectory),
                               np.stack(r.trajectory), atol=1e-4)
    assert ate(np.stack(p.trajectory), gt) < 1e-3


def test_uint16_depth_bit_equals_float32(sequence):
    _, depths = sequence
    cfg = config_from_reference(CFG)
    raw = np.round(depths[:4] * cfg.depth_scale).astype(np.uint16)
    host = raw.astype(np.float32) / np.float32(cfg.depth_scale)
    for i in range(4):
        pu = pf.preprocess(torch.as_tensor(raw[i]), PK, cfg)
        ph = pf.preprocess(torch.as_tensor(host[i]), PK, cfg)
        for a, b in zip(pu, ph):
            for u, v in zip(a, b):
                assert torch.equal(u, v)
    out_u = pf.scan_odometry(torch.as_tensor(raw), PK, cfg)
    out_f = pf.scan_odometry(torch.as_tensor(host), PK, cfg)
    assert torch.equal(out_u[0], out_f[0])


def test_preprocess_matches_reference(sequence):
    _, depths = sequence
    r = rf.preprocess(jnp.asarray(depths[2]), K, CFG)
    p = pf.preprocess(torch.as_tensor(depths[2]), PK,
                      config_from_reference(CFG))
    assert len(r) == len(p) == 3
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_allclose(b.points.numpy(), np.asarray(a.points),
                                   atol=1e-5)
        np.testing.assert_allclose(b.normals.numpy(), np.asarray(a.normals),
                                   atol=1e-5)


@pytest.mark.parametrize("case", ["tracked", "lost_low_inliers",
                                  "lost_nonfinite", "promote_rotation",
                                  "promote_overlap"])
def test_promote_flags_match_reference(case):
    from tpuslam.geom import se3 as rse3
    from tpuslam.icp import ICPResult as RRes
    from tpuslam_torch.icp import ICPResult as PRes

    T = np.array(rse3.exp(jnp.asarray([0.01, 0.0, 0.0, 0.0, 0.02, 0.0])))
    T0 = np.eye(4, dtype=np.float32)
    inl = 0.8
    if case == "lost_low_inliers":
        inl = 0.05
    elif case == "lost_nonfinite":
        T[0, 3] = np.nan
    elif case == "promote_rotation":
        T = np.array(rse3.exp(jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.4, 0.0])))
    elif case == "promote_overlap":
        inl = 0.3
    z = np.float32(0.0)
    r = rf._promote_flags(RRes(jnp.asarray(T), 4, z, jnp.float32(inl), True,
                               jnp.zeros((6, 6)), z), jnp.asarray(T0), CFG)
    p = pf._promote_flags(PRes(torch.as_tensor(T), 4, z,
                               torch.tensor(inl, dtype=torch.float32), True,
                               torch.zeros(6, 6), z), torch.as_tensor(T0),
                          config_from_reference(CFG))
    assert bool(p.lost) == bool(r.lost)
    assert bool(p.promote) == bool(r.promote)
    np.testing.assert_array_equal(p.T_kf_cam.numpy(), np.asarray(r.T_kf_cam))


def test_harness_runs_small_on_cpu():
    from tpuslam_torch.bench.harness import run_bench

    res = run_bench(frames=6, height=120, width=160, device="cpu", warmup=0,
                    reps=1, slam_frames=None, loader_frames=None)
    assert res["device"] == "cpu" and res["frames"] == 6
    assert res["poses_finite"] and res["ate_rmse_m"] < 1e-3
    assert res["icp_iter_count"] == 50
    for key in ("fps", "ms_per_frame", "icp_iter_latency_ms"):
        assert res[key] > 0
