"""The port's backend (tpuslam_torch/backend/, geom/voxel.py) against the
reference, started from identical state through tpuslam_torch.interop.

- `voxel_downsample`: identical masks; centroids and normals within 1e-6
  (the port sums each voxel in float64, the reference in float32).
- Pose-graph solvers (dense and block-CG) on the same graph: poses within
  2e-6, final cost within 1e-6 relative + 1e-9 (the port's edge Jacobians
  are closed-form, the reference's forward-mode).
- `propose_attempt`: identical candidate pairs and padding, initial
  guesses within 1e-6.
- `relocalize`, with `fused_gn` False and True: the same anchor keyframe,
  verified pose within 1e-4, inlier fraction within 1e-3, RMS within 1e-3
  relative.
- The fused loop-closure attempt (projective verification of the
  candidates + gates + pose-graph solve), with `fused_gn` False and True:
  identical convergence flags and gate decisions, verification poses
  within 1e-4, inlier fractions within 1e-3, RMS within 1e-3 relative,
  coverage within 1e-4, optimized poses within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.backend.loopclosure as rlc
import tpuslam.backend.posegraph as rpg
import tpuslam.backend.relocalize as rrl
import tpuslam.frontend as rf
import tpuslam_torch.backend.loopclosure as plc
import tpuslam_torch.backend.posegraph as ppg
import tpuslam_torch.backend.relocalize as prl
from tpuslam.backend.verify import passes_gates_traced as r_gates
from tpuslam.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam.data.synthetic import loop_trajectory, render_depth
from tpuslam.geom import se3 as rse3
from tpuslam.geom.cloud import PointCloud as RCloud
from tpuslam.geom.voxel import voxel_downsample as r_voxel
from tpuslam.icp import FlatICP
from tpuslam_torch.backend.verify import (
    COVERAGE_COL,
    min_eigenvalue_sym3,
    passes_gates_traced,
)
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.voxel import voxel_downsample as p_voxel
from tpuslam_torch.interop import (
    config_from_reference,
    keyframe_record_from_reference,
    pose_graph_from_reference,
)

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
PK = PIntrinsics(*K)
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
KF_FRAMES = (0, 6, 12, 18, 24, 30, 36)


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def twist(rng, scale):
    return np.asarray(rse3.exp(jnp.asarray(rng.normal(size=6) * scale,
                                           jnp.float32)), np.float64)


# ------------------------------------------------------------------- voxel

@pytest.mark.parametrize("case", ["frame", "overflow"])
def test_voxel_downsample_matches_reference(case):
    if case == "frame":
        gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
        pyr = rf.preprocess(jnp.asarray(render_depth(gt[5], K, H, W,
                                                     seed=5)), K, CFG)
        cloud = pyr[0].as_cloud()
        args = (0.02, 1 << 13, -20.0, 40.0)
    else:   # more occupied voxels than capacity: the overflow bin
        rng = np.random.default_rng(3)
        pts = rng.uniform(-1.0, 1.0, size=(4000, 3)).astype(np.float32)
        nrm = rng.normal(size=(4000, 3)).astype(np.float32)
        cloud = RCloud(jnp.asarray(pts), jnp.asarray(nrm),
                       jnp.asarray(rng.uniform(size=4000) < 0.8))
        args = (0.1, 512, -2.0, 4.0)
    r = r_voxel(cloud, *args)
    p = p_voxel(PointCloud(*(t(a) for a in cloud)), *args)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(r.mask))
    np.testing.assert_allclose(p.points.numpy(), np.asarray(r.points),
                               atol=1e-6)
    np.testing.assert_allclose(p.normals.numpy(), np.asarray(r.normals),
                               atol=1e-6)
    assert int(p.mask.sum()) > 100


# -------------------------------------------------------------- pose graph

def random_graph(n=12, seed=0):
    """A chain with one weighted loop edge, noisy initial poses (the
    reference's GraphHost builds it; the port gets it through interop)."""
    rng = np.random.default_rng(seed)
    gt = np.stack([twist(rng, 0.3) for _ in range(n)])
    cfg = PoseGraphConfig(max_nodes=16, max_edges=64, gn_iters=10)
    g = rpg.GraphHost(cfg)
    for k in range(n):
        g.add_node(gt[k] if k == 0 else twist(rng, 0.02) @ gt[k])
    for k in range(1, n):
        g.add_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k])
    g.add_edge(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1], weight=2.0)
    return g.graph(bucketed=True), cfg, gt


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_solvers_match_reference(solver):
    G, cfg, gt = random_graph()
    cfg = dataclasses.replace(cfg, solver=solver)
    rp, rc = rpg.optimize(G, cfg)
    pcfg = config_from_reference(SLAMConfig(posegraph=cfg)).posegraph
    pp, pc_ = ppg.optimize(pose_graph_from_reference(G, "cpu"), pcfg)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), atol=2e-6)
    assert abs(float(pc_) - float(rc)) <= 1e-6 * float(rc) + 1e-9
    np.testing.assert_allclose(pp.numpy()[:gt.shape[0]], gt, atol=1e-5)
    assert float(ppg.graph_cost(pose_graph_from_reference(G, "cpu"), pcfg)) \
        == pytest.approx(float(rpg.graph_cost(G, cfg)), rel=1e-5)


def test_min_eigenvalue_matches_lapack():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(64, 200, 3))
    n[:8, :, 2] *= 1e-3                       # near-planar coverage
    A = np.einsum("bki,bkj->bij", n, n) / 200.0
    np.testing.assert_allclose(min_eigenvalue_sym3(t(A)).numpy(),
                               np.linalg.eigvalsh(A)[:, 0], atol=1e-12)


# ------------------------------------------------------------ loop closure

@pytest.fixture(scope="module")
def keyframe_scene():
    """Reference keyframe records of a two-lap loop (frame 24 revisits
    frame 0) at slightly drifted poses, their port twins, and a
    reference graph of odometry edges."""
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    rng = np.random.default_rng(7)
    ref_recs, poses = [], []
    for n, f in enumerate(KF_FRAMES):
        d = jnp.asarray(render_depth(gt[f], K, H, W, seed=f))
        pyr, packed, cloud, _ = rf.promote_bundle_jit(d, K, CFG, False)
        lvl = CFG.keyframe.verify_level
        h, w, _ = pyr[lvl].points.shape
        T = gt[f] if n == 0 else twist(rng, 0.01) @ gt[f]
        poses.append(T)
        ref_recs.append(rf.KeyframeRecord(
            index=f, timestamp=f / 30.0, T_world_kf=T.astype(np.float32),
            cloud=cloud,
            verify=rf.VerifyTable(packed=packed[lvl], height=h, width=w,
                                  level=lvl)))
    g = rpg.GraphHost(CFG.posegraph)
    for n, T in enumerate(poses):
        g.add_node(T.astype(np.float32))
        if n:
            g.add_edge(n - 1, n, np.linalg.inv(gt[KF_FRAMES[n - 1]])
                       @ gt[KF_FRAMES[n]])
    port_recs = [keyframe_record_from_reference(r, "cpu") for r in ref_recs]
    return ref_recs, port_recs, g, [p.astype(np.float64) for p in poses]


def test_propose_attempt_matches_reference(keyframe_scene):
    ref_recs, port_recs, _, poses = keyframe_scene
    known = {(0, 4)}
    r = rlc.propose_attempt(ref_recs, poses, CFG.icp, CFG.posegraph,
                            exclude_pairs=known, K=K)
    p = plc.propose_attempt(port_recs, poses,
                            config_from_reference(CFG).icp,
                            config_from_reference(CFG).posegraph,
                            exclude_pairs=known, K=PK)
    assert [(i, j) for i, j, _ in p[0]] == [(i, j) for i, j, _ in r[0]]
    assert [(i, j) for i, j, _ in p[1]] == [(i, j) for i, j, _ in r[1]]
    assert p[2] == r[2] and len(p[0]) >= 2
    for (_, _, a), (_, _, b) in zip(p[1], r[1]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert (p[3].height, p[3].width, p[3].level) == (r[3].height, r[3].width,
                                                     r[3].level)


@pytest.mark.parametrize("fused_gn", [False, True], ids=["plain", "fused"])
def test_relocalize_matches_reference(keyframe_scene, fused_gn):
    """A frame of the second lap, lost at a drifted pose, re-anchors on
    the same keyframe at the same verified pose."""
    ref_recs, port_recs, _, _ = keyframe_scene
    cfg = dataclasses.replace(CFG, icp=dataclasses.replace(
        CFG.icp, fused_gn=fused_gn))
    pcfg = config_from_reference(cfg)
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    d = jnp.asarray(render_depth(gt[27], K, H, W, seed=27))
    _, _, cloud, _ = rf.promote_bundle_jit(d, K, CFG, False)
    T_last = twist(np.random.default_rng(9), 0.02) @ gt[27]
    r = rrl.relocalize(cloud, ref_recs, T_last, cfg.icp, cfg.posegraph, K=K)
    p = prl.relocalize(PointCloud(*(t(a) for a in cloud)), port_recs, T_last,
                       pcfg.icp, pcfg.posegraph, K=PK)
    assert r is not None and p is not None
    assert p.kf_id == r.kf_id
    np.testing.assert_allclose(p.T_kf_cam, r.T_kf_cam, atol=1e-4)
    assert p.inlier_fraction == pytest.approx(r.inlier_fraction, abs=1e-3)
    assert p.rms == pytest.approx(r.rms, rel=1e-3)


@pytest.mark.parametrize("fused_gn", [False, True], ids=["plain", "fused"])
def test_fused_attempt_matches_reference(keyframe_scene, fused_gn):
    ref_recs, port_recs, g, poses = keyframe_scene
    cfg = dataclasses.replace(CFG, icp=dataclasses.replace(
        CFG.icp, fused_gn=fused_gn))
    pcfg = config_from_reference(cfg)
    live, padded, _, v0 = rlc.propose_attempt(
        ref_recs, poses, cfg.icp, cfg.posegraph, K=K)
    G = g.graph(bucketed=True)
    b = len(padded)
    ci = np.asarray([i for i, _, _ in live] + [0] * (b - len(live)),
                    np.int32)
    cj = np.asarray([j for _, j, _ in live] + [0] * (b - len(live)),
                    np.int32)
    T_inits = np.stack([T for _, _, T in padded])
    K_lvl = K.scaled(1.0 / 2 ** v0.level)
    ref = np.asarray(rlc.fused_attempt_jit(
        tuple(ref_recs[i].verify.packed for i, _, _ in padded),
        tuple(ref_recs[j].cloud.points for _, j, _ in padded),
        tuple(ref_recs[j].cloud.normals for _, j, _ in padded),
        tuple(ref_recs[j].cloud.mask for _, j, _ in padded),
        K_lvl, jnp.asarray(T_inits), jnp.int32(len(live)), G,
        jnp.asarray(ci), jnp.asarray(cj), v0.height, v0.width, cfg.icp,
        cfg.posegraph, True, 2.0))
    ours = plc.fused_attempt_jit(
        [port_recs[i].verify.packed for i, _, _ in padded],
        [port_recs[j].cloud.points for _, j, _ in padded],
        [port_recs[j].cloud.normals for _, j, _ in padded],
        [port_recs[j].cloud.mask for _, j, _ in padded],
        PIntrinsics(*K_lvl), t(T_inits), len(live),
        pose_graph_from_reference(G, "cpu"), t(ci), t(cj), v0.height,
        v0.width, pcfg.icp, pcfg.posegraph, True, 2.0).numpy()
    n_rows = b * (FlatICP.SIZE + 1)
    rr, pr = ref[:n_rows].reshape(b, -1), ours[:n_rows].reshape(b, -1)
    np.testing.assert_array_equal(pr[:, FlatICP.CONVERGED],
                                  rr[:, FlatICP.CONVERGED])
    np.testing.assert_array_equal(
        passes_gates_traced(torch.as_tensor(pr), pcfg.posegraph).numpy(),
        np.asarray(r_gates(jnp.asarray(rr), cfg.posegraph)))
    np.testing.assert_allclose(pr[:, FlatICP.T], rr[:, FlatICP.T],
                               atol=1e-4)
    np.testing.assert_allclose(pr[:, FlatICP.INLIER_FRACTION],
                               rr[:, FlatICP.INLIER_FRACTION], atol=1e-3)
    np.testing.assert_allclose(pr[:, FlatICP.RMS], rr[:, FlatICP.RMS],
                               rtol=1e-3)
    np.testing.assert_allclose(pr[:, COVERAGE_COL], rr[:, COVERAGE_COL],
                               atol=1e-4)
    np.testing.assert_allclose(ours[n_rows:], ref[n_rows:], atol=1e-4)
    assert np.asarray(r_gates(jnp.asarray(rr), cfg.posegraph)).sum() >= 1
