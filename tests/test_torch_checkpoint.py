"""The port's checkpoint / resume (tpuslam_torch/utils/checkpoint.py)
against the reference's (tpuslam/utils/checkpoint.py): the npz format is
shared, so a file written by either package resumes in the other.

On the 48-frame two-lap loop of tests/test_torch_slam.py (boundary chunks
of 8, the deferred backend, loop closure on), a snapshot after 24 frames
is continued for 24 more: by the reference from its own file (the
yardstick), by the port from the reference's file, and by both packages
from the port's file.  Poses must stay within 1e-4 of the yardstick, with
the same keyframes and closure pairs.  Also: odometry resume within 1e-5
of the uninterrupted run (tests/test_checkpoint.py), the map re-fused on
load, and the port's fix of the reference's stale deferred attempt.
"""

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
from tpuslam.data.synthetic import loop_trajectory, orbit_trajectory, render_depth
from tpuslam.slam import SlamSystem as RSlam
from tpuslam.utils import checkpoint as rck
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.frontend import Odometry as POdometry
from tpuslam_torch.icp import pack_pyramid
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.slam import SlamSystem as PSlam
from tpuslam_torch.utils import checkpoint as pck

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
PCFG = config_from_reference(CFG)
FRAMES, CUT, CHUNK = 48, 24, 8
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    return np.stack([render_depth(gt[i], K, H, W, seed=i)
                     for i in range(FRAMES)]).astype(np.float32)


def new_ref():
    return RSlam(K, CFG, enable_loop_closure=True, chunk_mode="boundary",
                 async_backend=True)


def new_port():
    return PSlam(PK, PCFG, enable_loop_closure=True, chunk_mode="boundary",
                 async_backend=True, device="cpu")


def run(slam, depths, lo, hi):
    ts = np.arange(FRAMES) / 30.0
    for i in range(lo, hi, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    return slam


def finish(slam, depths):
    run(slam, depths, CUT, FRAMES).finalize()
    _, est = slam.trajectory()
    return ([r.index for r in slam.odo.keyframes],
            [(c.i, c.j) for c in slam.closures], est)


@pytest.fixture(scope="module")
def files(loop, tmp_path_factory):
    """Snapshots after CUT frames by each package, and the reference
    continuing its own."""
    d = tmp_path_factory.mktemp("ckpt")
    ref_path, port_path = str(d / "ref.npz"), str(d / "port.npz")
    r = run(new_ref(), loop, 0, CUT)
    rck.save_checkpoint(ref_path, r, r.odo.frame_idx)
    p = run(new_port(), loop, 0, CUT)
    pck.save_checkpoint(port_path, p, p.odo.frame_idx)
    yard = new_ref()
    assert rck.load_checkpoint(ref_path, yard) == CUT
    return ref_path, port_path, finish(yard, loop)


def assert_matches(got, want):
    kf, closures, est = got
    assert kf == want[0]
    assert closures == want[1]
    np.testing.assert_allclose(est, want[2], atol=POSE_TOL)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "port"),
                                           ("port", "reference")])
def test_checkpoint_resumes_across_packages(loop, files, writer, reader):
    ref_path, port_path, yardstick = files
    slam = new_port() if reader == "port" else new_ref()
    load = pck.load_checkpoint if reader == "port" else rck.load_checkpoint
    assert load(ref_path if writer == "reference" else port_path, slam) == CUT
    assert slam.graph.num_nodes == len(slam.odo.keyframes) >= 3
    assert sum(r.verify is not None for r in slam.odo.keyframes) >= 3
    got = finish(slam, loop)
    assert len(got[1]) >= 1
    assert_matches(got, yardstick)


def test_checkpoint_arrays_match_reference_layout(files):
    """Same keys, dtypes and shapes in both packages' files."""
    ref_path, port_path, _ = files
    zr, zp = np.load(ref_path), np.load(port_path)
    assert sorted(zr.files) == sorted(zp.files)
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype, k
        assert zr[k].shape == zp[k].shape, k
    assert zp["kf_verify_packed"].dtype == np.float16
    assert int(zp["version"]) == 2


def _render_orbit(n):
    poses = orbit_trajectory(n)
    return np.stack([render_depth(poses[i], K, H, W, seed=i)
                     for i in range(n)])


def test_odometry_checkpoint_resume_identical(tmp_path):
    """tests/test_checkpoint.py's crash-after-frame-5 recovery, in the
    port: the resumed run reproduces the uninterrupted one."""
    cfg = PCFG.replace(keyframe=KeyframeConfig(max_translation=0.10,
                                               max_rotation=0.15))
    depths = _render_orbit(10)
    path = str(tmp_path / "ckpt.npz")
    ref = POdometry(PK, cfg, device="cpu")
    for i in range(10):
        ref.process(depths[i], timestamp=i / 30.0)
    a = POdometry(PK, cfg, device="cpu")
    for i in range(5):
        a.process(depths[i], timestamp=i / 30.0)
    pck.save_checkpoint(path, a, a.frame_idx)
    b = POdometry(PK, cfg, device="cpu")
    assert pck.load_checkpoint(path, b) == 5
    # the row-gather tables are rebuilt from the restored pyramid on load
    assert all(torch.equal(x, y) for x, y in
               zip(b.kf_packed, pack_pyramid(b.kf_pyr, cfg.icp)))
    for i in range(5, 10):
        b.process(depths[i], timestamp=i / 30.0)
    np.testing.assert_allclose(np.stack(b.trajectory), np.stack(ref.trajectory),
                               atol=1e-5)
    assert len(b.keyframes) == len(ref.keyframes)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_resume_rebuilds_voxel_map(tmp_path, sharded):
    depths = _render_orbit(10)
    cfg = PCFG.replace(keyframe=KeyframeConfig(max_translation=0.02,
                                               max_rotation=0.05))
    path = str(tmp_path / "map.npz")

    def new():
        return PSlam(PK, cfg, enable_loop_closure=False, enable_map=True,
                     sharded_map=sharded, device="cpu")

    s1 = new()
    for i in range(10):
        s1.process(depths[i], timestamp=i / 30.0)
    n_ins = len(s1.odo.keyframes)
    assert n_ins >= 2
    pck.save_checkpoint(path, s1, s1.odo.frame_idx)
    s2 = new()
    pck.load_checkpoint(path, s2)
    assert s2.map.size() == s1.map.size() > 0
    np.testing.assert_allclose(np.sort(s2.map.points(), axis=0),
                               np.sort(s1.map.points(), axis=0), atol=1e-6)
    if not sharded:
        assert s2.map.num_insertions == s1.map.num_insertions == n_ins


def test_load_drops_a_pending_attempt(loop, files, monkeypatch):
    """A live system holding a deferred attempt, restored from a file: the
    attempt is dropped and never drained (the reference keeps it pending,
    to apply at its next chunk), and the run takes a fresh resume's
    keyframes."""
    _, port_path, _ = files
    live = run(new_port(), loop, 0, 40)
    stale = live._pending_attempt
    assert stale is not None
    drained = []
    drain = PSlam._drain_closure_attempt

    def recording(self, p, flat=None):
        drained.append(p)
        return drain(self, p, flat)

    monkeypatch.setattr(PSlam, "_drain_closure_attempt", recording)
    pck.load_checkpoint(port_path, live)
    assert live._pending_attempt is None
    fresh = new_port()
    pck.load_checkpoint(port_path, fresh)
    a, b = finish(live, loop), finish(fresh, loop)
    assert drained and all(p is not stale for p in drained)
    assert a[0] == b[0]
    r_live = run(new_ref(), loop, 0, 40)
    rck.load_checkpoint(port_path, r_live)
    assert r_live._pending_attempt is not None     # the reference's fault


def test_v1_layout_and_descriptors(tmp_path, files):
    """A v1 file (a dense cloud stack without ids) loads; keyframe
    descriptors in a file load onto their records as float32 host arrays
    and are written back as they were read."""
    _, port_path, _ = files
    z = dict(np.load(port_path))
    n_kf = len(z["kf_indices"])
    keep = z["kf_cloud_ids"]
    slam = new_port()
    pck.load_checkpoint(port_path, slam)
    want = [r.cloud for r in slam.odo.keyframes]
    v1 = {k: v for k, v in z.items() if k != "kf_cloud_ids"}
    v1["version"] = np.asarray(1)
    if len(keep) != n_kf:                 # v1 held every keyframe's cloud
        pytest.skip("sparsified file has no v1 equivalent")
    np.savez(str(tmp_path / "v1.npz"), **v1)
    s1 = new_port()
    pck.load_checkpoint(str(tmp_path / "v1.npz"), s1)
    for a, b in zip(s1.odo.keyframes, want):
        assert all(torch.equal(x, y) for x, y in zip(a.cloud, b))
    ids = np.arange(0, n_kf, 2, dtype=np.int32)
    rows = np.random.default_rng(0).random((len(ids), 2 * 6 * 8),
                                           dtype=np.float32)
    z["kf_desc_ids"], z["kf_desc"] = ids, rows
    np.savez(str(tmp_path / "desc.npz"), **z)
    s2 = new_port()
    pck.load_checkpoint(str(tmp_path / "desc.npz"), s2)
    for k, rec in enumerate(s2.odo.keyframes):
        if k % 2:
            assert rec.desc is None
        else:
            assert isinstance(rec.desc, np.ndarray)
            np.testing.assert_array_equal(rec.desc, rows[k // 2])
    pck.save_checkpoint(str(tmp_path / "again.npz"), s2, s2.odo.frame_idx)
    z2 = np.load(str(tmp_path / "again.npz"))
    np.testing.assert_array_equal(z2["kf_desc_ids"], ids)
    np.testing.assert_array_equal(z2["kf_desc"], rows)
    assert z2["kf_desc"].dtype == np.float32
