"""Pose-free loop closure in the port (tpuslam_torch/frontend.py
`depth_descriptor`, backend/loopclosure.py `propose_descriptor_candidates`
and the descriptor branch of `propose_attempt`) against the reference's,
on the drifted 48-frame loop of tests/test_descriptor_lc.py: 120×160,
boundary chunks of 8 and a 0.012 m world-anchor bias injected before
every chunk, with `lc_max_dist` 0.02 so that proximity proposal cannot
nominate the revisit.

The port must take the reference's keyframes and closure pairs with the
descriptor off (none) and on, its poses within 1e-4 of the reference's,
and with it on bring the ATE under half of the ATE with it off, as the
reference's own test asserts.  The deferred backend closes the pairs the
synchronous one closes.  A descriptor agrees with the reference's within
1e-6 relative; proposal over the same descriptors gives the same pairs in
the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_descriptor_lc import (
    BIAS_PER_CHUNK,
    CHUNK,
    FRAMES,
    H,
    K,
    W,
    _cfg,
)
from tpuslam.data.synthetic import loop_trajectory, render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.interop import (
    config_from_reference,
    keyframe_record_from_reference,
)
from tpuslam_torch.slam import SlamSystem as PSlam

torch.set_num_threads(1)

PK = PIntrinsics(*K)
POSE_TOL = 1e-4
TS = np.arange(FRAMES) / 30.0


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES)]).astype(np.float32)
    return gt, depths


def drive_drifted(slam, depths, lo=0, hi=FRAMES):
    """The reference test's loop: boundary chunks, the bias composed onto
    the live keyframe's world pose before every chunk but the first."""
    bias = np.eye(4, dtype=np.float32)
    bias[2, 3] = BIAS_PER_CHUNK
    for i in range(lo, hi, CHUNK):
        if i > 0:
            slam.odo.T_world_kf = bias @ slam.odo.T_world_kf.astype(
                np.float32)
        slam.process_chunk(depths[i:i + CHUNK], TS[i:i + CHUNK])
    return slam


def summary(slam, gt):
    ts, est = slam.trajectory()
    return {"kf": [r.index for r in slam.odo.keyframes],
            "closures": [(c.i, c.j) for c in slam.closures], "est": est,
            "ate": ate_rmse(ts, est, TS, gt, max_difference=0.005)["rmse"]}


def new_port(on: bool, deferred: bool = False):
    return PSlam(PK, config_from_reference(_cfg(on)),
                 enable_loop_closure=True, chunk_mode="boundary",
                 async_backend=deferred, device="cpu")


@pytest.fixture(scope="module")
def reference(loop):
    """The reference's drifted runs, descriptor off and on, and the
    records of the run with it on (before `finalize`)."""
    gt, depths = loop
    runs = {}
    for on in (False, True):
        slam = drive_drifted(RSlam(K, _cfg(on), enable_loop_closure=True,
                                   chunk_mode="boundary"), depths)
        if on:
            runs["records"] = list(slam.odo.keyframes)
        slam.finalize()
        runs[on] = summary(slam, gt)
    return runs


def test_depth_descriptor_matches_reference(loop):
    import jax.numpy as jnp

    from tpuslam import frontend as rf
    from tpuslam_torch import frontend as pf

    _, depths = loop
    cfg = _cfg(True)
    pcfg = config_from_reference(cfg)
    assert pf.DESC_GRID == rf.DESC_GRID
    for i in (0, 7, 12, 24, 41):
        r_pyr = rf.preprocess_jit(jnp.asarray(depths[i]), K, cfg)
        want = np.asarray(rf.depth_descriptor(r_pyr[-1].points,
                                              r_pyr[-1].mask))
        p_pyr = pf.preprocess(torch.as_tensor(depths[i]), PK, pcfg)
        got = pf.depth_descriptor(p_pyr[-1].points, p_pyr[-1].mask)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        # the bundle's descriptor is the same function of the same level
        *_, desc = pf.promote_bundle_jit(torch.as_tensor(depths[i]), PK,
                                         pcfg, True)
        assert torch.equal(desc, got)


def test_descriptor_proposal_matches_reference(reference):
    """The same records (the reference's descriptors carried across by
    interop): the same pairs in the same order, for several exclusion
    sets, gaps and candidate caps."""
    from tpuslam.backend.loopclosure import (
        propose_descriptor_candidates as r_prop,
    )
    from tpuslam_torch.backend.loopclosure import (
        propose_descriptor_candidates as p_prop,
    )

    r_recs = reference["records"]
    p_recs = [keyframe_record_from_reference(r, "cpu") for r in r_recs]
    assert all(isinstance(r.desc, np.ndarray) for r in p_recs)
    verifiable = np.ones(len(r_recs), bool)
    verifiable[1] = False
    pg = _cfg(True).posegraph
    ppg = config_from_reference(_cfg(True)).posegraph
    seen = 0
    for gap, cap, dmax in ((3, 2, pg.lc_desc_max_dist), (1, 8, 0.5),
                           (0, 64, 10.0)):
        r_pg = dataclasses.replace(pg, lc_min_gap=gap, lc_desc_max_dist=dmax)
        p_pg = dataclasses.replace(ppg, lc_min_gap=gap,
                                   lc_desc_max_dist=dmax)
        want = r_prop(r_recs, r_pg, set(), verifiable, cap)
        assert p_prop(p_recs, p_pg, set(), verifiable, cap) == want
        if want:
            excl = {want[0]}
            assert (p_prop(p_recs, p_pg, excl, verifiable, cap)
                    == r_prop(r_recs, r_pg, excl, verifiable, cap))
        seen += len(want)
    assert seen > 0


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_drifted_loop_matches_reference(loop, reference, on):
    gt, depths = loop
    slam = drive_drifted(new_port(on), depths)
    slam.finalize()
    got, want = summary(slam, gt), reference[on]
    assert got["kf"] == want["kf"]
    assert got["closures"] == want["closures"]
    np.testing.assert_allclose(got["est"], want["est"], atol=POSE_TOL)
    if on:
        assert len(got["closures"]) >= 1
        assert all(isinstance(r.desc, np.ndarray)
                   for r in slam.odo.keyframes if r.cloud is not None)
        assert got["ate"] < 0.5 * reference[False]["ate"], (
            got["ate"], reference[False]["ate"])
    else:
        assert got["closures"] == []
        assert all(r.desc is None for r in slam.odo.keyframes)


def test_deferred_backend_closes_the_same_pairs(loop, reference):
    """Descriptor candidates ride the attempt the deferred backend defers:
    the same closure pairs as the synchronous run (the reference's test
    holds its own runs to that), and the drift collapses."""
    gt, depths = loop
    slam = drive_drifted(new_port(True, deferred=True), depths)
    slam.finalize()
    got = summary(slam, gt)
    assert got["closures"] == reference[True]["closures"]
    assert got["ate"] < 0.02


def test_interop_carries_the_descriptor(reference):
    r_recs = reference["records"]
    assert any(r.desc is not None for r in r_recs)
    for r in r_recs:
        p = keyframe_record_from_reference(r, "cpu")
        if r.desc is None:
            assert p.desc is None
            continue
        assert isinstance(p.desc, np.ndarray) and p.desc.dtype == np.float32
        np.testing.assert_array_equal(p.desc, np.asarray(r.desc))


CUT = 24


@pytest.fixture(scope="module")
def files(loop, tmp_path_factory):
    """Snapshots with descriptors after CUT drifted frames, one by each
    package, and the reference continuing its own file (the yardstick)."""
    from tpuslam.utils import checkpoint as rck
    from tpuslam_torch.utils import checkpoint as pck

    gt, depths = loop
    d = tmp_path_factory.mktemp("desc_ckpt")
    paths = {"reference": str(d / "ref.npz"), "port": str(d / "port.npz")}
    r = drive_drifted(RSlam(K, _cfg(True), enable_loop_closure=True,
                            chunk_mode="boundary"), depths, 0, CUT)
    rck.save_checkpoint(paths["reference"], r, r.odo.frame_idx)
    p = drive_drifted(new_port(True), depths, 0, CUT)
    pck.save_checkpoint(paths["port"], p, p.odo.frame_idx)
    yard = RSlam(K, _cfg(True), enable_loop_closure=True,
                 chunk_mode="boundary")
    assert rck.load_checkpoint(paths["reference"], yard) == CUT
    drive_drifted(yard, depths, CUT).finalize()
    return paths, summary(yard, gt)


def test_descriptor_checkpoint_layout_matches_reference(files):
    """The same npz keys, dtypes and shapes in both packages' files, the
    descriptors among them, and the same descriptors within 1e-6."""
    paths, _ = files
    zr, zp = np.load(paths["reference"]), np.load(paths["port"])
    assert "kf_desc" in zp.files and "kf_desc_ids" in zp.files
    assert sorted(zr.files) == sorted(zp.files)
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype, k
        assert zr[k].shape == zp[k].shape, k
    assert zp["kf_desc"].dtype == np.float32
    assert zp["kf_desc"].shape[1] == 2 * 6 * 8
    np.testing.assert_array_equal(zp["kf_desc_ids"], zr["kf_desc_ids"])
    np.testing.assert_allclose(zp["kf_desc"], zr["kf_desc"], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_descriptor_checkpoint_resumes_across_packages(loop, files, writer,
                                                       reader):
    """A file of either package, descriptors in it, resumed by the other
    and driven on: the descriptors restored within 1e-6 of the file's, and
    the yardstick's keyframes and closure pairs, poses within 1e-4."""
    from tpuslam.utils import checkpoint as rck
    from tpuslam_torch.utils import checkpoint as pck

    gt, depths = loop
    paths, yard = files
    if reader == "port":
        slam, load = new_port(True), pck.load_checkpoint
    else:
        slam, load = (RSlam(K, _cfg(True), enable_loop_closure=True,
                            chunk_mode="boundary"), rck.load_checkpoint)
    assert load(paths[writer], slam) == CUT
    z = np.load(paths[writer])
    for r, k in enumerate(z["kf_desc_ids"]):
        desc = slam.odo.keyframes[int(k)].desc
        if reader == "port":
            assert isinstance(desc, np.ndarray)
        np.testing.assert_allclose(np.asarray(desc), z["kf_desc"][r],
                                   rtol=1e-6, atol=0)
    drive_drifted(slam, depths, CUT).finalize()
    got = summary(slam, gt)
    assert got["kf"] == yard["kf"]
    assert got["closures"] == yard["closures"] and got["closures"]
    np.testing.assert_allclose(got["est"], yard["est"], atol=POSE_TOL)
