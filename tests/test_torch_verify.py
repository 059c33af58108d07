"""The port's loop-closure verification API and its grid-hash fallbacks
(tpuslam_torch/backend/loopclosure.py `verify_closure`,
`propose_and_verify`, `find_closures`; backend/relocalize.py without
tables; slam.py `_chain_attempt_fallback`) against the reference's.

The grid cases run on the reference's own inputs (its keyframe records
carried across by interop), as tests/test_torch_grid.py holds
`align_clouds`: verified closures equal, T within 5e-5.  The setups are
the reference's: tests/test_verify_paths.py (14 frames, uniform tables,
then a corrupted table meta and no intrinsics) and tests/test_reloc.py
(keyframe 1's cloud seen from an offset pose).  The SLAM system's grid
attempt: tests/test_torch_verify_resume.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_slam import CFG as SLAM_CFG
from tests.test_slam import H, K, W, loop_trajectory
from tpuslam.data.synthetic import render_depth
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.backend.verify import ROW_SIZE
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.geom.cloud import PointCloud as PCloud
from tpuslam_torch.interop import (
    config_from_reference,
    keyframe_record_from_reference,
)

torch.set_num_threads(1)

PK = PIntrinsics(*K)
T_TOL = 5e-5            # align_clouds' tolerance (tests/test_torch_grid.py)
POSE_TOL = 1e-4


def port_records(records):
    return [keyframe_record_from_reference(r, "cpu") for r in records]


def assert_same_closures(got, want):
    assert [(c.i, c.j) for c in got] == [(c.i, c.j) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.T_ij, w.T_ij, atol=T_TOL)
        assert abs(g.rms - w.rms) < 1e-5
        assert abs(g.inlier_fraction - w.inlier_fraction) < 1e-3


@pytest.fixture(scope="module")
def keyframes():
    """tests/test_verify_paths.py's 14 frames through the reference."""
    n = 14
    gt = loop_trajectory(30)[:n]
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(n)])
    slam = RSlam(K, SLAM_CFG, enable_loop_closure=False)
    for i in range(n):
        slam.process(depths[i], timestamp=i / 30.0)
    kfs = list(slam.odo.keyframes)
    assert len(kfs) >= 4 and all(r.verify is not None for r in kfs)
    return kfs


def counting(monkeypatch, module, names, calls):
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("case", ["uniform", "corrupt-meta", "no-K"])
def test_find_closures_matches_reference(keyframes, monkeypatch, case):
    """Uniform tables take the projective batch; a table of another level,
    or no intrinsics, the grid batch — in both packages, with the same
    closures and attempted pairs."""
    import tpuslam.backend.loopclosure as rlc
    import tpuslam_torch.backend.loopclosure as plc

    r_kfs = list(keyframes)
    if case == "corrupt-meta":
        v = r_kfs[0].verify
        r_kfs[0] = r_kfs[0]._replace(verify=v._replace(level=v.level + 1))
    p_kfs = port_records(r_kfs)
    pg = dataclasses.replace(SLAM_CFG.posegraph, lc_min_gap=1,
                             lc_max_dist=2.0)
    ppg = config_from_reference(SLAM_CFG).posegraph
    ppg = dataclasses.replace(ppg, lc_min_gap=1, lc_max_dist=2.0)
    picp = config_from_reference(SLAM_CFG).icp
    poses = [r.T_world_kf.astype(np.float64) for r in r_kfs]
    r_calls, p_calls = {}, {}
    counting(monkeypatch, rlc, ("_verify_pairs_jit",
                                "_verify_projective_pairs_jit"), r_calls)
    counting(monkeypatch, plc, ("verify_batch_grid", "verify_batch"),
             p_calls)
    k_r, k_p = (None, None) if case == "no-K" else (K, PK)
    want, want_att = rlc.find_closures(r_kfs, poses, SLAM_CFG.icp, pg,
                                       K=k_r)
    got, got_att = plc.find_closures(p_kfs, poses, picp, ppg, K=k_p)
    grid = case != "uniform"
    assert r_calls == ({"_verify_pairs_jit": 1} if grid
                       else {"_verify_projective_pairs_jit": 1})
    assert p_calls == ({"verify_batch_grid": 1} if grid
                       else {"verify_batch": 1})
    assert got_att == want_att and len(got_att) >= 2
    assert len(want) >= 1
    assert_same_closures(got, want)


def test_propose_and_verify_reads_nothing_back(keyframes, monkeypatch):
    """`propose_and_verify` only issues the batch: no tensor is read back;
    its rows gate to `find_closures`' closures."""
    import tpuslam_torch.backend.loopclosure as plc

    p_kfs = port_records(keyframes)
    ppg = dataclasses.replace(config_from_reference(SLAM_CFG).posegraph,
                              lc_min_gap=1, lc_max_dist=2.0)
    picp = config_from_reference(SLAM_CFG).icp
    poses = [r.T_world_kf.astype(np.float64) for r in p_kfs]
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    live, rows, attempted = plc.propose_and_verify(p_kfs, poses, picp, ppg,
                                                   K=None)
    assert reads == [] and rows.shape == (4, ROW_SIZE)
    monkeypatch.undo()
    closures = plc.gate_rows(live, rows.numpy(), ppg)
    assert {(c.i, c.j) for c in closures} <= attempted
    again, _ = plc.find_closures(p_kfs, poses, picp, ppg, K=None)
    assert [(c.i, c.j) for c in again] == [(c.i, c.j) for c in closures]


def test_verify_closure_matches_reference(keyframes):
    """One pair through the grid verifier, from the graph's estimate and
    from a perturbed one: the same verdict, T within 5e-5."""
    from tpuslam.backend.loopclosure import verify_closure as r_verify
    from tpuslam_torch.backend.loopclosure import verify_closure as p_verify

    p_kfs = port_records(keyframes)
    picp = config_from_reference(SLAM_CFG).icp
    ppg = config_from_reference(SLAM_CFG).posegraph
    accepted = 0
    for i, j in ((0, 2), (1, 3), (0, len(keyframes) - 1)):
        T = (np.linalg.inv(keyframes[i].T_world_kf.astype(np.float64))
             @ keyframes[j].T_world_kf.astype(np.float64))
        for dx in (0.0, 0.03):
            T0 = T.copy()
            T0[0, 3] += dx
            want = r_verify(keyframes[i].cloud, keyframes[j].cloud, T0,
                            SLAM_CFG.icp, SLAM_CFG.posegraph)
            got = p_verify(p_kfs[i].cloud, p_kfs[j].cloud, T0, picp, ppg)
            assert (got is None) == (want is None), (i, j, dx)
            if want is not None:
                assert_same_closures([got], [want])
                accepted += 1
    assert accepted >= 2


def test_relocalize_without_tables_matches_reference():
    """tests/test_reloc.py's unit inputs with K=None (the grid fallback):
    the same keyframe, T within 5e-5."""
    import jax.numpy as jnp

    from tests.test_reloc import CFG, _sequence
    from tpuslam.backend.relocalize import relocalize as r_reloc
    from tpuslam.geom import se3
    from tpuslam_torch.backend.relocalize import relocalize as p_reloc

    _, depths = _sequence(20)
    slam = RSlam(K, CFG, enable_loop_closure=False)
    for i in range(20):
        slam.process(depths[i], timestamp=i / 30.0)
    kfs = slam.odo.keyframes
    tau = jnp.array([0.02, -0.015, 0.01, 0.01, -0.01, 0.008])
    T_cam_kf1 = se3.inv(se3.exp(tau))
    q = kfs[1].cloud.transform(se3.inv(np.asarray(T_cam_kf1)))
    T_last = kfs[1].T_world_kf.astype(np.float64) @ np.asarray(T_cam_kf1)
    want = r_reloc(q, kfs, T_last, CFG.icp, CFG.posegraph)
    pcfg = config_from_reference(CFG)
    got = p_reloc(PCloud(*(torch.as_tensor(np.array(a)) for a in q)),
                  port_records(kfs), T_last, pcfg.icp, pcfg.posegraph,
                  K=None)
    assert want is not None and got is not None
    assert got.kf_id == want.kf_id
    np.testing.assert_allclose(got.T_kf_cam, want.T_kf_cam, atol=T_TOL)
    assert abs(got.rms - want.rms) < 1e-5
