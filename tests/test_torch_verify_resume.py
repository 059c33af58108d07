"""The port's SLAM system resumed with verification tables of two shapes
(tpuslam_torch/slam.py `_chain_attempt_fallback`) against the reference's.

A file written under `verify_level=2` after one chunk of the 48-frame
two-lap loop of tests/test_torch_slam.py, resumed by systems at
`verify_level=1`: the restored keyframes hold level-2 tables and the new
ones level-1 tables, so an attempt whose candidates span both verifies by
the grid probe.  The port must take the reference's keyframes and closure
pairs given the same file, its poses within 1e-4.
"""

import dataclasses

import numpy as np
import torch

from tests.test_torch_slam import CFG, CHUNK, FRAMES, H, K, W
from tests.test_torch_verify import counting
from tpuslam.data.synthetic import loop_trajectory, render_depth
from tpuslam.slam import SlamSystem as RSlam
from tpuslam.utils import checkpoint as rck
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.slam import SlamSystem as PSlam
from tpuslam_torch.utils import checkpoint as pck

torch.set_num_threads(1)

POSE_TOL = 1e-4


def test_slam_resumed_with_mixed_tables_matches_reference(tmp_path,
                                                          monkeypatch):
    """The grid attempt runs (`_chain_attempt_fallback`, counted) as often
    in the port as in the reference, with the same outcome."""
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES)]).astype(np.float32)
    ts = np.arange(FRAMES) / 30.0

    def at_level(v):
        return dataclasses.replace(CFG, keyframe=dataclasses.replace(
            CFG.keyframe, verify_level=v))

    cut = CHUNK
    writer = RSlam(K, at_level(2), enable_loop_closure=True,
                   chunk_mode="boundary")
    writer.process_chunk(depths[:cut], ts[:cut])
    path = str(tmp_path / "level2.npz")
    rck.save_checkpoint(path, writer, writer.odo.frame_idx)

    calls = {}
    counting(monkeypatch, RSlam, ("_chain_attempt_fallback",), calls)
    counting(monkeypatch, PSlam, ("_chain_attempt_fallback",), calls)
    pcfg = config_from_reference(at_level(1))

    def finish(slam, load):
        assert load(path, slam) == cut
        for i in range(cut, FRAMES, CHUNK):
            slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes],
                [(c.i, c.j) for c in slam.closures], slam.trajectory()[1])

    want = finish(RSlam(K, at_level(1), enable_loop_closure=True,
                        chunk_mode="boundary"), rck.load_checkpoint)
    n_ref = calls.pop("_chain_attempt_fallback", 0)
    got = finish(PSlam(PIntrinsics(*K), pcfg, enable_loop_closure=True,
                       chunk_mode="boundary", device="cpu"),
                 pck.load_checkpoint)
    assert n_ref >= 1 and calls["_chain_attempt_fallback"] == n_ref
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) >= 1
    np.testing.assert_allclose(got[2], want[2], atol=POSE_TOL)
