"""The port's `bench_scale` and `bench_pathology` (tpuslam_torch/bench/
harness.py) against the reference's (tpuslam/bench/harness.py) at cut
sizes, on CPU.

  * bench_scale: 64 frames of the five-lap loop at 120×160 (the recorded
    run: 2,000 at 320×240), chunks of 16 (32), BASELINE config 5 as is:
    every frame promotes at this speed, the graph doubles from 32 nodes,
    the cloud budget of 48 binds;
  * bench_pathology: 40 frames at 120×160 (60 at 640×480).

Keyframes, closures, lost frames and the graph's nodes and capacity must
be equal, and the ATEs within 1e-4 m of each other.
"""

import pytest
import torch

from tpuslam.bench import harness as ref
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.bench import harness as port

torch.set_num_threads(1)

ATE_TOL = 1e-4


def test_bench_scale_matches_reference():
    kw = dict(frames=64, height=120, width=160, chunk=16)
    r = ref.bench_scale(**kw)
    p = port.bench_scale(**kw, device="cpu")
    for k in ("frames", "graph_nodes", "node_capacity", "keyframes",
              "retained_clouds", "loop_closures", "lost_frames"):
        assert p[k] == r[k], k
    assert p["node_capacity"] > 32 and p["retained_clouds"] == 48
    assert p["loop_closures"] >= 2 and p["lost_frames"] == 0
    assert abs(p["ate_rmse_m"] - r["ate_rmse_m"]) < ATE_TOL
    assert p["ate_rmse_m"] < 0.02 and p["poses_finite"]


def test_bench_pathology_matches_reference(monkeypatch):
    keyframes = []
    finalize = RSlam.finalize

    def counting(self):
        finalize(self)
        keyframes.append(len(self.odo.keyframes))

    monkeypatch.setattr(RSlam, "finalize", counting)
    r = ref.bench_pathology(frames=40, height=120, width=160)
    p = port.bench_pathology(frames=40, height=120, width=160, device="cpu")
    assert p["keyframes"] == keyframes[-1]
    for k in ("frames", "loop_closures", "lost_frames"):
        assert p[k] == r[k], k
    assert p["lost_frames"] == 0
    assert abs(p["ate_rmse_m"] - r["ate_rmse_m"]) < ATE_TOL
    assert p["ate_rmse_m"] < 0.04


def test_bench_loader_reports_decoder():
    p = port.bench_loader(height=48, width=64, frames=6)
    assert p["decode_fps"] > 0 and p["cached_fps"] > 0
    assert p["decoder"].split(" ")[0] in ("native", "cv2", "numpy")
    assert p["native"] == p["decoder"].startswith("native")
