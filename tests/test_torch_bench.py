"""The port's `bench_scale` and `bench_pathology` (tpuslam_torch/bench/
harness.py) against the reference's (tpuslam/bench/harness.py) at cut
sizes, on CPU; `bench_slam`'s keys against the reference's (read from its
source: running its five JAX variants would compile each) and `run_bench`'s
nested `slam` and `loader`.

  * bench_scale: 64 frames of the five-lap loop at 120×160 (the recorded
    run: 2,000 at 320×240), chunks of 16 (32), BASELINE config 5 as is:
    every frame promotes at this speed, the graph doubles from 32 nodes,
    the cloud budget of 48 binds;
  * bench_pathology: 40 frames at 120×160 (60 at 640×480).

Keyframes, closures, lost frames and the graph's nodes and capacity must
be equal, and the ATEs within 1e-4 m of each other.
"""

import ast
import inspect
import math

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


def reference_bench_slam_keys() -> set:
    """The keys of the dict `tpuslam.bench.harness.bench_slam` returns."""
    tree = ast.parse(inspect.getsource(ref.bench_slam).lstrip())
    returns = [n for n in ast.walk(tree) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict)]
    return {k.value for k in returns[-1].value.keys}


SLAM_KEYS = {
    "slam_fps", "slam_fps_async", "async_gain", "slam_fps_chunked",
    "slam_fps_chunked_async", "slam_fps_chunked_inline", "slam_fps_reps",
    "upload_fps_equiv", "chunk", "slam_ate_rmse_m", "slam_chunked_ate_rmse_m",
    "slam_chunked_async_ate_rmse_m", "slam_chunked_inline_ate_rmse_m",
    "loop_closures", "loop_closures_chunked", "loop_closures_chunked_async",
    "loop_closures_chunked_inline", "keyframes", "keyframes_chunked",
    "frames"}
REPS = {"sync": 3, "async": 3, "chunked": 5, "chunked_async": 5,
        "chunked_inline": 3}


def check_bench_slam(r: dict, frames: int) -> None:
    assert set(r) == SLAM_KEYS | {"device"} and r["device"] == "cpu"
    assert {k: len(v) for k, v in r["slam_fps_reps"].items()} == REPS
    assert r["frames"] == frames and r["chunk"] == 8
    for k in SLAM_KEYS - {"slam_fps_reps", "chunk", "frames"}:
        assert math.isfinite(r[k]) and r[k] >= 0, k
    assert r["keyframes"] >= 1 and r["keyframes_chunked"] >= 1
    assert r["async_gain"] == pytest.approx(
        r["slam_fps_async"] / r["slam_fps"])


def test_bench_slam_has_the_reference_keys():
    assert reference_bench_slam_keys() == SLAM_KEYS
    check_bench_slam(port.bench_slam(frames=16, height=48, width=64,
                                     device="cpu"), 16)


def test_run_bench_nests_loader_and_slam():
    kw = dict(frames=3, height=48, width=64, device="cpu", warmup=0, reps=1)
    r = port.run_bench(**kw, slam_frames=8, loader_frames=4)
    check_bench_slam(r["slam"], 8)
    assert {"decode_fps", "cached_fps", "native", "decoder"} <= set(
        r["loader"])
    bare = port.run_bench(**kw, slam_frames=None, loader_frames=None)
    assert "slam" not in bare and "loader" not in bare
