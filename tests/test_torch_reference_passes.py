"""The port's short runs of the reference's full-width passes, on the CPU,
held to the reference's committed results
(`tpuslam_torch/bench/data/reference_vga.npz`, written by
tests/torch_reference_poses.py from `tpuslam` on the CPU):

  * `orbit_fused`: the first 24 frames of the 240-frame 640×480 orbit
    through `scan_odometry` with `fused_gn=True` (a scan is causal: its
    first frames are those of the whole scan): promotion flags equal,
    poses within TOL_POSE, inlier fractions within TOL_INLIERS;
  * `loop_deferred`, `loop_fused_chunked`, `drift_off`, `drift_on`,
    `scale`, `pathology`: each pass as the port's runner drives it, over
    the first frames of its inputs (the file's `short_frames`), then
    `finalize`, held by `harness.hold_to_reference` at TOL_POSE: a stable
    pass keeps the reference's keyframes and closure pairs with every pose
    within TOL_POSE; a chaotic one stays within twice the reference's own
    spread, its ATE and counts inside the reference's.  The pathology pass
    alone is held at the reference's own rounding spread where that is
    above TOL_POSE (`pathology_rounding_spread`: the reference's poses
    when its degraded depth moves by 1-2 float32 ulps; see its test).

No JAX is imported here.  chip_smoke.py holds the card's full-width passes
to the same file.
"""

import json

import numpy as np
import pytest
import torch

from tests import torch_reference_poses as script
from tpuslam_torch.bench import harness
from tpuslam_torch.config import ICPConfig, SLAMConfig
from tpuslam_torch.data.synthetic import (
    loop_trajectory,
    orbit_trajectory,
    render_depth,
)
from tpuslam_torch.frontend import scan_odometry
from tpuslam_torch.slam import SlamSystem

torch.set_num_threads(1)

TOL_POSE = 1e-5
TOL_INLIERS = 1e-4
ORBIT_FRAMES = 24


@pytest.fixture(scope="module")
def ref():
    return harness.reference_results(str(script.OUT))


def short(ref, prefix: str) -> int:
    return json.loads(str(ref["short_frames"]))[prefix]


def loop_prefix(ref, frames: int):
    """K, ground truth and depth of the first `frames` frames of the
    file's 120-frame 640×480 loop, as the port renders each."""
    h, w = int(ref["height"]), int(ref["width"])
    K = harness._intrinsics(h, w)
    gt = loop_trajectory(int(ref["loop_frames"]),
                         cycles=int(ref["loop_cycles"]),
                         radius=0.35)[:frames]
    return K, gt, np.stack([render_depth(gt[i], K, h, w, seed=i)
                            for i in range(frames)]).astype(np.float32)


def test_port_fused_orbit_scan_matches_the_file(ref):
    h, w = int(ref["height"]), int(ref["width"])
    K = harness._intrinsics(h, w)
    gt = orbit_trajectory(int(ref["orbit_frames"]))[:ORBIT_FRAMES]
    depths = torch.as_tensor(np.stack(
        [render_depth(gt[i], K, h, w, seed=i)
         for i in range(ORBIT_FRAMES)]).astype(np.float32))
    cfg = SLAMConfig(height=h, width=w, icp=ICPConfig(fused_gn=True))
    assert cfg.to_json() == json.loads(str(ref["configs"]))["orbit_fused"]
    poses, promote, inliers = scan_odometry(depths, K, cfg.validate())
    want = {k: ref[f"orbit_fused_{k}"][:ORBIT_FRAMES]
            for k in ("poses", "promote", "inliers")}
    np.testing.assert_array_equal(promote.numpy(), want["promote"])
    err = float(np.abs(poses.numpy() - want["poses"]).max())
    print(f"fused: max pose error {err:.3e} over {ORBIT_FRAMES} frames")
    assert err <= TOL_POSE
    np.testing.assert_allclose(inliers.numpy(), want["inliers"],
                               atol=TOL_INLIERS)


@pytest.mark.parametrize("variant", ["deferred", "fused_chunked"])
def test_port_loop_pass_short_run_matches_the_file(ref, variant):
    prefix = f"loop_{variant}"
    frames = short(ref, prefix)
    K, gt, d = loop_prefix(ref, frames)
    cfg = harness.slam_bench_config(int(ref["height"]), int(ref["width"]),
                                    variant == "fused_chunked")
    _, slam = harness._slam_pass(
        K, cfg, torch.as_tensor(d), np.arange(frames) / 30.0,
        int(ref["chunk"]), chunk_sub=int(ref["chunk_sub"]),
        async_backend=variant == "deferred", chunk_mode="boundary")
    rep = harness.hold_to_reference(
        ref, f"{prefix}_short",
        harness.pass_result(slam, np.arange(frames) / 30.0, gt), TOL_POSE)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_port_drift_short_run_matches_the_file(ref, on):
    prefix = f"drift_{'on' if on else 'off'}"
    frames = short(ref, prefix)
    K, gt, d = loop_prefix(ref, frames)
    slam = SlamSystem(K, harness.drift_config(on), enable_loop_closure=True,
                      async_backend=True, chunk_mode="boundary",
                      chunk_sub=int(ref["chunk_sub"]), device="cpu")
    ts = np.arange(frames) / 30.0
    harness.drive_drifted(slam, torch.as_tensor(d), ts, 0, frames)
    slam.finalize()
    rep = harness.hold_to_reference(ref, f"{prefix}_short",
                                    harness.pass_result(slam, ts, gt),
                                    TOL_POSE)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]


def test_port_scale_short_run_matches_the_file(ref):
    """The first 200 frames of bench_scale's 2,000-frame 320×240 loop
    through bench_scale's system and chunking."""
    frames = short(ref, "scale")
    h, w = script.SCALE_HEIGHT, script.SCALE_WIDTH
    K = harness._intrinsics(h, w)
    gt = loop_trajectory(script.SCALE_FRAMES,
                         cycles=script.SCALE_CYCLES)[:frames]
    d = np.stack([render_depth(gt[i], K, h, w, seed=i)
                  for i in range(frames)]).astype(np.float32)
    ts = np.arange(frames) / 30.0
    slam = SlamSystem(K, harness.scale_config(h, w), enable_loop_closure=True,
                      chunk_mode="boundary", async_backend=True, chunk_sub=1,
                      device="cpu")
    harness._run_chunked(slam, torch.as_tensor(d), ts, script.SCALE_CHUNK)
    rep = harness.hold_to_reference(ref, "scale_short",
                                    harness.pass_result(slam, ts, gt),
                                    TOL_POSE)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]


def test_port_pathology_matches_the_file(ref):
    """bench_pathology's 60 degraded 640×480 frames through its system and
    chunking.  Held at the reference's rounding spread, not TOL_POSE: the
    port's posed transform rounds 1 ulp from XLA's in ~28% of points, on
    this depth that flips a few association rows (tests/test_torch_kernels
    .py::test_posed_association_on_degraded_depth_parts_only_by_the_
    transform), and the reference's own pass moves by up to
    `pathology_rounding_spread` when its depth moves by 1-2 ulps."""
    frames = short(ref, "pathology")
    h, w = int(ref["height"]), int(ref["width"])
    K, gt, d = harness.pathology_sequence(frames, h, w)
    ts = np.arange(frames) / 30.0
    slam = SlamSystem(K, SLAMConfig(height=h, width=w).validate(),
                      enable_loop_closure=True, chunk_mode="boundary",
                      async_backend=True, device="cpu")
    harness._run_chunked(slam, torch.as_tensor(d), ts, int(ref["chunk"]))
    tol = max(TOL_POSE,
              float(ref["pathology_short_rounding_spread"].max()))
    rep = harness.hold_to_reference(ref, "pathology_short",
                                    harness.pass_result(slam, ts, gt), tol)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]
    lost = [bool(s.get("lost")) for s in slam.odo.stats]
    assert lost == ref["pathology_short_lost"].tolist()


def test_hold_rule_stable_and_chaotic():
    """`hold_to_reference` on a made-up pass of 6 frames: a stable pass
    fails on any keyframe, closure, pose, flag or map BA difference, at its
    tolerance whatever its spread; a chaotic one only outside twice its
    spread (before map BA: twice that spread), its ATE limit, its spans,
    or twice the reference's reach in map BA's observations and cost."""
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(6, 4, 4))
    ref = {"p_poses": poses, "p_keyframes": np.asarray([0, 3]),
           "p_closures": np.asarray([[3, 0]]), "p_ate_rmse_m": 1e-3,
           "p_promote": np.asarray([1, 0, 0, 1, 0, 0], bool),
           "p_map_ba_num_obs": np.int64(500), "p_map_ba_cost": 2.0}
    got = {"poses": poses + 5e-6, "keyframes": [0, 3], "closures": [(3, 0)],
           "ate_rmse_m": 1e-3}
    assert not harness.hold_to_reference(ref, "p", got, 1e-5)["failures"]
    for change in ({"poses": poses + 2e-5}, {"keyframes": [0, 4]},
                   {"closures": []}, {"promote": ref["p_promote"][::-1]},
                   {"map_ba_num_obs": 501, "map_ba_cost": 2.0},
                   {"map_ba_num_obs": 500, "map_ba_cost": 2.001}):
        rep = harness.hold_to_reference(ref, "p", {**got, **change}, 1e-5)
        assert len(rep["failures"]) == 1, (change, rep["failures"])
    rep = harness.hold_to_reference(ref, "p", {**got, "poses": poses[:5]},
                                    1e-5)
    assert rep["failures"] and "DIFFER" not in harness.describe_hold(rep)
    # a stable pass whose own spread is above the tolerance: the tolerance
    spread = {**ref, "p_stable": np.bool_(True),
              "p_spread": np.asarray([0, 0, 4e-5, 0, 0, 0])}
    for err, n in ((9e-6, 0), (2e-5, 1)):
        rep = harness.hold_to_reference(
            spread, "p", {**got, "poses": poses + err}, 1e-5)
        assert rep["limit"] == 1e-5 and len(rep["failures"]) == n
    # its poses before map BA: within the tolerance too
    ba = {**got, "map_ba_num_obs": 500, "map_ba_cost": 2.0}
    ref["p_poses_before_ba"] = poses - 1.0
    for err, n in ((9e-6, 0), (2e-5, 1)):
        rep = harness.hold_to_reference(
            ref, "p", {**ba, "poses_before_ba": poses - 1.0 + err}, 1e-5)
        assert len(rep["failures"]) == n, rep["failures"]
    chaotic = {**ref, "p_stable": np.bool_(False),
               "p_spread": np.asarray([0, 0, 1e-3, 2e-3, 0, 0]),
               "p_ate_max_m": 2e-3, "p_span_keyframes": np.asarray([2, 3]),
               "p_span_closures": np.asarray([1, 2])}
    far = poses.copy()
    far[4] += 3.9e-3
    ok = {**got, "poses": far, "keyframes": [0, 2, 4], "ate_rmse_m": 2.9e-3,
          "closures": [(4, 0), (2, 0)]}
    rep = harness.hold_to_reference(chaotic, "p", ok, 1e-5)
    assert not rep["failures"] and rep["limit"] == 4e-3
    assert "DIFFER from keyframe 1" in harness.describe_hold(rep)
    for change in ({"poses": poses + 4.1e-3}, {"ate_rmse_m": 3.1e-3},
                   {"keyframes": [0]}, {"closures": []}):
        rep = harness.hold_to_reference(chaotic, "p", {**ok, **change}, 1e-5)
        assert len(rep["failures"]) == 1, (change, rep["failures"])
    # map BA in a chaotic pass: the reference's runs reach 480-510
    # observations (twice the reach: ±40) and costs 1.9-2.05 (±0.2) from its
    # unmoved 500 and 2.0; poses before BA twice their spread (2e-3)
    chaotic.update(p_span_map_ba_obs=np.asarray([480, 510]),
                   p_span_map_ba_cost=np.asarray([1.9, 2.05]),
                   p_spread_before_ba=np.asarray([0, 1e-3, 0, 0, 0, 0]))
    ok.update(map_ba_num_obs=460, map_ba_cost=2.19,
              poses_before_ba=poses - 1.0 + 1.9e-3)
    rep = harness.hold_to_reference(chaotic, "p", ok, 1e-5)
    assert not rep["failures"]
    assert rep["map_ba_limits"] == pytest.approx([40, 0.2])
    for change in ({"map_ba_num_obs": 459}, {"map_ba_num_obs": 541},
                   {"map_ba_cost": 2.21}, {"map_ba_cost": 1.79},
                   {"poses_before_ba": poses - 1.0 + 2.1e-3}):
        rep = harness.hold_to_reference(chaotic, "p", {**ok, **change}, 1e-5)
        assert len(rep["failures"]) == 1, (change, rep["failures"])
    assert "limits ±40" in harness.describe_hold(rep)


def test_hold_rule_closure_union():
    """Where the file keeps a pass's `closure_union` (the worker pass: the
    closure pairs of every timed run of the reference), a pair outside it
    fails the hold, stable or chaotic, and nothing else changes; the
    worker's hold also keeps its keyframes equal where the reference's
    were the same in every timed run (`keyframes_fixed`)."""
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(6, 4, 4))
    ref = {"p_poses": poses, "p_keyframes": np.asarray([0, 3]),
           "p_closures": np.asarray([[3, 0]]), "p_ate_rmse_m": 1e-3,
           "p_stable": np.bool_(False),
           "p_spread": np.asarray([0, 0, 1e-3, 0, 0, 0]),
           "p_ate_max_m": 2e-3, "p_span_keyframes": np.asarray([2, 3]),
           "p_span_closures": np.asarray([1, 2])}
    got = {"poses": poses + 1e-3, "keyframes": [0, 3],
           "closures": [(3, 0), (5, 1)], "ate_rmse_m": 1e-3}
    # without the key: counts in their spans hold, whatever the pairs
    rep = harness.hold_to_reference(ref, "p", got, 1e-5)
    assert not rep["failures"] and "closures_outside" not in rep
    ref["p_closure_union"] = np.asarray([[3, 0], [5, 1], [4, 0]])
    rep = harness.hold_to_reference(ref, "p", got, 1e-5)
    assert not rep["failures"] and rep["closures_outside"] == []
    assert "outside the reference's union none" in harness.describe_hold(rep)
    rep = harness.hold_to_reference(
        ref, "p", {**got, "closures": [(3, 0), (5, 2)]}, 1e-5)
    assert rep["closures_outside"] == [(5, 2)]
    assert len(rep["failures"]) == 1 and "(5, 2)" in rep["failures"][0]
    stable = {**ref, "p_stable": np.bool_(True)}
    rep = harness.hold_to_reference(
        stable, "p", {**got, "poses": poses, "closures": [(4, 1)]}, 1e-5)
    assert len(rep["failures"]) == 2       # the pairs differ; outside too
    # keyframes: inside the span unless every timed run had the same ones
    moved = {**got, "keyframes": [0, 2, 4]}
    assert not harness.hold_worker_to_reference(ref, "p", moved,
                                                1e-5)["failures"]
    ref["p_keyframes_fixed"] = np.bool_(True)
    rep = harness.hold_worker_to_reference(ref, "p", moved, 1e-5)
    assert len(rep["failures"]) == 1 and "keyframes" in rep["failures"][0]
    assert not harness.hold_worker_to_reference(ref, "p", got,
                                                1e-5)["failures"]
