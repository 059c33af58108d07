"""The port held to the reference's committed full-width results
(`tpuslam_torch/bench/data/reference_vga.npz`, written by
tests/torch_reference_poses.py from `tpuslam` on the CPU), on the CPU:

  * the file is current: its configs are today's `tpuslam` defaults as
    the script sets them, each pass's config is also the one the port's
    runner builds (`harness.drift_config`, `scale_config`, ...), the drift
    bias is the harness's, every pass has its keys (with its short run
    and, where measured, its spread), and every `tpuslam` file it ran has
    the blob hash it recorded (a stale file fails here);
  * the port's `scan_odometry` and `scan_odometry_boundary` (chunks of 8)
    over the first 24 frames of the 240-frame 640×480 orbit, rendered by
    the port,
    give the file's poses within TOL_POSE, its promotion flags exactly and
    its inlier fractions within TOL_INLIERS (a scan is causal: its first
    24 frames are those of the whole scan; the orbit promotes no
    keyframe at the defaults, so every flag is False in both);
  * the port's SLAM system on the CPU over the whole 120-frame 640×480
    loop, as `bench_slam`'s per-frame and boundary-chunk synchronous
    passes (`harness._slam_pass`, `slam_bench_config`), gives the file's
    keyframes and closure pairs exactly and its poses within TOL_POSE.

chip_smoke.py holds the card's whole orbit and the 120-frame loop to the
same file.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests import torch_reference_poses as script
from tpuslam_torch.bench import harness
from tpuslam_torch.bench.harness import (
    _intrinsics,
    _render_sequence,
    _slam_pass,
    slam_bench_config,
)
from tpuslam_torch.config import SLAMConfig
from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
from tpuslam_torch.frontend import scan_odometry, scan_odometry_boundary

torch.set_num_threads(1)

FRAMES = 24
TOL_POSE = 1e-5
TOL_INLIERS = 1e-4


@pytest.fixture(scope="module")
def ref():
    return np.load(script.OUT)


@pytest.fixture(scope="module")
def orbit(ref):
    """The first FRAMES frames of the file's orbit, as the port's
    `_render_sequence` renders each (the orbit's poses depend on its
    length)."""
    K = _intrinsics(script.HEIGHT, script.WIDTH)
    gt = orbit_trajectory(int(ref["orbit_frames"]))[:FRAMES]
    depths = np.stack([render_depth(gt[i], K, script.HEIGHT, script.WIDTH,
                                    seed=i) for i in range(FRAMES)])
    return K, torch.as_tensor(depths.astype(np.float32))


def port_configs() -> dict:
    """The port's config of each pass the file keeps, by the writer's
    name (`script.configs`)."""
    h, w = script.HEIGHT, script.WIDTH
    orbit = SLAMConfig(height=h, width=w)
    return {"orbit": orbit, "orbit_fused": orbit.replace(
                icp=dataclasses.replace(orbit.icp, fused_gn=True)),
            "loop": slam_bench_config(h, w, False),
            "loop_fused": slam_bench_config(h, w, True),
            "cli": slam_bench_config(h, w, False),
            "drift_off": harness.drift_config(False),
            "drift_on": harness.drift_config(True),
            "scale": harness.scale_config(script.SCALE_HEIGHT,
                                          script.SCALE_WIDTH),
            "pathology": SLAMConfig(height=h, width=w)}


PASSES = ("orbit_classic", "orbit_boundary", "orbit_fused",
          "loop_per_frame", "loop_chunked", "loop_deferred",
          "loop_fused_chunked", "loop_fused_deferred", "loop_chunked_inline",
          "loop_worker", "cli_slam", "cli_odometry", "drift_off", "drift_on",
          "map_projective", "map_grid", "map_sharded", "scale", "pathology")


def test_the_file_is_current(ref):
    assert script.OUT.stat().st_size < 1 << 20
    assert str(ref["orbit_config"]) == script.orbit_config().to_json()
    assert str(ref["loop_config"]) == script.loop_config().to_json()
    # every pass's config: the file's, the writer's and the port's runner's
    configs = json.loads(str(ref["configs"]))
    port = port_configs()
    assert set(configs) == set(port)
    for name, cfg in script.configs().items():
        assert configs[name] == cfg.to_json(), name
        assert port[name].to_json() == cfg.to_json(), name
    # the drift helpers: the writer's copy and the harness's
    assert float(ref["drift_per_chunk"]) == script.DRIFT_PER_CHUNK == (
        harness.DRIFT_PER_CHUNK)
    assert json.loads(str(ref["short_frames"])) == script.SHORT
    assert ref["spread_deltas"].tolist() == list(script.SPREAD_DELTAS)
    for p in PASSES:
        for k in ("poses", "keyframes", "closures", "ate_rmse_m", "seconds"):
            assert f"{p}_{k}" in ref, f"{p}_{k}"
        if p in script.SHORT:
            n = script.SHORT[p]
            assert ref[f"{p}_short_poses"].shape == (n, 4, 4), p
    for q in ("pathology", "pathology_short"):
        assert ref[f"{q}_rounding_spread"].shape == (
            script.PATHOLOGY_FRAMES,) and f"{q}_stable" not in ref
    for q in ("map_grid", "map_grid_short"):
        assert ref[f"{q}_spread_before_ba"].shape == ref[f"{q}_spread"].shape
        for span, k in (("obs", "num_obs"), ("cost", "cost")):
            lo, hi = ref[f"{q}_span_map_ba_{span}"]
            assert lo <= ref[f"{q}_map_ba_{k}"] <= hi, (q, k)
    for q in script.SPREAD_RUNS:
        assert ref[f"{q}_spread"].shape == ref[f"{q}_poses"].shape[:1]
        if ref[f"{q}_stable"]:     # a stable pass: one count each
            assert ref[f"{q}_spread"].max() <= script.STABLE_SPREAD
            for k in ("keyframes", "closures"):
                lo, hi = ref[f"{q}_span_{k}"]
                assert lo == hi == len(ref[f"{q}_{k}"]), (q, k)
    # the worker pass: its spread over the worker's timing, the closure
    # pairs of every timed run, whether their keyframes were the same
    for q in ("loop_worker", "loop_worker_short"):
        union = {tuple(c) for c in ref[f"{q}_closure_union"].tolist()}
        assert {tuple(c) for c in ref[f"{q}_closures"].tolist()} <= union
        assert ref[f"{q}_span_closures"][1] <= len(union)
        assert ref[f"{q}_keyframes_fixed"].dtype == bool
    assert ref["loop_worker_short_closures"].shape[0] >= 1
    # the CLI passes read the loop written by the reference's writer
    assert ref["cli_slam_depth_sha256"].shape == (script.LOOP_FRAMES,)
    assert ref["pathology_ulps"].tolist() == list(script.PATHOLOGY_ULPS)
    assert ref["map_grid_poses_before_ba"].shape == (script.LOOP_FRAMES, 4,
                                                     4)
    assert ref["scale_poses"].shape == (script.SCALE_FRAMES, 4, 4)
    blobs = json.loads(str(ref["reference_blobs"]))
    for f in ("frontend", "slam", "mapping", "backend/map_ba",
              "backend/loopclosure"):
        assert f"tpuslam/{f}.py" in blobs, f
    for path, blob in blobs.items():
        assert script.blob_hash(script.ROOT / path) == blob, path
    assert (int(ref["height"]), int(ref["width"])) == (480, 640)
    assert ref["orbit_classic_poses"].shape == (int(ref["orbit_frames"]),
                                                4, 4)
    assert ref["loop_per_frame_poses"].shape == (int(ref["loop_frames"]),
                                                 4, 4)
    # the port's own config of the same JSON reads back to it
    assert SLAMConfig.from_json(str(ref["orbit_config"])).to_json() == str(
        ref["orbit_config"])


@pytest.mark.parametrize("scan", ["classic", "boundary"])
def test_port_orbit_scan_matches_the_file(ref, orbit, scan):
    K, depths = orbit
    cfg = SLAMConfig.from_json(str(ref["orbit_config"])).validate()
    if scan == "classic":
        poses, promote, inliers = scan_odometry(depths, K, cfg)
    else:
        poses, promote, inliers = scan_odometry_boundary(
            depths, K, cfg, int(ref["chunk"]))
    want = {k: ref[f"orbit_{scan}_{k}"][:FRAMES]
            for k in ("poses", "promote", "inliers")}
    np.testing.assert_array_equal(promote.numpy(), want["promote"])
    err = float(np.abs(poses.numpy() - want["poses"]).max())
    print(f"{scan}: max pose error {err:.3e} over {FRAMES} frames")
    assert err <= TOL_POSE
    np.testing.assert_allclose(inliers.numpy(), want["inliers"],
                               atol=TOL_INLIERS)


@pytest.mark.parametrize("variant", ["per_frame", "chunked"])
def test_port_loop_pass_matches_the_file(ref, variant):
    cfg = slam_bench_config(script.HEIGHT, script.WIDTH, False)
    assert cfg.to_json() == SLAMConfig.from_json(
        str(ref["loop_config"])).to_json()
    frames = int(ref["loop_frames"])
    K, _gt, depths = _render_sequence(frames, script.HEIGHT, script.WIDTH,
                                      loop_cycles=int(ref["loop_cycles"]))
    system = {"async_backend": False}
    if variant == "chunked":
        system["chunk_mode"] = "boundary"
    _, slam = _slam_pass(K, cfg, torch.as_tensor(depths),
                         np.arange(frames) / 30.0,
                         int(ref["chunk"]) if variant == "chunked" else 0,
                         chunk_sub=int(ref["chunk_sub"]), **system)
    assert [k.index for k in slam.odo.keyframes] == ref[
        f"loop_{variant}_keyframes"].tolist()
    closures = [[c.i, c.j] for c in slam.closures]
    assert closures == ref[f"loop_{variant}_closures"].tolist()
    assert len(closures) >= 1
    err = float(np.abs(slam.trajectory()[1]
                       - ref[f"loop_{variant}_poses"]).max())
    print(f"{variant}: max pose error {err:.3e} over {frames} frames, "
          f"{len(closures)} closures")
    assert err <= TOL_POSE
