"""The port held to the reference's committed full-width results
(`tpuslam_torch/bench/data/reference_vga.npz`, written by
tests/torch_reference_poses.py from `tpuslam` on the CPU), on the CPU:

  * the file is current: its configs are today's `tpuslam` defaults as
    the script sets them, and every `tpuslam` file it ran has the blob
    hash it recorded (a stale file fails here);
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

import json

import numpy as np
import pytest
import torch

from tests import torch_reference_poses as script
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


def test_the_file_is_current(ref):
    assert script.OUT.stat().st_size < 1 << 20
    assert str(ref["orbit_config"]) == script.orbit_config().to_json()
    assert str(ref["loop_config"]) == script.loop_config().to_json()
    blobs = json.loads(str(ref["reference_blobs"]))
    assert "tpuslam/frontend.py" in blobs and "tpuslam/slam.py" in blobs
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
