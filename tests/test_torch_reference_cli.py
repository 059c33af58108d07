"""The port's short runs of the reference's last full-width passes, on the
CPU, held to the reference's committed results
(`tpuslam_torch/bench/data/reference_vga.npz`, written by
tests/torch_reference_poses.py from `tpuslam` on the CPU):

  * `loop_chunked_inline`, `loop_fused_deferred`, `loop_worker`:
    `bench_slam`'s inline-chunk variant, `run_slam_bench(fused_gn=True)`'s
    deferred pass and `bench_slam`'s per-frame pass with the worker thread,
    each as the port's runner drives it (`harness._slam_pass`) over the
    first frames of the 120-frame 640×480 loop (the file's
    `short_frames`; the worker's: the shortest prefix on which the
    reference's undelayed run closes a loop), then `finalize`, held by
    `harness.hold_to_reference` at TOL_POSE (the worker by
    `hold_worker_to_reference`: its spread is over the worker's timing,
    and its closure pairs must be in the reference's union);
  * `cli_slam`, `cli_odometry`: the port's own CLI (`run_slam --chunk 8
    --chunk-sub 4 --async-backend --upload-raw`, `run_odometry`, both with
    `--device cpu --stop N`) on the first N frames of that loop written to
    disk by the port's `write_tum_sequence`, held the same way (the poses
    caught where the CLI writes its trajectory; odometry also at
    TOL_POSE), after the sequence's decoded depth is checked against the
    sha256 of each PNG the reference's writer made.

No JAX is imported here.  chip_smoke.py holds the card's full-width passes
to the same file (phases 9, 13 and 17b).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from tests import torch_reference_poses as script
from tpuslam_torch import cli
from tpuslam_torch.bench import harness
from tpuslam_torch.data import tum
from tpuslam_torch.data.synthetic import (
    loop_trajectory,
    render_depth,
    write_tum_sequence,
)

torch.set_num_threads(1)

TOL_POSE = 1e-5


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


# name: (fused_gn, chunk, the SlamSystem's options) as the port's runners
# give them (bench_slam, run_slam_bench)
PASSES = {"chunked_inline": (False, 8, {"async_backend": False,
                                        "chunk_mode": "inline"}),
          "fused_deferred": (True, 8, {"async_backend": True,
                                       "chunk_mode": "boundary"}),
          "worker": (False, 0, {"async_backend": True})}


@pytest.mark.parametrize("variant", list(PASSES))
def test_port_loop_pass_short_run_matches_the_file(ref, variant):
    prefix = f"loop_{variant}_short"
    frames = short(ref, f"loop_{variant}")
    fused, chunk, system = PASSES[variant]
    K, gt, d = loop_prefix(ref, frames)
    cfg = harness.slam_bench_config(int(ref["height"]), int(ref["width"]),
                                    fused)
    assert cfg.to_json() == json.loads(str(ref["configs"]))[
        "loop_fused" if fused else "loop"]
    ts = np.arange(frames) / 30.0
    _, slam = harness._slam_pass(K, cfg, torch.as_tensor(d), ts, chunk,
                                 chunk_sub=int(ref["chunk_sub"]), **system)
    hold = (harness.hold_worker_to_reference if variant == "worker"
            else harness.hold_to_reference)
    rep = hold(ref, prefix, harness.pass_result(slam, ts, gt), TOL_POSE)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]
    if variant == "worker":
        # the reference's undelayed run closes a loop on this prefix
        assert ref[f"{prefix}_closures"].shape[0] >= 1
        assert "closures_outside" in rep


@pytest.fixture(scope="module")
def sequence(ref, tmp_path_factory):
    """The first N frames of the loop (N: the CLI passes' short runs)
    written by the port's writer in TUM's layout, and the CLI's config."""
    frames = short(ref, "cli_slam")
    assert short(ref, "cli_odometry") == frames
    root = tmp_path_factory.mktemp("cli")
    seq, cfg = str(root / "seq"), str(root / "cfg.json")
    h, w = int(ref["height"]), int(ref["width"])
    write_tum_sequence(seq, frames, harness._intrinsics(h, w), h, w,
                       poses=loop_trajectory(int(ref["loop_frames"]),
                                             cycles=int(ref["loop_cycles"]),
                                             radius=0.35)[:frames])
    with open(cfg, "w") as f:
        f.write(harness.slam_bench_config(h, w, False).to_json())
    return seq, cfg, frames


def test_port_sequence_decodes_to_the_files_depth(ref, sequence):
    """The port's writer made the input the reference's CLI read: each
    decoded depth PNG (uint16 counts) has the sha256 the file keeps."""
    seq, _, frames = sequence
    got = [hashlib.sha256(np.ascontiguousarray(f.depth, "<u2").tobytes())
           .hexdigest()
           for f in tum.TumSequence(seq).frames(stop=frames, raw=True)]
    assert got == ref["cli_slam_depth_sha256"][:frames].tolist()


@pytest.mark.parametrize("command", ["run_slam", "run_odometry"])
def test_port_cli_short_run_matches_the_file(ref, sequence, command,
                                             monkeypatch, capsys):
    from tpuslam_torch import frontend, slam

    seq, cfg, frames = sequence
    assert json.loads(str(ref["configs"]))["cli"] == open(cfg).read()
    made, written = [], {}

    def kept(cls):
        class Kept(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)
        return Kept

    write_trajectory = tum.write_trajectory

    def capture(path, ts, poses):
        written["poses"] = np.array(poses)
        write_trajectory(path, ts, poses)

    monkeypatch.setattr(slam, "SlamSystem", kept(slam.SlamSystem))
    monkeypatch.setattr(frontend, "Odometry", kept(frontend.Odometry))
    monkeypatch.setattr(tum, "write_trajectory", capture)
    flags = (["--chunk", str(int(ref["chunk"])), "--chunk-sub",
              str(int(ref["chunk_sub"])), "--async-backend", "--upload-raw"]
             if command == "run_slam" else [])
    assert cli.main([command, "--sequence", seq, "--config", cfg, *flags,
                     "--stop", str(frames), "--device", "cpu", "--traj-out",
                     f"{seq}/traj.txt"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    system = made[-1]
    odo = system.odo if command == "run_slam" else system
    got = {"poses": written["poses"],
           "keyframes": [k.index for k in odo.keyframes],
           "closures": [(c.i, c.j) for c in getattr(system, "closures", [])],
           "ate_rmse_m": summary["ate_rmse_m"]}
    prefix = ("cli_slam" if command == "run_slam" else "cli_odometry"
              ) + "_short"
    rep = harness.hold_to_reference(ref, prefix, got, TOL_POSE)
    print(harness.describe_hold(rep))
    assert not rep["failures"], rep["failures"]
    assert summary["frames"] == frames
    assert [bool(s.get("lost")) for s in odo.stats] == ref[
        f"{prefix}_lost"].tolist()
