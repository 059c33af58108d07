"""The port's frame-to-map tracking held to the reference's committed
results (`tpuslam_torch/bench/data/reference_vga.npz`, written by
tests/torch_reference_poses.py from `tpuslam` on the CPU), on the CPU:
`harness.run_map_bench` unsharded over the first frames of the 120-frame
640×480 two-lap loop (the file's `short_frames`), then `finalize`:

  * `map_projective`: `track_against_map=True` (the reverse projective
    association);
  * `map_grid`: `map_track_mode="grid"` with map BA at `finalize`.

Each is held by `harness.hold_to_reference` at TOL_POSE: a stable pass
keeps the reference's keyframes and closure pairs with every pose within
TOL_POSE (and, with map BA, its poses before it, its observation count and
its cost); a chaotic one (the reference's own poses move when its voxel
origin moves by 1e-4 m) stays within twice the reference's spread (before
map BA too), its ATE and counts inside the reference's, map BA's
observation count and cost within twice the reference's own reach.  The refinement gates and the map size are logged beside the
reference's.  No JAX is imported here; chip_smoke.py holds the card's
full-width passes to the same file.
"""

import json

import numpy as np
import pytest
import torch

from tests import torch_reference_poses as script
from tpuslam_torch.bench import harness
from tpuslam_torch.data.synthetic import loop_trajectory, render_depth

torch.set_num_threads(1)

TOL_POSE = 1e-5


@pytest.fixture(scope="module")
def ref():
    return harness.reference_results(str(script.OUT))


@pytest.mark.parametrize("mode", ["projective", "grid"])
def test_port_map_short_run_matches_the_file(ref, mode):
    prefix = f"map_{mode}_short"
    frames = json.loads(str(ref["short_frames"]))[f"map_{mode}"]
    h, w = int(ref["height"]), int(ref["width"])
    K = harness._intrinsics(h, w)
    gt = loop_trajectory(int(ref["loop_frames"]),
                         cycles=int(ref["loop_cycles"]),
                         radius=0.35)[:frames]
    d = np.stack([render_depth(gt[i], K, h, w, seed=i)
                  for i in range(frames)]).astype(np.float32)
    out: dict = {}
    grid = mode == "grid"
    r = harness.run_map_bench(frames, h, w, device="cpu", warmup=0,
                              sequence=(K, gt, d), map_track_mode=mode,
                              map_ba=grid, outputs=out)
    slam = out["slam"]
    got = harness.pass_result(slam, np.arange(frames) / 30.0, gt)
    if grid:
        got.update(poses_before_ba=out["before_ba"][1],
                   map_ba_num_obs=slam.map_ba_stats["num_obs"],
                   map_ba_cost=slam.map_ba_stats["cost"])
    rep = harness.hold_to_reference(ref, prefix, got, TOL_POSE)
    ok = [s["ok"] for s in slam.map_refine_stats]
    print(harness.describe_hold(rep))
    print(f"{prefix}: map size {r['map_size']} (the reference's "
          f"{int(ref[f'{prefix}_map_size'])}), refinement gates "
          f"{sum(ok)}/{len(ok)} ok ({int(ref[f'{prefix}_refine_ok'].sum())}"
          f"/{ref[f'{prefix}_refine_ok'].size})")
    assert not rep["failures"], rep["failures"]
    if rep["stable"]:
        assert ok == ref[f"{prefix}_refine_ok"].tolist()
