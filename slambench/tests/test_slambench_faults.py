"""`correct` is decided by the comparison with the plain reference: a
sound run reads true, and a run whose timed path is broken underneath
reads false.  The faults a cell can have: a step that returns its state
unchanged, half of a hand-over's frames left out, an answer altered
where it is produced.  (One chip: no exchange between chips to leave
out.)  On the CPU at a small size, the port on its plain twins, each run
in a fresh interpreter."""

import pytest

from slambench.tests.small import run_small

UNCHANGED_STEP = """
# the GN step hands its carry back as it came: no pose moves
import tpuslam_torch.icp as icp
from tpuslam_torch.kernels import gn_step
def frozen(points, q, n, w, carry, *a, **k):
    return carry
gn_step.gn_step = icp.gn_step = frozen
"""

HALF_THE_FRAMES = """
# each hand-over tracks only half of its frames, each twice
from tpuslam_torch import frontend, slam
orig_scan = frontend.scan_superchunk_frozen
def half(depths, *a, **k):
    idx = torch.arange(depths.shape[0]) // 2 * 2
    return orig_scan(depths[idx], *a, **k)
slam.scan_superchunk_frozen = half
orig_odo = frontend.scan_odometry_boundary_jit
def half_odo(depths, *a, **k):
    idx = torch.arange(depths.shape[0]) // 2 * 2
    return orig_odo(depths[idx], *a, **k)
frontend.scan_odometry_boundary_jit = half_odo
"""

ALTERED_POSE = """
# the last pose of every hand-over moved by a millimetre where it is made
import numpy as np
from tpuslam_torch import frontend, slam
orig = slam.SlamSystem.process_chunk
def altered(self, depths, timestamps=None):
    out = orig(self, depths, timestamps).copy()
    kf, T = self.odo.frame_refs[-1]
    T = np.array(T, dtype=np.float64)
    T[0, 3] += 1e-3
    self.odo.frame_refs[-1] = (kf, T)
    out[-1, 0, 3] += 1e-3
    return out
slam.SlamSystem.process_chunk = altered
orig_odo = frontend.scan_odometry_boundary_jit
def altered_odo(*a, **k):
    poses, flags, inl = orig_odo(*a, **k)
    poses = poses.clone()
    poses[-1, 0, 3] += 1e-3
    return poses, flags, inl
frontend.scan_odometry_boundary_jit = altered_odo
"""

CELLS = ("slam-loop-vga", "odom-orbit-vga")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    rc, line, err, _ = run_small(cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [UNCHANGED_STEP, HALF_THE_FRAMES,
                                   ALTERED_POSE],
                         ids=["unchanged_step", "half_the_frames",
                              "altered_pose"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    rc, line, err, _ = run_small(cell, prelude=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, err[-3000:]
    assert any(c["value"] == "no reading" or c["value"] > c["limit"]
               for c in line["compared"].values())
