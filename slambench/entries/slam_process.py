"""Entry `slam_process`: the port's SLAM system as
`python -m tpuslam_torch.cli run_slam` drives it at its defaults — a
fresh `SlamSystem` a session (the backend synchronous, loop closure on),
every frame through `process` as it arrives (`--chunk 0`), then
`finalize` and `trajectory()`.

Each session is a generator: it yields one `("chunk", 1, seconds)` a
frame (the time from handing the frame over to its pose on the host: the
frame's tracking readback and, when it promoted, the keyframe's promotion
and the loop-closure attempt, both synchronous) and a last
`("done", record)`.  The window may drop a session between two frames.

Correctness: the sampled sessions are run again frame by frame by the
plain reference (`slambench/reference/plain.py`, `Slam._process_frame`)
on the same depth, and the four numbers of `slam_process_chunk` are
compared: the largest entry gap of the 3×4 poses as `process` returned
them (tracked) and of `trajectory()` after `finalize` (after the pose
graph), and the frames promoted to keyframes and the closure pairs
accepted that differ (exact).
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from slambench.entries.slam_process_chunk import Entry as ChunkEntry

# Limits of the compared numbers, each between the largest reading of
# sound runs and the smallest of the control, the reference with TF32
# matmuls (`slambench/tools/readings.py` on an NVIDIA H100 80GB HBM3 at
# 700 W, 12 seeds, 24 sampled sessions covering all 8 of the pool; each
# session reads the same on every seed): sound runs read at most 2.19e-6
# tracked and 2.10e-6 after the graph, the control at least 6.07e-4 and
# 5.06e-4, with 0-2 keyframes differing.  The limit sits ~9x above the
# first and ~25x below the second.  Keyframes and closures are exact.
LIMITS = {
    "pose_gap_tracked": 2e-5,
    "pose_gap_final": 2e-5,
    "keyframe_mismatch": 0,
    "closure_mismatch": 0,
}
CHECK_SESSIONS = 2          # sessions the reference runs again


class Entry(ChunkEntry):
    """`slam_process_chunk`'s set-up, warm-up and comparison; the session
    and the reference step one frame at a time."""

    def session(self, s: int):
        from tpuslam_torch.slam import SlamSystem

        depth = self.pool["depth"][s]
        ts = self.pool["timestamps"]
        frames = depth.shape[0]
        with record_function("bench.new_system"):
            slam = SlamSystem(self.K, self.cfg, device=self.device,
                              **self.system)
        tracked, chunks = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            with record_function("bench.process"):
                pose = slam.process(depth[f], float(ts[f]))
            dt = time.perf_counter() - t0
            tracked.append(pose)
            # one frame, none of it through the boundary scan
            chunks.append((1, 0, dt))
            yield ("chunk", 1, dt)
        with record_function("bench.finalize"):
            slam.finalize()
            _ts, traj = slam.trajectory()
        yield ("done", {
            "pool": s, "frames": frames, "chunks": chunks,
            "tracked": np.stack(tracked), "trajectory": traj,
            "keyframes": [int(r.index) for r in slam.odo.keyframes],
            "closures": [(int(c.i), int(c.j)) for c in slam.closures],
        })

    def reference(self, s: int, work=None) -> dict:
        from slambench.reference import plain

        ref = plain.Slam(self.pool["K"], self.tree,
                         int(self.system["chunk_sub"]), work)
        depth = self.pool["depth"][s]
        tracked = [ref._process_frame(depth[f])
                   for f in range(depth.shape[0])]
        ref.finalize()
        return {"tracked": np.stack(tracked),
                "trajectory": ref.trajectory(),
                "keyframes": ref.keyframe_frames(),
                "closures": list(ref.closures)}
