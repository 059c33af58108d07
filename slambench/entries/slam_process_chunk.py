"""Entry `slam_process_chunk`: the port's SLAM system as
`python -m tpuslam_torch.cli run_slam --chunk 8 --chunk-sub 4` drives it —
a fresh `SlamSystem` a session (boundary chunk mode, the backend
synchronous, loop closure on), every chunk through `process_chunk`, then
`finalize` and `trajectory()`.

Each session is a generator: it yields one `("chunk", frames, seconds)`
a hand-over (the time from handing the chunk over to its poses on the
host) and a last `("done", record)`.  The window may drop a session
between two hand-overs.

Correctness: the sampled sessions are run again by the plain reference
(`slambench/reference/plain.py`) on the same depth, and four numbers are
compared: the largest entry gap of the 3×4 poses as `process_chunk`
returned them (tracked) and of `trajectory()` after `finalize` (after the
pose graph), and the frames promoted to keyframes and the closure pairs
accepted that differ (exact).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import record_function

# Limits of the compared numbers, each between the largest reading of
# sound runs and the smallest of the control (PERF.md, "How correct is
# decided", gives the readings they were set from).
LIMITS = {
    "pose_gap_tracked": 6e-5,
    "pose_gap_final": 6e-5,
    "keyframe_mismatch": 0,
    "closure_mismatch": 0,
}
CHECK_SESSIONS = 2          # sessions the reference runs again


def _pose_gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(a)[:, :3, :4]
                               - np.asarray(b)[:, :3, :4])))


class Entry:
    def __init__(self, config: dict, pool: dict, device: torch.device):
        from tpuslam_torch.config import Intrinsics, SLAMConfig

        self.config = config
        self.tree = config["slam_config"]
        self.cfg = SLAMConfig.from_json(json.dumps(self.tree)).validate()
        self.system = dict(config["system"])
        self.chunk = int(self.system.pop("chunk"))
        self.pool = pool
        self.K = Intrinsics(*pool["K"])
        self.device = device

    def warm(self) -> None:
        """Every session of the pool once, then again until every
        program met is captured: a captured program's first call runs
        eagerly and its second captures, so the window only replays."""
        from tpuslam_torch import graphs

        sessions = range(self.pool["depth"].shape[0])
        for s in list(sessions) + list(sessions):
            if s == 0 and graphs.stats() and all(
                    e["captured"] for e in graphs.stats()):
                break
            for _ev in self.session(s):
                pass

    def session(self, s: int):
        from tpuslam_torch.slam import SlamSystem

        depth = self.pool["depth"][s]
        ts = self.pool["timestamps"]
        frames = depth.shape[0]
        with record_function("bench.new_system"):
            slam = SlamSystem(self.K, self.cfg, device=self.device,
                              **self.system)
        tracked, chunks = [], []
        for c0 in range(0, frames, self.chunk):
            boot = slam.odo.kf_pyr is None
            t0 = time.perf_counter()
            with record_function("bench.process_chunk"):
                poses = slam.process_chunk(depth[c0:c0 + self.chunk],
                                           ts[c0:c0 + self.chunk])
            dt = time.perf_counter() - t0
            n = poses.shape[0]
            tracked.append(poses)
            # frames that went through the boundary scan (`slam.scan`)
            chunks.append((n, n - (slam.chunk_sub if boot else 0), dt))
            yield ("chunk", n, dt)
        with record_function("bench.finalize"):
            slam.finalize()
            _ts, traj = slam.trajectory()
        yield ("done", {
            "pool": s, "frames": frames, "chunks": chunks,
            "tracked": np.concatenate(tracked), "trajectory": traj,
            "keyframes": [int(r.index) for r in slam.odo.keyframes],
            "closures": [(int(c.i), int(c.j)) for c in slam.closures],
        })

    def reference(self, s: int, work=None) -> dict:
        from slambench.reference import plain

        ref = plain.Slam(self.pool["K"], self.tree,
                         int(self.system["chunk_sub"]), work)
        depth = self.pool["depth"][s]
        tracked = [ref.process_chunk(depth[c0:c0 + self.chunk])
                   for c0 in range(0, depth.shape[0], self.chunk)]
        ref.finalize()
        return {"tracked": np.concatenate(tracked),
                "trajectory": ref.trajectory(),
                "keyframes": ref.keyframe_frames(),
                "closures": list(ref.closures)}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        return {
            "pose_gap_tracked": _pose_gap(got["tracked"], want["tracked"]),
            "pose_gap_final": _pose_gap(got["trajectory"],
                                        want["trajectory"]),
            "keyframe_mismatch": len(set(got["keyframes"])
                                     ^ set(want["keyframes"])),
            "closure_mismatch": len(set(map(tuple, got["closures"]))
                                    ^ set(map(tuple, want["closures"]))),
        }
