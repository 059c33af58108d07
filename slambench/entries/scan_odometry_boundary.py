"""Entry `scan_odometry_boundary`: the port's full-sequence odometry,
`frontend.scan_odometry_boundary_jit` over a device-resident session in
chunks (one captured chunk program a chunk), each session one call with
its poses and promotion flags then read back to the host.

Correctness: the sampled sessions are scanned again by the plain
reference on the same depth; compared are the largest entry gap of the
3×4 world poses and the frames whose promotion flag differs (exact).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import record_function

LIMITS = {"pose_gap": 6e-5, "promote_mismatch": 0}
CHECK_SESSIONS = 2


class Entry:
    def __init__(self, config: dict, pool: dict, device: torch.device):
        from tpuslam_torch.config import Intrinsics, SLAMConfig

        self.config = config
        self.tree = config["slam_config"]
        self.cfg = SLAMConfig.from_json(json.dumps(self.tree)).validate()
        self.chunk = int(config["system"]["chunk"])
        self.pool = pool
        self.K = Intrinsics(*pool["K"])
        self.device = device

    def warm(self) -> None:
        """One scan of three chunks: the chunk program's first call runs
        eagerly, its second captures, its third replays; every session
        has the same shapes."""
        from tpuslam_torch.frontend import scan_odometry_boundary_jit

        poses, _, _ = scan_odometry_boundary_jit(
            self.pool["depth"][0, :3 * self.chunk], self.K, self.cfg,
            chunk=self.chunk)
        poses.cpu()

    def session(self, s: int):
        from tpuslam_torch.frontend import scan_odometry_boundary_jit

        depth = self.pool["depth"][s]
        t0 = time.perf_counter()
        with record_function("bench.scan"):
            poses, flags, _inl = scan_odometry_boundary_jit(
                depth, self.K, self.cfg, chunk=self.chunk)
        with record_function("bench.readback"):
            poses = poses.cpu().numpy()
            flags = flags.cpu().numpy()
        dt = time.perf_counter() - t0
        yield ("chunk", depth.shape[0], dt)
        yield ("done", {"pool": s, "frames": depth.shape[0],
                        "chunks": [(depth.shape[0], depth.shape[0], dt)],
                        "poses": poses, "promote": flags})

    def reference(self, s: int, work=None) -> dict:
        from slambench.reference import plain

        poses, flags = plain.scan_boundary(self.pool["depth"][s],
                                           self.pool["K"], self.tree,
                                           self.chunk, work)
        return {"poses": poses, "promote": flags}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        gap = np.abs(np.asarray(got["poses"], np.float64)[:, :3, :4]
                     - np.asarray(want["poses"], np.float64)[:, :3, :4])
        return {"pose_gap": float(np.max(gap)),
                "promote_mismatch": int(np.sum(
                    np.asarray(got["promote"], bool)
                    != np.asarray(want["promote"], bool)))}
