"""Carry the reference's configuration and tracking state into the port.

The "parameters" of this system are its config and its tracking state;
both cross over as plain data (JSON, numpy arrays), so this module needs
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpuslam_torch.config import SLAMConfig
from tpuslam_torch.frontend import ScanState


def config_from_reference(cfg_like) -> SLAMConfig:
    """The port's SLAMConfig equal to a reference `tpuslam.config.SLAMConfig`
    (or any dataclass tree with the same fields)."""
    return SLAMConfig.from_json(json.dumps(dataclasses.asdict(cfg_like)))


def scan_state_from_numpy(kf_packed, T_world_kf, T_kf_cam, last_delta,
                          device) -> ScanState:
    """The port's ScanState from numpy arrays of the reference's
    `frontend.ScanState` (per-level packed tables and three 4×4 poses)."""
    def pose(a):
        return torch.as_tensor(np.array(a, dtype=np.float32),
                               device=device)

    return ScanState(
        kf_packed=tuple(torch.as_tensor(np.array(t), device=device)
                        for t in kf_packed),
        T_world_kf=pose(T_world_kf),
        T_kf_cam=pose(T_kf_cam),
        last_delta=pose(last_delta),
    )
