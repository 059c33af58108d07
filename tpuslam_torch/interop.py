"""Carry the reference's configuration and state into the port.

The "parameters" of this system are its config, its tracking state, its
keyframe records and its pose graph; all cross over as plain data (JSON,
numpy arrays), so this module needs nothing of the JAX package: the
reference's objects are read field by field through `np.asarray`.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpuslam_torch.backend.map_ba import MapBAProblem
from tpuslam_torch.backend.posegraph import PoseGraph
from tpuslam_torch.config import SLAMConfig
from tpuslam_torch.frontend import KeyframeRecord, ScanState, VerifyTable
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels.correspond import GridIndex, with_cell_table
from tpuslam_torch.transfer import upload


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


def pose_graph_from_reference(graph, device) -> PoseGraph:
    """The port's PoseGraph from the reference's `backend.posegraph
    .PoseGraph` (or anything with its six fields as arrays)."""
    return PoseGraph(*(upload(np.asarray(f), device) for f in graph))


def keyframe_record_from_reference(rec, device) -> KeyframeRecord:
    """The port's KeyframeRecord from the reference's `frontend
    .KeyframeRecord`: pose, voxel cloud and verification table as arrays
    on `device`, the depth descriptor as a float32 numpy array (the port
    keeps descriptors in host memory)."""
    cloud = verify = None
    if rec.cloud is not None:
        cloud = PointCloud(*(upload(np.asarray(a), device)
                             for a in rec.cloud))
    if rec.verify is not None:
        verify = VerifyTable(packed=upload(np.asarray(rec.verify.packed),
                                           device),
                             height=int(rec.verify.height),
                             width=int(rec.verify.width),
                             level=int(rec.verify.level))
    return KeyframeRecord(index=int(rec.index),
                          timestamp=float(rec.timestamp),
                          T_world_kf=np.array(rec.T_world_kf,
                                              dtype=np.float32),
                          cloud=cloud, verify=verify,
                          desc=(None if rec.desc is None else
                                np.array(rec.desc, dtype=np.float32)))


def grid_index_from_reference(index, device) -> GridIndex:
    """The port's GridIndex from the reference's `kernels.correspond
    .GridIndex`: the same keys, and its points and normals as the port's
    (M, 8) rows in the same order."""
    points = np.asarray(index.points, dtype=np.float32)
    rows = np.zeros((points.shape[0], 8), dtype=np.float32)
    rows[:, 0:3] = points
    rows[:, 3:6] = np.asarray(index.normals, dtype=np.float32)
    return with_cell_table(GridIndex(
        keys=upload(np.asarray(index.keys, dtype=np.int32), device),
        rows=upload(rows, device),
        origin=upload(np.asarray(index.origin, dtype=np.float32), device),
        cell=float(np.asarray(index.cell))))


def map_ba_problem_from_reference(prob, device) -> MapBAProblem:
    """The port's MapBAProblem from the reference's (field by field)."""
    return MapBAProblem(*(upload(np.asarray(f), device) for f in prob))
