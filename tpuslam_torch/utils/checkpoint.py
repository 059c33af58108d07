"""Checkpoint / resume — port of `tpuslam/utils/checkpoint.py`.

An npz snapshot of an `Odometry` or `SlamSystem`: keyframe poses, pyramid,
clouds, verification tables and depth descriptors, the pose graph, the
per-frame references and the frame index.  The keys, dtypes and format
version are the reference's, so a file written by either package resumes
in the other.

Host state (poses, the graph's arrays) is numpy in both packages; the
keyframe pyramid, clouds and verification tables are tensors on the
system's device, written through `.cpu()` and copied back to the device on
load (verification tables stay float16).  Descriptors live in host memory
in both directions (float32 numpy arrays).

Two divergences from the reference: `load_checkpoint` clears the deferred
backend's pending loop-closure attempt, which the reference leaves in
place, so a solve dispatched before the restore cannot apply after it; and
`save_checkpoint` waits for the worker-thread backend's queued attempts to
commit and reads the state under the system's lock, where the reference
drains only the deferred attempt and can capture a graph in mid-commit.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

from tpuslam_torch.frontend import (
    KeyframeRecord,
    VerifyTable,
    host_descriptor,
)
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import Frame, pack_pyramid
from tpuslam_torch.transfer import upload

# v2: keyframe clouds are stored as a kf_cloud_ids-keyed subset (holes from
# sparsification) + optional verification tables; v1 stored a dense
# per-keyframe stack.  Both load; writing emits v2.
_FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)


def _is_slam(system) -> bool:
    return hasattr(system, "odo")


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path: str, system, frame_idx: int) -> None:
    """Snapshot an `Odometry` or `SlamSystem` to an npz (atomic rename).

    A SlamSystem's snapshot holds every loop-closure attempt in flight: the
    deferred one is drained, the worker's queued ones are committed
    (`wait_backend_idle`, which raises the worker's error or after its time
    limit), and the state is read under the system's lock."""
    lock = contextlib.nullcontext()
    if _is_slam(system):
        system._drain_pending()
        system.wait_backend_idle()
        lock = system._lock
    with lock:
        data = _state(system, frame_idx)
    # np.savez appends ".npz" to a name without it, which would break the
    # atomic rename: write through the open fd instead
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _state(system, frame_idx: int) -> dict:
    """The arrays `save_checkpoint` writes (host copies of the state)."""
    odo = system.odo if _is_slam(system) else system
    data: dict = {
        "version": _FORMAT_VERSION,
        "frame_idx": frame_idx,
        "timestamps": np.asarray(odo.timestamps),
        "trajectory": (np.stack(odo.trajectory) if odo.trajectory
                       else np.zeros((0, 4, 4))),
        "T_world_kf": np.array(odo.T_world_kf),
        "T_kf_cam": _host(odo.T_kf_cam),
        "last_delta": _host(odo.last_delta),
        "kf_indices": np.asarray([k.index for k in odo.keyframes]),
        "kf_timestamps": np.asarray([k.timestamp for k in odo.keyframes]),
        "kf_poses": (np.stack([k.T_world_kf for k in odo.keyframes])
                     if odo.keyframes else np.zeros((0, 4, 4))),
        "frame_ref_ids": np.asarray([r[0] for r in odo.frame_refs]),
        "frame_ref_T": (np.stack([r[1] for r in odo.frame_refs])
                        if odo.frame_refs else np.zeros((0, 4, 4))),
    }
    # the keyframe pyramid, to keep tracking after a resume
    if odo.kf_pyr is not None:
        for li, f in enumerate(odo.kf_pyr):
            data[f"kf_pyr_{li}_points"] = _host(f.points)
            data[f"kf_pyr_{li}_normals"] = _host(f.normals)
            data[f"kf_pyr_{li}_mask"] = _host(f.mask)
        data["kf_pyr_levels"] = len(odo.kf_pyr)
    # keyframe clouds (loop closure): sparsification leaves holes, so the
    # retained subset is stored with its keyframe ids
    retained = [(k, r.cloud) for k, r in enumerate(odo.keyframes)
                if r.cloud is not None]
    if retained:
        data["kf_cloud_ids"] = np.asarray([k for k, _ in retained],
                                          dtype=np.int32)
        data["kf_cloud_points"] = np.stack([_host(c.points)
                                            for _, c in retained])
        data["kf_cloud_normals"] = np.stack([_host(c.normals)
                                             for _, c in retained])
        data["kf_cloud_mask"] = np.stack([_host(c.mask) for _, c in retained])
    data["protected_kf_ids"] = np.asarray(sorted(odo.protected_kf_ids),
                                          dtype=np.int32)
    # projective-verification tables; one meta triple covers the stack, so
    # tables of another shape or level (possible after resuming a file
    # written under a different verify_level) are skipped
    vt = [(k, r.verify) for k, r in enumerate(odo.keyframes)
          if r.verify is not None]
    if vt:
        v0 = vt[0][1]
        vt = [(k, v) for k, v in vt
              if v.packed.shape == v0.packed.shape
              and (v.height, v.width, v.level) == (v0.height, v0.width,
                                                   v0.level)]
        data["kf_verify_ids"] = np.asarray([k for k, _ in vt], dtype=np.int32)
        data["kf_verify_packed"] = np.stack([_host(v.packed) for _, v in vt])
        data["kf_verify_meta"] = np.asarray(
            [v0.height, v0.width, v0.level], dtype=np.int32)
    # pose-free loop-closure descriptors (lc_descriptor), so a resumed run
    # keeps its drift-robust proposal
    descs = [(k, r.desc) for k, r in enumerate(odo.keyframes)
             if r.desc is not None]
    if descs:
        data["kf_desc_ids"] = np.asarray([k for k, _ in descs],
                                         dtype=np.int32)
        data["kf_desc"] = np.stack([host_descriptor(d) for _, d in descs])
    if _is_slam(system):
        g = system.graph
        data.update(
            graph_num_nodes=g.num_nodes,
            graph_num_edges=g.num_edges,
            graph_poses=g._poses[: g.num_nodes].copy(),
            graph_edge_i=g._edge_i[: g.num_edges].copy(),
            graph_edge_j=g._edge_j[: g.num_edges].copy(),
            graph_edge_T=g._edge_T[: g.num_edges].copy(),
            graph_edge_w=g._edge_w[: g.num_edges].copy(),
        )
    return data


def load_checkpoint(path: str, system) -> int:
    """Restore state saved by `save_checkpoint` (by either package) onto
    the system's device; returns the next frame index."""
    with np.load(path, allow_pickle=False) as z:
        return _restore(z, system)


def _restore(z, system) -> int:
    if int(z["version"]) not in _READABLE_VERSIONS:
        raise ValueError(f"unknown checkpoint version {z['version']}")
    odo = system.odo if _is_slam(system) else system
    dev = odo.device

    def put(a) -> torch.Tensor:
        return upload(a, dev)

    odo.timestamps = [float(t) for t in z["timestamps"]]
    odo.trajectory = [T for T in z["trajectory"]]
    odo.T_world_kf = z["T_world_kf"].astype(np.float32)
    odo.T_kf_cam = put(z["T_kf_cam"].astype(np.float32))
    odo.last_delta = put(z["last_delta"].astype(np.float32))
    odo.frame_idx = int(z["frame_idx"])
    odo.frame_refs = [
        (int(i), T) for i, T in zip(z["frame_ref_ids"], z["frame_ref_T"])
    ]
    if "kf_pyr_levels" in z:
        odo.kf_pyr = tuple(
            Frame(points=put(z[f"kf_pyr_{li}_points"]),
                  normals=put(z[f"kf_pyr_{li}_normals"]),
                  mask=put(z[f"kf_pyr_{li}_mask"]))
            for li in range(int(z["kf_pyr_levels"])))
    # the row-gather tables derive from the pyramid and are not stored
    odo.kf_packed = (pack_pyramid(odo.kf_pyr, odo.cfg.icp)
                     if odo.kf_pyr is not None else None)
    n_kf = len(z["kf_indices"])
    # each stack is read (and inflated) once: z[key] reads it anew
    cloud_row = {}           # keyframe id → row in the stored cloud stack
    if "kf_cloud_points" in z:
        ids = (z["kf_cloud_ids"] if "kf_cloud_ids" in z
               else np.arange(n_kf))    # v1: a dense per-keyframe stack
        cloud_row = {int(k): r for r, k in enumerate(ids)}
        clouds = [z[f"kf_cloud_{f}"] for f in PointCloud._fields]
    verify_row = {}
    if "kf_verify_ids" in z:
        verify_row = {int(k): r for r, k in enumerate(z["kf_verify_ids"])}
        vh, vw, vlvl = (int(v) for v in z["kf_verify_meta"])
        tables = z["kf_verify_packed"]
    desc_row = {}
    if "kf_desc_ids" in z:
        desc_row = {int(k): r for r, k in enumerate(z["kf_desc_ids"])}
        descs = z["kf_desc"]
    odo.keyframes = []
    for k in range(n_kf):
        cloud = verify = None
        if k in cloud_row:
            cloud = PointCloud(*(put(a[cloud_row[k]]) for a in clouds))
        if k in verify_row:
            verify = VerifyTable(packed=put(tables[verify_row[k]]),
                                 height=vh, width=vw, level=vlvl)
        odo.keyframes.append(KeyframeRecord(
            index=int(z["kf_indices"][k]),
            timestamp=float(z["kf_timestamps"][k]),
            T_world_kf=z["kf_poses"][k].astype(np.float32),
            cloud=cloud, verify=verify,
            desc=descs[desc_row[k]] if k in desc_row else None))
    # the recency sequence is not persisted: restored anchors start equal
    odo.protected_kf_ids = (
        {int(i): 0 for i in z["protected_kf_ids"]}
        if "protected_kf_ids" in z else {})
    if not _is_slam(system):
        return int(z["frame_idx"])
    # a deferred attempt dispatched before the restore holds poses of
    # another graph: it must never apply
    system._pending_attempt = None
    if "graph_num_nodes" in z:
        g = system.graph
        g.num_nodes = int(z["graph_num_nodes"])
        g.num_edges = int(z["graph_num_edges"])
        g.ensure_capacity(nodes=g.num_nodes, edges=g.num_edges)
        g._poses[: g.num_nodes] = z["graph_poses"]
        g._edge_i[: g.num_edges] = z["graph_edge_i"]
        g._edge_j[: g.num_edges] = z["graph_edge_j"]
        g._edge_T[: g.num_edges] = z["graph_edge_T"]
        g._edge_w[: g.num_edges] = z["graph_edge_w"]
        system._num_graph_nodes = g.num_nodes
        system._known_edges = {
            (int(g._edge_i[e]), int(g._edge_j[e])) for e in range(g.num_edges)
        }
    # the map derives from the keyframes and is not stored: re-fuse them,
    # or map tracking would run against an empty map after a resume
    if system.map is not None:
        for rec in odo.keyframes:
            if rec.cloud is not None:
                system.map.insert(rec.cloud, rec.T_world_kf)
        system._map_index = None
    return int(z["frame_idx"])
