"""Relocalization after tracking loss — port of
`tpuslam/backend/relocalize.py`.

After `reloc_after` consecutive lost frames the SLAM system tries to
re-anchor the current frame on a stored keyframe: candidates are the
keyframes nearest the last known camera position, each verified from two
initial guesses (the current estimate and identity) by aligning the lost
frame's voxel cloud onto the keyframe's retained organized table or, when
the candidates carry no uniform tables (or no intrinsics are given), onto
the keyframe's cloud through the grid-hash probe; judged by the
loop-closure gates.  One readback per attempt; on the card the candidate
batch is one replay of a CUDA graph (tpuslam_torch/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.backend.verify import (
    flat_verify_scalars,
    passes_gates,
    uniform_verify_table,
    verify_grid,
)
from tpuslam_torch.config import ICPConfig, Intrinsics, PoseGraphConfig
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import FlatICP, align_cloud_to_organized
from tpuslam_torch.transfer import upload


class Relocalization(NamedTuple):
    kf_id: int               # keyframe the frame re-anchored on
    T_kf_cam: np.ndarray     # (4, 4) verified camera pose in that keyframe
    rms: float
    inlier_fraction: float


def _batch_verify_projective(_state, frame_cloud, tables, T_inits, *,
                             K_lvl: Intrinsics, h: int, w: int,
                             icp_cfg: ICPConfig):
    return (), torch.stack([flat_verify_scalars(align_cloud_to_organized(
        frame_cloud, table, h, w, K_lvl, T_inits[b], icp_cfg))
        for b, table in enumerate(tables)])


def _batch_verify(_state, frame_cloud, kf_clouds, T_inits, *,
                  icp_cfg: ICPConfig):
    return (), torch.stack([verify_grid(frame_cloud, cloud, T_inits[b],
                                        icp_cfg)
                            for b, cloud in enumerate(kf_clouds)])


# one graph a (B, the shapes, K, h, w, icp_cfg) and a (B, the shapes,
# icp_cfg): the reference's two jitted batches
_BATCH_VERIFY_PROJECTIVE = graphs.Program("_batch_verify_projective_jit",
                                          _batch_verify_projective)
_BATCH_VERIFY = graphs.Program("_batch_verify_jit", _batch_verify)


def _batch_verify_projective_jit(frame_cloud: PointCloud, tables,
                                 K_lvl: Intrinsics, T_inits: torch.Tensor,
                                 h: int, w: int, icp_cfg: ICPConfig,
                                 eager: bool = False) -> torch.Tensor:
    """(B, ROW_SIZE) rows: the lost frame's cloud aligned onto each
    candidate table from its initial guess (one alignment after another,
    carries on the device); one CUDA graph on the card unless `eager`."""
    return _BATCH_VERIFY_PROJECTIVE.run(frame_cloud, list(tables), T_inits,
                                        eager=eager, K_lvl=K_lvl, h=h, w=w,
                                        icp_cfg=icp_cfg)


def _batch_verify_jit(frame_cloud: PointCloud, kf_clouds,
                      T_inits: torch.Tensor, icp_cfg: ICPConfig,
                      eager: bool = False) -> torch.Tensor:
    """(B, ROW_SIZE) rows: the lost frame's cloud aligned onto each
    candidate keyframe's cloud by the grid-hash ICP (`align_clouds`), one
    alignment after another; one CUDA graph on the card unless `eager`."""
    return _BATCH_VERIFY.run(frame_cloud, list(kf_clouds), T_inits,
                             eager=eager, icp_cfg=icp_cfg)


def relocalize(
    frame_cloud: PointCloud,
    keyframes,                      # Sequence[KeyframeRecord]
    T_last_world_cam: np.ndarray,
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    max_candidates: int = 4,
    max_dist: Optional[float] = None,
    K: Intrinsics | None = None,
) -> Optional[Relocalization]:
    """Try to re-anchor a lost frame on a stored keyframe.

    Candidates: keyframes by distance of their origin to the last known
    camera position, within `max_dist` (default 2× the loop-closure
    radius) or, when none is, the nearest ones.  Each is verified from the
    current estimate and from identity; the first combination passing the
    loop-closure gates in (distance, estimate-before-identity) order wins.
    """
    if max_dist is None:
        max_dist = 2.0 * pg_cfg.lc_max_dist
    p_last = np.asarray(T_last_world_cam, dtype=np.float64)[:3, 3]
    order = []
    for k, rec in enumerate(keyframes):
        if rec.cloud is None:
            continue
        d = float(np.linalg.norm(
            rec.T_world_kf.astype(np.float64)[:3, 3] - p_last))
        order.append((d, k))
    order.sort()
    in_radius = [o for o in order if o[0] <= max_dist]
    order = in_radius if in_radius else order
    cand_ids = [k for _, k in order[:max_candidates]]
    if not cand_ids:
        return None

    combos: list[tuple[int, np.ndarray]] = []   # (kf_id, T_init)
    for k in cand_ids:
        T_est = (np.linalg.inv(keyframes[k].T_world_kf.astype(np.float64))
                 @ np.asarray(T_last_world_cam, dtype=np.float64))
        combos.append((k, T_est))
        combos.append((k, np.eye(4)))

    v0 = (uniform_verify_table(keyframes, cand_ids)
          if K is not None else None)
    T_inits = upload(np.stack([T for _, T in combos]).astype(np.float32),
                     frame_cloud.points.device)
    if v0 is not None:
        flat = _batch_verify_projective_jit(
            frame_cloud, [keyframes[k].verify.packed for k, _ in combos],
            K.scaled(1.0 / (2 ** v0.level)), T_inits, v0.height, v0.width,
            icp_cfg)
    else:
        flat = _batch_verify_jit(frame_cloud,
                                 [keyframes[k].cloud for k, _ in combos],
                                 T_inits, icp_cfg)
    s = flat.cpu().numpy()            # the ONE host sync of the attempt
    for row_idx, (kf_id, _) in enumerate(combos):
        row = s[row_idx]
        if not passes_gates(row, pg_cfg):
            continue
        return Relocalization(
            kf_id=kf_id,
            T_kf_cam=row[FlatICP.T].reshape(4, 4).astype(np.float64),
            rms=float(row[FlatICP.RMS]),
            inlier_fraction=float(row[FlatICP.INLIER_FRACTION]),
        )
    return None
