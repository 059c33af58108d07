"""Loop-closure proposal and verification — port of the projective path of
`tpuslam/backend/loopclosure.py`.

Proposal is host-side numpy over keyframe positions; verification aligns
keyframe j's stored voxel cloud onto keyframe i's retained organized
tracking table (`icp.align_cloud_to_organized`: one row gather per point
per iteration, the ICP kernels of the tracking path); acceptance gates on
convergence, residual RMS, inlier fraction and normal coverage
(backend/verify.py).  `fused_attempt_jit` chains verification, the gates,
the candidate edges and the pose-graph solve on the device without
reading anything back, so the host pays one readback per attempt.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpuslam_torch.backend.posegraph import (
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from tpuslam_torch.backend.verify import (
    flat_verify_scalars,
    passes_gates,
    passes_gates_traced,
    uniform_verify_table,
)
from tpuslam_torch.config import ICPConfig, Intrinsics, PoseGraphConfig
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import FlatICP, align_cloud_to_organized


class ClosureCandidate(NamedTuple):
    i: int                  # earlier keyframe id
    j: int                  # later keyframe id
    dist: float             # metric distance between keyframe origins


class Closure(NamedTuple):
    i: int
    j: int
    T_ij: np.ndarray        # verified relative pose: node_i ← node_j
    rms: float
    inlier_fraction: float


def propose_candidates(
    kf_poses: Sequence[np.ndarray],
    cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    verifiable: np.ndarray | None = None,
) -> list[ClosureCandidate]:
    """Proximity-gated candidate pairs (i < j − lc_min_gap, |Δt| < radius),
    closest first, at most `max_candidates`.  Keyframes whose clouds were
    sparsified away (`verifiable` False) are excluded before the cap."""
    exclude_pairs = exclude_pairs or set()
    pos = np.asarray([T[:3, 3] for T in kf_poses], dtype=np.float32)
    k = len(pos)
    cands: list[ClosureCandidate] = []
    if k < 2:
        return cands
    pos = pos - pos.mean(axis=0)     # bound the f32 cancellation error
    sq = np.einsum("kd,kd->k", pos, pos)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
    d = np.sqrt(np.maximum(d2, 0.0))
    eligible = (
        (d < cfg.lc_max_dist)
        & (np.arange(k)[None, :] - np.arange(k)[:, None] > cfg.lc_min_gap)
    )
    if verifiable is not None:
        v = np.asarray(verifiable, dtype=bool)
        eligible &= v[:, None] & v[None, :]
    ii, jj = np.nonzero(eligible)
    order = np.argsort(d[ii, jj], kind="stable")
    for o in order:
        i, j = int(ii[o]), int(jj[o])
        if (i, j) in exclude_pairs:
            continue
        cands.append(ClosureCandidate(i=i, j=j, dist=float(d[i, j])))
        if len(cands) >= max_candidates:
            break
    return cands


def _gate_row(s: np.ndarray, pg_cfg: PoseGraphConfig) -> Closure | None:
    """Gate one flat verification row and wrap an accepted one as a
    Closure (ids filled in by the caller)."""
    if not passes_gates(s, pg_cfg):
        return None
    return Closure(
        i=-1, j=-1,
        T_ij=s[FlatICP.T].reshape(4, 4).astype(np.float64),
        rms=float(s[FlatICP.RMS]),
        inlier_fraction=float(s[FlatICP.INLIER_FRACTION]),
    )


def _pad_batch(live: list, max_candidates: int) -> list:
    """Pad to the next power-of-two batch size (capped at max_candidates)
    with repeats of the first entry, as the reference's batch buckets."""
    if not 0 < len(live) <= max_candidates:
        raise ValueError(f"{len(live)} candidates for a batch of at most "
                         f"{max_candidates}")
    b = 1
    while b < len(live):
        b *= 2
    b = min(b, max_candidates)
    return live + [live[0]] * (b - len(live))


def propose_attempt(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
):
    """Host-side proposal only — no device work.

    Returns `(live, padded, attempted, v0)`: the live `(i, j, T_init)`
    candidates, the power-of-two padded list (repeats of entry 0), all
    attempted pairs, and the shared VerifyTable meta (None when the
    keyframes carry no uniform verification tables).  `live` is empty when
    nothing was verifiable.
    """
    if pg_cfg.lc_descriptor:
        raise NotImplementedError(
            "PoseGraphConfig.lc_descriptor: descriptor proposal is not "
            "ported yet (ROADMAP Queue 1 item 11)")
    attempted: set[tuple[int, int]] = set()
    verifiable = np.asarray([r.cloud is not None for r in keyframes], bool)
    cands = propose_candidates(kf_poses, pg_cfg, exclude_pairs,
                               max_candidates,
                               verifiable=verifiable[: len(kf_poses)])
    live = []
    for c in cands:
        T_init = np.linalg.inv(np.asarray(kf_poses[c.i])) @ np.asarray(
            kf_poses[c.j])
        live.append((c.i, c.j, T_init.astype(np.float32)))
        attempted.add((c.i, c.j))
    if not live:
        return live, [], attempted, None
    padded = _pad_batch(live, max_candidates)
    v0 = (uniform_verify_table(keyframes, [i for i, _, _ in live])
          if K is not None else None)
    return live, padded, attempted, v0


def verify_batch(tables, pts, nrm, msk, K_lvl: Intrinsics,
                 T_inits: torch.Tensor, n_live: int, h: int, w: int,
                 icp_cfg: ICPConfig) -> torch.Tensor:
    """(B, ROW_SIZE) verification rows of B candidates, on the device.

    The reference vmaps one alignment over the padded batch; here the
    `n_live` real candidates run one after another through the same ICP
    kernels (carries on the device), and the padding rows — repeats of
    candidate 0 by construction — copy row 0 instead of recomputing it.
    """
    rows = [flat_verify_scalars(align_cloud_to_organized(
        PointCloud(points=pts[b], normals=nrm[b], mask=msk[b]), tables[b],
        h, w, K_lvl, T_inits[b], icp_cfg)) for b in range(n_live)]
    rows += [rows[0]] * (len(tables) - n_live)
    return torch.stack(rows)


def fused_attempt_jit(tables, pts, nrm, msk, K_lvl: Intrinsics,
                      T_inits: torch.Tensor, n_live: int, graph,
                      cand_i: torch.Tensor, cand_j: torch.Tensor, h: int,
                      w: int, icp_cfg: ICPConfig, pg_cfg: PoseGraphConfig,
                      use_dense: bool, lc_weight: float) -> torch.Tensor:
    """The whole loop-closure attempt on the device, without a host sync.

    Projective verification of the B candidates, the acceptance gates
    (`passes_gates_traced`), the candidate edges appended to the bucketed
    graph with weight lc_weight·accept (rejected candidates weigh zero),
    the pose-graph solve (`use_dense`: the host-resolved solver), and the
    flat readback packing.

    Returns flat float32: rows.reshape(-1) ++ poses.reshape(-1) (rows:
    (B, verify.ROW_SIZE); poses: graph.poses.shape).
    """
    rows = verify_batch(tables, pts, nrm, msk, K_lvl, T_inits, n_live, h, w,
                        icp_cfg)
    b = rows.shape[0]
    is_real = (torch.arange(b, device=rows.device) < n_live).to(rows.dtype)
    accept = passes_gates_traced(rows, pg_cfg) * is_real
    cand_T = rows[:, FlatICP.T].reshape(b, 4, 4).to(graph.edge_T.dtype)
    # a diverged verification can return a non-finite pose (its gate
    # weight is 0), but 0·NaN would still poison the solve: use identity
    finite_T = torch.all(torch.isfinite(cand_T).reshape(b, 16), dim=1)
    cand_T = torch.where(finite_T[:, None, None], cand_T,
                         torch.eye(4, dtype=cand_T.dtype,
                                   device=cand_T.device))
    g_ext = graph._replace(
        edge_i=torch.cat([graph.edge_i, cand_i]),
        edge_j=torch.cat([graph.edge_j, cand_j]),
        edge_T=torch.cat([graph.edge_T, cand_T]),
        edge_weight=torch.cat([graph.edge_weight, lc_weight * accept]),
    )
    if use_dense:
        poses_opt, _cost = optimize_pose_graph(g_ext, pg_cfg, 0.5)
    else:
        poses_opt, _cost = optimize_pose_graph_cg(
            g_ext, pg_cfg, 0.5, cg_iters=int(pg_cfg.cg_iters),
            cg_tol=float(pg_cfg.cg_tol))
    return torch.cat([rows.reshape(-1).to(torch.float32),
                      poses_opt.reshape(-1).to(torch.float32)])


def gate_rows(live, s: np.ndarray, pg_cfg: PoseGraphConfig) -> list[Closure]:
    """Host gating of readback rows → accepted Closures (the mirror of the
    device-side `passes_gates_traced`: same values, same compares)."""
    out: list[Closure] = []
    for row_idx, (i, j, _) in enumerate(live):
        v = _gate_row(s[row_idx], pg_cfg)
        if v is not None:
            out.append(Closure(i=i, j=j, T_ij=v.T_ij, rms=v.rms,
                               inlier_fraction=v.inlier_fraction))
    return out
