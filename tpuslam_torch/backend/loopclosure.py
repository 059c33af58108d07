"""Loop-closure proposal and verification — port of
`tpuslam/backend/loopclosure.py`.

Proposal is host-side numpy: by keyframe positions (`propose_candidates`)
and, with `PoseGraphConfig.lc_descriptor`, pose-free by depth-descriptor
similarity (`propose_descriptor_candidates`, over descriptors already in
host memory: it reads no device tensor).  Verification aligns keyframe
j's stored voxel cloud onto keyframe i's retained organized tracking
table (`icp.align_cloud_to_organized`: one row gather per point per
iteration, the ICP kernels of the tracking path) or, when the keyframes
carry no uniform tables, onto keyframe i's cloud through the grid-hash
probe (`icp.align_clouds`: a sorted index, the grid_correspond kernel,
gn_step).  Acceptance gates on convergence, residual RMS, inlier fraction
and normal coverage (backend/verify.py).

`fused_attempt_jit` chains verification, the gates, the candidate edges
and the pose-graph solve on the device without reading anything back, so
the host pays one readback per attempt (on the card one replay of a CUDA
graph, tpuslam_torch/graphs.py).  The per-pair API is
`verify_closure` (one pair, one readback), `propose_and_verify` (no
readback) and `find_closures` (one readback a pass).  Each verification
batch — projective (`verify_batch`) or grid-hash (`verify_batch_grid`,
`verify_closure` its B = 1 case) — is one graph a key on the card as
well, the reference's jitted batches.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.backend.posegraph import (
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from tpuslam_torch.backend.verify import (
    flat_verify_scalars,
    passes_gates,
    passes_gates_traced,
    uniform_verify_table,
    verify_grid,
)
from tpuslam_torch.config import ICPConfig, Intrinsics, PoseGraphConfig
from tpuslam_torch.frontend import host_descriptor
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import FlatICP, align_cloud_to_organized
from tpuslam_torch.transfer import upload


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


def propose_descriptor_candidates(
    keyframes,
    cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]],
    verifiable: np.ndarray,
    max_candidates: int,
) -> list[tuple[int, int]]:
    """Pose-free candidate pairs by depth-descriptor similarity.

    Distance between two keyframes: the weighted relative block-depth
    difference 2·Σw|za−zb| / Σw(za+zb) over their blocks (w = the smaller
    of the two valid fractions); pairs under 25% mutual block coverage
    never match.  Returns up to `max_candidates` closest pairs under
    `lc_desc_max_dist`, gap-gated like proximity proposal but with no pose
    term, so a drifted revisit still surfaces; verification from an
    identity guess decides.
    """
    ids = [k for k, r in enumerate(keyframes)
           if r.desc is not None and k < len(verifiable) and verifiable[k]]
    if len(ids) < 2:
        return []
    D = np.stack([host_descriptor(keyframes[k].desc) for k in ids])
    n = D.shape[1] // 2
    Z, Fv = D[:, :n], D[:, n:]
    W = np.minimum(Fv[:, None, :], Fv[None, :, :])          # (K, K, n)
    num = (W * np.abs(Z[:, None, :] - Z[None, :, :])).sum(-1)
    den = (W * (Z[:, None, :] + Z[None, :, :])).sum(-1) + 1e-6
    d = 2.0 * num / den
    kf_ids = np.asarray(ids)
    eligible = (
        (d < cfg.lc_desc_max_dist)
        & (W.sum(-1) >= 0.25 * n)
        & (kf_ids[None, :] - kf_ids[:, None] > cfg.lc_min_gap)
    )
    ii, jj = np.nonzero(eligible)
    out: list[tuple[int, int]] = []
    for o in np.argsort(d[ii, jj], kind="stable"):
        pair = (int(kf_ids[ii[o]]), int(kf_ids[jj[o]]))
        if pair in exclude_pairs:
            continue
        out.append(pair)
        if len(out) >= max_candidates:
            break
    return out


def _verify_batch_grid(_state, clouds_i, clouds_j, T_inits, *, n_live: int,
                       icp_cfg: ICPConfig):
    rows = [verify_grid(clouds_j[b], clouds_i[b], T_inits[b], icp_cfg)
            for b in range(n_live)]
    rows += [rows[0]] * (len(clouds_i) - n_live)
    return (), torch.stack(rows)


# the reference's _verify_pairs_jit (and _verify_jit, its B = 1 case): one
# graph a (B, live candidates, the clouds' shapes, icp_cfg)
_VERIFY_PAIRS = graphs.Program("_verify_pairs_jit", _verify_batch_grid)


def verify_batch_grid(clouds_i, clouds_j, T_inits: torch.Tensor,
                      n_live: int, icp_cfg: ICPConfig,
                      eager: bool = False) -> torch.Tensor:
    """(B, ROW_SIZE) grid-hash verification rows of B candidate pairs, the
    fallback of `verify_batch` for keyframes without uniform tables.  The
    `n_live` real candidates run one after another (each index built, then
    probed); the padding rows copy row 0, as in `verify_batch`.  One CUDA
    graph on the card, unless `eager`."""
    return _VERIFY_PAIRS.run(list(clouds_i), list(clouds_j), T_inits,
                             eager=eager, n_live=n_live, icp_cfg=icp_cfg)


def verify_closure(
    cloud_i: PointCloud,
    cloud_j: PointCloud,
    T_init_ij: np.ndarray,
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
) -> Closure | None:
    """Verify one candidate by the grid-hash ICP: keyframe j's cloud onto
    keyframe i's, both in their own camera frames, from `T_init_ij` (the
    graph's node_i ← node_j); `verify_batch_grid`'s B = 1 graph.  One
    readback; the ids of the Closure returned are -1."""
    T0 = upload(np.asarray(T_init_ij, dtype=np.float32)[None],
                cloud_i.points.device)
    s = verify_batch_grid([cloud_i], [cloud_j], T0, 1, icp_cfg)
    return _gate_row(s[0].cpu().numpy(), pg_cfg)


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
    cap = max_candidates
    if pg_cfg.lc_descriptor:
        desc_pairs = propose_descriptor_candidates(
            keyframes, pg_cfg, (exclude_pairs or set()) | attempted,
            verifiable, int(pg_cfg.lc_desc_candidates))
        for (i, j) in desc_pairs:
            # identity guess: a descriptor match means a similar viewpoint,
            # and the (possibly drifted) pose estimate is not used
            live.append((i, j, np.eye(4, dtype=np.float32)))
            attempted.add((i, j))
        if desc_pairs:
            cap = max_candidates + int(pg_cfg.lc_desc_candidates)
            while cap & (cap - 1):       # batch sizes stay powers of two
                cap += 1
    if not live:
        return live, [], attempted, None
    padded = _pad_batch(live, cap)
    v0 = (uniform_verify_table(keyframes, [i for i, _, _ in live])
          if K is not None else None)
    return live, padded, attempted, v0


def _verify_batch(_state, tables, pts, nrm, msk, T_inits, *,
                  K_lvl: Intrinsics, n_live: int, h: int, w: int,
                  icp_cfg: ICPConfig):
    rows = [flat_verify_scalars(align_cloud_to_organized(
        PointCloud(points=pts[b], normals=nrm[b], mask=msk[b]), tables[b],
        h, w, K_lvl, T_inits[b], icp_cfg)) for b in range(n_live)]
    rows += [rows[0]] * (len(tables) - n_live)
    return (), torch.stack(rows)


# the reference's _verify_projective_pairs_jit: one graph a (B, live
# candidates, the tables' and clouds' shapes, K, h, w, icp_cfg)
_VERIFY_PROJECTIVE_PAIRS = graphs.Program("_verify_projective_pairs_jit",
                                          _verify_batch)


def verify_batch(tables, pts, nrm, msk, K_lvl: Intrinsics,
                 T_inits: torch.Tensor, n_live: int, h: int, w: int,
                 icp_cfg: ICPConfig, eager: bool = False) -> torch.Tensor:
    """(B, ROW_SIZE) verification rows of B candidates, on the device.

    The reference vmaps one alignment over the padded batch; here the
    `n_live` real candidates run one after another through the same ICP
    kernels (carries on the device), and the padding rows — repeats of
    candidate 0 by construction — copy row 0 instead of recomputing it.
    One CUDA graph on the card (inline inside `fused_attempt_jit`'s),
    unless `eager`.
    """
    return _VERIFY_PROJECTIVE_PAIRS.run(
        list(tables), list(pts), list(nrm), list(msk), T_inits, eager=eager,
        K_lvl=K_lvl, n_live=n_live, h=h, w=w, icp_cfg=icp_cfg)


def propose_and_verify(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
):
    """Propose, then issue the verification batch without reading back.

    Returns `(live, rows, attempted)`: the live `(i, j, T_init)`
    candidates, the (B, verify.ROW_SIZE) rows on the device (B the padded
    batch; rows ≥ len(live) repeat row 0) — projective against the
    keyframes' retained tables when they are uniform and `K` is given,
    else grid-hash cloud to cloud — and all attempted pairs.  `rows` is
    None when nothing was verifiable.
    """
    live, padded, attempted, v0 = propose_attempt(
        keyframes, kf_poses, icp_cfg, pg_cfg, exclude_pairs,
        max_candidates, K)
    if not live:
        return live, None, attempted
    T_inits = upload(np.stack([T for _, _, T in padded]),
                     keyframes[live[0][1]].cloud.points.device)
    clouds_j = [keyframes[j].cloud for _, j, _ in padded]
    if v0 is not None:
        rows = verify_batch(
            [keyframes[i].verify.packed for i, _, _ in padded],
            [c.points for c in clouds_j], [c.normals for c in clouds_j],
            [c.mask for c in clouds_j], K.scaled(1.0 / (2 ** v0.level)),
            T_inits, len(live), v0.height, v0.width, icp_cfg)
    else:
        rows = verify_batch_grid([keyframes[i].cloud for i, _, _ in padded],
                                 clouds_j, T_inits, len(live), icp_cfg)
    return live, rows, attempted


def extend_with_candidates(graph, rows: torch.Tensor, n_live: int,
                           cand_i: torch.Tensor, cand_j: torch.Tensor,
                           pg_cfg: PoseGraphConfig, lc_weight: float):
    """The bucketed graph with the B candidate edges appended, on the
    device: each weighs lc_weight·accept (`passes_gates_traced`, padding
    rows 0), and a non-finite candidate pose becomes the identity (its
    weight is 0, but 0·NaN would still poison the solve)."""
    b = rows.shape[0]
    is_real = (torch.arange(b, device=rows.device) < n_live).to(rows.dtype)
    accept = passes_gates_traced(rows, pg_cfg) * is_real
    cand_T = rows[:, FlatICP.T].reshape(b, 4, 4).to(graph.edge_T.dtype)
    finite_T = torch.all(torch.isfinite(cand_T).reshape(b, 16), dim=1)
    cand_T = torch.where(finite_T[:, None, None], cand_T,
                         torch.eye(4, dtype=cand_T.dtype,
                                   device=cand_T.device))
    return graph._replace(
        edge_i=torch.cat([graph.edge_i, cand_i]),
        edge_j=torch.cat([graph.edge_j, cand_j]),
        edge_T=torch.cat([graph.edge_T, cand_T]),
        edge_weight=torch.cat([graph.edge_weight, lc_weight * accept]),
    )


def _fused_attempt(_state, tables, pts, nrm, msk, T_inits, graph, cand_i,
                   cand_j, *, K_lvl: Intrinsics, n_live: int, h: int, w: int,
                   icp_cfg: ICPConfig, pg_cfg: PoseGraphConfig,
                   use_dense: bool, lc_weight: float):
    rows = verify_batch(tables, pts, nrm, msk, K_lvl, T_inits, n_live, h, w,
                        icp_cfg)
    g_ext = extend_with_candidates(graph, rows, n_live, cand_i, cand_j,
                                   pg_cfg, lc_weight)
    if use_dense:
        poses_opt, _cost = optimize_pose_graph(g_ext, pg_cfg, 0.5)
    else:
        poses_opt, _cost = optimize_pose_graph_cg(
            g_ext, pg_cfg, 0.5, cg_iters=int(pg_cfg.cg_iters),
            cg_tol=float(pg_cfg.cg_tol))
    return (), torch.cat([rows.reshape(-1).to(torch.float32),
                          poses_opt.reshape(-1).to(torch.float32)])


# one graph a (B, live candidates, table size, buckets, solver, configs)
_FUSED_ATTEMPT = graphs.Program("fused_attempt_jit", _fused_attempt)


def fused_attempt_jit(tables, pts, nrm, msk, K_lvl: Intrinsics,
                      T_inits: torch.Tensor, n_live: int, graph,
                      cand_i: torch.Tensor, cand_j: torch.Tensor, h: int,
                      w: int, icp_cfg: ICPConfig, pg_cfg: PoseGraphConfig,
                      use_dense: bool, lc_weight: float,
                      eager: bool = False) -> torch.Tensor:
    """The whole loop-closure attempt on the device, without a host sync:
    one replay of a CUDA graph on the card, unless `eager`.

    Projective verification of the B candidates, the acceptance gates
    (`passes_gates_traced`), the candidate edges appended to the bucketed
    graph with weight lc_weight·accept (rejected candidates weigh zero),
    the pose-graph solve (`use_dense`: the host-resolved solver), and the
    flat readback packing.

    Returns flat float32: rows.reshape(-1) ++ poses.reshape(-1) (rows:
    (B, verify.ROW_SIZE); poses: graph.poses.shape).
    """
    return _FUSED_ATTEMPT.run(
        list(tables), list(pts), list(nrm), list(msk), T_inits, graph,
        cand_i, cand_j, eager=eager, K_lvl=K_lvl, n_live=n_live, h=h, w=w,
        icp_cfg=icp_cfg, pg_cfg=pg_cfg, use_dense=use_dense,
        lc_weight=lc_weight)


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


def find_closures(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
) -> tuple[list[Closure], set[tuple[int, int]]]:
    """One propose → verify → gate pass over the keyframes, one readback.

    `keyframes[k].cloud` is node k's stored cloud (None: sparsified away,
    never proposed).  Verification is projective against the retained
    tables when they are uniform and `K` is given, else grid-hash.
    Returns the verified closures and ALL attempted pairs, so a caller can
    skip failed pairs until an optimization moves their initial guesses.
    """
    live, rows, attempted = propose_and_verify(
        keyframes, kf_poses, icp_cfg, pg_cfg, exclude_pairs,
        max_candidates, K)
    if rows is None:
        return [], attempted
    return gate_rows(live, rows.cpu().numpy(), pg_cfg), attempted
