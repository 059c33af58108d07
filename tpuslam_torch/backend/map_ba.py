"""Schur-complement map bundle adjustment — port of
`tpuslam/backend/map_ba.py`.

Keyframe poses {T_i} and map control points {m_j} are refined jointly
against point-to-plane observations

    r_o = n_j · (T_i · p_o) − n_j · m_j − s_j ,

where p_o is a keyframe-cloud point matched to control point j and s_j
moves the control point along its own normal.  Each landmark has that one
degree of freedom, so its block is the scalar a_j = Σ w and the Schur
complement needs no per-landmark inverse:

    H_red = H_pp − Uᵀ diag(1/a) U ,   b_red = b_p − Uᵀ (c / a) ,

with U ∈ R^{M×6N} the pose-landmark coupling.  H_pp is block-diagonal; the
pose-pose fill-in is one (6N, M)·(M, 6N) product (`torch.matmul`, TF32
off as the package sets it).  The pose-graph edges enter as priors
(backend/posegraph.edge_normal_system), node 0 carries the gauge prior,
and after each GN round the landmarks are back-substituted.

`build_map_ba_problem` associates every keyframe point with its nearest
control point by the grid probe: all N·C points, moved into the world,
in one pose-less launch of the grid kernel (kernels/correspond.py).  The
rest is plain PyTorch, as the reference has no Pallas kernel here.
Nothing reads a tensor back to the host, so `optimize_map_ba`'s
`gn_iters` rounds are one CUDA graph on the card (tpuslam_torch/graphs.py),
as the reference jits them; the problem's build runs op by op.

`optimize_map_ba_spmd` shards the landmarks and their observations over
the mesh (dist/mesh.py; `partition_observations` buckets the observations
by the rank that owns their landmark, on the host) and the graph's edges
as `backend/distba.py` does.  Each rank eliminates its own landmarks,
adds its edges' system, and one `all_reduce` a GN round sums the reduced
(6N, 6N) systems and costs; every rank solves the sum and back-substitutes
only its own landmarks, so no landmark crosses ranks until the end.  Its
rounds and the closing `all_gather` of the map are one CUDA graph on a
mesh without a group or over NCCL (`mesh.captures`); over gloo they run
op by op.  The partition stays on the host, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.backend.posegraph import (
    PoseGraph,
    _info_vector,
    _prior,
    _scatter_add,
    edge_normal_system,
)
from tpuslam_torch.backend.distba import all_reduce_system, shard_edges
from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.dist.mesh import (
    Mesh,
    captures,
    collective_program,
    replicate,
)
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels.correspond import (
    _INVALID_KEY,
    build_grid_index,
    grid_hash_correspond,
)


class MapBAProblem(NamedTuple):
    """Fixed-capacity frame-to-map BA problem (static shapes).

    Each observation row couples one keyframe pose (obs_pose) with one map
    control point (obs_map); padding rows carry obs_w = 0.
    """

    map_points: torch.Tensor    # (M, 3) world-frame control points
    map_normals: torch.Tensor   # (M, 3) unit normals (world frame)
    map_mask: torch.Tensor      # (M,) bool
    obs_pose: torch.Tensor      # (O,) int32 keyframe index
    obs_map: torch.Tensor       # (O,) int32 control-point index
    obs_p: torch.Tensor         # (O, 3) observed point in KEYFRAME frame
    obs_w: torch.Tensor         # (O,) float ≥ 0 (0 = unused slot)


def _huber_w(r: torch.Tensor, delta: float) -> torch.Tensor:
    ar = torch.abs(r)
    return torch.where(ar <= delta, 1.0, delta / torch.clamp(ar, min=1e-12))


def map_ba_partials(poses: torch.Tensor, prob: MapBAProblem,
                    huber_delta: float):
    """The Schur ingredients of one observation set: (H_pp (6N, 6N)
    block-diagonal, b_p (6N,), U (M, 6N), a (M,), c (M,), cost ())."""
    N = poses.shape[0]
    M = prob.map_points.shape[0]
    op, om = prob.obs_pose.long(), prob.obs_map.long()
    T_i = poses[op]                                  # (O, 4, 4)
    x = torch.einsum("oab,ob->oa", T_i[:, :3, :3], prob.obs_p) \
        + T_i[:, :3, 3]
    n = prob.map_normals[om]
    m = prob.map_points[om]
    r = torch.sum(n * (x - m), dim=-1)               # (O,)
    w = prob.obs_w * _huber_w(r, huber_delta)
    J = torch.cat([n, torch.cross(x, n, dim=-1)], dim=-1)   # (O, 6) [ρ, φ]
    wJ = J * w[:, None]
    zeros = dict(dtype=poses.dtype, device=poses.device)

    # H_pp: block-diagonal per pose, a segment sum of w·J Jᵀ over obs_pose
    blocks = _scatter_add(torch.zeros((N, 6, 6), **zeros), (op,),
                          torch.einsum("oi,oj->oij", wJ, J))
    H_pp = _embed_block_diag(blocks)
    b_p = _scatter_add(torch.zeros((N, 6), **zeros), (op,),
                       wJ * r[:, None]).reshape(6 * N)
    # landmark scalars and the coupling U[j, 6i:6i+6] = Σ w·J
    a = _scatter_add(torch.zeros((M,), **zeros), (om,), w)
    c = _scatter_add(torch.zeros((M,), **zeros), (om,), w * r)
    U = _scatter_add(torch.zeros((M * N, 6), **zeros), (om * N + op,), wJ)
    U = U.reshape(M, 6 * N)
    cost = torch.sum(w * r * r)
    return H_pp, b_p, U, a, c, cost


def _embed_block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 6, 6) per-pose blocks → dense (6N, 6N) block-diagonal matrix."""
    N = blocks.shape[0]
    eye = torch.eye(N, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("ij,ikl->ikjl", eye, blocks).reshape(6 * N, 6 * N)


def _inv_a(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 1e-9, 1.0 / torch.clamp(a, min=1e-9), 0.0)


def schur_reduce(H_pp, b_p, U, a, c):
    """Eliminate the per-landmark scalar blocks (unobserved ones weigh 0)."""
    inv_a = _inv_a(a)
    H_red = H_pp - (U * inv_a[:, None]).T @ U
    b_red = b_p - U.T @ (inv_a * c)
    return H_red, b_red


def backsub_landmarks(delta_p: torch.Tensor, U, a, c):
    """ds_j = (c_j + u_jᵀ δ) / a_j (zero where unobserved)."""
    return _inv_a(a) * (c + U @ delta_p)


def _solve_gauged(poses, node_mask, H, b, cfg: PoseGraphConfig):
    """Gauge prior on node 0 + LM damping; returns the twist step (6N,),
    zero when the solve is not finite."""
    prior = _prior(node_mask, cfg).repeat_interleave(6)
    H = H + torch.diag(prior + cfg.damping * torch.abs(torch.diagonal(H)))
    x, _ = torch.linalg.solve_ex(H, b)
    delta = -x
    return torch.where(torch.all(torch.isfinite(delta)), delta, 0.0)


def _optimize_map_ba(_state, graph: PoseGraph, prob: MapBAProblem, *,
                     cfg: PoseGraphConfig, huber_delta: float,
                     edge_huber_delta: float):
    info = _info_vector(cfg, graph.poses)
    poses, map_pts = graph.poses, prob.map_points
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(cfg.gn_iters):
        p = prob._replace(map_points=map_pts)
        H_pp, b_p, U, a, c, cost_map = map_ba_partials(poses, p, huber_delta)
        H_red, b_red = schur_reduce(H_pp, b_p, U, a, c)
        H_e, b_e, cost_e = edge_normal_system(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, edge_huber_delta)
        delta = _solve_gauged(poses, graph.node_mask, H_red + H_e,
                              b_red + b_e, cfg)
        ds = backsub_landmarks(delta, U, a, c)
        poses = se3.exp(delta.reshape(-1, 6)) @ poses
        map_pts = map_pts + ds[:, None] * prob.map_normals
        cost = cost_map + cost_e
    return (), (poses, map_pts, cost)


_OPTIMIZE_MAP_BA = graphs.Program("optimize_map_ba", _optimize_map_ba)


def optimize_map_ba(graph: PoseGraph, prob: MapBAProblem,
                    cfg: PoseGraphConfig, huber_delta: float = 0.05,
                    edge_huber_delta: float = 0.5, eager: bool = False):
    """Joint pose-graph + frame-to-map GN via the Schur complement (one
    device), `cfg.gn_iters` rounds: one CUDA graph on the card (keyed by
    the graph's buckets, the problem's shapes, cfg and the Huber widths)
    unless `eager`.

    Returns (poses (N, 4, 4), map_points (M, 3) refined, the last round's
    cost ()).  The graph's edges act as odometry / loop-closure priors; the
    map observations tie every keyframe to the shared surface.
    """
    return _OPTIMIZE_MAP_BA.run(graph, prob, eager=eager, cfg=cfg,
                                huber_delta=huber_delta,
                                edge_huber_delta=edge_huber_delta)


def partition_observations(prob: MapBAProblem, n_dev: int,
                           cap_factor: float = 1.5):
    """Bucket the observations by the rank that owns their landmark (ranks
    own contiguous blocks of ⌈M/D⌉ landmarks), on the host, exactly as the
    reference does.

    Returns (the problem with M padded to a multiple of `n_dev`, the
    observations reordered into `n_dev` buckets of one capacity
    ⌈O/D·cap_factor⌉ and `obs_map` rewritten to OWNER-LOCAL indices;
    landmarks a rank; the count of live observations dropped because their
    bucket was full), its tensors on `prob`'s device.  Weight-0 rows are
    left out of the buckets.
    """
    M = prob.map_points.shape[0]
    m_per = -(-M // n_dev)
    pad = m_per * n_dev - M
    mp = prob.map_points.cpu().numpy()
    mn = prob.map_normals.cpu().numpy()
    mm = prob.map_mask.cpu().numpy()
    if pad:
        mp = np.concatenate([mp, np.zeros((pad, 3), mp.dtype)])
        mn = np.concatenate([mn, np.zeros((pad, 3), mn.dtype)])
        mm = np.concatenate([mm, np.zeros((pad,), bool)])
    obs_pose = prob.obs_pose.cpu().numpy()
    obs_map = prob.obs_map.cpu().numpy()
    obs_p = prob.obs_p.cpu().numpy()
    obs_w = prob.obs_w.cpu().numpy()
    live = obs_w > 0
    owner = obs_map // m_per
    cap = int(np.ceil(obs_pose.shape[0] / n_dev * cap_factor))
    out_pose = np.zeros((n_dev, cap), np.int32)
    out_map = np.zeros((n_dev, cap), np.int32)
    out_p = np.zeros((n_dev, cap, 3), obs_p.dtype)
    out_w = np.zeros((n_dev, cap), obs_w.dtype)
    dropped = 0
    for d in range(n_dev):
        sel = np.nonzero(live & (owner == d))[0]
        if sel.shape[0] > cap:
            dropped += sel.shape[0] - cap
            sel = sel[:cap]
        k = sel.shape[0]
        out_pose[d, :k] = obs_pose[sel]
        out_map[d, :k] = obs_map[sel] - d * m_per
        out_p[d, :k] = obs_p[sel]
        out_w[d, :k] = obs_w[sel]
    dev = prob.map_points.device
    new_prob = MapBAProblem(*(torch.as_tensor(a, device=dev) for a in (
        mp, mn, mm, out_pose.reshape(-1), out_map.reshape(-1),
        out_p.reshape(-1, 3), out_w.reshape(-1))))
    return new_prob, m_per, dropped


def _optimize_map_ba_spmd(_state, graph: PoseGraph, local: MapBAProblem,
                          *, cfg: PoseGraphConfig, huber_delta: float,
                          edge_huber_delta: float, mesh: Mesh,
                          landmarks: int):
    """The rounds on this rank's landmarks, observations and edges
    (`graph`'s edge arrays), then the map gathered and cut to the
    problem's `landmarks`."""
    info = _info_vector(cfg, graph.poses)
    poses, map_pts = graph.poses, local.map_points
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(cfg.gn_iters):
        p = local._replace(map_points=map_pts)
        H_pp, b_p, U, a, c, cost_map = map_ba_partials(poses, p, huber_delta)
        # this rank's landmarks eliminated here, then the one all-reduce
        H_red, b_red = schur_reduce(H_pp, b_p, U, a, c)
        H_e, b_e, cost_e = edge_normal_system(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, edge_huber_delta)
        H, b, cost = all_reduce_system(mesh, H_red + H_e, b_red + b_e,
                                       cost_map + cost_e)
        delta = _solve_gauged(poses, graph.node_mask, H, b, cfg)
        ds = backsub_landmarks(delta, U, a, c)     # our landmarks only
        poses = se3.exp(delta.reshape(-1, 6)) @ poses
        map_pts = map_pts + ds[:, None] * local.map_normals
    return (), (poses, mesh.all_gather(map_pts)[:landmarks], cost)


# the reference's jitted shard_map: one graph a (mesh, cfg, Huber widths,
# the graph's buckets, landmarks a rank, the observations' capacity, the
# problem's landmarks), its all-reduces and all-gather inside, where
# `captures` allows
_OPTIMIZE_MAP_BA_SPMD = collective_program("optimize_map_ba_spmd",
                                           _optimize_map_ba_spmd)


def optimize_map_ba_spmd(graph: PoseGraph, prob: MapBAProblem,
                         cfg: PoseGraphConfig, mesh: Mesh,
                         huber_delta: float = 0.05,
                         edge_huber_delta: float = 0.5,
                         eager: bool = False):
    """Distributed `optimize_map_ba`: the same inputs and outputs (poses
    (N, 4, 4), map points (M, 3), the last round's cost ()), whole on every
    rank and on the mesh's device.

    The landmarks and their observations are split by
    `partition_observations`, the edges by `distba.shard_edges`, on the
    host.  The sums of the ranks' partial systems are the single-device
    sums up to the order of float additions; observations over a bucket's
    capacity are dropped, as in the reference.  On the card the rounds and
    the gather are one CUDA graph a key on a mesh without a group or over
    NCCL (`mesh.captures`); over gloo, on the CPU or with `eager` op by op.
    """
    M = prob.map_points.shape[0]
    sprob, m_per, _dropped = partition_observations(prob, mesh.size)
    cap = sprob.obs_w.shape[0] // mesh.size
    lm = slice(mesh.rank * m_per, (mesh.rank + 1) * m_per)
    ob = slice(mesh.rank * cap, (mesh.rank + 1) * cap)
    graph = replicate(graph, mesh)
    local = replicate(MapBAProblem(
        map_points=sprob.map_points[lm], map_normals=sprob.map_normals[lm],
        map_mask=sprob.map_mask[lm], obs_pose=sprob.obs_pose[ob],
        obs_map=sprob.obs_map[ob], obs_p=sprob.obs_p[ob],
        obs_w=sprob.obs_w[ob]), mesh)
    edge_i, edge_j, edge_T, edge_w = shard_edges(graph, mesh)
    graph = graph._replace(edge_i=edge_i, edge_j=edge_j, edge_T=edge_T,
                           edge_weight=edge_w)
    return _OPTIMIZE_MAP_BA_SPMD.run(
        graph, local, eager=eager or not captures(mesh), cfg=cfg,
        huber_delta=huber_delta, edge_huber_delta=edge_huber_delta,
        mesh=mesh, landmarks=M)


def build_map_ba_problem(kf_poses: torch.Tensor, kf_points: torch.Tensor,
                         kf_mask: torch.Tensor, control_points: torch.Tensor,
                         control_normals: torch.Tensor,
                         control_mask: torch.Tensor, max_dist: float,
                         kf_ids: torch.Tensor | None = None) -> MapBAProblem:
    """Associate every keyframe-cloud point with its nearest map control
    point (the grid probe) and emit fixed-capacity observations.

    The probe returns the match's position in the sorted control array
    (`Correspondence.idx`), so the problem's landmarks are the index's
    rows.  Where the reference maps the probe over the keyframes, this
    moves all N·C points into the world and probes them in one launch.

    Args:
      kf_poses: (N, 4, 4) world←keyframe.
      kf_points: (N, C, 3) per-keyframe downsampled clouds (keyframe frame).
      kf_mask: (N, C) validity.
      control_*: (M, ...) map control points / normals in the world frame.
      max_dist: association gate (m), also the index's cell.
      kf_ids: optional (N,) int32 pose-graph node id of each keyframe row,
        when the rows are a subset of the graph's nodes (default 0..N-1).
    """
    N, C, _ = kf_points.shape
    ctrl = PointCloud(points=control_points, normals=control_normals,
                      mask=control_mask)
    index = build_grid_index(ctrl, cell=float(max_dist))
    x = se3.transform_points(kf_poses, kf_points).reshape(N * C, 3)
    corr = grid_hash_correspond(x.contiguous(),
                                kf_mask.reshape(N * C).contiguous(), index,
                                max_dist)
    idx = torch.where(corr.w > 0, corr.idx, 0).to(torch.int32)
    if kf_ids is None:
        kf_ids = torch.arange(N, dtype=torch.int32, device=kf_points.device)
    return MapBAProblem(
        map_points=index.points.contiguous(),
        map_normals=index.normals.contiguous(),
        map_mask=index.keys != _INVALID_KEY,
        obs_pose=kf_ids.to(torch.int32).repeat_interleave(C),
        obs_map=idx,
        obs_p=kf_points.reshape(N * C, 3),
        obs_w=corr.w,
    )
