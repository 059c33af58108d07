"""Edge-sharded pose-graph optimization — port of
`tpuslam/backend/distba.py`.

The graph's edges (odometry and loop closures) are split over the mesh
(dist/mesh.py).  Every rank builds the normal system of its block of edges
with the single-device code (`posegraph.edge_normal_system`), one
`all_reduce` a GN round sums the (6N, 6N) systems and their costs, and
every rank solves the summed system with `posegraph.solve_and_update`: the
poses stay the same on every rank.  Plain PyTorch, as the reference is
plain XLA here.
"""

from __future__ import annotations

import torch

from tpuslam_torch.backend.posegraph import (
    PoseGraph,
    _info_vector,
    edge_normal_system,
    solve_and_update,
)
from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.dist.mesh import (
    Mesh,
    pad_to_multiple,
    replicate,
    shard_leading,
)


def shard_edges(graph: PoseGraph, mesh: Mesh):
    """This rank's block of the graph's edges, (edge_i, edge_j, edge_T,
    edge_weight), padded to a multiple of the mesh size as the reference
    pads them: a padding edge is the identity between node 0 and itself
    with weight 0, so it adds nothing."""
    d = mesh.size
    n = graph.edge_i.shape[0]
    pad = -(-n // d) * d - n
    edge_T = graph.edge_T
    if pad:
        eye = torch.eye(4, dtype=edge_T.dtype, device=edge_T.device)
        edge_T = torch.cat([edge_T, eye.expand(pad, 4, 4)])
    edges = (pad_to_multiple(graph.edge_i, d), pad_to_multiple(graph.edge_j, d),
             edge_T, pad_to_multiple(graph.edge_weight, d))
    return tuple(shard_leading(e, mesh).contiguous() for e in edges)


def all_reduce_system(mesh: Mesh, H: torch.Tensor, b: torch.Tensor,
                      cost: torch.Tensor):
    """(H, b, cost) summed over the ranks in ONE collective."""
    flat = mesh.all_reduce(torch.cat([H.reshape(-1), b, cost.reshape(1)]))
    m = b.shape[0]
    return flat[:m * m].reshape(m, m), flat[m * m:-1], flat[-1]


def optimize_pose_graph_spmd(graph: PoseGraph, cfg: PoseGraphConfig,
                             mesh: Mesh, huber_delta: float = 0.5):
    """Distributed `posegraph.optimize_pose_graph`: the same inputs and
    outputs, (poses (N, 4, 4), the last round's cost ()), whole on every
    rank and on the mesh's device; the edges are split over the mesh."""
    graph = replicate(graph, mesh)
    edge_i, edge_j, edge_T, edge_w = shard_edges(graph, mesh)
    info = _info_vector(cfg, graph.poses)
    poses = graph.poses
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(cfg.gn_iters):
        H, b, cost = all_reduce_system(mesh, *edge_normal_system(
            poses, edge_i, edge_j, edge_T, edge_w, info, huber_delta))
        poses = solve_and_update(poses, graph.node_mask, H, b, cfg)
    return poses, cost
