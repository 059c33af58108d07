"""Edge-sharded pose-graph optimization — port of
`tpuslam/backend/distba.py`.

The graph's edges (odometry and loop closures) are split over the mesh
(dist/mesh.py).  Every rank builds the normal system of its block of edges
with the single-device code (`posegraph.edge_normal_system`), one
`all_reduce` a GN round sums the (6N, 6N) systems and their costs, and
every rank solves the summed system with `posegraph.solve_and_update`: the
poses stay the same on every rank.  Plain PyTorch, as the reference is
plain XLA here.

The `cfg.gn_iters` rounds, their all-reduces included, are one CUDA graph
(tpuslam_torch/graphs.py) on a mesh without a group or over NCCL
(`mesh.captures`), as the reference jits its `shard_map`; over gloo they
run op by op.  The padding of the edges stays outside the graph, as the
reference pads outside its jitted `run`.
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
    captures,
    collective_program,
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


def _optimize_spmd(_state, graph: PoseGraph, *, cfg: PoseGraphConfig,
                   huber_delta: float, mesh: Mesh):
    """`posegraph._optimize_dense` on this rank's edges (`graph`'s edge
    arrays), the system all-reduced each round."""
    info = _info_vector(cfg, graph.poses)
    poses = graph.poses
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(cfg.gn_iters):
        H, b, cost = all_reduce_system(mesh, *edge_normal_system(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, huber_delta))
        poses = solve_and_update(poses, graph.node_mask, H, b, cfg)
    return (), (poses, cost)


# the reference's jitted shard_map: one graph a (mesh, cfg, Huber width,
# the graph's buckets), its all-reduces inside, where `captures` allows
_OPTIMIZE_SPMD = collective_program("optimize_pose_graph_spmd",
                                    _optimize_spmd)


def optimize_pose_graph_spmd(graph: PoseGraph, cfg: PoseGraphConfig,
                             mesh: Mesh, huber_delta: float = 0.5,
                             eager: bool = False):
    """Distributed `posegraph.optimize_pose_graph`: the same inputs and
    outputs, (poses (N, 4, 4), the last round's cost ()), whole on every
    rank and on the mesh's device; the edges are split over the mesh.  On
    the card one CUDA graph a key on a mesh without a group or over NCCL
    (`mesh.captures`); over gloo, on the CPU or with `eager` op by op."""
    graph = replicate(graph, mesh)
    edge_i, edge_j, edge_T, edge_w = shard_edges(graph, mesh)
    local = graph._replace(edge_i=edge_i, edge_j=edge_j, edge_T=edge_T,
                           edge_weight=edge_w)
    return _OPTIMIZE_SPMD.run(local, eager=eager or not captures(mesh),
                              cfg=cfg, huber_delta=huber_delta, mesh=mesh)
