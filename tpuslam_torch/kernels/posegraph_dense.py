"""The dense pose-graph solve in one launch — `csrc/posegraph_dense.cu`.

`backend/posegraph.optimize_pose_graph` runs `gn_iters` Gauss-Newton rounds
over a bucketed graph.  On a CUDA tensor whose node bucket is at most
`MAX_NODES` (and whose system fits one block's shared memory) every round
runs inside one launch of the hand kernel; otherwise (a CPU tensor, or a
bucket of 64-256 nodes) the plain twin `posegraph.optimize_dense_reference`
runs op by op and counts `counter.plain()`.  `engages` is that decision, a
function of what the caller can see: the device and the two buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.kernels import _build

counter = _build.LaunchCounter("posegraph_dense")   # csrc/posegraph_dense.cu

MAX_NODES = 32          # the largest bucket whose system fits one block
SMEM_LIMIT = 232448     # bytes of shared memory a block may use (H100)

# The kernel against the twin: the same float32 mathematics summed in
# another order and solved by Cholesky where the twin runs LU, over
# `gn_iters` rounds.  Pose entries (rotations ≤ 1, translations ~1 m) within
# TOL_POSE, ~84 float32 ulps of 1.0; the cost of the last round within
# TOL_COST_REL of the twin's, plus TOL_COST_ABS for a converged graph,
# whose cost (~1e-12) is float32 residual noise.
TOL_POSE = 1e-5
TOL_COST_REL = 1e-4
TOL_COST_ABS = 1e-9


def smem_bytes(nodes: int, edges: int) -> int:
    """Shared memory a launch takes, as the kernel lays it out: H and b
    ((6N + 1)² floats), the transposed panel (6 (6N + 1)), the step (6N),
    the poses (16N), the diagonal factors' inverses (21N), an edge's record
    (43) and indices (4), each node's offset (N + 1), the live count and
    the cost."""
    return 4 * ((6 * nodes + 1) * (6 * nodes + 7) + 44 * nodes + 47 * edges
                + 3)


def engages(device_type: str, nodes: int, edges: int) -> bool:
    """Whether the kernel runs the solve: a CUDA tensor, a node bucket of
    at most `MAX_NODES` and a system that fits the block (up to 389 edges
    at 32 nodes)."""
    return (device_type == "cuda" and 1 <= nodes <= MAX_NODES
            and smem_bytes(nodes, edges) <= SMEM_LIMIT)


def launch(poses: torch.Tensor, node_mask: torch.Tensor,
           edge_i: torch.Tensor, edge_j: torch.Tensor, edge_T: torch.Tensor,
           edge_weight: torch.Tensor, cfg: PoseGraphConfig,
           huber_delta: float):
    """Every Gauss-Newton round in one launch on the current stream:
    returns (poses (N, 4, 4), cost of the last round's linearization
    point), as the twin does."""
    dev = poses.device
    n, e = poses.shape[0], edge_i.shape[0]
    if not engages(dev.type, n, e):
        raise ValueError(f"posegraph_dense: no kernel for {n} nodes and {e} "
                         f"edges on {dev}")
    poses, node_mask, edge_i, edge_j, edge_T, edge_weight = (
        t.contiguous() for t in (poses, node_mask, edge_i, edge_j, edge_T,
                                 edge_weight))
    _build.require(poses, "poses", dtype=torch.float32, shape=(n, 4, 4))
    _build.require(node_mask, "node_mask", dtype=torch.bool, shape=(n,),
                   device=dev)
    for name, t in (("edge_i", edge_i), ("edge_j", edge_j)):
        _build.require(t, name, dtype=torch.int32, shape=(e,), device=dev)
    _build.require(edge_T, "edge_T", dtype=torch.float32, shape=(e, 4, 4),
                   device=dev)
    _build.require(edge_weight, "edge_weight", dtype=torch.float32,
                   shape=(e,), device=dev)
    out = torch.empty_like(poses)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    # the scalars as the twin's float32 ops round them
    info_t, info_r, huber, damping = np.array(
        [cfg.trans_weight, cfg.rot_weight, huber_delta, cfg.damping],
        dtype=np.float32).tolist()
    stream = _build.stream_handle(poses)
    err = _build.library().tpuslam_posegraph_dense(
        poses.data_ptr(), node_mask.data_ptr(), edge_i.data_ptr(),
        edge_j.data_ptr(), edge_T.data_ptr(), edge_weight.data_ptr(), n, e,
        info_t, info_r, huber, damping, int(cfg.gn_iters), out.data_ptr(),
        cost.data_ptr(), stream)
    _build.check_launch(err, "posegraph_dense")
    counter.launched(stream)
    return out, cost
