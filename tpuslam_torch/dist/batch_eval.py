"""Data-parallel batched alignment — port of `tpuslam/dist/batch_eval.py`.

ICP over a batch of frame pairs (parameter sweeps, throughput runs,
multi-sequence evaluation), the batch split over the mesh's ranks
(dist/mesh.py): each rank aligns its own pairs with no traffic between
ranks, and one `all_gather` at the end gives every rank the whole batch's
results in batch order.

Where the reference `vmap`s `icp.align_frames` (each member stops with its
own result), a rank here runs `icp.align_frames` on its members one after
another, with its kernels on the card (`correspond`, `gn_step`).  Each
member's loops have a fixed budget and a DONE flag on the device (icp.py),
so nothing reads back to the host: the members and the `all_gather` are
one CUDA graph, as the reference jits its `vmap`, on a mesh without a
group or over NCCL (`mesh.captures`); over gloo they run op by op.
"""

from __future__ import annotations

import torch

from tpuslam_torch.config import ICPConfig, Intrinsics
from tpuslam_torch.dist.mesh import (
    Mesh,
    captures,
    collective_program,
    shard_leading,
    tree_map,
)
from tpuslam_torch.icp import ICPResult, align_frames

# an ICPResult's fields as one float32 row, for the one all_gather
_WIDTHS = {"T": 16, "iters": 1, "rms": 1, "inlier_fraction": 1,
           "converged": 1, "H": 36, "num_inliers": 1}


def shard_batch(tree, mesh: Mesh):
    """This rank's block of every tensor's leading (batch) dimension, on
    its device; the batch must be a multiple of the mesh size."""
    return tree_map(lambda t: shard_leading(t, mesh), tree)


def _member(tree, b: int):
    return tree_map(lambda t: t[b], tree)


def _pack(res: ICPResult) -> torch.Tensor:
    return torch.cat([getattr(res, f).reshape(-1).to(torch.float32)
                      for f in ICPResult._fields])


def _unpack(rows: torch.Tensor) -> ICPResult:
    out, c = {}, 0
    for f in ICPResult._fields:
        out[f] = rows[:, c:c + _WIDTHS[f]]
        c += _WIDTHS[f]
    return ICPResult(
        T=out["T"].reshape(-1, 4, 4), iters=out["iters"][:, 0].to(torch.int32),
        rms=out["rms"][:, 0], inlier_fraction=out["inlier_fraction"][:, 0],
        converged=out["converged"][:, 0] != 0, H=out["H"].reshape(-1, 6, 6),
        num_inliers=out["num_inliers"][:, 0])


def _batched_program(_state, src_pyrs, dst_pyrs, T0s, *, K: Intrinsics,
                     cfg: ICPConfig, mesh: Mesh):
    rows = torch.stack([_pack(align_frames(
        _member(src_pyrs, b), _member(dst_pyrs, b), K, T0s[b], cfg))
        for b in range(T0s.shape[0])])
    return (), _unpack(mesh.all_gather(rows))


# the reference's jitted vmap: one graph a (mesh, K, cfg, the batch size
# and the pyramids' shapes), its all-gather inside, where `captures` allows
_BATCHED = collective_program("batched_align_frames", _batched_program)


def make_batched_aligner(mesh: Mesh, cfg: ICPConfig):
    """`fn(src_pyrs, dst_pyrs, K, T0s, eager=False) -> ICPResult` with a
    leading batch dimension on every field.

    Every tensor of the src / dst pyramids and of T0s carries a leading
    batch dimension and is this rank's block of it (`shard_batch`); the
    result holds the whole batch, in batch order, on every rank.  On the
    card one CUDA graph a key on a mesh without a group or over NCCL
    (`mesh.captures`); over gloo, on the CPU or with `eager` op by op.
    """
    graphed = captures(mesh)

    def fn(src_pyrs, dst_pyrs, K: Intrinsics, T0s: torch.Tensor,
           eager: bool = False) -> ICPResult:
        return _BATCHED.run(tuple(src_pyrs), tuple(dst_pyrs), T0s,
                            eager=eager or not graphed, K=K, cfg=cfg,
                            mesh=mesh)

    return fn
