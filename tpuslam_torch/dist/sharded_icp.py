"""Point-sharded ICP — port of `tpuslam/dist/sharded_icp.py`.

The source cloud's points are sharded over the mesh (dist/mesh.py); the
organized target is whole on every rank (one depth image a level, packed
once into its row table).  Every rank runs the same coarse-to-fine loop on
its point shard, and the only traffic between ranks is one `all_reduce`
of the (G, 32) GN partials a solve: after it every rank solves the same
system, so the pose is the same on every rank and is never broadcast.

Each outer iteration is the posed association (kernels/correspond.py, the
source moved by the carry's pose in the kernel) on the shard, then for each
of the `inner` solves the posed reduction (kernels/gn_partials.py), the
all-reduce and the epilogue (kernels/gn_epilogue.py), which keeps the
carry — pose, stats and a DONE flag — on the device.  This is the ring
ICP's solve path (dist/ring_map.py) with the projective association in
place of the ring hops, and `icp._icp_loop`'s fixed budget of
⌈max_iters/inner⌉ outer iterations: every rank runs the same number of
collectives whatever its data, and nothing in a level reads back to the
host.  (Only a one-rank mesh on the CPU stops at DONE, as `_icp_loop`
does.)
"""

from __future__ import annotations

import torch

from tpuslam_torch.config import ICPConfig, Intrinsics
from tpuslam_torch.dist.mesh import (
    Mesh,
    captures,
    collective_program,
    pad_to_multiple,
    replicate,
    shard_cloud,
)
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import (
    ICPResult,
    _result,
    pack_pyramid,
    select_level_source,
)
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.correspond import (
    correspondence_buffers,
    projective_correspond_at_pose,
)
from tpuslam_torch.kernels.gn_partials import gn_reduce_partials_at_pose


def _icp_level_spmd(local: PointCloud, packed: torch.Tensor, height: int,
                    width: int, K: Intrinsics, T0: torch.Tensor,
                    cfg: ICPConfig, mesh: Mesh, max_iters: int,
                    inner_steps: int | None, tol_delta: float | None
                    ) -> ICPResult:
    """One pyramid level on this rank's point shard `local`."""
    inner = max(1, int(cfg.inner_steps if inner_steps is None
                       else inner_steps))
    tol = cfg.tol_delta if tol_delta is None else tol_delta
    tol_sq = tol ** 2
    outer = -(-max_iters // inner) if max_iters > 0 else 0
    points = local.points.contiguous()
    normals = local.normals.contiguous()
    mask = local.mask.contiguous()
    num_valid_src = mesh.all_reduce(torch.sum(mask.to(torch.float32)))
    carry = ep.init_carry(T0, max_iters)
    may_stop = mesh.size == 1 and carry.device.type == "cpu"
    corr = correspondence_buffers(points.shape[0], points.device)
    for _ in range(outer):
        if may_stop and bool(carry[ep.DONE] != 0):
            break
        projective_correspond_at_pose(
            points, mask, normals, packed, height, width, K,
            cfg.max_corr_dist, cfg.normal_dot_min, carry, out=corr)
        for k in range(inner):
            # this shard's partial system at the carry's current pose,
            # completed by THE collective; every rank then solves it
            partials = mesh.all_reduce(gn_reduce_partials_at_pose(
                points, corr.q, corr.n, corr.w, carry[ep.T_SLICE],
                cfg.huber_delta, done=carry))
            carry, _ = ep.gn_epilogue(
                partials, carry, num_valid_src, cfg.damping, cfg.damping_abs,
                cfg.max_trans_step, cfg.max_rot_step, is_last=k == inner - 1,
                inner=inner, max_iters=max_iters, tol_sq=tol_sq)
    return _result(carry, tol_sq)


def align_frames_spmd(src_pyr, dst_pyr, K: Intrinsics, T0: torch.Tensor,
                      cfg: ICPConfig, mesh: Mesh) -> ICPResult:
    """Coarse-to-fine projective ICP with the source points sharded.

    The semantics of `icp.align_frames` (the per-level source decimation,
    iteration caps, inner steps and tolerances): the source of each level
    is padded to a multiple of 8·D with mask=False rows, which the
    all-reduced system ignores, and this rank takes its contiguous block.
    `src_pyr`, `dst_pyr` and `T0` are whole on every rank; they are moved
    to the mesh's device.  The result is whole on every rank.
    """
    src_pyr, dst_pyr, T = replicate((src_pyr, dst_pyr, T0), mesh)
    packed_pyr = pack_pyramid(dst_pyr, cfg)
    mult = 8 * mesh.size
    result = None
    for li in range(len(src_pyr) - 1, -1, -1):     # coarsest → finest
        cloud = select_level_source(src_pyr, li, cfg)
        local = shard_cloud(PointCloud(
            points=pad_to_multiple(cloud.points, mult),
            normals=pad_to_multiple(cloud.normals, mult),
            mask=pad_to_multiple(cloud.mask, mult, fill=False)), mesh)
        h, w, _ = dst_pyr[li].points.shape
        iters = (cfg.iters_per_level[li] if li < len(cfg.iters_per_level)
                 else cfg.max_iters)
        ipl, tpl = cfg.inner_steps_per_level, cfg.tol_delta_per_level
        inner = ipl[li] if ipl is not None and li < len(ipl) else None
        tol = tpl[li] if tpl is not None and li < len(tpl) else None
        result = _icp_level_spmd(local, packed_pyr[li], h, w,
                                 K.scaled(1.0 / (2 ** li)), T, cfg, mesh,
                                 iters, inner, tol)
        T = result.T
    return result


def _align_spmd_program(_state, src_pyr, dst_pyr, T0, *, K: Intrinsics,
                        cfg: ICPConfig, mesh: Mesh):
    return (), align_frames_spmd(src_pyr, dst_pyr, K, T0, cfg, mesh)


# the reference's jitted SPMD aligner: one graph a (mesh, K, cfg, the
# pyramids' shapes), its all-reduces inside, where `captures` allows
_ALIGN_SPMD = collective_program("align_frames_spmd", _align_spmd_program)


def make_aligned_spmd_fn(mesh: Mesh, cfg: ICPConfig):
    """`fn(src_pyr, dst_pyr, K, T0, eager=False) -> ICPResult`:
    `align_frames_spmd` on this mesh and config, its result whole on every
    rank.  On the card one CUDA graph a key on a mesh without a group or
    over NCCL (`mesh.captures`); over gloo, on the CPU or with `eager` op
    by op."""
    graphed = captures(mesh)

    def fn(src_pyr, dst_pyr, K: Intrinsics, T0: torch.Tensor,
           eager: bool = False) -> ICPResult:
        return _ALIGN_SPMD.run(tuple(src_pyr), tuple(dst_pyr), T0,
                               eager=eager or not graphed, K=K, cfg=cfg,
                               mesh=mesh)

    return fn
