"""Projective point-to-plane ICP — port of the frame path of `tpuslam/icp.py`.

Per pyramid level (coarsest → finest) an ICP loop runs: transform the
source, one projective row gather (kernels/correspond.py), then
`inner_steps` GN solves against that association, each a reduction to
partials (kernels/gn_partials.py) and an epilogue (kernels/gn_epilogue.py)
that solves, updates the pose and keeps the loop carry on the device.

The reference's `lax.while_loop` exits early once ‖δ‖ ≤ tol.  Here the
loop runs a fixed budget of ⌈max_iters / inner⌉ outer iterations; the
epilogue sets the carry's DONE flag where the reference's predicate fails,
after which every kernel leaves the carry as it is.  Iteration counts and
poses are the reference's, and no tensor is read back to the host inside
the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.config import ICPConfig, Intrinsics
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.correspond import (
    pack_organized_target,
    projective_correspond_packed,
)
from tpuslam_torch.kernels.gn_partials import gn_reduce_partials


class ICPResult(NamedTuple):
    T: torch.Tensor               # (4, 4) estimated src→dst transform
    iters: torch.Tensor           # () int32 iterations executed (last level)
    rms: torch.Tensor             # () inlier RMS point-to-plane residual
    inlier_fraction: torch.Tensor  # () inliers / valid source points
    converged: torch.Tensor       # () bool
    H: torch.Tensor               # (6, 6) final GN information matrix
    num_inliers: torch.Tensor     # () absolute inlier count


class Frame(NamedTuple):
    """One organized depth frame at a single pyramid level."""

    points: torch.Tensor    # (H, W, 3) camera-frame
    normals: torch.Tensor   # (H, W, 3)
    mask: torch.Tensor      # (H, W) bool

    def as_cloud(self) -> PointCloud:
        h, w, _ = self.points.shape
        nm = self.normals.reshape(h * w, 3)
        return PointCloud(
            points=self.points.reshape(h * w, 3),
            normals=nm,
            mask=self.mask.reshape(h * w) & (torch.sum(nm * nm, dim=-1) > 0.5),
        )


def subsample_frame(frame: Frame, factor: int = 2) -> Frame:
    """Stride-subsample an organized frame (pyramid level down)."""
    return Frame(
        points=frame.points[::factor, ::factor],
        normals=frame.normals[::factor, ::factor],
        mask=frame.mask[::factor, ::factor],
    )


def subsample_source(frame: Frame, factor: int) -> PointCloud:
    """Decimate the SOURCE side of an alignment (ICPConfig.finest_subsample):
    1 → all pixels; 2 → every other row; 4 → one stride-2 grid."""
    if factor == 1:
        return frame.as_cloud()
    if factor == 2:
        return Frame(points=frame.points[0::2], normals=frame.normals[0::2],
                     mask=frame.mask[0::2]).as_cloud()
    if factor == 4:
        return subsample_frame(frame, 2).as_cloud()
    raise ValueError(f"finest_subsample must be 1, 2 or 4; got {factor}")


def select_level_source(src_pyr, li: int, cfg: ICPConfig) -> PointCloud:
    """Per-level SOURCE cloud under the decimation knobs (factor 4 uses the
    next-coarser pyramid frame when one exists, as the reference does)."""
    lvl_sub = cfg.level_subsample
    if lvl_sub is not None and li < len(lvl_sub):
        factor = int(lvl_sub[li])
    else:
        factor = int(cfg.finest_subsample) if li == 0 else 1
    if factor == 4 and li + 1 < len(src_pyr):
        return src_pyr[li + 1].as_cloud()
    return subsample_source(src_pyr[li], factor)


def build_pyramid(frame: Frame, levels: int):
    """[finest, ..., coarsest] stride-2 pyramid."""
    pyr = [frame]
    for _ in range(levels - 1):
        pyr.append(subsample_frame(pyr[-1]))
    return pyr


def _table_dtype(cfg: ICPConfig) -> torch.dtype:
    return {"float16": torch.float16, "float32": torch.float32}[
        cfg.packed_dtype]


def pack_pyramid(pyr, cfg: ICPConfig) -> tuple:
    """Pack every level of an organized pyramid into row-gather tables."""
    dtype = _table_dtype(cfg)
    return tuple(pack_organized_target(f.points, f.normals, f.mask,
                                       dtype=dtype) for f in pyr)


def _icp_loop(packed: torch.Tensor, height: int, width: int, K: Intrinsics,
              src: PointCloud, T0: torch.Tensor, cfg: ICPConfig,
              max_iters: int, inner_steps: int | None = None,
              tol_delta: float | None = None) -> ICPResult:
    """Projective ICP against one packed table, carry on the device."""
    inner = max(1, int(cfg.inner_steps if inner_steps is None
                       else inner_steps))
    tol = cfg.tol_delta if tol_delta is None else tol_delta
    tol_sq = tol ** 2
    outer = -(-max_iters // inner) if max_iters > 0 else 0
    num_valid_src = torch.sum(src.mask.to(torch.float32))
    carry = ep.init_carry(T0, max_iters)
    for _ in range(outer):
        T = carry[ep.T_SLICE].reshape(4, 4)
        x = se3.transform_points(T, src.points)
        n_rot = se3.rotate_vectors(T, src.normals)
        corr = projective_correspond_packed(
            x, src.mask, packed, height, width, K, cfg.max_corr_dist,
            src_normals_in_dst=n_rot, normal_dot_min=cfg.normal_dot_min,
            done=carry)
        for k in range(inner):
            if k > 0:
                # frozen association, source re-transformed (inner/outer ICP)
                x = se3.transform_points(carry[ep.T_SLICE].reshape(4, 4),
                                         src.points)
            partials = gn_reduce_partials(x, corr.q, corr.n, corr.w,
                                          cfg.huber_delta, done=carry)
            carry, _ = ep.gn_epilogue(
                partials, carry, num_valid_src, cfg.damping, cfg.damping_abs,
                cfg.max_trans_step, cfg.max_rot_step, is_last=k == inner - 1,
                inner=inner, max_iters=max_iters, tol_sq=tol_sq)
    return ICPResult(
        T=carry[ep.T_SLICE].reshape(4, 4),
        iters=carry[ep.IT].to(torch.int32),
        rms=carry[ep.RMS],
        inlier_fraction=carry[ep.INLIER_FRACTION],
        converged=carry[ep.DELTA_SQ] <= tol_sq,
        H=carry[ep.H_SLICE].reshape(6, 6),
        num_inliers=carry[ep.NUM_INLIERS],
    )


def align_frames_packed(src_pyr, dst_packed: tuple, K: Intrinsics,
                        T0: torch.Tensor, cfg: ICPConfig) -> ICPResult:
    """Coarse-to-fine projective ICP against pre-packed target tables.

    `dst_packed[li]` is `pack_pyramid`'s table for level `li`; the target's
    image geometry is taken from `src_pyr` (both sides of a tracking pair
    share the pyramid shapes).
    """
    if cfg.fused_gn:
        raise NotImplementedError(
            "ICPConfig.fused_gn: the fused GN kernel is not ported yet")
    T = T0
    result = None
    for li in range(len(src_pyr) - 1, -1, -1):  # coarsest → finest
        K_l = K.scaled(1.0 / (2 ** li))
        src_cloud = select_level_source(src_pyr, li, cfg)
        h, w, _ = src_pyr[li].points.shape
        packed = dst_packed[li]
        if packed.shape[0] != h * w:
            raise ValueError(
                f"level {li}: target table has {packed.shape[0]} rows but "
                f"source frame is {h}×{w} — align_frames_packed requires "
                f"both sides of the pair to share pyramid shapes")
        iters = (cfg.iters_per_level[li] if li < len(cfg.iters_per_level)
                 else cfg.max_iters)
        ipl, tpl = cfg.inner_steps_per_level, cfg.tol_delta_per_level
        inner = ipl[li] if ipl is not None and li < len(ipl) else None
        tol = tpl[li] if tpl is not None and li < len(tpl) else None
        result = _icp_loop(packed, h, w, K_l, src_cloud, T, cfg, iters,
                           inner_steps=inner, tol_delta=tol)
        T = result.T
    return result


def align_frames(src_pyr, dst_pyr, K: Intrinsics, T0: torch.Tensor,
                 cfg: ICPConfig) -> ICPResult:
    """Coarse-to-fine projective ICP between two organized frames.

    Estimates T s.t. `dst_point ≈ T · src_point` (pose of the src camera in
    the dst camera frame).  Packs the target per call; keyframe tracking
    packs once with `pack_pyramid` and calls `align_frames_packed`.
    """
    return align_frames_packed(src_pyr, pack_pyramid(dst_pyr, cfg), K, T0,
                               cfg)
