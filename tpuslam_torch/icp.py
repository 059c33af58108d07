"""Point-to-plane ICP — port of `tpuslam/icp.py`.

Per pyramid level (coarsest → finest) an ICP loop runs, each outer
iteration: one association at the carry's pose (one launch that
transforms the source itself: the projective row gather of
kernels/correspond.py against an organized target, or the 27-cell grid
probe against a sorted index), then `inner_steps` GN solves against that
association, each one launch (kernels/gn_step.py) that transforms the
source by the current pose, reduces, solves, updates the pose and keeps
the loop carry on the device.

The reference's `lax.while_loop` exits early once ‖δ‖ ≤ tol.  Here the
loop runs a fixed budget of ⌈max_iters / inner⌉ outer iterations; the
epilogue sets the carry's DONE flag where the reference's predicate fails,
after which every kernel leaves the carry as it is.  Iteration counts and
poses are the reference's, and no tensor is read back to the host inside
the loop.  (On CPU tensors, where reading the flag waits for nothing, the
loop stops at DONE: the remaining iterations would leave the carry as it
is.)

With `ICPConfig.fused_gn` each GN solve of a projective loop is one launch
of the fused kernel instead (kernels/gn_fused.py: the association's row,
its gates, the residual, Huber, the reduction, the solve and the carry
update), and an outer iteration issues nothing else.  The unorganized
paths (`align_to_index`, `align_clouds`) have no fused form.

The reference's jitted entry points are CUDA graphs here
(tpuslam_torch/graphs.py), one a key, op by op on the CPU or with
`eager=True`: `align_frames_jit`, `align_clouds_jit` (the index build
inside), and `align_map_to_frame_jit` / `align_to_index_jit`, whose graphs
the SLAM system's map refinements replay too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import ICPConfig, Intrinsics
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.backproject import project
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.correspond import (
    GridIndex,
    brute_force_correspond,
    build_grid_index_jit,
    correspondence_buffers,
    grid_correspond_at_pose,
    pack_organized_target,
    projective_correspond_at_pose,
)
from tpuslam_torch.kernels.gn_fused import gate_buffer, gn_fused_step
from tpuslam_torch.kernels.gn_step import gn_step


class ICPResult(NamedTuple):
    T: torch.Tensor               # (4, 4) estimated src→dst transform
    iters: torch.Tensor           # () int32 iterations executed (last level)
    rms: torch.Tensor             # () inlier RMS point-to-plane residual
    inlier_fraction: torch.Tensor  # () inliers / valid source points
    converged: torch.Tensor       # () bool
    H: torch.Tensor               # (6, 6) final GN information matrix
    num_inliers: torch.Tensor     # () absolute inlier count


class FlatICP:
    """Index map of `flat_icp_scalars`: an ICPResult's scalars as one
    (20,) float32 vector, so a host reads a verification in one transfer
    (the tracking loop has its own layout, frontend.FlatTrack)."""

    T = slice(0, 16)          # (4, 4) row-major
    CONVERGED = 16
    INLIER_FRACTION = 17
    NUM_INLIERS = 18
    RMS = 19
    SIZE = 20


def flat_icp_scalars(res: ICPResult) -> torch.Tensor:
    """Pack an ICPResult's scalars per the FlatICP layout (on its device)."""
    return torch.cat([
        res.T.reshape(16).to(torch.float32),
        torch.stack([
            res.converged.to(torch.float32),
            res.inlier_fraction.to(torch.float32),
            res.num_inliers.to(torch.float32),
            res.rms.to(torch.float32),
        ]),
    ])


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


def _finished(carry: torch.Tensor) -> bool:
    """DONE is set and reading it costs no device round trip (CPU)."""
    return carry.device.type == "cpu" and bool(carry[ep.DONE] != 0)


def _projective(packed: torch.Tensor, height: int, width: int,
                K: Intrinsics, cfg: ICPConfig):
    """The ICP loop's association against an organized target's table."""
    def associate(points, mask, normals, carry, out):
        projective_correspond_at_pose(
            points, mask, normals, packed, height, width, K,
            cfg.max_corr_dist, cfg.normal_dot_min, carry, out=out)
    return associate


def _icp_loop(associate, src: PointCloud, T0: torch.Tensor, cfg: ICPConfig,
              max_iters: int, inner_steps: int | None = None,
              tol_delta: float | None = None) -> ICPResult:
    """ICP with the carry on the device.  `associate(points, mask,
    normals, carry, out)` writes the association at the carry's pose into
    `out` (`correspondence_buffers`), transforming the source itself."""
    inner = max(1, int(cfg.inner_steps if inner_steps is None
                       else inner_steps))
    tol = cfg.tol_delta if tol_delta is None else tol_delta
    tol_sq = tol ** 2
    outer = -(-max_iters // inner) if max_iters > 0 else 0
    num_valid_src = torch.sum(src.mask.to(torch.float32))
    points = src.points.contiguous()
    normals = src.normals.contiguous()
    mask = src.mask.contiguous()
    carry = ep.init_carry(T0, max_iters)
    corr = correspondence_buffers(points.shape[0], points.device)
    for _ in range(outer):
        if _finished(carry):
            break
        associate(points, mask, normals, carry, corr)
        for k in range(inner):
            # frozen association; the step transforms the source by the
            # carry's current pose (inner/outer ICP) and updates the carry
            # in place
            gn_step(points, corr.q, corr.n, corr.w, carry, num_valid_src,
                    cfg.huber_delta, cfg.damping, cfg.damping_abs,
                    cfg.max_trans_step, cfg.max_rot_step,
                    is_last=k == inner - 1, inner=inner, max_iters=max_iters,
                    tol_sq=tol_sq)
    return _result(carry, tol_sq)


def _result(carry: torch.Tensor, tol_sq: float) -> ICPResult:
    return ICPResult(
        T=carry[ep.T_SLICE].reshape(4, 4),
        iters=carry[ep.IT].to(torch.int32),
        rms=carry[ep.RMS],
        inlier_fraction=carry[ep.INLIER_FRACTION],
        converged=carry[ep.DELTA_SQ] <= tol_sq,
        H=carry[ep.H_SLICE].reshape(6, 6),
        num_inliers=carry[ep.NUM_INLIERS],
    )


def _icp_loop_projective_fused(packed: torch.Tensor, height: int,
                               width: int, K: Intrinsics, src: PointCloud,
                               T0: torch.Tensor, cfg: ICPConfig,
                               max_iters: int,
                               inner_steps: int | None = None,
                               tol_delta: float | None = None) -> ICPResult:
    """Projective ICP with the fused GN step (kernels/gn_fused.py).

    The reference's semantics (`_icp_loop_projective_fused`): per outer
    iteration one association at the current pose, then `inner` solves
    whose gates use that pose and whose residuals use the freshly updated
    one (the carry's T).  Each solve is one `gn_fused_step` launch: the
    first of an outer iteration takes the carry's T as its gate pose and
    keeps it in `gate` for the others, and each computes the association's
    row itself, from the projection that gates it.  The fixed budget with
    the DONE flag replaces the while-loop, as in `_icp_loop`.
    """
    inner = max(1, int(cfg.inner_steps if inner_steps is None
                       else inner_steps))
    tol = cfg.tol_delta if tol_delta is None else tol_delta
    tol_sq = tol ** 2
    outer = -(-max_iters // inner) if max_iters > 0 else 0
    num_valid_src = torch.sum(src.mask.to(torch.float32))
    # the kernel always applies the normal gate; cosines are ≥ -1 and a
    # zero normal gives 0 > -2, so -2 disables it (tpuslam/icp.py:245)
    ndmin = cfg.normal_dot_min if cfg.normal_dot_min > 0.0 else -2.0
    points = src.points.contiguous()
    normals = src.normals.contiguous()
    mask = src.mask.contiguous()
    carry = ep.init_carry(T0, max_iters)
    gate = gate_buffer(points.device)
    for _ in range(outer):
        if _finished(carry):
            break
        for k in range(inner):
            gn_fused_step(points, normals, mask, packed, carry, gate, k == 0,
                          K, width, height, cfg.max_corr_dist, ndmin,
                          cfg.huber_delta, num_valid_src, cfg.damping,
                          cfg.damping_abs, cfg.max_trans_step,
                          cfg.max_rot_step, is_last=k == inner - 1,
                          inner=inner, max_iters=max_iters, tol_sq=tol_sq)
    return _result(carry, tol_sq)


def _projective_loop(packed: torch.Tensor, height: int, width: int,
                     K: Intrinsics, src: PointCloud, T0: torch.Tensor,
                     cfg: ICPConfig, max_iters: int,
                     inner_steps: int | None = None,
                     tol_delta: float | None = None) -> ICPResult:
    """ICP against an organized target's table: the fused loop with
    `cfg.fused_gn`, else `_icp_loop` over the projective gather."""
    if cfg.fused_gn:
        return _icp_loop_projective_fused(packed, height, width, K, src, T0,
                                          cfg, max_iters, inner_steps,
                                          tol_delta)
    return _icp_loop(_projective(packed, height, width, K, cfg), src, T0,
                     cfg, max_iters, inner_steps, tol_delta)


def align_cloud_to_organized(src: PointCloud, packed: torch.Tensor,
                             height: int, width: int, K: Intrinsics,
                             T0: torch.Tensor, cfg: ICPConfig) -> ICPResult:
    """Align an unorganized cloud onto an ORGANIZED target's packed table.

    The backend's verification path (loop closure, relocalization): the
    target keyframe keeps the row-gather table its own tracking built, so
    association is one row gather per source point per iteration.
    Estimates T s.t. target_point ≈ T·src_point.  `inlier_fraction` is
    measured against all valid source points.
    """
    return _projective_loop(packed, height, width, K, src, T0, cfg,
                            cfg.max_iters)


def align_map_to_frame(map_cloud: PointCloud, frame: Frame, K: Intrinsics,
                       T0_world_cam: torch.Tensor,
                       cfg: ICPConfig) -> ICPResult:
    """Frame-to-map tracking by REVERSE projective association (the
    reference's `align_map_to_frame`).

    The map is the source and the organized current frame the target:
    each world-frame map point is moved into the camera at the current
    estimate S = T_cam←world, projected, and matched to the frame pixel it
    lands on with one row gather from the frame's packed table.  Map points
    outside the warm start's frustum (10% margin, nearer than `depth_max`)
    are masked out, so `inlier_fraction` counts against what the camera
    could see.  Returns T_world←cam = S⁻¹ in `.T`.
    """
    h, w, _ = frame.points.shape
    packed = pack_organized_target(frame.points, frame.normals, frame.mask,
                                   dtype=_table_dtype(cfg))
    S0 = se3.inv(T0_world_cam)
    x0 = se3.transform_points(S0, map_cloud.points)
    uv0, in_front0 = project(x0, K)
    margin = 0.1  # fractional frustum slack for warm-start error
    in_view = (
        in_front0
        & (uv0[..., 0] >= -margin * w) & (uv0[..., 0] < (1 + margin) * w)
        & (uv0[..., 1] >= -margin * h) & (uv0[..., 1] < (1 + margin) * h)
        & (x0[..., 2] < cfg.depth_max)
    )
    src = PointCloud(points=map_cloud.points, normals=map_cloud.normals,
                     mask=map_cloud.mask & in_view)
    res = _projective_loop(packed, h, w, K, src, S0, cfg, cfg.max_iters)
    return res._replace(T=se3.inv(res.T))


def align_frames_packed(src_pyr, dst_packed: tuple, K: Intrinsics,
                        T0: torch.Tensor, cfg: ICPConfig) -> ICPResult:
    """Coarse-to-fine projective ICP against pre-packed target tables.

    `dst_packed[li]` is `pack_pyramid`'s table for level `li`; the target's
    image geometry is taken from `src_pyr` (both sides of a tracking pair
    share the pyramid shapes).
    """
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
        result = _projective_loop(packed, h, w, K_l, src_cloud, T, cfg,
                                  iters, inner_steps=inner, tol_delta=tol)
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


def _build_index(dst: PointCloud, cfg: ICPConfig) -> GridIndex:
    # cell edge ≥ the correspondence radius: the 27-cell probe suffices
    return build_grid_index_jit(dst, cell=float(cfg.max_corr_dist))


def align_to_index(src: PointCloud, index: GridIndex, T0: torch.Tensor,
                   cfg: ICPConfig) -> ICPResult:
    """Align a cloud against a prebuilt grid index (frame-to-map tracking
    with `map_track_mode="grid"`): each outer iteration probes the index
    at the carry's pose in one launch (kernels/correspond.py
    `grid_correspond_at_pose`).  The index is built once per map update,
    not per frame.  Estimates T s.t. target_point ≈ T·src_point;
    `inlier_fraction` is measured against all valid source points."""
    def associate(points, mask, normals, carry, out):
        grid_correspond_at_pose(points, mask, index, cfg.max_corr_dist,
                                carry, out=out)
    return _icp_loop(associate, src, T0, cfg, cfg.max_iters)


def align_clouds(src: PointCloud, dst: PointCloud, T0: torch.Tensor,
                 cfg: ICPConfig, use_grid: bool = True) -> ICPResult:
    """Align two unorganized clouds (the reference's per-pair path).

    `use_grid=False` selects the O(N·M) brute-force oracle (tests, tiny
    clouds), which moves the source by the carry's pose in the kernels'
    order and is plain PyTorch on any device."""
    if use_grid:
        return align_to_index(src, _build_index(dst, cfg), T0, cfg)

    def associate(points, mask, normals, carry, out):
        x = se3.transform_points_ordered(carry[ep.T_SLICE].reshape(4, 4),
                                         points)
        corr = brute_force_correspond(x, mask, dst, cfg.max_corr_dist)
        for o, c in zip(out, corr):
            o.copy_(c)
    return _icp_loop(associate, src, T0, cfg, cfg.max_iters)


# ---------------------------------------------------------------------------
# The reference's jitted entry points: one CUDA graph a key on the card
# (tpuslam_torch/graphs.py), op by op on the CPU or with `eager`.
# ---------------------------------------------------------------------------


def _align_frames_program(_state, src_pyr, dst_pyr, T0, *, K: Intrinsics,
                          cfg: ICPConfig):
    return (), align_frames(src_pyr, dst_pyr, K, T0, cfg)


_ALIGN_FRAMES = graphs.Program("align_frames_jit", _align_frames_program)


def align_frames_jit(src_pyr, dst_pyr, K: Intrinsics, T0: torch.Tensor,
                     cfg: ICPConfig, eager: bool = False) -> ICPResult:
    """`align_frames`, the target's packing included, as one CUDA graph on
    the card (keyed by K, cfg and the pyramids' shapes), unless `eager`."""
    return _ALIGN_FRAMES.run(tuple(src_pyr), tuple(dst_pyr), T0, eager=eager,
                             K=K, cfg=cfg)


def _align_clouds_program(_state, src, dst, T0, *, cfg: ICPConfig,
                          use_grid: bool):
    return (), align_clouds(src, dst, T0, cfg, use_grid)


_ALIGN_CLOUDS = graphs.Program("align_clouds_jit", _align_clouds_program)


def align_clouds_jit(src: PointCloud, dst: PointCloud, T0: torch.Tensor,
                     cfg: ICPConfig, use_grid: bool = True,
                     eager: bool = False) -> ICPResult:
    """`align_clouds` as one CUDA graph on the card (dst's index build and
    the alignment; keyed by cfg, `use_grid` and the clouds' shapes), unless
    `eager`."""
    return _ALIGN_CLOUDS.run(src, dst, T0, eager=eager, cfg=cfg,
                             use_grid=use_grid)


def _align_map_to_frame_program(_state, map_cloud, frame, T0, *,
                                K: Intrinsics, cfg: ICPConfig):
    res = align_map_to_frame(map_cloud, frame, K, T0, cfg)
    return (), (res, flat_icp_scalars(res))


def _align_to_index_program(_state, src, index, T0, *, cfg: ICPConfig):
    res = align_to_index(src, index, T0, cfg)
    return (), (res, flat_icp_scalars(res))


# These two graphs are the SLAM system's map refinements too
# (slam._refine_projective_jit, slam._refine_grid_jit): one graph a key
# for both callers, named after the refinements in graphs.stats().
_ALIGN_MAP_TO_FRAME = graphs.Program("_refine_projective_jit",
                                     _align_map_to_frame_program)
_ALIGN_TO_INDEX = graphs.Program("_refine_grid_jit", _align_to_index_program)


def align_map_to_frame_jit(map_cloud: PointCloud, frame: Frame,
                           K: Intrinsics, T0_world_cam: torch.Tensor,
                           cfg: ICPConfig, eager: bool = False):
    """`align_map_to_frame` as one CUDA graph on the card (keyed by K, cfg
    and the shapes, the map's capacity among them), unless `eager`.  The
    map, the frame and the warm start are copied in at every call, so a
    replay aligns against the map as it is now.  Returns (ICPResult, its
    `flat_icp_scalars`), as the ring's call does."""
    return _ALIGN_MAP_TO_FRAME.run(map_cloud, frame, T0_world_cam,
                                   eager=eager, K=K, cfg=cfg)


def align_to_index_jit(src: PointCloud, index: GridIndex, T0: torch.Tensor,
                       cfg: ICPConfig, eager: bool = False):
    """`align_to_index` as one CUDA graph on the card (keyed by cfg, the
    index's cell and the shapes), unless `eager`; the index (keys, rows,
    origin, table) is copied in at every call, so a replay probes the
    index rebuilt after the latest insert.  Returns (ICPResult, its
    `flat_icp_scalars`)."""
    return _ALIGN_TO_INDEX.run(src, index, T0, eager=eager, cfg=cfg)
