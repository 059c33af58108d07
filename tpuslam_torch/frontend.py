"""Frame-to-keyframe odometry — port of the scan path of
`tpuslam/frontend.py`.

`scan_odometry` tracks a whole sequence with every piece of state on the
input's device: a Python loop over frames, the keyframe kept as its packed
gather tables, promotion a `torch.where` select instead of the reference's
`lax.cond`, and per-frame outputs written into preallocated tensors that
the caller reads back once.  Nothing inside a frame waits for the GPU.

Keyframe criterion: relative motion (translation/rotation) beyond
threshold OR inlier fraction below threshold; a frame whose inlier fraction
falls below `lost_inlier_fraction` (or whose pose is non-finite) keeps its
warm-start pose and never promotes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.config import Intrinsics, SLAMConfig
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.backproject import backproject, device_scalar
from tpuslam_torch.geom.normals import organized_normals
from tpuslam_torch.icp import Frame, ICPResult, align_frames_packed, pack_pyramid


def damped_velocity(delta: torch.Tensor, gamma: float) -> torch.Tensor:
    """Scale an inter-frame motion twist for the warm start (see
    SLAMConfig.cv_damping for why γ < 1 is required for stability)."""
    if gamma == 0.0:
        return torch.eye(4, dtype=delta.dtype, device=delta.device)
    if gamma == 1.0:
        return delta
    return se3.exp(gamma * se3.log(delta))


def decimate2(d: torch.Tensor) -> torch.Tensor:
    """Stride-2 decimation of an (H, W) plane (the reference's CPU path;
    its TPU one-hot matmul is bit-identical to this slice)."""
    return d[::2, ::2]


def preprocess(depth: torch.Tensor, K: Intrinsics, cfg: SLAMConfig):
    """depth (H, W) → organized pyramid [finest..coarsest] of Frames.

    The depth image is decimated first and each level backprojected with
    its own scaled intrinsics.  Input dtypes: float32 metres; uint16 raw
    counts, divided here by `cfg.depth_scale` with a true IEEE divide (a 0-d
    device tensor divisor — a Python-scalar divisor would become a multiply
    by the reciprocal on CUDA), so the result is bit-equal to host-divided
    float32 depth; float16 metres.
    """
    d = depth.to(torch.float32)
    if depth.dtype == torch.uint16:
        d = d / device_scalar(cfg.depth_scale, d)
    pyr = []
    for li in range(cfg.icp.pyramid_levels):
        pts, mask = backproject(d, K.scaled(1.0 / (2 ** li)),
                                depth_min=cfg.icp.depth_min,
                                depth_max=cfg.icp.depth_max)
        nrm, nmask = organized_normals(pts, mask)
        pyr.append(Frame(points=pts, normals=nrm, mask=mask & nmask))
        if li + 1 < cfg.icp.pyramid_levels:
            d = decimate2(d)
    return tuple(pyr)


class TrackResult(NamedTuple):
    T_kf_cam: torch.Tensor     # (4, 4) camera pose in keyframe frame
    icp: ICPResult
    promote: torch.Tensor      # () bool — should current frame become keyframe
    lost: torch.Tensor         # () bool — tracking failure


def _promote_flags(res: ICPResult, T0: torch.Tensor,
                   cfg: SLAMConfig) -> TrackResult:
    T = res.T
    lost = ((res.inlier_fraction < cfg.keyframe.lost_inlier_fraction)
            | ~torch.all(torch.isfinite(T)))
    T = torch.where(lost, T0, T)
    promote = (
        (se3.translation_norm(T) > cfg.keyframe.max_translation)
        | (se3.rotation_angle(T) > cfg.keyframe.max_rotation)
        | (res.inlier_fraction < cfg.keyframe.min_inlier_fraction)
    ) & ~lost
    return TrackResult(T_kf_cam=T, icp=res, promote=promote, lost=lost)


def track_step_packed(kf_packed: tuple, cur_pyr, K: Intrinsics,
                      T0: torch.Tensor, cfg: SLAMConfig) -> TrackResult:
    """Track the current pyramid against a pre-packed keyframe and decide
    promotion (flags stay on the device)."""
    res = align_frames_packed(cur_pyr, kf_packed, K, T0, cfg.icp)
    return _promote_flags(res, T0, cfg)


class ScanState(NamedTuple):
    kf_packed: tuple            # keyframe row-gather tables (per level)
    T_world_kf: torch.Tensor
    T_kf_cam: torch.Tensor
    last_delta: torch.Tensor


def initial_state(depth0: torch.Tensor, K: Intrinsics,
                  cfg: SLAMConfig) -> ScanState:
    """The scan's start: frame 0 is the keyframe, every pose the identity."""
    eye = torch.eye(4, dtype=torch.float32, device=depth0.device)
    kf = pack_pyramid(preprocess(depth0, K, cfg), cfg.icp)
    return ScanState(kf_packed=kf, T_world_kf=eye, T_kf_cam=eye,
                     last_delta=eye)


def scan_step(state: ScanState, depth: torch.Tensor, K: Intrinsics,
              cfg: SLAMConfig):
    """Track one frame; returns (new_state, (T_world_cam, promote,
    inlier_fraction)), all on the device."""
    pyr = preprocess(depth, K, cfg)
    T0 = state.T_kf_cam @ damped_velocity(state.last_delta, cfg.cv_damping)
    out = track_step_packed(state.kf_packed, pyr, K, T0, cfg)
    T_world_cam = state.T_world_kf @ out.T_kf_cam
    promote = out.promote
    new_packed = pack_pyramid(pyr, cfg.icp)
    eye = torch.eye(4, dtype=T_world_cam.dtype, device=T_world_cam.device)
    new_state = ScanState(
        kf_packed=tuple(torch.where(promote, n, o)
                        for n, o in zip(new_packed, state.kf_packed)),
        T_world_kf=torch.where(promote, T_world_cam, state.T_world_kf),
        T_kf_cam=torch.where(promote, eye, out.T_kf_cam),
        last_delta=se3.relative(state.T_kf_cam, out.T_kf_cam),
    )
    return new_state, (T_world_cam, promote, out.icp.inlier_fraction)


def scan_odometry(depths: torch.Tensor, K: Intrinsics, cfg: SLAMConfig,
                  state: ScanState | None = None):
    """Full-sequence frame-to-keyframe odometry.

    Args:
      depths: (F, H, W) depth frames on the device the scan runs on.
      state: where to start (interop.scan_state_from_numpy); by default
        frame 0 is the keyframe and every frame, frame 0 included, is
        tracked, as in the reference.
    Returns:
      poses (F, 4, 4) world←cam, promote flags (F,), inlier fractions (F,),
      on the device, filled without any host synchronisation.
    """
    dev = depths.device
    F = depths.shape[0]
    if state is None:
        state = initial_state(depths[0], K, cfg)
    poses = torch.empty((F, 4, 4), dtype=torch.float32, device=dev)
    promotes = torch.empty((F,), dtype=torch.bool, device=dev)
    inliers = torch.empty((F,), dtype=torch.float32, device=dev)
    for i in range(F):
        state, (T_world_cam, promote, inl) = scan_step(state, depths[i], K,
                                                       cfg)
        poses[i] = T_world_cam
        promotes[i] = promote
        inliers[i] = inl
    return poses, promotes, inliers
