"""Depth-image backprojection and pinhole projection — port of
`tpuslam/geom/backproject.py`.

Vectorized over the (H, W) image with pixel-index grids; organized output
``(H, W, 3)`` + validity mask.  The operation order is the reference's.
Divisions by an intrinsic go through a 0-d tensor on the input's device:
PyTorch's CUDA true-divide by a Python scalar multiplies by the rounded
reciprocal instead, which moves results by an ulp.
"""

from __future__ import annotations

import torch

from tpuslam_torch.config import Intrinsics


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on `like`'s device, made by a fill (no copy from
    the host, so no synchronisation)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def backproject(depth: torch.Tensor, K: Intrinsics, depth_min: float = 0.1,
                depth_max: float = 10.0):
    """Depth image -> organized point cloud.

    Args:
      depth: (H, W) float32 metres; <=0 or out-of-range marks invalid pixels.
      K: intrinsics.
    Returns:
      points (H, W, 3) float32 camera-frame, mask (H, W) bool.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :].expand(h, w)
    x = (u - K.cx) / device_scalar(K.fx, depth) * depth
    y = (v - K.cy) / device_scalar(K.fy, depth) * depth
    points = torch.stack([x, y, depth], dim=-1)
    mask = (depth > depth_min) & (depth < depth_max) & torch.isfinite(depth)
    points = torch.where(mask[..., None], points, 0.0)
    return points, mask


def project(points: torch.Tensor, K: Intrinsics):
    """Camera-frame points -> continuous pixel coordinates.

    Args:
      points: (..., 3).
    Returns:
      uv (..., 2) float pixel coords, valid (...,) bool (positive depth).
    """
    z = points[..., 2]
    valid = z > 1e-6
    z_safe = torch.where(valid, z, 1.0)
    u = points[..., 0] / z_safe * K.fx + K.cx
    v = points[..., 1] / z_safe * K.fy + K.cy
    return torch.stack([u, v], dim=-1), valid
