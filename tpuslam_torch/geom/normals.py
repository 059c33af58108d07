"""Organized-image normal estimation — port of `tpuslam/geom/normals.py`.

Central differences along image rows/cols via `torch.roll`, cross product,
normalize, orient toward the camera, then zero the one-pixel border that
the roll wraps around.
"""

from __future__ import annotations

import torch

DEPTH_DISC = 0.1    # m: the neighbour-pair discontinuity gate's default
NORM_EPS = 1e-12    # the least cross-product norm that makes a normal


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, in the reference's component order."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def organized_normals(points: torch.Tensor, mask: torch.Tensor,
                      depth_disc: float = DEPTH_DISC):
    """Estimate normals of an organized cloud.

    Args:
      points: (H, W, 3) camera-frame points.
      mask: (H, W) validity.
      depth_disc: m — reject neighbor pairs spanning a depth discontinuity.
    Returns:
      normals (H, W, 3) unit, oriented toward camera (n·p < 0);
      nmask (H, W) bool, subset of `mask`.
    """
    right = torch.roll(points, -1, dims=1)
    left = torch.roll(points, 1, dims=1)
    down = torch.roll(points, -1, dims=0)
    up = torch.roll(points, 1, dims=0)
    m_right = torch.roll(mask, -1, dims=1)
    m_left = torch.roll(mask, 1, dims=1)
    m_down = torch.roll(mask, -1, dims=0)
    m_up = torch.roll(mask, 1, dims=0)

    du = right - left
    dv = down - up
    z = points[..., 2]
    ok_u = ((torch.abs(right[..., 2] - z) < depth_disc)
            & (torch.abs(left[..., 2] - z) < depth_disc))
    ok_v = ((torch.abs(down[..., 2] - z) < depth_disc)
            & (torch.abs(up[..., 2] - z) < depth_disc))

    n = cross(du, dv)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    good = (
        mask
        & m_right & m_left & m_down & m_up
        & ok_u & ok_v
        & (norm[..., 0] > NORM_EPS)
    )
    n = n / torch.clamp(norm, min=NORM_EPS)
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    # Zero out the image border (roll wraps around).
    h, w = mask.shape
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[1:-1, 1:-1] = True
    good = good & border
    n = torch.where(good[..., None], n, 0.0)
    return n, good
