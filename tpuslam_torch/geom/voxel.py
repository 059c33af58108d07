"""Voxel-grid downsampling — port of `tpuslam/geom/voxel.py`.

Static output shape, as in the reference: quantize each point to integer
voxel coordinates in a fixed world box, sort the points by voxel key
(stable, so points of a voxel keep their input order), mark where the key
changes, prefix-sum to dense segment ids, and sum positions, normals and
counts per segment into `capacity` rows (one overflow bin absorbs the
tail).  Everything is torch ops on the input's device with no host
synchronisation.  The segment sums accumulate in float64 and round once to
float32, so the result does not depend on the order the device adds in;
the reference adds sequentially in float32, so the two agree to float32
rounding (tests/test_torch_backend.py).
"""

from __future__ import annotations

import torch

from tpuslam_torch.geom.backproject import device_scalar
from tpuslam_torch.geom.cloud import PointCloud

_INVALID_KEY = torch.iinfo(torch.int32).max


def voxel_keys(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
               origin: float, extent: float):
    """Two-part voxel key per point: (key_hi, key_lo, in_box).

    key_hi = cx·dims + cy, key_lo = cz (int32); invalid points get
    (INT32_MAX, INT32_MAX) so they sort last."""
    dims = int(-(-extent // voxel_size))  # ceil
    # a true divide (a Python-scalar divisor is a reciprocal multiply on
    # CUDA, which moves points on a voxel boundary)
    c = torch.floor((points - origin) / device_scalar(voxel_size, points))
    # clamp before the cast: the float→int conversion of an out-of-range
    # value is undefined; every clamped value is out of the box either way
    c = c.clamp(-1.0, float(dims)).to(torch.int32)
    in_box = torch.all((c >= 0) & (c < dims), dim=-1) & mask
    c = torch.clamp(c, 0, dims - 1)
    key_hi = torch.where(in_box, c[..., 0] * dims + c[..., 1], _INVALID_KEY)
    key_lo = torch.where(in_box, c[..., 2], _INVALID_KEY)
    return key_hi, key_lo, in_box


def voxel_downsample(cloud: PointCloud, voxel_size: float, capacity: int,
                     origin: float = -20.0,
                     extent: float = 40.0) -> PointCloud:
    """Downsample to ≤ `capacity` voxel centroids (static output shape).

    Output normals are the renormalized per-voxel mean of input normals.
    """
    pts, nrm, mask = cloud.points, cloud.normals, cloud.mask
    key_hi, key_lo, valid = voxel_keys(pts, mask, voxel_size, origin, extent)
    key = key_hi.to(torch.int64) * (2 ** 31) + key_lo.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    s_key = key[order]
    new_seg = torch.ones_like(s_key, dtype=torch.bool)
    new_seg[1:] = s_key[1:] != s_key[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.clamp(seg_id, max=capacity)    # overflow bin = capacity

    w = valid.to(torch.float64)[order]
    vals = torch.cat([pts[order].to(torch.float64) * w[:, None],
                      nrm[order].to(torch.float64) * w[:, None],
                      w[:, None]], dim=1)                        # (N, 7)
    sums = torch.zeros((capacity + 1, 7), dtype=torch.float64,
                       device=pts.device)
    sums.index_add_(0, seg_id, vals)
    sums = sums[:capacity].to(pts.dtype)
    sum_pts, sum_nrm, counts = sums[:, 0:3], sums[:, 3:6], sums[:, 6]
    out_mask = counts > 0
    denom = torch.clamp(counts, min=1.0)[:, None]
    centroids = sum_pts / denom
    nmean = sum_nrm / denom
    nnorm = torch.linalg.norm(nmean, dim=-1, keepdim=True)
    normals = torch.where(nnorm > 1e-8,
                          nmean / torch.clamp(nnorm, min=1e-8), 0.0)
    centroids = torch.where(out_mask[:, None], centroids, 0.0)
    return PointCloud(points=centroids, normals=normals, mask=out_mask)
