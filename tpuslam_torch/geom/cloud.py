"""Point-cloud container — port of `tpuslam/geom/cloud.py`.

Fixed-capacity padding discipline: `points` is a static-shape (N, 3)
tensor and `mask` marks which rows are real; every consumer reduces with
the mask.  Organized clouds (N = H·W, row-major pixels) feed the projective
association kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.geom import se3


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud.

    points:  (N, 3) float — padded rows hold zeros.
    normals: (N, 3) float — unit normals, zeros where unknown/padded.
    mask:    (N,)  bool  — True for valid rows.
    """

    points: torch.Tensor
    normals: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        """Rigid transform; rotates normals with the rotation block."""
        return PointCloud(
            points=se3.transform_points(T, self.points),
            normals=se3.rotate_vectors(T, self.normals),
            mask=self.mask,
        )

    def masked_points(self) -> torch.Tensor:
        return torch.where(self.mask[..., None], self.points, 0.0)

    def centroid(self) -> torch.Tensor:
        n = torch.clamp(self.count().to(self.points.dtype), min=1.0)
        return torch.sum(self.masked_points(), dim=-2) / n[..., None]

    @classmethod
    def from_points(
        cls,
        points: torch.Tensor,
        normals: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Build from raw tensors, optionally padding up to `capacity`."""
        n = points.shape[-2]
        if normals is None:
            normals = torch.zeros_like(points)
        if mask is None:
            mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                              device=points.device)
        if capacity is not None and capacity != n:
            if capacity < n:
                raise ValueError(f"capacity {capacity} < point count {n}")
            pad = capacity - n
            points = torch.nn.functional.pad(points, (0, 0, 0, pad))
            normals = torch.nn.functional.pad(normals, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        return cls(points=points, normals=normals, mask=mask)
