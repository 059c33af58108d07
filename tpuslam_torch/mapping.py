"""Global voxel map — port of `tpuslam/mapping.py`.

The map is a fixed-capacity masked `PointCloud` in the world frame, on the
device.  Fusing a keyframe is the sort-based voxel reduction
(geom/voxel.py) of `concat(map, transformed cloud)`: static shapes, no
hash table, no host synchronisation.  On the card the fusion replays a
CUDA graph (`fuse_jit`, the reference's jitted `_fuse`; graphs.py), keyed
by the capacities and the voxel grid: the map and the new cloud are its
inputs, copied in, and the fused map comes out as a copy, so the map is
never a buffer that the next replay writes.  Frame-to-map tracking reads
it through `icp.align_map_to_frame` (reverse projective association) or,
with `map_track_mode="grid"`, through the grid-hash index that
`build_index` sorts (kernels/correspond.py; a graph of its own on the
card, once an insert).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import VoxelConfig
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.voxel import voxel_downsample
from tpuslam_torch.kernels.correspond import GridIndex, build_grid_index_jit
from tpuslam_torch.transfer import resolve_device, upload


def _fuse(map_cloud: PointCloud, new_cloud: PointCloud, T_world: torch.Tensor,
          capacity: int, voxel_size: float, origin: float,
          extent: float) -> PointCloud:
    moved = new_cloud.transform(T_world)
    merged = PointCloud(
        points=torch.cat([map_cloud.points, moved.points], dim=0),
        normals=torch.cat([map_cloud.normals, moved.normals], dim=0),
        mask=torch.cat([map_cloud.mask, moved.mask], dim=0),
    )
    return voxel_downsample(merged, voxel_size, capacity, origin, extent)


def _fuse_program(_state, map_cloud, new_cloud, T_world, **static):
    return (), _fuse(map_cloud, new_cloud, T_world, **static)


_FUSE = graphs.Program("_fuse", _fuse_program)


def fuse_jit(map_cloud: PointCloud, new_cloud: PointCloud,
             T_world: torch.Tensor, capacity: int, voxel_size: float,
             origin: float, extent: float, eager: bool = False) -> PointCloud:
    """`_fuse`: the map with `new_cloud` posed at `T_world` fused in; a
    CUDA graph on the card unless `eager`."""
    return _FUSE.run(map_cloud, new_cloud, T_world, eager=eager,
                     capacity=capacity, voxel_size=voxel_size, origin=origin,
                     extent=extent)


class VoxelMap:
    """Host wrapper holding the device-resident world map."""

    def __init__(self, cfg: VoxelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        n = cfg.map_capacity
        self.cloud = PointCloud(
            points=torch.zeros((n, 3), device=self.device),
            normals=torch.zeros((n, 3), device=self.device),
            mask=torch.zeros((n,), dtype=torch.bool, device=self.device),
        )
        self.num_insertions = 0

    def insert(self, cloud: PointCloud, T_world) -> None:
        """Fuse a (keyframe-local) cloud posed at T_world into the map."""
        T = upload(np.asarray(T_world, dtype=np.float32), self.device)
        self.cloud = fuse_jit(self.cloud, cloud, T, self.cfg.map_capacity,
                              self.cfg.map_voxel_size, self.cfg.origin,
                              self.cfg.extent)
        self.num_insertions += 1

    def build_index(self, cell: float) -> GridIndex:
        """Grid-hash index over the current map (for frame-to-map ICP).

        Rebuilt per map update, not per frame; anchored at the map centroid
        so the 256³ local grid (cell·256 span) covers a room-scale map.  A
        replay of `build_grid_index_jit`'s graph on the card.
        """
        return build_grid_index_jit(self.cloud, cell=cell)

    def size(self) -> int:
        return int(self.cloud.count())

    def points(self) -> np.ndarray:
        """Valid world-frame points (host copy, for viz/eval)."""
        m = self.cloud.mask.cpu().numpy()
        return self.cloud.points.cpu().numpy()[m]
