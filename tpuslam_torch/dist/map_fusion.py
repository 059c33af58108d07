"""Sharded voxel-map fusion by all-to-all owner routing — port of
`tpuslam/dist/map_fusion.py`.

The world voxel map is sharded over the mesh by a hash of the voxel key:
`owner(voxel) = mix32(key) % D`, which load-balances any trajectory.  Each
rank holds a fixed-capacity shard of the voxels it owns.  Fusing a
keyframe cloud re-shards it from frame-major to owner-major: each rank
takes its slice of the incoming points, computes every point's owner,
buckets the points by owner (a stable sort) and ONE `all_to_all` routes
every bucket to its owner, which fuses the arrivals into its shard with
the single-device voxel reduction (geom/voxel.py).  All points of a voxel
land on one owner, so the sharded map holds exactly the single-device
map's voxels.

Static shapes: a (source → owner) bucket is `bucket_cap` rows; arrivals
beyond it are dropped (mask False) and the drop count is summed over the
mesh, so callers can size the cap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.config import VoxelConfig
from tpuslam_torch.dist.mesh import Mesh, shard_cloud
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.voxel import voxel_downsample, voxel_keys
from tpuslam_torch.transfer import upload

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for int64 `a` in [0, 2³²) and a constant c < 2³²,
    in two 16-bit halves of c so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 avalanche mix of the two-part voxel key, in
    int64 holding values in [0, 2³²) (PyTorch has no uint32 multiply)."""
    h = _mul32(key_hi.to(torch.int64) & _M32, 2654435761)
    h = h ^ _mul32(key_lo.to(torch.int64) & _M32, 40503)
    h = h ^ (h >> 15)
    h = _mul32(h, 2246822519)
    return h ^ (h >> 13)


def voxel_owner(points: torch.Tensor, mask: torch.Tensor, n_dev: int,
                cfg: VoxelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(owner ∈ [0, n_dev), in_box) for each point under cfg's world grid."""
    key_hi, key_lo, in_box = voxel_keys(points, mask, cfg.map_voxel_size,
                                        cfg.origin, cfg.extent)
    owner = (_mix32(key_hi, key_lo) % n_dev).to(torch.int32)
    return owner, in_box


class FusionStats(NamedTuple):
    dropped: torch.Tensor   # () int64 — points lost to bucket_cap overflow
    routed: torch.Tensor    # () int64 — points exchanged over the mesh


def _bucket_by_owner(pts, nrm, valid, owner, n_dev: int, bucket_cap: int):
    """Pack local points into a (D·B, 7) owner-major bucket table.

    Row layout [px py pz nx ny nz w]; rows beyond a destination's fill
    level carry w = 0.  A stable sort by owner (invalid rows last) and one
    gather per destination row, as the reference does.
    """
    n = pts.shape[0]
    o = torch.where(valid, owner, n_dev).to(torch.int64)
    order = torch.sort(o, stable=True).indices
    rows = torch.cat([pts, nrm], dim=1)[order]             # owner-sorted
    counts = torch.bincount(o, minlength=n_dev + 1)[:n_dev]
    starts = torch.cumsum(counts, 0) - counts              # exclusive
    j = torch.arange(bucket_cap, device=pts.device)
    take = torch.clamp(counts, max=bucket_cap)             # rows shipped
    idx = torch.clamp(starts[:, None] + j[None, :], 0, n - 1)
    w = (j[None, :] < take[:, None]).reshape(-1, 1).to(pts.dtype)
    bucket = torch.cat([rows[idx.reshape(-1)], w], dim=1)
    return bucket, torch.sum(counts - take), torch.sum(take)


def _fuse_shard(map_shard: PointCloud, new_local: PointCloud,
                T_world: torch.Tensor, mesh: Mesh, bucket_cap: int,
                shard_cap: int, cfg: VoxelConfig):
    """Route this rank's new points to their voxel owners; fuse locally."""
    moved = new_local.transform(T_world)
    owner, in_box = voxel_owner(moved.points, moved.mask, mesh.size, cfg)
    bucket, dropped, routed = _bucket_by_owner(
        moved.points, moved.normals, moved.mask & in_box, owner, mesh.size,
        bucket_cap)
    # frame-major → owner-major: one tiled all-to-all over the mesh
    arrivals = mesh.all_to_all(bucket)                     # (D·B, 7)
    merged = PointCloud(
        points=torch.cat([map_shard.points, arrivals[:, 0:3]], dim=0),
        normals=torch.cat([map_shard.normals, arrivals[:, 3:6]], dim=0),
        mask=torch.cat([map_shard.mask, arrivals[:, 6] > 0.5], dim=0),
    )
    fused = voxel_downsample(merged, cfg.map_voxel_size, shard_cap,
                             cfg.origin, cfg.extent)
    counts = mesh.all_reduce(torch.stack([dropped, routed]))
    return fused, FusionStats(dropped=counts[0], routed=counts[1])


def make_fuse_fn(mesh: Mesh, cfg: VoxelConfig, new_capacity: int,
                 bucket_slack: float = 2.0):
    """The sharded-fusion step for fixed capacities.

    Returns `(fuse, bucket_cap, shard_cap)`; `fuse(map_shard, new_local,
    T_world) -> (map_shard, stats)` takes this rank's map shard
    (`cfg.map_capacity // D` rows) and its slice of the incoming keyframe
    cloud (`new_capacity / D` rows, frame-major).
    """
    n_dev = mesh.size
    local_n = -(-new_capacity // n_dev)
    bucket_cap = max(8, int(np.ceil(local_n / n_dev * bucket_slack)))
    shard_cap = -(-cfg.map_capacity // n_dev)

    def fuse(map_shard: PointCloud, new_local: PointCloud, T_world):
        return _fuse_shard(map_shard, new_local, T_world, mesh, bucket_cap,
                           shard_cap, cfg)

    return fuse, bucket_cap, shard_cap


class ShardedVoxelMap:
    """Host wrapper of a mesh-sharded world voxel map — the sharded twin of
    mapping.VoxelMap.  `cloud_shards` is THIS rank's shard and feeds
    dist/ring_map directly (the map is point-sharded already: tracking
    needs no reshard); `gather()` assembles the whole map on every rank
    (tests and viewers only)."""

    def __init__(self, cfg: VoxelConfig, mesh: Mesh, new_capacity: int):
        self.cfg = cfg
        self.mesh = mesh
        self.shard_cap = -(-cfg.map_capacity // mesh.size)
        dev = mesh.device
        self.cloud_shards = PointCloud(
            points=torch.zeros((self.shard_cap, 3), device=dev),
            normals=torch.zeros((self.shard_cap, 3), device=dev),
            mask=torch.zeros((self.shard_cap,), dtype=torch.bool, device=dev),
        )
        self.new_capacity = -(-new_capacity // mesh.size) * mesh.size
        self._fuse, self.bucket_cap, _ = make_fuse_fn(mesh, cfg,
                                                      self.new_capacity)
        self.dropped_total = 0
        self.num_insertions = 0

    def insert(self, cloud: PointCloud, T_world) -> FusionStats:
        """Fuse a (keyframe-local) cloud posed at T_world into the map.
        Every rank passes the same whole cloud; each routes its slice."""
        local = shard_cloud(cloud, self.mesh)
        if local.capacity * self.mesh.size != self.new_capacity:
            raise ValueError(
                f"cloud capacity {cloud.capacity} != fusion capacity "
                f"{self.new_capacity} (shapes are static; use one capacity)")
        T = upload(np.asarray(T_world, dtype=np.float32), self.mesh.device)
        self.cloud_shards, stats = self._fuse(self.cloud_shards, local, T)
        self.dropped_total += int(stats.dropped)
        self.num_insertions += 1
        return stats

    def gather(self) -> PointCloud:
        """The whole map on every rank, shards in rank order (defeats the
        sharding)."""
        c = self.cloud_shards
        mask = self.mesh.all_gather(c.mask.to(torch.uint8)) > 0
        return PointCloud(points=self.mesh.all_gather(c.points),
                          normals=self.mesh.all_gather(c.normals), mask=mask)

    def size(self) -> int:
        return int(self.mesh.all_reduce(self.cloud_shards.count()
                                        .to(torch.int64)))

    def points(self) -> np.ndarray:
        """Valid world-frame points (host copy, for viz/eval)."""
        full = self.gather()
        m = full.mask.cpu().numpy()
        return full.points.cpu().numpy()[m]
