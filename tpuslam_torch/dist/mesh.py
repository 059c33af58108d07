"""Device mesh and collectives — port of `tpuslam/dist/mesh.py`.

The reference's 1-D `jax.sharding.Mesh` over one `"shard"` axis becomes a
`Mesh` over the ranks of a `torch.distributed` process group, one device
per rank: the processes run the same program, each holding its slice of
every sharded array, and the collectives (`all_reduce`, `all_to_all`,
`all_gather`, P2P) are NCCL's on the GPU and gloo's on the CPU.  Without an
initialized process group the mesh has one rank and no collectives: each
collective is then the identity.

Nothing tells a process of a cluster: `initialize_distributed` takes the
rendezvous address (`tcp://host:port` or `file://path`), the world size
and the rank from its caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import threading
from typing import Optional

import torch
import torch.distributed as dist

from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.transfer import resolve_device

SHARD_AXIS = "shard"        # the mesh's one axis (points, edges, frames)
# id(group) → (group, serial): each process group's number in a captured
# program's key; the group is held, so its id is never reused
_group_serials: dict = {}
_serials = itertools.count(1)
_serials_lock = threading.Lock()


def _group_serial(group) -> int:
    if group is None:
        return 0
    with _serials_lock:
        entry = _group_serials.get(id(group))
        if entry is None:
            entry = _group_serials[id(group)] = (group, next(_serials))
        return entry[1]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of one process group along SHARD_AXIS, as seen from this
    process: `rank` of `size`, its `device`, and the `group` (None for the
    one-rank mesh without collectives).  Hashes by identity, so caches
    keyed on a mesh are per mesh object."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        """The group's backend ("nccl", "gloo", ...), "none" without one."""
        return "none" if self.group is None else str(
            dist.get_backend(self.group))

    def graph_key(self) -> tuple:
        """This mesh in a captured program's key (graphs.static_key): the
        identity of its process group (a number never reused in a
        process), its rank, size and backend.  Two meshes of one group and
        rank share graphs (they share the group's communicator); meshes
        without a group run no collective and share them too.  Its `repr`
        would not do: it names the group by an address, which a later
        group may take."""
        return ("mesh", _group_serial(self.group), self.rank, self.size,
                self.backend)

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all over dim 0: block d of `t` goes to rank d; the
        result holds the blocks received, in rank order."""
        if self.group is None:
            return t
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, concatenated over dim 0 in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 60.0) -> None:
    """Start this process's default group (a no-op without `init_method`):
    NCCL when a GPU is present, gloo otherwise, unless `backend` says."""
    if init_method is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the default process group, or the one-rank mesh without
    collectives when no group is initialized.  `device` is this rank's
    device (for NCCL, the GPU the rank owns)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    size=dist.get_world_size(), device=dev)
    return Mesh(group=None, rank=0, size=1, device=dev)


def tree_map(fn, tree):
    """`fn` on every tensor of a tensor, tuple, NamedTuple or list; other
    leaves (Python numbers, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return tree


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` whole on this rank's device (the reference's
    fully replicated `P()` layout)."""
    return tree_map(lambda t: t.to(mesh.device), tree)


def shard_leading(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of dim 0 of `x`, on its device (the
    reference's `P(axis)` layout).  Like the reference, dim 0 must be a
    multiple of the mesh size."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading dimension {n} is not a multiple of the "
                         f"mesh size {mesh.size}")
    local = n // mesh.size
    return x[mesh.rank * local:(mesh.rank + 1) * local].to(mesh.device)


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int = 0,
                    fill=0) -> torch.Tensor:
    """Pad dim `dim` of `x` with `fill` up to a multiple of `multiple`."""
    n = x.shape[dim]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    shape = list(x.shape)
    shape[dim] = target - n
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=dim)


def shard_cloud(cloud: PointCloud, mesh: Mesh) -> PointCloud:
    """This rank's slice of a cloud padded to a multiple of the mesh size
    (contiguous blocks in rank order, as the reference shards dim 0).

    Padding rows carry mask=False, so every downstream reduction already
    ignores them — sharding changes layout, never semantics.
    """
    d = mesh.size
    padded = PointCloud(points=pad_to_multiple(cloud.points, d),
                        normals=pad_to_multiple(cloud.normals, d),
                        mask=pad_to_multiple(cloud.mask, d, fill=False))
    local = padded.capacity // d
    lo = mesh.rank * local
    return PointCloud(*(a[lo:lo + local] for a in padded))
