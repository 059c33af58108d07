"""Ring-sharded frame-to-map ICP — port of `tpuslam/dist/ring_map.py`.

Frame points AND map points are sharded over the mesh (dist/mesh.py).  Each
ICP correspondence runs D ring hops: the NN of the local frame shard
against the map shard held at that hop, min-merged into the running best,
while the held shard passes to the right neighbour.  After D hops every
frame point has seen the whole map; the GN reduction over the frame shards
completes with one `all_reduce`.  The map never lives whole on one device.

Two ring backends (the `backend` argument, the reference's names in
brackets):

  * `"kernel"` [`"pallas"`] — each hop is the hand kernel
    kernels/ring_nn.py (its plain twin on CPU tensors), one launch a hop
    that also moves the frame points by the carry's pose, starts the
    running best on the first hop and applies the correspondence gates on
    the last: an outer iteration issues no op around the hops.  The
    default.
  * `"ops"` [`"xla"`] — each hop is plain PyTorch: direct squared
    distances, argmin, gather (chunked over map rows).  An oracle; the
    card's main path does not use it.

Transport (both backends): shards are packed (M, 8) row tables
(kernels/ring_nn.pack_cloud_rows) that pass to the right neighbour by
`torch.distributed` P2P (`batch_isend_irecv`) in two alternating buffers;
a hop's exchange is posted before its NN runs on the held shard, so the
transfer overlaps the compute (NCCL runs it on its own stream).  With one
rank there are no transfers.

The ICP loop is `icp._icp_loop`'s: a fixed budget of ⌈max_iters/inner⌉
outer iterations whose GN steps are the partials kernel (which moves the
frame points by the carry's pose itself), an `all_reduce` of the partials
and the epilogue kernel, which keeps the carry — pose, stats and a DONE
flag — on the device.  Every rank runs the same number
of collectives whatever its data: a host-side early exit could let the
ranks disagree on it and deadlock.  (Only a one-rank mesh on the CPU
stops at DONE, as `_icp_loop` does.)  The epilogue's Gauss elimination
stands for the reference's `solve_gn_step`; both solve the same damped
system.

The reference jits the whole alignment (a `shard_map`); here it is one
CUDA graph a key on the card, collectives and hops included, on a mesh
without a group or over NCCL (`captures`).  The NCCL communicator is made
by the first collective, which every mesh runs eagerly (the map's
fusion, or the key's warm-up) before any capture.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.distributed as dist

from tpuslam_torch import graphs
from tpuslam_torch.config import ICPConfig
from tpuslam_torch.dist.mesh import Mesh, pad_to_multiple, shard_cloud
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.icp import ICPResult, _result, flat_icp_scalars
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.gn_partials import gn_reduce_partials_at_pose
from tpuslam_torch.kernels.ring_nn import (
    ROW_DIM,
    init_best,
    pack_cloud_rows,
    ring_correspond_hop,
    ring_state,
)

BACKENDS = ("kernel", "ops")
_OPS_BLOCK = 4096           # map rows per chunk of the "ops" hop


def _ring_hops(mesh: Mesh, shard: torch.Tensor, spare: list, visit) -> None:
    """Call `visit(s, held)` on each of the D shards in turn (s = 0 .. D−1),
    passing the held shard to the right neighbour while the visit runs.
    Receives land in the two `spare` buffers (shaped as `shard`, made once
    per alignment) in turn, never in the caller's `shard`; a buffer is
    received into only after its own send was waited for and its visit
    enqueued (NCCL orders its stream after the work enqueued before)."""
    held = shard
    for s in range(mesh.size):
        reqs = []
        if s + 1 < mesh.size:
            nxt = spare[s % 2]
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, held, mesh.right, mesh.group),
                dist.P2POp(dist.irecv, nxt, mesh.left, mesh.group)])
        visit(s, held)
        for r in reqs:
            r.wait()
        if reqs:
            held = nxt


def _ops_hop(x, held, best):
    """One hop of the "ops" ring: exact NN by direct squared distances."""
    best_d2, best_row = best
    for c0 in range(0, held.shape[0], _OPS_BLOCK):
        rows = held[c0:c0 + _OPS_BLOCK]
        d2 = torch.sum((x[:, None, :] - rows[None, :, :3]) ** 2, dim=-1)
        d2 = torch.where(rows[None, :, 6] > 0.5, d2, float("inf"))
        d_loc, j = torch.min(d2, dim=1)
        better = d_loc < best_d2
        best_d2.copy_(torch.where(better, d_loc, best_d2))
        best_row.copy_(torch.where(better[:, None], rows[j], best_row))


def _ops_correspond(x, x_mask, shard, spare, max_dist: float, mesh: Mesh):
    """(q, n, w) of the local frame points over ALL map shards, by the
    "ops" hops."""
    best_d2, best_row = init_best(x.shape[0], x.device)
    _ring_hops(mesh, shard, spare,
               lambda s, held: _ops_hop(x, held, (best_d2, best_row)))
    q, n = best_row[:, :3].contiguous(), best_row[:, 3:6].contiguous()
    has_normal = torch.sum(n * n, dim=-1) > 0.5
    valid = (x_mask & torch.isfinite(best_d2) & (best_d2 < max_dist * max_dist)
             & has_normal)
    return q, n, valid.to(x.dtype)


def _ring_icp(frame: PointCloud, shard: torch.Tensor, T0: torch.Tensor,
              cfg: ICPConfig, mesh: Mesh, backend: str) -> ICPResult:
    """The ICP loop on this rank's frame shard and the rotating map shards."""
    inner = max(1, int(cfg.inner_steps))
    tol_sq = cfg.tol_delta ** 2
    outer = -(-cfg.max_iters // inner) if cfg.max_iters > 0 else 0
    num_valid_src = mesh.all_reduce(torch.sum(frame.mask.to(torch.float32)))
    carry = ep.init_carry(T0, cfg.max_iters)
    may_stop = mesh.size == 1 and carry.device.type == "cpu"
    points = frame.points.contiguous()
    mask = frame.mask.contiguous()
    spare = ([torch.empty_like(shard), torch.empty_like(shard)]
             if mesh.size > 1 else [])
    if backend == "kernel":
        state = ring_state(points.shape[0], points.device)
        last = mesh.size - 1

        def visit(s, held):
            ring_correspond_hop(points, mask, held, state, carry, s == 0,
                                s == last, cfg.max_corr_dist)
    for _ in range(outer):
        if may_stop and bool(carry[ep.DONE] != 0):
            break
        if backend == "kernel":
            # the hops move the points by the carry's pose and write q, n
            # and w into `state`
            _ring_hops(mesh, shard, spare, visit)
            q, n, w = state.q, state.n, state.w
        else:
            x = se3.transform_points(carry[ep.T_SLICE].reshape(4, 4), points)
            q, n, w = _ops_correspond(x, mask, shard, spare,
                                      cfg.max_corr_dist, mesh)
        for k in range(inner):
            # the reduction moves the points by the carry's current pose
            # (in the hops' order: the first solve sees the x they matched)
            partials = mesh.all_reduce(gn_reduce_partials_at_pose(
                points, q, n, w, carry[ep.T_SLICE], cfg.huber_delta,
                done=carry))
            carry, _ = ep.gn_epilogue(
                partials, carry, num_valid_src, cfg.damping, cfg.damping_abs,
                cfg.max_trans_step, cfg.max_rot_step, is_last=k == inner - 1,
                inner=inner, max_iters=cfg.max_iters, tol_sq=tol_sq)
    return _result(carry, tol_sq)


def captures(mesh: Mesh) -> bool:
    """Whether the ring replays a CUDA graph on this mesh: without a group
    (one rank, no collectives) or over NCCL, whose collectives and P2P
    run on the card and are captured into the graph.  Over gloo it runs
    op by op: gloo copies every CUDA collective through host memory,
    which a capture cannot hold.  A decision from the group's backend,
    taken before the call; nothing falls back at run time."""
    return mesh.backend in ("none", "nccl")


def _ring_align(_state, frame: PointCloud, map_shard: PointCloud,
                T0: torch.Tensor, *, mesh: Mesh, cfg: ICPConfig,
                backend: str):
    frame_mult = 8 * mesh.size if backend == "kernel" else mesh.size
    map_mult = 128 if backend == "kernel" else 1
    local = shard_cloud(PointCloud(
        points=pad_to_multiple(frame.points, frame_mult),
        normals=pad_to_multiple(frame.normals, frame_mult),
        mask=pad_to_multiple(frame.mask, frame_mult, fill=False)), mesh)
    shard = pad_to_multiple(pack_cloud_rows(*map_shard), map_mult)
    if shard.shape[1] != ROW_DIM:
        raise ValueError(f"map shard rows: {shard.shape}")
    res = _ring_icp(local, shard, T0, cfg, mesh, backend)
    return (), (res, flat_icp_scalars(res))


_RING_ALIGN = graphs.Program("ring_align", _ring_align)


def drop_graphs() -> None:
    """Drop the ring's captured graphs.  Their NCCL kernels use the
    communicator of the group they were captured on: call this before
    that group is destroyed."""
    _RING_ALIGN.drop()


@lru_cache(maxsize=32)
def make_ring_align_fn(mesh: Mesh, cfg: ICPConfig, backend: str = "kernel"):
    """The ring-ICP callable for one mesh, config and backend (cached).

    `call(frame, map_shard, T0, eager=False) -> (ICPResult, flat)`:
    `frame` is the whole frame cloud (every rank holds it) and is padded
    and sliced to this rank's shard here; `map_shard` is this rank's map
    shard (e.g. `ShardedVoxelMap.cloud_shards`).  Both are padded to the
    reference's multiples (frame 8·D and map rows 128 for "kernel", D and
    1 for "ops") with mask=False rows.  `flat` is `flat_icp_scalars` of
    the result (layout icp.FlatICP), so a host reads every gate in one
    transfer.

    On the card the call is one CUDA graph (tpuslam_torch/graphs.py) with
    its all-reduces and ring hops inside, keyed by the mesh's identity
    (`Mesh.graph_key`), cfg, the backend and the shapes, where `captures`
    allows it; on a gloo mesh, on the CPU or with `eager` it runs op by
    op.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    graphed = captures(mesh)

    def call(frame: PointCloud, map_shard: PointCloud, T0: torch.Tensor,
             eager: bool = False):
        return _RING_ALIGN.run(frame, map_shard, T0,
                               eager=eager or not graphed, mesh=mesh,
                               cfg=cfg, backend=backend)

    return call


def align_to_map_ring(frame: PointCloud, map_shard: PointCloud,
                      T0: torch.Tensor, cfg: ICPConfig, mesh: Mesh,
                      backend: str = "kernel") -> ICPResult:
    """Frame-to-map ICP with BOTH clouds sharded over the mesh.

    Frame points stay put; map shards ring-rotate each correspondence — a
    rank holds M/D map rows, yet correspondences are exact over the whole
    map within `max_corr_dist`.  Arguments as `make_ring_align_fn`'s call.
    """
    res, _flat = make_ring_align_fn(mesh, cfg, backend)(frame, map_shard, T0)
    return res
