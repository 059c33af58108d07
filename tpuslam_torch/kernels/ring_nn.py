"""The ring map-exchange nearest neighbour, one hop a launch — port of
`tpuslam/kernels/pallas_ring.py` (`ring_nn`) and of the correspondence
around it, `tpuslam/dist/ring_map.py:_ring_best_correspond_pallas`.

A map shard is a packed (M, 8) float32 row table `[q, n, valid, 0]`
(`pack_cloud_rows`, the row-major form of the reference's column table).
A hop scores every query x against every row as
``(|q|² + (1 − valid)·1e30) − (2x)·q`` — the squared distance less |x|² —
and merges the hop into a running best: the first row of the least score
within the hop, taken only where it is strictly less than the running
score (so an earlier hop wins ties, as the reference's merge across blocks
and hops does).

`ring_correspond_hop`, the ring ICP's hop, launches `csrc/ring_nn.cu`.
It moves the frame points by the ICP loop carry's pose itself (the kernel
always reads the pose), starts the running best on the ring's first hop,
and on its last applies the reference's gates (d² = max(score + |x|², 0)
under `max_dist`, a valid row, a unit normal, the source mask) and writes
x, q, n and w into a `RingState` for the GN reduction.  Once the carry's
DONE is set it reads and writes nothing.

On CPU tensors it runs the plain twin `ring_correspond_hop_reference`,
which has the same steps and arithmetic, chunked over `block_m` rows so
that it never holds an (N, M) matrix.  Its merge is also that of
`ring_nn_hop_reference`, the bare hop on queries already in the map's
frame into a running best (`init_best`), which the tests hold to the
reference's Pallas kernel.  Kernel and twin are bit-equal on the card.
The kernel scores only the valid rows (and each block's first invalid
one, which stands for all of them: every invalid row scores the same
1e30); the twin scores every row.

The kernel's partials and tickets are one persistent buffer each per
stream (or per CUDA graph under capture), owned by this module (they grow
to the largest hop seen on that stream): launches on one stream share
them in order, launches on two streams never share them.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from tpuslam_torch.geom.se3 import transform_points_ordered
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import gn_epilogue as ep

counter = _build.LaunchCounter("ring_nn")

ROW_DIM = 8                 # packed row: [x y z nx ny nz valid 0]
_BIG = 1e30                 # pushes invalid rows out of every minimum
_workspace: dict = {}       # (device, stream or graph) → (tickets, partials)
_workspace_lock = threading.Lock()
_build.register_workspace(_workspace, _workspace_lock)


class RingState(NamedTuple):
    """The ring correspondence's buffers for one alignment (N queries)."""

    score: torch.Tensor     # (N,) running least score, |q|² − 2x·q
    row: torch.Tensor       # (N, 8) running winning row
    x: torch.Tensor         # (N, 3) queries at the pose (last hop)
    q: torch.Tensor         # (N, 3) matched map points (last hop)
    n: torch.Tensor         # (N, 3) matched map normals (last hop)
    w: torch.Tensor         # (N,) {0, 1} validity of each match (last hop)


def ring_state(n: int, device) -> RingState:
    """The buffers, made once per alignment (no hop allocates or fills);
    the first hop writes the running best and the last the rest."""
    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return RingState(score=e(n), row=e(n, ROW_DIM), x=e(n, 3), q=e(n, 3),
                     n=e(n, 3), w=e(n))


def pack_cloud_rows(points: torch.Tensor, normals: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(M, 3) + (M, 3) + (M,) → (M, 8) float32 row table."""
    return torch.cat([points, normals, mask.to(points.dtype)[:, None],
                      torch.zeros_like(points[:, :1])], dim=1).contiguous()


def init_best(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The running best before the first hop: score +inf, a zero row."""
    return (torch.full((n,), float("inf"), device=device),
            torch.zeros((n, ROW_DIM), device=device))


def _merge_hop(x: torch.Tensor, shard: torch.Tensor,
               best_score: torch.Tensor, best_row: torch.Tensor,
               block_m: int) -> None:
    """The hop's products and sums in the kernel's order, merged in place."""
    x2 = 2.0 * x
    for c0 in range(0, shard.shape[0], block_m):
        q = shard[c0:c0 + block_m]
        qq = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
        cst = qq + (1.0 - q[:, 6]) * _BIG
        g = (x2[:, 0:1] * q[None, :, 0] + x2[:, 1:2] * q[None, :, 1]
             + x2[:, 2:3] * q[None, :, 2])
        score, j = torch.min(cst[None, :] - g, dim=1)   # first index on ties
        better = score < best_score
        best_score.copy_(torch.where(better, score, best_score))
        best_row.copy_(torch.where(better[:, None], q[j], best_row))


def ring_nn_hop_reference(x: torch.Tensor, shard: torch.Tensor,
                          best_score: torch.Tensor, best_row: torch.Tensor,
                          block_m: int = 512) -> None:
    """The bare hop: queries already in the map's frame merged into the
    running best, with the kernel's products and sums in its order (the
    reference's `ring_nn` hop; `ring_correspond_hop`'s merge)."""
    counter.plain()
    _merge_hop(x, shard, best_score, best_row, block_m)


def ring_correspond_hop_reference(points: torch.Tensor, mask: torch.Tensor,
                                  shard: torch.Tensor, state: RingState,
                                  T: torch.Tensor, first: bool, last: bool,
                                  max_dist: float,
                                  block_m: int = 512) -> None:
    """Plain twin of the ring ICP's hop, in place on `state`: the ordered
    transform, a fresh running best on the first hop, the merge, and on the
    last hop the gates in the kernel's order."""
    counter.plain()
    x = transform_points_ordered(T, points)
    if first:
        state.score.fill_(float("inf"))
        state.row.zero_()
    _merge_hop(x, shard, state.score, state.row, block_m)
    if not last:
        return
    xx = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    d2 = torch.clamp(state.score + xx, min=0.0)
    found = (state.row[:, 6] > 0.5) & torch.isfinite(state.score)
    nrm = state.row[:, 3:6]
    has_normal = (nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                  + nrm[:, 2] * nrm[:, 2]) > 0.5
    valid = mask & found & (d2 < max_dist * max_dist) & has_normal
    state.x.copy_(x)
    state.q.copy_(state.row[:, :3])
    state.n.copy_(nrm)
    state.w.copy_(valid.to(torch.float32))


def _scratch(dev: torch.device, tiles: int, cells: int):
    """The current stream's (or graph's, `_build.scratch_key`) tickets
    (zero between launches) and partials (a score and a row index a cell)
    on `dev`, grown to at least `tiles`
    tickets and `cells` cells.  They are made on that stream, so a grown
    workspace frees the old one in the stream's order: no launch of
    another stream ever reads it."""
    key = _build.scratch_key(dev)
    with _workspace_lock:
        ws = _workspace.get(key)
        if ws is None or ws[0].numel() < tiles or ws[1].numel() < 2 * cells:
            tiles = max(tiles, ws[0].numel() if ws else 0)
            cells = max(cells, ws[1].numel() // 2 if ws else 0)
            ws = (torch.zeros(tiles, dtype=torch.int32, device=dev),
                  torch.empty(2 * cells, dtype=torch.float32, device=dev))
            _workspace[key] = ws
        return ws


def _launch(pts, carry, shard, best_score, best_row, first: bool,
            gates) -> None:
    """Check the inputs and launch one hop at the carry's pose (its T, read
    on the device; nothing runs once its DONE is set).  `gates`: None, or
    (mask, max_dist, x, q, n, w) for the last hop."""
    dev = pts.device
    n, m = pts.shape[0], shard.shape[0]
    _build.require(pts, "points", dtype=torch.float32, shape=(n, 3),
                   device=dev)
    _build.require(shard, "shard", dtype=torch.float32, shape=(m, ROW_DIM),
                   device=dev)
    _build.require(best_score, "best_score", dtype=torch.float32,
                   shape=(n,), device=dev)
    _build.require(best_row, "best_row", dtype=torch.float32,
                   shape=(n, ROW_DIM), device=dev)
    for name, t in (("shard", shard), ("best_row", best_row)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    out = [None] * 5
    max_dist_sq = 0.0
    if gates is not None:
        mask, max_dist, *out_t = gates
        _build.require(mask, "mask", dtype=torch.bool, shape=(n,), device=dev)
        for name, t, shape in zip(("x", "q", "n", "w"), out_t,
                                  ((n, 3), (n, 3), (n, 3), (n,))):
            _build.require(t, name, dtype=torch.float32, shape=shape,
                           device=dev)
        out = [mask.data_ptr()] + [t.data_ptr() for t in out_t]
        max_dist_sq = max_dist * max_dist
    if n == 0:
        return
    stream = _build.stream_handle(pts)
    lib = _build.library()
    slices = lib.tpuslam_ring_nn_slices(n, m)
    tickets, part = _scratch(dev, lib.tpuslam_ring_nn_query_tiles(n),
                             slices * n)
    err = lib.tpuslam_ring_nn(
        pts.data_ptr(), carry.data_ptr() + 4 * ep.T_SLICE.start,
        shard.data_ptr(), n, m, slices, carry.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), best_score.data_ptr(), best_row.data_ptr(),
        int(first), out[0], max_dist_sq, *out[1:], stream)
    if err != 0:
        tickets.zero_()    # a refused launch must not leave a count behind
    _build.check_launch(err, "ring_nn")
    counter.launched(stream)


def ring_correspond_hop(points: torch.Tensor, mask: torch.Tensor,
                        shard: torch.Tensor, state: RingState,
                        carry: torch.Tensor, first: bool, last: bool,
                        max_dist: float) -> None:
    """One hop of the ring correspondence at the carry's pose, in place.

    Args:
      points: (N, 3) float32 frame points in the frame's own camera; the
        kernel applies the carry's pose.
      mask: (N,) bool frame validity.
      shard: (M, 8) float32 packed map rows held at this hop.
      state: this alignment's `RingState`.
      carry: (64,) float32 ICP loop carry (kernels/gn_epilogue.py): its
        pose moves the points; once its DONE is set the hop does nothing.
      first: the ring's first hop — the running best starts here.
      last: the ring's last hop — the gates run and x, q, n, w are written.
      max_dist: the correspondence radius.
    """
    if points.device.type == "cpu":
        if not bool(carry[ep.DONE] != 0):
            ring_correspond_hop_reference(
                points, mask, shard, state, carry[ep.T_SLICE].reshape(4, 4),
                first, last, max_dist)
        return
    if points.device.type != "cuda":
        raise ValueError(f"ring_correspond_hop: no kernel for "
                         f"{points.device}")
    _build.require(carry, "carry", dtype=torch.float32,
                   shape=(ep.CARRY_SIZE,), device=points.device)
    _launch(points, carry, shard, state.score, state.row, first,
            (mask, max_dist, state.x, state.q, state.n, state.w)
            if last else None)

