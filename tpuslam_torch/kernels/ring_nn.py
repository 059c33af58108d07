"""One hop of the ring map-exchange nearest neighbour — port of
`tpuslam/kernels/pallas_ring.py` (`ring_nn`).

A map shard is a packed (M, 8) float32 row table `[q, n, valid, 0]`
(`pack_cloud_rows`, the row-major form of the reference's column table).
`ring_nn_hop` scores every query x against every row as
``(|q|² + (1 − valid)·1e30) − (2x)·q`` — the squared distance less |x|²,
which the caller adds back — and merges the hop into a running best: the
first row of the least score within the hop, taken only where it is
strictly less than the running score (so an earlier hop wins ties, as the
reference's merge across blocks and hops does).  The running best score
(N,) and row (N, 8) are updated IN PLACE: the ring calls one hop per
shard on the same two tensors.

On a CUDA tensor it launches `csrc/ring_nn.cu`; on a CPU tensor it runs
the plain twin `ring_nn_hop_reference`, which has the same arithmetic,
chunked over `block_m` rows so that it never holds an (N, M) matrix.  The
two are bit-equal on the card.
"""

from __future__ import annotations

import torch

from tpuslam_torch.kernels import _build

counter = _build.LaunchCounter()

ROW_DIM = 8                 # packed row: [x y z nx ny nz valid 0]
_BIG = 1e30                 # pushes invalid rows out of every minimum


def pack_cloud_rows(points: torch.Tensor, normals: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(M, 3) + (M, 3) + (M,) → (M, 8) float32 row table."""
    return torch.cat([points, normals, mask.to(points.dtype)[:, None],
                      torch.zeros_like(points[:, :1])], dim=1).contiguous()


def init_best(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The running best before the first hop: score +inf, a zero row."""
    return (torch.full((n,), float("inf"), device=device),
            torch.zeros((n, ROW_DIM), device=device))


def ring_nn_hop_reference(x: torch.Tensor, shard: torch.Tensor,
                          best_score: torch.Tensor, best_row: torch.Tensor,
                          block_m: int = 512) -> None:
    """Plain twin of the hop kernel (same products and sums, same order)."""
    counter.plain_calls += 1
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


def ring_nn_hop(x: torch.Tensor, shard: torch.Tensor,
                best_score: torch.Tensor, best_row: torch.Tensor,
                done: torch.Tensor | None = None) -> None:
    """Merge one shard's nearest rows into the running best, in place.

    Args:
      x: (N, 3) float32 queries in the map's frame.
      shard: (M, 8) float32 packed rows (`pack_cloud_rows`).
      best_score: (N,) float32 running least score (+inf before hop 0).
      best_row: (N, 8) float32 running winning row.
      done: optional float32 tensor whose element 0, when non-zero, makes
        the kernel leave the running best as it is (the ICP loop's
        device-side early exit).  The CPU twin ignores it.
    """
    if x.device.type == "cpu":
        ring_nn_hop_reference(x, shard, best_score, best_row)
        return
    if x.device.type != "cuda":
        raise ValueError(f"ring_nn_hop: no kernel for {x.device}")
    dev = x.device
    n, m = x.shape[0], shard.shape[0]
    _build.require(x, "x", dtype=torch.float32, shape=(n, 3), device=dev)
    _build.require(shard, "shard", dtype=torch.float32, shape=(m, ROW_DIM),
                   device=dev)
    _build.require(best_score, "best_score", dtype=torch.float32,
                   shape=(n,), device=dev)
    _build.require(best_row, "best_row", dtype=torch.float32,
                   shape=(n, ROW_DIM), device=dev)
    for name, t in (("shard", shard), ("best_row", best_row)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    if done is not None:
        _build.require(done, "done", dtype=torch.float32, device=dev)
    if n == 0:
        return
    lib = _build.library()
    slices = lib.tpuslam_ring_nn_slices(m)
    part_score = torch.empty((slices, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((slices, n), dtype=torch.int32, device=dev)
    tickets = torch.zeros((lib.tpuslam_ring_nn_query_tiles(n),),
                          dtype=torch.int32, device=dev)
    err = lib.tpuslam_ring_nn(
        x.data_ptr(), shard.data_ptr(), n, m,
        done.data_ptr() if done is not None else None, part_score.data_ptr(),
        part_idx.data_ptr(), tickets.data_ptr(), best_score.data_ptr(),
        best_row.data_ptr(), _build.stream_handle(x))
    _build.check_launch(err, "ring_nn")
    counter.launches += 1
