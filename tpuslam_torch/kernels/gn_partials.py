"""GN reduction to per-block partial sums — port of
`tpuslam/kernels/pallas_gn.py`.

`gn_reduce_partials` reduces matched points to a (num_blocks, 32) float32
table: row = one block's 30 sums (21 upper-triangle H entries in row-major
order, 6 b entries, Σw·r², Σvalid, Σw) and two zero columns.  On a CUDA
tensor it launches `csrc/gn_partials.cu`; on a CPU tensor it runs the plain
twin `gn_reduce_partials_reference`.  The two assign points to blocks
differently, so they agree after the fold to the order of summation
(rel 1e-4), not bit for bit.  `fold_partials` gives (H, b, stats) like the
reference's `gn_reduce_pallas`.
"""

from __future__ import annotations

import torch

from tpuslam_torch.kernels import _build

counter = _build.LaunchCounter()

NUM_SUMS = 30
ROW = 32
BLOCK_THREADS = 256
MAX_BLOCKS = 264          # two blocks per SM of an H100 (132 SMs)


def num_blocks(n_points: int) -> int:
    """Rows of the partials table for `n_points` (the kernel's grid)."""
    return max(1, min(-(-n_points // BLOCK_THREADS), MAX_BLOCKS))


def point_terms(x, q, n, w_valid, huber_delta: float) -> torch.Tensor:
    """(N, 30) per-point terms of the reduction, in the partials' order."""
    x0, x1, x2 = x.unbind(-1)
    q0, q1, q2 = q.unbind(-1)
    n0, n1, n2 = n.unbind(-1)
    r = n0 * (x0 - q0) + n1 * (x1 - q1) + n2 * (x2 - q2)
    ar = torch.abs(r)
    hub = torch.where(ar <= huber_delta, 1.0,
                      huber_delta / torch.clamp(ar, min=1e-12))
    w = w_valid * hub
    j = (n0, n1, n2, x1 * n2 - x2 * n1, x2 * n0 - x0 * n2, x0 * n1 - x1 * n0)
    vals = []
    for a in range(6):
        wja = w * j[a]
        for b in range(a, 6):
            vals.append(wja * j[b])
    wr = w * r
    vals += [wr * j[a] for a in range(6)]
    vals += [wr * r, w_valid, w]
    return torch.stack(vals, dim=-1)


def gn_reduce_partials_reference(x, q, n, w_valid,
                                 huber_delta: float) -> torch.Tensor:
    """Plain twin: contiguous chunks of points per block row."""
    counter.plain_calls += 1
    n_pts = x.shape[0]
    nb = num_blocks(n_pts)
    terms = point_terms(x, q, n, w_valid, huber_delta)
    chunk = max(1, -(-n_pts // nb))
    terms = torch.nn.functional.pad(terms, (0, ROW - NUM_SUMS,
                                            0, nb * chunk - n_pts))
    return terms.reshape(nb, chunk, ROW).sum(dim=1)


def gn_reduce_partials(x: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                       w_valid: torch.Tensor, huber_delta: float,
                       done: torch.Tensor | None = None) -> torch.Tensor:
    """Reduce matched points to (num_blocks(N), 32) partial sums.

    Args:
      x, q, n: (N, 3) float32 transformed source / matched target / target
        normals.
      w_valid: (N,) float32 {0,1} validity.
      huber_delta: Huber knee (metres).
      done: optional float32 tensor; when its element 0 is non-zero the
        kernel writes zero partials without reading the points.  The CPU
        twin ignores it.
    """
    if x.device.type == "cpu":
        return gn_reduce_partials_reference(x, q, n, w_valid, huber_delta)
    if x.device.type != "cuda":
        raise ValueError(f"gn_reduce_partials: no kernel for {x.device}")
    dev = x.device
    n_pts = x.shape[0]
    for name, t in (("x", x), ("q", q), ("n", n)):
        _build.require(t, name, dtype=torch.float32, shape=(n_pts, 3),
                       device=dev)
    _build.require(w_valid, "w_valid", dtype=torch.float32, shape=(n_pts,),
                   device=dev)
    if done is not None:
        _build.require(done, "done", dtype=torch.float32, device=dev)
    nb = num_blocks(n_pts)
    partials = torch.empty((nb, ROW), dtype=torch.float32, device=dev)
    err = _build.library().tpuslam_gn_partials(
        x.data_ptr(), q.data_ptr(), n.data_ptr(), w_valid.data_ptr(), n_pts,
        huber_delta, done.data_ptr() if done is not None else None,
        partials.data_ptr(), nb, _build.stream_handle(x))
    _build.check_launch(err, "gn_partials")
    counter.launches += 1
    return partials


def fold_partials(partials: torch.Tensor):
    """Fold a partials table: (H (6,6), b (6,), num_inliers, Σw·r², Σw)."""
    sums = partials.sum(dim=0)
    iu, ju = torch.triu_indices(6, 6, device=partials.device)
    H = torch.zeros((6, 6), dtype=partials.dtype, device=partials.device)
    H[iu, ju] = sums[:21]
    H[ju, iu] = sums[:21]
    return H, sums[21:27], sums[28], sums[27], sums[29]
