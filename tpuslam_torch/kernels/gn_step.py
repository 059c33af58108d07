"""One GN solve of the ICP loop in one launch — the GN step of
`tpuslam/icp.py:129-139`: ``x = transform_points(T, src.points)``, then
`gn_reduce_partials_pallas`, then `gn_epilogue_pallas`.

`gn_step` transforms the untransformed source points by the carry's pose,
reduces the point-to-plane system against a fixed association (q, n, w
from `kernels/correspond.py`), folds, solves and updates the ICP loop's
carry (layout in `kernels/gn_epilogue.py`) IN PLACE: the carry passed in
is the carry returned.  Once the carry's DONE is set a call writes
nothing.  On a CUDA tensor it launches `csrc/gn_step.cu`; on a CPU tensor
it runs the plain twin `gn_step_reference` and copies its result into the
carry.

The twin repeats the kernel's steps: the transform in the kernel's order
(bit for bit), the partials rows of `kernels/gn_partials.py`'s twin, the
fold in the kernels' grouping and the epilogue's twin.  Kernel and twin
assign points to rows differently, so they agree to the order of
summation, not bit for bit.

The kernel's last block folds the other blocks' rows after an atomic
ticket.  The ticket word and the rows' scratch are one persistent buffer
each per stream, owned by this module and shared with
`kernels/gn_fused.py`'s kernel: launches on one stream run in order, so
the ticket is back at zero before the next launch reads it, and launches
on two streams (tracking on the main stream, a loop-closure attempt on the
SLAM backend's worker stream) never share a ticket or a row.  A CUDA
graph (tpuslam_torch/graphs.py) bakes in scratch of its own, made at its
warm-up, so two graphs replayed at once never share one either.
"""

from __future__ import annotations

import threading

import torch

from tpuslam_torch.geom.se3 import transform_points_ordered
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.gn_partials import BLOCK_THREADS, ROW, partial_rows

counter = _build.LaunchCounter("gn_step")

# The default grid's cap: one block per SM of an H100.  Against two blocks
# an SM it halves the last block's fold, and read 10.014 against 10.358 µs
# of device time a solve at 153,600 points (chip_smoke.py, NVIDIA H100 80GB
# HBM3, 700 W; the same CUDA-event time).
MAX_BLOCKS = 132
SCRATCH_ROWS = 264        # the largest grid a launch may take
# (device, stream or graph) → (ticket int32[1], partials rows)
_workspace: dict = {}
_workspace_lock = threading.Lock()
_build.register_workspace(_workspace, _workspace_lock)


def num_blocks(n_points: int, max_blocks: int = MAX_BLOCKS) -> int:
    """The kernel's grid for `n_points` (one row of partials a block)."""
    return max(1, min(-(-n_points // BLOCK_THREADS), max_blocks))


def gn_step_reference(points, q, n, w_valid, carry, num_valid_src,
                      huber_delta: float, damping: float, damping_abs: float,
                      max_trans: float, max_rot: float, is_last: bool,
                      inner: int, max_iters: int, tol_sq: float,
                      blocks: int | None = None) -> torch.Tensor:
    """Plain twin of the kernel; returns a new carry (the input is left as
    it is).  `blocks`: the rows of partials (the kernel's grid)."""
    counter.plain()
    x = transform_points_ordered(carry[ep.T_SLICE].reshape(4, 4), points)
    rows = partial_rows(x, q, n, w_valid, huber_delta,
                        blocks or num_blocks(points.shape[0]))
    carry_out, _ = ep.epilogue_plain(rows, carry, num_valid_src, damping,
                                     damping_abs, max_trans, max_rot,
                                     is_last, inner, max_iters, tol_sq)
    return carry_out


def scratch(dev: torch.device):
    """The ticket word (zero between launches) and rows of the current
    stream on `dev` — of the graph, while one is warmed up or captured
    (`_build.scratch_key`).  They are made on that stream, so the ticket's
    zero fill runs before the stream's first launch, and the caching
    allocator ties the blocks to the stream that uses them.  Stream handles
    come from PyTorch's fixed pools, so the table stays small."""
    key = _build.scratch_key(dev)
    with _workspace_lock:
        if key not in _workspace:
            _workspace[key] = (
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.empty((SCRATCH_ROWS, ROW), dtype=torch.float32,
                            device=dev))
        return _workspace[key]


def gn_step(points: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
            w_valid: torch.Tensor, carry: torch.Tensor,
            num_valid_src: torch.Tensor, huber_delta: float, damping: float,
            damping_abs: float, max_trans: float, max_rot: float,
            is_last: bool, inner: int, max_iters: int, tol_sq: float,
            blocks: int | None = None) -> torch.Tensor:
    """One GN solve; updates `carry` in place and returns it.

    Args:
      points: (N, 3) float32 source points, untransformed (the kernel
        applies the carry's pose).
      q, n: (N, 3) float32 matched target points and normals.
      w_valid: (N,) float32 {0,1} validity of each match.
      carry: (64,) float32 ICP loop carry, updated in place.
      num_valid_src: () float32 Σ source mask (inlier-fraction denominator).
      huber_delta, damping, damping_abs, max_trans, max_rot, is_last,
      inner, max_iters, tol_sq: as `gn_reduce_partials_at_pose` and
        `gn_epilogue`.
      blocks: the grid (default `num_blocks(N)`), at most 264.
    """
    if points.device.type == "cpu":
        return carry.copy_(gn_step_reference(
            points, q, n, w_valid, carry, num_valid_src, huber_delta,
            damping, damping_abs, max_trans, max_rot, is_last, inner,
            max_iters, tol_sq, blocks))
    if points.device.type != "cuda":
        raise ValueError(f"gn_step: no kernel for {points.device}")
    dev = points.device
    n_pts = points.shape[0]
    for name, t in (("points", points), ("q", q), ("n", n)):
        _build.require(t, name, dtype=torch.float32, shape=(n_pts, 3),
                       device=dev)
    _build.require(w_valid, "w_valid", dtype=torch.float32, shape=(n_pts,),
                   device=dev)
    _build.require(carry, "carry", dtype=torch.float32,
                   shape=(ep.CARRY_SIZE,), device=dev)
    _build.require(num_valid_src, "num_valid_src", dtype=torch.float32,
                   shape=(), device=dev)
    nb = blocks or num_blocks(n_pts)
    if not 1 <= nb <= SCRATCH_ROWS:
        raise ValueError(f"blocks: {nb}, kernel takes 1..{SCRATCH_ROWS}")
    ticket, rows = scratch(dev)
    stream = _build.stream_handle(points)
    err = _build.library().tpuslam_gn_step(
        points.data_ptr(), q.data_ptr(), n.data_ptr(), w_valid.data_ptr(),
        n_pts, huber_delta, carry.data_ptr(), num_valid_src.data_ptr(),
        damping, damping_abs, max_trans, max_rot, int(is_last), int(inner),
        int(max_iters), tol_sq, rows.data_ptr(), ticket.data_ptr(), nb,
        stream)
    if err != 0:
        ticket.zero_()    # a refused launch must not leave a count behind
    _build.check_launch(err, "gn_step")
    counter.launched(stream)
    return carry
