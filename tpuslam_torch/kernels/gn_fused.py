"""Fused projective GN solve — port of `tpuslam/kernels/gn_fused.py` and of
the solve around it in the reference's fused ICP loop
(`tpuslam/icp.py:252-290`).

`gn_fused_step` is one GN solve of `icp._icp_loop_projective_fused` in one
launch: each source point's association row (transform by the gate pose,
project, round, clip to the image), the gather of that row, the gates at
the gate pose (in-bounds, distance, normal compatibility), the residual at
the carry's pose, Huber and the 30 sums, then the fold, the damped solve
and the update of the ICP loop's carry (layout in `kernels/gn_epilogue.py`)
IN PLACE.  The gate pose is the carry's T on the first solve of an outer
iteration (`is_first`), which also stores it in a 12-float buffer
(`gate_buffer`, made once per alignment) for the outer iteration's later
solves.  Once the carry's DONE is set a call writes nothing.  On a CUDA
tensor it launches `csrc/gn_fused.cu`; on a CPU tensor it runs the plain
twin `gn_fused_step_reference` and copies its results into the carry and
the buffer.

The twin repeats the kernel's steps: the gate transform in
`transform_points_ordered`'s order and the kernel's projection
(`association_rows_ordered`), the gather, `fused_terms`, the partial sums
in the kernel's grouping of points into blocks (`block_rows`), and the
epilogue's twin.  The row index and the validity w are bit-equal to the
kernel's; the sums agree to the order of summation.

`fused_terms` is the reference's elementwise formulation
(`_gates_and_residual` + `_reduce_outputs`), and `gn_fused_reference` the
reference's oracle with its signature (gathered rows in, (H, b,
num_inliers, Σw·r²) out); the tests hold both to the reference.

The kernel's last block folds the other blocks' rows after a ticket.  The
ticket word and the rows' scratch are `kernels/gn_step.py`'s, one of each
per stream (or per CUDA graph): launches on one stream share them in
order, launches on two streams never share them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.config import Intrinsics
from tpuslam_torch.geom.backproject import device_scalar
from tpuslam_torch.geom.se3 import transform_points_ordered
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels.gn_partials import (
    BLOCK_THREADS,
    NUM_SUMS,
    ROW,
    point_terms,
)
from tpuslam_torch.kernels.gn_step import num_blocks, scratch

counter = _build.LaunchCounter("gn_fused")

GATE_SIZE = 12            # rows 0-2 of the gate pose, row-major


def _max_d2(max_dist: float) -> float:
    """The reference's `jnp.asarray(max_dist, f32) ** 2`: squared in f32."""
    d = np.float32(max_dist)
    return float(d * d)


def _pixels(xg0, xg1, xg2, K: Intrinsics):
    """(in_front, u, v) of gate-time points: the kernel's projection,
    rounded half to even."""
    def s(v):
        return device_scalar(v, xg0)

    in_front = xg2 > 1e-6
    zsafe = torch.where(in_front, xg2, 1.0)
    u = xg0 / zsafe * s(K.fx) + s(K.cx)
    v = xg1 / zsafe * s(K.fy) + s(K.cy)
    return in_front, torch.round(u), torch.round(v)


def association_rows_ordered(T_gate, points, K: Intrinsics, height: int,
                             width: int) -> torch.Tensor:
    """(N,) int64 table row of each point's association at the gate pose,
    as the kernel computes it: the ordered transform, the gates'
    projection, the pixel clipped to the image (a NaN coordinate clips to
    0, as XLA's float-to-int conversion in the reference gives it)."""
    _, ui, vi = _pixels(*transform_points_ordered(T_gate, points).unbind(-1),
                        K)
    uc = torch.nan_to_num(ui, nan=0.0).clamp(0.0, width - 1.0)
    vc = torch.nan_to_num(vi, nan=0.0).clamp(0.0, height - 1.0)
    return vc.long() * width + uc.long()


def fused_terms(points, normals, mask, rows, T_gate, T_res, K: Intrinsics,
                width: int, height: int, max_dist: float,
                normal_dot_min: float, huber_delta: float) -> torch.Tensor:
    """(N, 30) per-point terms of the fused step, in the partials' order.

    Args:
      points, normals: (N, 3) float32 RAW source cloud.
      mask: (N,) bool source validity.
      rows: (N, 8) gathered target rows (`pack_organized_target` layout),
        float16 or float32; widened to float32 here.
      T_gate / T_res: float32 poses at the association / for the residuals,
        (4, 4) or their rows 0-2 as (3, 4).
    """
    f32 = torch.float32

    def s(v):
        return device_scalar(v, points)

    rg = [T_gate[a, b] for a in range(3) for b in range(3)]
    sn = normals.unbind(-1)
    r32 = rows.to(f32)
    q = (r32[:, 0], r32[:, 1], r32[:, 2])
    n = (r32[:, 3], r32[:, 4], r32[:, 5])
    dm = r32[:, 6]

    xg0, xg1, xg2 = transform_points_ordered(T_gate, points).unbind(-1)
    in_front, ui, vi = _pixels(xg0, xg1, xg2, K)
    in_bounds = ((ui >= 0.0) & (ui <= s(float(width)) - 1.0)
                 & (vi >= 0.0) & (vi <= s(float(height)) - 1.0))
    dq0, dq1, dq2 = xg0 - q[0], xg1 - q[1], xg2 - q[2]
    d2 = dq0 * dq0 + dq1 * dq1 + dq2 * dq2
    nr0 = rg[0] * sn[0] + rg[1] * sn[1] + rg[2] * sn[2]
    nr1 = rg[3] * sn[0] + rg[4] * sn[1] + rg[5] * sn[2]
    nr2 = rg[6] * sn[0] + rg[7] * sn[1] + rg[8] * sn[2]
    ndot = n[0] * nr0 + n[1] * nr1 + n[2] * nr2
    valid = (mask.to(f32) > 0.5) & (dm > 0.5) & in_front & in_bounds \
        & (d2 < s(_max_d2(max_dist))) & (ndot > s(normal_dot_min))

    xr = transform_points_ordered(T_res, points)
    return point_terms(xr, r32[:, 0:3], r32[:, 3:6], valid.to(f32),
                       huber_delta)


def gn_fused_reference(points, normals, mask, rows_gathered, T_gate, T_res,
                       K: Intrinsics, width: int, height: int,
                       max_dist: float, normal_dot_min: float,
                       huber_delta: float):
    """Plain twin with the reference oracle's signature: returns
    (H (6, 6), b (6,), num_inliers (), weighted_sq_sum ())."""
    counter.plain()
    sums = fused_terms(points, normals, mask, rows_gathered, T_gate, T_res,
                       K, width, height, max_dist, normal_dot_min,
                       huber_delta).sum(dim=0)
    iu, ju = torch.triu_indices(6, 6, device=points.device)
    H = torch.zeros((6, 6), dtype=sums.dtype, device=points.device)
    H[iu, ju] = sums[:21]
    H[ju, iu] = sums[:21]
    return H, sums[21:27], sums[28], sums[27]


def block_rows(terms: torch.Tensor, blocks: int) -> torch.Tensor:
    """(blocks, 32) partial sums in the kernel's grouping: point i goes to
    block (i // 256) % blocks, as the grid-stride loop hands it out."""
    n_pts = terms.shape[0]
    span = BLOCK_THREADS * blocks
    waves = max(1, -(-n_pts // span))
    terms = torch.nn.functional.pad(terms, (0, ROW - NUM_SUMS,
                                            0, waves * span - n_pts))
    return terms.reshape(waves, blocks, BLOCK_THREADS, ROW).sum(dim=(0, 2))


def fused_rows(points, normals, mask, packed, T_gate, T_res, K: Intrinsics,
               width: int, height: int, max_dist: float,
               normal_dot_min: float, huber_delta: float,
               blocks: int) -> torch.Tensor:
    """The kernel's rows of partial sums before its fold: the association
    at T_gate (`association_rows_ordered`), the gather, `fused_terms`,
    `block_rows`."""
    flat = association_rows_ordered(T_gate, points, K, height, width)
    return block_rows(fused_terms(points, normals, mask, packed[flat],
                                  T_gate, T_res, K, width, height, max_dist,
                                  normal_dot_min, huber_delta), blocks)


def gn_fused_step_reference(points, normals, mask, packed, carry, gate,
                            is_first: bool, K: Intrinsics, width: int,
                            height: int, max_dist: float,
                            normal_dot_min: float, huber_delta: float,
                            num_valid_src, damping: float,
                            damping_abs: float, max_trans: float,
                            max_rot: float, is_last: bool, inner: int,
                            max_iters: int, tol_sq: float):
    """Plain twin of the kernel.  Returns (carry_out, gate_out), new tensors
    (the inputs are left as they are)."""
    counter.plain()
    T_res = carry[ep.T_SLICE].reshape(4, 4)
    gate_now = T_res[:3].reshape(GATE_SIZE) if is_first else gate
    rows = fused_rows(points, normals, mask, packed, gate_now.reshape(3, 4),
                      T_res, K, width, height, max_dist, normal_dot_min,
                      huber_delta, num_blocks(points.shape[0]))
    carry_out, _ = ep.epilogue_plain(rows, carry, num_valid_src, damping,
                                     damping_abs, max_trans, max_rot,
                                     is_last, inner, max_iters, tol_sq)
    return carry_out, torch.where(carry[ep.DONE] != 0, gate, gate_now)


def gate_buffer(device) -> torch.Tensor:
    """The gate pose's buffer for one alignment (`gn_fused_step`'s `gate`);
    the first solve of each outer iteration fills it."""
    return torch.empty(GATE_SIZE, dtype=torch.float32, device=device)


def gn_fused_step(points: torch.Tensor, normals: torch.Tensor,
                  mask: torch.Tensor, packed: torch.Tensor,
                  carry: torch.Tensor, gate: torch.Tensor, is_first: bool,
                  K: Intrinsics, width: int, height: int, max_dist: float,
                  normal_dot_min: float, huber_delta: float,
                  num_valid_src: torch.Tensor, damping: float,
                  damping_abs: float, max_trans: float, max_rot: float,
                  is_last: bool, inner: int, max_iters: int,
                  tol_sq: float) -> torch.Tensor:
    """One fused GN solve; updates `carry` (and on `is_first` `gate`) in
    place and returns the carry.

    Args:
      points, normals: (N, 3) float32 RAW source cloud (not transformed).
      mask: (N,) bool source validity.
      packed: (H·W, 8) target table (`pack_organized_target`), float16 or
        float32.
      carry: (64,) float32 ICP loop carry: its T is the residual pose, and
        on `is_first` the gate pose too.
      gate: (12,) float32 `gate_buffer`: rows 0-2 of the gate pose, read
        when `is_first` is False; written (the carry's T) when it is True.
      K / width / height: target camera.
      max_dist / normal_dot_min / huber_delta: gates and robust loss (the
        normal gate always applies: pass ≤ -1 to disable it).
      num_valid_src, damping, damping_abs, max_trans, max_rot, is_last,
      inner, max_iters, tol_sq: as `gn_epilogue`.
    """
    if points.device.type == "cpu":
        carry_out, gate_out = gn_fused_step_reference(
            points, normals, mask, packed, carry, gate, is_first, K, width,
            height, max_dist, normal_dot_min, huber_delta, num_valid_src,
            damping, damping_abs, max_trans, max_rot, is_last, inner,
            max_iters, tol_sq)
        gate.copy_(gate_out)
        return carry.copy_(carry_out)
    if points.device.type != "cuda":
        raise ValueError(f"gn_fused_step: no kernel for {points.device}")
    dev = points.device
    n_pts = points.shape[0]
    for name, t in (("points", points), ("normals", normals)):
        _build.require(t, name, dtype=torch.float32, shape=(n_pts, 3),
                       device=dev)
    _build.require(mask, "mask", dtype=torch.bool, shape=(n_pts,),
                   device=dev)
    if packed.dtype not in (torch.float16, torch.float32):
        raise TypeError(f"packed: dtype {packed.dtype}, kernel takes float16 "
                        f"or float32")
    _build.require(packed, "packed", dtype=packed.dtype,
                   shape=(height * width, 8), device=dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    _build.require(carry, "carry", dtype=torch.float32,
                   shape=(ep.CARRY_SIZE,), device=dev)
    _build.require(gate, "gate", dtype=torch.float32, shape=(GATE_SIZE,),
                   device=dev)
    _build.require(num_valid_src, "num_valid_src", dtype=torch.float32,
                   shape=(), device=dev)
    ticket, rows = scratch(dev)
    stream = _build.stream_handle(points)
    err = _build.library().tpuslam_gn_fused_step(
        points.data_ptr(), normals.data_ptr(), mask.data_ptr(),
        packed.data_ptr(), int(packed.dtype == torch.float16), n_pts, height,
        width, K.fx, K.fy, K.cx, K.cy, _max_d2(max_dist), normal_dot_min,
        huber_delta, carry.data_ptr(), gate.data_ptr(), int(is_first),
        num_valid_src.data_ptr(), damping, damping_abs, max_trans, max_rot,
        int(is_last), int(inner), int(max_iters), tol_sq, rows.data_ptr(),
        ticket.data_ptr(), num_blocks(n_pts), stream)
    if err != 0:
        ticket.zero_()    # a refused launch must not leave a count behind
    _build.check_launch(err, "gn_fused")
    counter.launched(stream)
    return carry
