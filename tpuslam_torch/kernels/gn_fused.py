"""Fused projective GN step — port of `tpuslam/kernels/gn_fused.py`.

One pass per GN solve: the gate-time transform (pose at the association),
projection / bounds / distance / normal-compatibility gates, the
residual-time transform (freshly updated pose), the point-to-plane
residual, Huber and the 30-sum reduction.  `gn_fused_partials` writes the
(num_blocks, 32) partials table of `kernels/gn_partials.py`, which the
epilogue kernel folds and solves.  On a CUDA tensor it launches
`csrc/gn_fused.cu`, which also does the association's row gather
(`packed[flat]`) in registers; on a CPU tensor it runs the plain twin
`gn_fused_partials_reference`.

`gn_fused_reference` is the reference's oracle with the reference's
signature (gathered rows in, (H, b, num_inliers, Σw·r²) out); both twins
share `fused_terms`, the reference's elementwise formulation
(`_gates_and_residual` + `_reduce_outputs`): scalar-broadcast transforms
summed left to right, so the validity w is bit-equal to the kernel's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.config import Intrinsics
from tpuslam_torch.geom.backproject import device_scalar
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels.gn_partials import (
    NUM_SUMS,
    ROW,
    num_blocks,
    point_terms,
)

counter = _build.LaunchCounter()


def _max_d2(max_dist: float) -> float:
    """The reference's `jnp.asarray(max_dist, f32) ** 2`: squared in f32."""
    d = np.float32(max_dist)
    return float(d * d)


def fused_terms(points, normals, mask, rows, T_gate, T_res, K: Intrinsics,
                width: int, height: int, max_dist: float,
                normal_dot_min: float, huber_delta: float) -> torch.Tensor:
    """(N, 30) per-point terms of the fused step, in the partials' order.

    Args:
      points, normals: (N, 3) float32 RAW source cloud.
      mask: (N,) bool source validity.
      rows: (N, 8) gathered target rows (`pack_organized_target` layout),
        float16 or float32; widened to float32 here.
      T_gate / T_res: (4, 4) float32 poses at the association / for the
        residuals.
    """
    f32 = torch.float32

    def s(v):
        return device_scalar(v, points)

    rg = [T_gate[a, b] for a in range(3) for b in range(3)]
    tg = [T_gate[a, 3] for a in range(3)]
    rr = [T_res[a, b] for a in range(3) for b in range(3)]
    tr = [T_res[a, 3] for a in range(3)]
    p = points.unbind(-1)
    sn = normals.unbind(-1)
    r32 = rows.to(f32)
    q = (r32[:, 0], r32[:, 1], r32[:, 2])
    n = (r32[:, 3], r32[:, 4], r32[:, 5])
    dm = r32[:, 6]

    xg0 = rg[0] * p[0] + rg[1] * p[1] + rg[2] * p[2] + tg[0]
    xg1 = rg[3] * p[0] + rg[4] * p[1] + rg[5] * p[2] + tg[1]
    xg2 = rg[6] * p[0] + rg[7] * p[1] + rg[8] * p[2] + tg[2]
    in_front = xg2 > 1e-6
    zsafe = torch.where(in_front, xg2, 1.0)
    u = xg0 / zsafe * s(K.fx) + s(K.cx)
    v = xg1 / zsafe * s(K.fy) + s(K.cy)
    ui = torch.round(u)
    vi = torch.round(v)
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

    xr0 = rr[0] * p[0] + rr[1] * p[1] + rr[2] * p[2] + tr[0]
    xr1 = rr[3] * p[0] + rr[4] * p[1] + rr[5] * p[2] + tr[1]
    xr2 = rr[6] * p[0] + rr[7] * p[1] + rr[8] * p[2] + tr[2]
    xr = torch.stack([xr0, xr1, xr2], dim=-1)
    return point_terms(xr, r32[:, 0:3], r32[:, 3:6], valid.to(f32),
                       huber_delta)


def gn_fused_reference(points, normals, mask, rows_gathered, T_gate, T_res,
                       K: Intrinsics, width: int, height: int,
                       max_dist: float, normal_dot_min: float,
                       huber_delta: float):
    """Plain twin with the reference oracle's signature: returns
    (H (6, 6), b (6,), num_inliers (), weighted_sq_sum ())."""
    counter.plain_calls += 1
    sums = fused_terms(points, normals, mask, rows_gathered, T_gate, T_res,
                       K, width, height, max_dist, normal_dot_min,
                       huber_delta).sum(dim=0)
    iu, ju = torch.triu_indices(6, 6, device=points.device)
    H = torch.zeros((6, 6), dtype=sums.dtype, device=points.device)
    H[iu, ju] = sums[:21]
    H[ju, iu] = sums[:21]
    return H, sums[21:27], sums[28], sums[27]


def gn_fused_partials_reference(points, normals, mask, packed, flat, T_gate,
                                T_res, K: Intrinsics, width: int,
                                height: int, max_dist: float,
                                normal_dot_min: float,
                                huber_delta: float) -> torch.Tensor:
    """Plain twin of the kernel: gather, terms, contiguous chunks of points
    per block row (the layout of `gn_reduce_partials_reference`)."""
    counter.plain_calls += 1
    n_pts = points.shape[0]
    nb = num_blocks(n_pts)
    terms = fused_terms(points, normals, mask, packed[flat.long()],
                        T_gate.reshape(4, 4), T_res.reshape(4, 4), K, width,
                        height, max_dist, normal_dot_min, huber_delta)
    chunk = max(1, -(-n_pts // nb))
    terms = torch.nn.functional.pad(terms, (0, ROW - NUM_SUMS,
                                            0, nb * chunk - n_pts))
    return terms.reshape(nb, chunk, ROW).sum(dim=1)


def gn_fused_partials(points: torch.Tensor, normals: torch.Tensor,
                      mask: torch.Tensor, packed: torch.Tensor,
                      flat: torch.Tensor, T_gate: torch.Tensor,
                      T_res: torch.Tensor, K: Intrinsics, width: int,
                      height: int, max_dist: float, normal_dot_min: float,
                      huber_delta: float,
                      done: torch.Tensor | None = None) -> torch.Tensor:
    """One fused GN step's (num_blocks(N), 32) partial sums.

    Args:
      points, normals: (N, 3) float32 RAW source cloud (not transformed).
      mask: (N,) bool source validity.
      packed: (H·W, 8) target table (`pack_organized_target`), float16 or
        float32.
      flat: (N,) int32 row of each point's association, in [0, H·W).
      T_gate / T_res: 16 contiguous float32 (a (4, 4) pose or a carry's
        T slice): the pose the association was made at, and the pose the
        residuals are linearized at.
      K / width / height: target camera.
      max_dist / normal_dot_min / huber_delta: gates and robust loss (the
        normal gate always applies: pass ≤ -1 to disable it).
      done: optional float32 tensor; when its element 0 is non-zero the
        kernel writes zero partials without reading anything.  The CPU
        twin ignores it.
    """
    if points.device.type == "cpu":
        return gn_fused_partials_reference(
            points, normals, mask, packed, flat, T_gate, T_res, K, width,
            height, max_dist, normal_dot_min, huber_delta)
    if points.device.type != "cuda":
        raise ValueError(f"gn_fused_partials: no kernel for {points.device}")
    dev = points.device
    n_pts = points.shape[0]
    for name, t in (("points", points), ("normals", normals)):
        _build.require(t, name, dtype=torch.float32, shape=(n_pts, 3),
                       device=dev)
    _build.require(mask, "mask", dtype=torch.bool, shape=(n_pts,),
                   device=dev)
    _build.require(flat, "flat", dtype=torch.int32, shape=(n_pts,),
                   device=dev)
    if packed.dtype not in (torch.float16, torch.float32):
        raise TypeError(f"packed: dtype {packed.dtype}, kernel takes float16 "
                        f"or float32")
    _build.require(packed, "packed", dtype=packed.dtype,
                   shape=(height * width, 8), device=dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    for name, t in (("T_gate", T_gate), ("T_res", T_res)):
        _build.require(t, name, dtype=torch.float32, device=dev)
        if t.numel() != 16:
            raise ValueError(f"{name}: {t.numel()} elements, kernel takes 16")
    if done is not None:
        _build.require(done, "done", dtype=torch.float32, device=dev)
    nb = num_blocks(n_pts)
    partials = torch.empty((nb, ROW), dtype=torch.float32, device=dev)
    err = _build.library().tpuslam_gn_fused(
        points.data_ptr(), normals.data_ptr(), mask.data_ptr(),
        packed.data_ptr(), int(packed.dtype == torch.float16),
        flat.data_ptr(), n_pts, T_gate.data_ptr(), T_res.data_ptr(),
        K.fx, K.fy, K.cx, K.cy, float(width - 1), float(height - 1),
        _max_d2(max_dist), normal_dot_min, huber_delta,
        done.data_ptr() if done is not None else None, partials.data_ptr(),
        nb, _build.stream_handle(points))
    _build.check_launch(err, "gn_fused")
    counter.launches += 1
    return partials
