"""Shared backend-verification plumbing (loop closure + relocalization) —
port of `tpuslam/backend/verify.py`.

Both consumers verify a candidate alignment with the same evidence (an ICP
result's flat scalars plus the normal-coverage observability eigenvalue),
judged by the same gates, so the row layout, its packing on the device and
the gate predicate live here once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.icp import (
    FlatICP,
    ICPResult,
    align_clouds,
    flat_icp_scalars,
)

# column appended after the FlatICP block: smallest eigenvalue of the
# normalized inlier normal-coverage matrix (Σw·nnᵀ)/Σw
COVERAGE_COL = FlatICP.SIZE
ROW_SIZE = FlatICP.SIZE + 1


def min_eigenvalue_sym3(A: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of symmetric (..., 3, 3) matrices in closed form
    (the trigonometric solution of the characteristic cubic), in float64.

    Torch ops only, so it never waits for the device — `torch.linalg
    .eigvalsh` checks its solver's status on the host.  It agrees with a
    LAPACK eigensolver to float32 rounding (tests/test_torch_backend.py).
    """
    A = A.to(torch.float64)
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    p_safe = torch.where(p > 0, p, 1.0)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / (2.0 * p_safe ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    smallest = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return torch.where(p > 0, smallest, q)


def flat_verify_scalars(res: ICPResult) -> torch.Tensor:
    """(ROW_SIZE,) float32: FlatICP scalars + the coverage eigenvalue."""
    Hr = res.H[:3, :3]
    w_sum = torch.clamp(torch.trace(Hr), min=1e-9)
    cov = min_eigenvalue_sym3(Hr / w_sum).to(torch.float32)
    return torch.cat([flat_icp_scalars(res), cov[None]])


def verify_grid(src, dst, T_init: torch.Tensor, icp_cfg) -> torch.Tensor:
    """(ROW_SIZE,) verification row on the device of cloud `src` aligned
    onto cloud `dst` by the grid-hash ICP (`icp.align_clouds`: dst's
    sorted index, then the grid_correspond and gn_step kernels) — the
    verifier for keyframes without uniform tables."""
    return flat_verify_scalars(
        align_clouds(src, dst, T_init, icp_cfg, use_grid=True))


def uniform_verify_table(records, ids):
    """The shared VerifyTable meta of keyframe `ids`, or None when any lacks
    one or they differ in shape or (height, width, level)."""
    v0 = records[ids[0]].verify
    if v0 is None:
        return None
    for k in ids:
        v = records[k].verify
        if (v is None or v.packed.shape != v0.packed.shape
                or (v.height, v.width, v.level)
                != (v0.height, v0.width, v0.level)):
            return None
    return v0


def passes_gates_traced(rows: torch.Tensor,
                        pg_cfg: PoseGraphConfig) -> torch.Tensor:
    """Device form of `passes_gates`: (B, ROW_SIZE) → (B,) float32 accept
    mask from the same float32 values and compares, so the host's mirror
    takes the same decisions."""
    T = rows[:, FlatICP.T].reshape(-1, 4, 4)
    ok = ((rows[:, FlatICP.CONVERGED] > 0.5)
          & (rows[:, FlatICP.RMS] <= pg_cfg.lc_max_residual)
          & (rows[:, FlatICP.INLIER_FRACTION] >= pg_cfg.lc_min_inliers)
          & (rows[:, COVERAGE_COL] >= pg_cfg.lc_min_normal_coverage)
          & torch.all(torch.isfinite(T).reshape(-1, 16), dim=1))
    return ok.to(rows.dtype)


def passes_gates(row: np.ndarray, pg_cfg: PoseGraphConfig) -> bool:
    """Acceptance gates over one flat verification row: converged, residual
    RMS, inlier fraction, normal-coverage observability, finite pose.
    Thresholds are compared at float32, as on the device."""
    T = row[FlatICP.T].reshape(4, 4)
    return (
        bool(row[FlatICP.CONVERGED] > 0.5)
        and np.float32(row[FlatICP.RMS]) <= np.float32(pg_cfg.lc_max_residual)
        and np.float32(row[FlatICP.INLIER_FRACTION])
        >= np.float32(pg_cfg.lc_min_inliers)
        and np.float32(row[COVERAGE_COL])
        >= np.float32(pg_cfg.lc_min_normal_coverage)
        and bool(np.all(np.isfinite(T)))
    )
