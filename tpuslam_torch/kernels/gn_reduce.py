"""Point-to-plane Gauss-Newton reduction and solve — plain oracles, port of
`tpuslam/kernels/gn_reduce.py`.

Residual rᵢ = nᵢ·(xᵢ − qᵢ); Jacobian w.r.t. a left twist δ = (ρ, φ) is
Jᵢ = [nᵢ, xᵢ×nᵢ]; Huber IRLS weight times the {0,1} validity.  These are
the oracles of the GN kernels (kernels/gn_partials.py, gn_epilogue.py);
the main path does not call them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.geom.normals import cross


class GNStats(NamedTuple):
    H: torch.Tensor               # (6, 6)
    b: torch.Tensor               # (6,)
    num_inliers: torch.Tensor     # () float — Σ validity
    weighted_sq_sum: torch.Tensor  # () float — Σ w·r²
    num_valid_src: torch.Tensor   # () float — Σ source mask


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss: min(1, δ/|r|)."""
    ar = torch.abs(r)
    return torch.where(ar <= delta, 1.0, delta / torch.clamp(ar, min=1e-12))


def gn_reduce(x, q, n, w_valid, src_mask, huber_delta: float) -> GNStats:
    """Reduce matched points to the 6×6 normal equations and stats."""
    r = torch.sum(n * (x - q), dim=-1)
    w = w_valid * huber_weight(r, huber_delta)
    J = torch.cat([n, cross(x, n)], dim=-1)  # (N, 6)
    wJ = J * w[:, None]
    return GNStats(
        H=wJ.T @ J,
        b=wJ.T @ r,
        num_inliers=torch.sum(w_valid),
        weighted_sq_sum=torch.sum(w * r * r),
        num_valid_src=torch.sum(src_mask.to(x.dtype)),
    )


def solve_gn_step(H: torch.Tensor, b: torch.Tensor, damping: float,
                  damping_abs: float = 1e-3,
                  max_trans_step: float = 0.3,
                  max_rot_step: float = 0.3) -> torch.Tensor:
    """Damped 6×6 solve (LU with pivoting) with the trust-region clamp;
    a non-finite solution becomes a zero step."""
    diag = torch.diagonal(H)
    lam_abs = damping_abs * (torch.sum(diag) / 6.0) + 1e-9
    Hd = (H + torch.diag(damping * diag)
          + lam_abs * torch.eye(6, dtype=H.dtype, device=H.device))
    delta = torch.linalg.solve_ex(Hd, -b)[0]
    ok = torch.all(torch.isfinite(delta))
    delta = torch.where(ok, delta, torch.zeros_like(delta))
    t_norm = torch.linalg.vector_norm(delta[:3])
    r_norm = torch.linalg.vector_norm(delta[3:])
    scale = torch.clamp(
        torch.minimum(max_trans_step / torch.clamp(t_norm, min=1e-12),
                      max_rot_step / torch.clamp(r_norm, min=1e-12)),
        max=1.0)
    return delta * scale
