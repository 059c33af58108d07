"""SE(3) / SO(3) Lie-group math — port of `tpuslam/geom/se3.py`.

Poses are plain (4, 4) float32 tensors; twists are (6,) tensors ordered
``(rho, phi)`` = (translation part, rotation part).  Every function
broadcasts over leading batch dimensions and stays on the input's device.
Branches are `torch.where` selects, never Python control flow on tensor
values, so nothing here waits for the GPU.

Convention: ``exp(delta) @ T`` is a *left* (world-frame) update, which is
what the ICP solver uses.
"""

from __future__ import annotations

import torch

_EPS = 1e-8

# Series-vs-exact switch for the sinc-family coefficients: an f32
# cancellation bound (θ < 0.25), the reference's threshold — see
# tpuslam/geom/se3.py for the derivation.
_SINC_SERIES_THETA_SQ = 0.0625


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """Return (A, B, C) = (sinθ/θ, (1−cosθ)/θ², (θ−sinθ)/θ³), Taylor-safe.

    The exact branch is only ever evaluated at θ² ≥ the threshold, so both
    branches are finite for every input.
    """
    theta_sq_safe = torch.clamp(theta_sq, min=_SINC_SERIES_THETA_SQ)
    theta = torch.sqrt(theta_sq_safe)
    small = theta_sq < _SINC_SERIES_THETA_SQ
    t2 = theta_sq
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(theta)) / theta_sq_safe)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (theta - torch.sin(theta)) / (theta_sq_safe * theta))
    return a, b, c


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, safe for θ ∈ [0, π].

    θ/sinθ is written as a function of cosθ with a series branch in
    u = 1−cosθ near u=0; near π the axis is read from the symmetric part.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sinθ · axis
    u = 1.0 - cos_theta
    c_safe = torch.clamp(cos_theta, -1.0 + 1e-6, 1.0 - 1e-6)
    s_exact = torch.arccos(c_safe) / torch.sqrt(1.0 - c_safe * c_safe)
    s_series = 1.0 + u / 3.0 + (2.0 / 15.0) * u * u
    scale = torch.where(u < 1e-3, s_series, s_exact)
    phi = w * scale[..., None]
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, -0.5))
    near_pi = theta > 3.0
    M = 0.5 * (R + R.transpose(-1, -2)) - cos_theta[..., None, None] * _eye3_like(R)
    col_sq = torch.sum(M * M, dim=-2)
    k = torch.argmax(col_sq, dim=-1)
    idx = k[..., None, None].expand(M.shape[:-1] + (1,))
    axis = torch.gather(M, -1, idx)[..., 0]
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    axis = axis * sign
    n2 = torch.sum(axis * axis, dim=-1, keepdim=True)
    axis = axis / torch.sqrt(torch.clamp(n2, min=1e-12))
    phi_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: exp twist translation block (…,3,3)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    return _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(phi)
    W2 = W @ W
    small = theta_sq < _SINC_SERIES_THETA_SQ
    coeff = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
        (1.0 - a / (2.0 * torch.clamp(b, min=_EPS)))
        / torch.clamp(theta_sq, min=_SINC_SERIES_THETA_SQ),
    )
    return _eye3_like(W) - 0.5 * W + coeff[..., None, None] * W2


def exp(tau: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) twist (rho, phi) -> (..., 4, 4) transform."""
    rho, phi = tau[..., :3], tau[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist (rho, phi)."""
    R, t = to_rt(T)
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse (no linear solve)."""
    R, t = to_rt(T)
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation block (for normals)."""
    R, _ = to_rt(T)
    return vecs @ R.transpose(-1, -2)


def relative(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """T_a⁻¹ ∘ T_b — pose of b expressed in a's frame."""
    return inv(T_a) @ T_b


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation magnitude of the pose (rad)."""
    R, _ = to_rt(T)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    t = T[..., :3, 3]
    return torch.sqrt(torch.sum(t * t, dim=-1))
