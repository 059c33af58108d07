"""Poses the warm start (`kernels/warm_start.py`) is held to its twin on,
for the tests and `chip_smoke.py`: motions Δ whose rotations reach each
branch of se3's logarithm and exponential, each beside a keyframe pose
T_kf_cam.  numpy alone: no JAX, no GPU needed.

Tests import it as `torch_warm_start_cases` (pytest puts `tests/` on the
path); `chip_smoke.py` loads it by its file path (the GPU host has another
package named `tests`, see torch_posegraph_cases.py).
"""

from __future__ import annotations

import numpy as np

# The rotation angle of Δ (rad) of each named case, and what it reaches at
# γ = 0.5, which halves the angle the exponential meets.
ANGLES = {
    "identity": None,                 # Δ = I exactly
    "theta 0, moved": 0.0,            # R = I exactly, t ≠ 0
    "u below 1e-3": 0.03,             # so3_log's series in u = 1 − cos θ
    "theta^2 below 0.0625": 0.2,      # every sinc coefficient's series
    "log exact, exp series": 0.4,     # θ² 0.16 in log, (γθ)² 0.04 in exp
    "theta^2 above 0.0625": 0.9,      # exact on both sides
    "theta above 3.0": 3.05,          # so3_log's near-π axis
    "theta near pi": 3.14159,
    "theta pi": np.pi,                # a half turn about x
}


def rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues in float64: the rotation by `angle` about `axis`."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    W = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                  [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * W + (1.0 - np.cos(angle)) * W @ W


def pose(R: np.ndarray, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T.astype(np.float32)


def _keyframe_pose(rng) -> np.ndarray:
    return pose(rotation(rng.normal(size=3), rng.uniform(0.0, 0.5)),
                rng.normal(scale=0.2, size=3))


def warm_start_cases(seed: int = 0) -> dict:
    """{name: (T_kf_cam, Δ)}, (4, 4) float32 each, one a branch (ANGLES),
    plus the identity keyframe pose a promotion leaves."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, angle in ANGLES.items():
        T = _keyframe_pose(rng)
        t = rng.normal(scale=0.02, size=3)
        if angle is None:
            D = np.eye(4, dtype=np.float32)
        elif name == "theta pi":
            D = pose(np.diag([1.0, -1.0, -1.0]), t)
        else:
            D = pose(rotation(rng.normal(size=3), angle), t)
        out[name] = (T, D)
    out["identity keyframe"] = (np.eye(4, dtype=np.float32),
                                out["log exact, exp series"][1])
    return out


def random_cases(n: int, seed: int = 1) -> dict:
    """{name: (T_kf_cam, Δ)}: `n` seeded motions, half at log-uniform
    angles 1e-6-0.5 rad (an inter-frame motion), half uniform up to π."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        angle = (10.0 ** rng.uniform(-6.0, np.log10(0.5)) if i % 2 == 0
                 else rng.uniform(0.0, np.pi))
        D = pose(rotation(rng.normal(size=3), angle),
                 rng.normal(scale=0.05, size=3))
        out[f"random {i}"] = (_keyframe_pose(rng), D)
    return out
