"""The benchmark's inputs: TUM's sensor, the synthetic room, its camera
paths and a depth renderer that runs on the card.

A frozen copy of the port's synthetic fixture (the room corner, the loop
and orbit paths, the analytic ray tracer), rewritten in torch so that a
run renders its session pool on the device in a few large calls instead
of 92 ms a frame in numpy on the host.  Each session's start phase along
its path is drawn from the run's seed; every width and shape is fixed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# TUM RGB-D's ROS-default intrinsics at 640×480 (Sturm et al., IROS 2012)
TUM_FX, TUM_FY, TUM_CX, TUM_CY = 525.0, 525.0, 319.5, 239.5


def intrinsics(height: int, width: int) -> tuple:
    """(fx, fy, cx, cy) of the TUM sensor scaled to height × width."""
    return (TUM_FX * width / 640.0, TUM_FY * height / 480.0,
            width / 2 - 0.5, height / 2 - 0.5)


def room() -> dict:
    """The room corner: four planes (n·p = c) and five spheres."""
    n = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                  [0.6, -0.4, -0.9]])
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return {
        "plane_n": n,
        "plane_c": np.array([-2.5, -0.8, -0.6, -1.9]),
        "sphere_center": np.array([[0.25, 0.2, 1.7], [-0.5, 0.3, 2.0],
                                   [0.55, -0.35, 1.4], [-0.35, -0.3, 1.2],
                                   [0.05, 0.45, 1.1]]),
        "sphere_radius": np.array([0.35, 0.25, 0.2, 0.15, 0.12]),
    }


def _euler_y_x(yaw: float, pitch: float) -> np.ndarray:
    """Rotation of intrinsic-free extrinsic "yx" Euler angles (scipy's
    lower-case convention): R = Rx(pitch) · Ry(yaw)."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cx, sx = math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    return rx @ ry


def loop_path(frames: int, phase: float, cycles: int,
              radius: float) -> np.ndarray:
    """(F, 4, 4) world←camera poses of `cycles` laps of the loop, starting
    `phase` (a fraction of a lap) along it."""
    poses = np.zeros((frames, 4, 4))
    for i in range(frames):
        a = 2 * np.pi * (cycles * i / frames + phase)
        poses[i, :3, :3] = _euler_y_x(0.15 * np.sin(a), 0.06 * np.sin(a))
        poses[i, :3, 3] = [radius * np.sin(a), 0.05 * np.sin(2 * a),
                           0.10 * (1 - np.cos(a))]
        poses[i, 3, 3] = 1.0
    return poses


def orbit_path(frames: int, phase: float, radius: float,
               angle: float) -> np.ndarray:
    """(F, 4, 4) poses of the hovering orbit (a hand-held camera over a
    desk), its periodic terms started `phase` of a period along."""
    poses = np.zeros((frames, 4, 4))
    for i in range(frames):
        s = i / max(frames - 1, 1)
        a = 2 * np.pi * (s + phase)
        # scipy's "yxz" with a zero last angle is R = Rx(pitch) · Ry(yaw)
        poses[i, :3, :3] = _euler_y_x(angle * np.sin(a), 0.04 * np.sin(a))
        poses[i, :3, 3] = [radius * np.sin(a), 0.02 * np.sin(2 * a),
                           0.04 * s]
        poses[i, 3, 3] = 1.0
    return poses


PATHS = {"loop": loop_path, "orbit": orbit_path}


def session_phases(seed: int, pool: int, jitter: float = 1.0) -> tuple:
    """The pool's start phases and the order the window visits them: one
    phase in each of `pool` equal strata of a period, at `jitter` × a
    uniform draw from the stratum's middle (0: the middle itself, so every
    seed has the same sessions, in another order)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=pool)
    phases = (np.arange(pool) + 0.5 + jitter * (u - 0.5)) / pool
    return phases, rng.permutation(pool)


def render_depth(poses: torch.Tensor, height: int, width: int,
                 K: tuple) -> torch.Tensor:
    """Analytic ray-traced z-depth of the room, (F, H, W) float32 metres,
    on `poses`' device.  float64 inside, as the port's numpy renderer;
    rays that hit nothing read 0."""
    dev = poses.device
    f64 = torch.float64
    sc = {k: torch.as_tensor(v, dtype=f64, device=dev)
          for k, v in room().items()}
    fx, fy, cx, cy = K
    u = torch.arange(width, dtype=f64, device=dev)
    v = torch.arange(height, dtype=f64, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack([(uu - cx) / fx, (vv - cy) / fy,
                         torch.ones_like(uu)], dim=-1)        # (H, W, 3)
    R = poses[:, :3, :3].to(f64)
    o = poses[:, :3, 3].to(f64)                               # (F, 3)
    d = torch.einsum("hwj,fkj->fhwk", d_cam, R)              # (F, H, W, 3)
    t_best = torch.full(d.shape[:-1], float("inf"), dtype=f64, device=dev)
    for n_vec, c in zip(sc["plane_n"], sc["plane_c"]):
        denom = d @ n_vec
        num = (c - o @ n_vec)[:, None, None]
        t = num / torch.where(denom.abs() < 1e-12, float("nan"), denom)
        t = torch.where((t > 0.05) & torch.isfinite(t), t, float("inf"))
        t_best = torch.minimum(t_best, t)
    a = torch.sum(d * d, dim=-1)
    for center, radius in zip(sc["sphere_center"], sc["sphere_radius"]):
        oc = o - center                                       # (F, 3)
        b = 2.0 * torch.einsum("fhwk,fk->fhw", d, oc)
        cc = (torch.sum(oc * oc, dim=-1) - radius ** 2)[:, None, None]
        disc = b * b - 4 * a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = (-b - sq) / (2 * a)
        t_sph = torch.where((disc > 0) & (t1 > 0.05), t1, float("inf"))
        t_best = torch.minimum(t_best, t_sph)
    return torch.where(torch.isfinite(t_best), t_best, 0.0).to(torch.float32)


def render_pool(traffic: dict, height: int, width: int, seed: int,
                device: torch.device, block: int = 16) -> dict:
    """The run's session pool: (P, F, H, W) float32 depth on `device`,
    the phases, the order in which the window visits the sessions, the
    timestamps and the intrinsics."""
    frames, pool = int(traffic["frames"]), int(traffic["pool"])
    path = PATHS[traffic["trajectory"]]
    phases, order = session_phases(seed, pool,
                                   float(traffic.get("phase_jitter", 1.0)))
    K = intrinsics(height, width)
    poses = torch.as_tensor(
        np.stack([path(frames, float(p), **traffic["params"])
                  for p in phases]), dtype=torch.float64, device=device)
    depth = torch.empty((pool, frames, height, width), dtype=torch.float32,
                        device=device)
    for s in range(pool):
        for f0 in range(0, frames, block):
            depth[s, f0:f0 + block] = render_depth(
                poses[s, f0:f0 + block], height, width, K)
    rate = float(traffic.get("rate_hz", 30.0))
    return {"depth": depth, "phases": phases, "order": order,
            "timestamps": np.arange(frames) / rate, "K": K}
