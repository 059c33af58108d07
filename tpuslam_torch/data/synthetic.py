"""Deterministic synthetic scenes (SURVEY.md §4 "Fixtures").

Provides (a) the plane+sphere two-cloud fixture pinned by BASELINE.json
config 1, and (b) an analytic ray-traced depth renderer so full-sequence
odometry/SLAM tests run without the TUM dataset (network is unavailable in
CI; SURVEY.md §4 "a tiny checked-in TUM-format micro-sequence").

The scene is a small "room corner": back wall, side wall, floor, and a
sphere — enough geometry to constrain all 6 DoF of point-to-plane ICP.

Vendored from `tpuslam/data/synthetic.py` (numpy only), minus the TUM
sequence writer, which needs the TUM loader and is not ported yet.  The
renderer must stay byte-identical to the reference's
(tests/test_torch_geom.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpuslam_torch.config import Intrinsics


class Scene(NamedTuple):
    """Planes as (normal, offset) with n·p = c, plus spheres (clutter)."""

    plane_n: np.ndarray        # (P, 3) unit normals
    plane_c: np.ndarray        # (P,)
    sphere_center: np.ndarray  # (S, 3)
    sphere_radius: np.ndarray  # (S,)


def default_scene() -> Scene:
    """Room corner with enough in-view constraint diversity that all 6 DoF
    of point-to-plane ICP are well observed (a lone fronto-parallel wall
    leaves roll/xy near-degenerate — the walls here sit well inside the
    ~±27° FOV and a tilted panel breaks the remaining symmetry)."""
    n = np.array(
        [
            [0.0, 0.0, -1.0],    # back wall   z = 2.5 (normal toward camera)
            [-1.0, 0.0, 0.0],    # side wall   x = 0.8
            [0.0, -1.0, 0.0],    # floor       y = 0.6 (camera y points down)
            [0.6, -0.4, -0.9],   # tilted panel crossing the upper-left view
        ]
    )
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    c = np.array([-2.5, -0.8, -0.6, -1.9])
    # Sphere clutter spread across the view: featureless infinite planes
    # leave in-plane translation unobservable for point-to-plane ICP; real
    # rooms have objects, and so does this one.
    centers = np.array(
        [
            [0.25, 0.2, 1.7],
            [-0.5, 0.3, 2.0],
            [0.55, -0.35, 1.4],
            [-0.35, -0.3, 1.2],
            [0.05, 0.45, 1.1],
        ]
    )
    radii = np.array([0.35, 0.25, 0.2, 0.15, 0.12])
    return Scene(plane_n=n, plane_c=c, sphere_center=centers,
                 sphere_radius=radii)


def sample_cloud(scene: Scene, n_points: int, seed: int = 0,
                 noise: float = 0.0):
    """Sample surface points + analytic normals from the scene (world frame).

    Returns (points (N,3) f32, normals (N,3) f32).  Points are distributed
    over the sphere and the in-view patches of each plane.
    """
    rng = np.random.default_rng(seed)
    n_sphere_total = n_points // 3
    n_per_plane = (n_points - n_sphere_total) // len(scene.plane_n)
    pts, nrm = [], []
    # Spheres: uniform directions, points split by surface area.
    areas = scene.sphere_radius ** 2
    for center, radius, frac in zip(
        scene.sphere_center, scene.sphere_radius, areas / areas.sum()
    ):
        k = max(int(n_sphere_total * frac), 8)
        d = rng.normal(size=(k, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append(center + radius * d)
        nrm.append(d)
    # Planes: patches around each plane's point nearest the view center.
    p_view = np.array([0.0, 0.0, 1.8])
    for n_vec, c in zip(scene.plane_n, scene.plane_c):
        center = p_view + (c - n_vec @ p_view) * n_vec
        helper = np.array([0.0, 1.0, 0.0])
        if abs(n_vec @ helper) > 0.9:
            helper = np.array([1.0, 0.0, 0.0])
        u = np.cross(n_vec, helper)
        u /= np.linalg.norm(u)
        v = np.cross(n_vec, u)
        a = rng.uniform(-0.9, 0.9, size=(n_per_plane, 1))
        b = rng.uniform(-0.9, 0.9, size=(n_per_plane, 1))
        p = center + a * u + b * v
        pts.append(p)
        nrm.append(np.broadcast_to(n_vec, p.shape).copy())
    points = np.concatenate(pts, axis=0).astype(np.float32)
    normals = np.concatenate(nrm, axis=0).astype(np.float32)
    if noise > 0:
        points = points + rng.normal(scale=noise, size=points.shape).astype(np.float32)
    return points, normals


def render_depth(T_world_cam: np.ndarray, K: Intrinsics, height: int,
                 width: int, scene: Scene | None = None,
                 noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """Analytic ray-traced z-depth image from a camera pose (world frame).

    Rays r(t) = o + t·d with d = R·((u-cx)/fx, (v-cy)/fy, 1); since d_z = 1
    in the camera frame, the hit parameter t *is* the z-depth.
    """
    scene = scene or default_scene()
    R = T_world_cam[:3, :3]
    o = T_world_cam[:3, 3]
    u = np.arange(width, dtype=np.float64)
    v = np.arange(height, dtype=np.float64)
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack(
        [(uu - K.cx) / K.fx, (vv - K.cy) / K.fy, np.ones_like(uu)], axis=-1
    )
    d = d_cam @ R.T  # (H, W, 3) world-frame ray directions
    t_best = np.full((height, width), np.inf)
    # Planes: n·(o + t d) = c  ⇒  t = (c − n·o) / (n·d)
    for n_vec, c in zip(scene.plane_n, scene.plane_c):
        denom = d @ n_vec
        t = (c - o @ n_vec) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
        t = np.where((t > 0.05) & np.isfinite(t), t, np.inf)
        t_best = np.minimum(t_best, t)
    # Spheres: |o + t d − c0|² = r²
    a = np.sum(d * d, axis=-1)
    for center, radius in zip(scene.sphere_center, scene.sphere_radius):
        oc = o - center
        b = 2.0 * (d @ oc)
        cc = oc @ oc - radius ** 2
        disc = b * b - 4 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        t1 = (-b - sq) / (2 * a)
        t_sph = np.where((disc > 0) & (t1 > 0.05), t1, np.inf)
        t_best = np.minimum(t_best, t_sph)
    depth = np.where(np.isfinite(t_best), t_best, 0.0)
    if noise > 0:
        rng = np.random.default_rng(seed)
        depth = np.where(
            depth > 0, depth + rng.normal(scale=noise, size=depth.shape), 0.0
        )
    return depth.astype(np.float32)


def degrade_depth(depth: np.ndarray, seed: int = 0,
                  z_noise_coeff: float = 0.0,
                  dropout_holes: int = 0,
                  hole_frac: float = 0.12,
                  edge_dropout: float = 0.0) -> np.ndarray:
    """Apply real-sensor pathologies to a clean rendered depth image
    (SURVEY.md §4 fixtures; prepares BASELINE configs 2-4 for real data).

    Models the dominant TUM/Kinect failure modes the clean renderer lacks:

      * depth-dependent noise — structured-light depth error grows
        quadratically with range, σ(z) ≈ `z_noise_coeff`·z² (Khoshelham &
        Elberink 2012 measure ≈ 2.85e-3 m⁻¹ for the Kinect v1),
      * rectangular dropout holes — specular/absorbing surfaces and stereo
        shadow return no depth in contiguous blobs, not salt-and-pepper:
        `dropout_holes` random rectangles of ~`hole_frac` of each image
        dimension are zeroed,
      * random edge dropout — a fraction of remaining pixels zeroed
        independently (quantization dropout at depth discontinuities).
    """
    rng = np.random.default_rng(seed)
    out = depth.copy()
    h, w = out.shape
    valid = out > 0
    if z_noise_coeff > 0:
        sigma = z_noise_coeff * out * out
        out = np.where(valid, out + rng.normal(size=out.shape) * sigma, 0.0)
    for _ in range(dropout_holes):
        hh = max(2, int(hole_frac * h * rng.uniform(0.5, 1.5)))
        ww = max(2, int(hole_frac * w * rng.uniform(0.5, 1.5)))
        r0 = rng.integers(0, max(1, h - hh))
        c0 = rng.integers(0, max(1, w - ww))
        out[r0:r0 + hh, c0:c0 + ww] = 0.0
    if edge_dropout > 0:
        keep = rng.uniform(size=out.shape) >= edge_dropout
        out = np.where(keep, out, 0.0)
    return out.astype(np.float32)


def burst_trajectory(num_frames: int, burst_start: int, burst_len: int,
                     burst_rate: float = 0.04,
                     radius: float = 0.18) -> np.ndarray:
    """Loop trajectory with a fast-rotation burst: `burst_len` frames of an
    extra `burst_rate` rad/frame yaw, then holding the new heading.  Real
    handheld TUM sequences (fr1 especially) have such whips; they stress
    the constant-velocity warm start and the coarse pyramid's basin."""
    from scipy.spatial.transform import Rotation

    poses = loop_trajectory(num_frames, cycles=1, radius=radius)
    extra = np.zeros(num_frames)
    end = min(burst_start + burst_len, num_frames)
    extra[burst_start:end] = burst_rate
    yaw = np.cumsum(extra)
    for i in range(num_frames):
        if yaw[i] != 0.0:
            R = Rotation.from_euler("y", yaw[i]).as_matrix()
            poses[i, :3, :3] = poses[i, :3, :3] @ R
    return poses


def loop_trajectory(num_frames: int, cycles: int = 1,
                    radius: float = 0.18) -> np.ndarray:
    """Camera walks `cycles` laps around a small loop and returns to the
    start each lap (world←cam poses, (F, 4, 4) f64).  The long-office-style
    fixture: repeated revisits exercise loop closure, keyframe
    sparsification, and pose-graph growth at BASELINE config-5 scale."""
    from scipy.spatial.transform import Rotation

    poses = np.zeros((num_frames, 4, 4))
    for i in range(num_frames):
        s = cycles * i / num_frames
        a = 2 * np.pi * s
        t = np.array([radius * np.sin(a), 0.05 * np.sin(2 * a),
                      0.10 * (1 - np.cos(a))])
        rot = Rotation.from_euler("yx", [0.15 * np.sin(a), 0.06 * np.sin(a)])
        poses[i, :3, :3] = rot.as_matrix()
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def orbit_trajectory(num_frames: int, radius: float = 0.05,
                     angle: float = 0.12) -> np.ndarray:
    """Smooth camera trajectory (world←cam poses, (F, 4, 4) f64): a gentle
    arc with small rotations.  Defaults keep per-frame motion in the
    real-handheld regime (~1-3 cm, ~1-2° between consecutive frames) even
    for short sequences — frame-to-frame ICP assumes small motion, exactly
    as on 30 fps TUM data."""
    from scipy.spatial.transform import Rotation

    poses = np.zeros((num_frames, 4, 4))
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        t = np.array(
            [radius * np.sin(2 * np.pi * s), 0.02 * np.sin(4 * np.pi * s),
             0.04 * s]
        )
        rot = Rotation.from_euler(
            "yxz", [angle * np.sin(2 * np.pi * s), 0.04 * np.sin(2 * np.pi * s), 0.0]
        ).as_matrix()
        poses[i, :3, :3] = rot
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses
