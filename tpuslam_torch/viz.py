"""Visualization — port of `tpuslam/viz.py`.

PNG artifacts: trajectory vs groundtruth plots, top-down map views,
depth and normal images, written by the CLI (`--viz-dir`).  Matplotlib
with the Agg backend (no display server), imported at first use; without
it every function raises ImportError saying so.  Inputs are numpy arrays
(host copies: `VoxelMap.points()`, `SlamSystem.trajectory()`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualization (--viz-dir) needs matplotlib, "
                          "which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    path: str,
    est_poses: np.ndarray,
    gt_poses: Optional[np.ndarray] = None,
    keyframe_indices: Optional[Sequence[int]] = None,
    title: str = "trajectory",
) -> str:
    """Top-down (x–z) and lateral (x–y) trajectory plot; returns `path`."""
    plt = _plt()
    est = np.asarray([T[:3, 3] for T in est_poses])
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    for ax, (a, b, la, lb) in zip(axes, [(0, 2, "x [m]", "z [m]"),
                                         (0, 1, "x [m]", "y [m]")]):
        ax.plot(est[:, a], est[:, b], "-", lw=1.5, label="estimate")
        if gt_poses is not None:
            gt = np.asarray([T[:3, 3] for T in gt_poses])
            ax.plot(gt[:, a], gt[:, b], "--", lw=1.0, label="groundtruth")
        if keyframe_indices:
            ks = [k for k in keyframe_indices if k < len(est)]
            ax.plot(est[ks, a], est[ks, b], "o", ms=4, label="keyframes")
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_map(path: str, points: np.ndarray,
             trajectory: Optional[np.ndarray] = None,
             title: str = "voxel map") -> str:
    """Top-down scatter of map points (+ optional trajectory overlay)."""
    plt = _plt()
    pts = np.asarray(points)
    fig, ax = plt.subplots(figsize=(7, 7))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=0.3, c=pts[:, 1], cmap="viridis",
                   alpha=0.6, linewidths=0)
    if trajectory is not None:
        t = np.asarray([T[:3, 3] for T in trajectory])
        ax.plot(t[:, 0], t[:, 2], "r-", lw=1.5, label="trajectory")
        ax.legend(fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_title(f"{title} ({len(pts)} points)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_depth_image(path: str, depth: np.ndarray,
                     vmax: Optional[float] = None) -> str:
    """Depth image as a colormapped PNG (invalid pixels black)."""
    plt = _plt()
    d = np.asarray(depth, dtype=np.float64)
    valid = d > 0
    vmax = vmax or (np.percentile(d[valid], 99) if valid.any() else 1.0)
    fig, ax = plt.subplots(figsize=(6, 4.6))
    shown = np.where(valid, d, np.nan)
    im = ax.imshow(shown, cmap="turbo", vmin=0, vmax=vmax)
    ax.set_axis_off()
    fig.colorbar(im, ax=ax, shrink=0.8, label="depth [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_normal_image(path: str, normals: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> str:
    """Normals as an RGB image (n/2+0.5 encoding, like the usual viz)."""
    plt = _plt()
    n = np.asarray(normals, dtype=np.float64)
    rgb = np.clip(n * 0.5 + 0.5, 0, 1)
    if mask is not None:
        rgb = np.where(np.asarray(mask)[..., None], rgb, 0.0)
    fig, ax = plt.subplots(figsize=(6, 4.6))
    ax.imshow(rgb)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def write_run_report(out_dir: str, system, gt_poses=None) -> list[str]:
    """Write the standard artifact set for an Odometry/SlamSystem run."""
    os.makedirs(out_dir, exist_ok=True)
    odo = system.odo if hasattr(system, "odo") else system
    if hasattr(system, "trajectory") and callable(system.trajectory):
        _, poses = system.trajectory()
    else:
        poses = np.stack(odo.trajectory)
    files = [
        plot_trajectory(
            os.path.join(out_dir, "trajectory.png"), poses, gt_poses,
            keyframe_indices=[k.index for k in odo.keyframes],
        )
    ]
    vmap = getattr(system, "map", None)
    if vmap is not None and vmap.size() > 0:
        files.append(
            plot_map(os.path.join(out_dir, "map.png"), vmap.points(), poses)
        )
    return files
