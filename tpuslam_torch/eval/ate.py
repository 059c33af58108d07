"""Trajectory evaluation: Horn alignment + ATE RMSE + RPE.

Vendored from `tpuslam/eval/ate.py` (pure numpy, float64), with the
timestamp association of `tpuslam/data/tum.py` carried along so that the
port needs nothing of the JAX package.  Timestamp association → closed-form
Horn (SVD) rigid alignment → RMSE of translational residuals; RPE over fixed
frame deltas as the drift metric.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def associate(
    a: Sequence[tuple[float, list[str]]],
    b: Sequence[tuple[float, list[str]]],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (the standard TUM tool
    algorithm: sort candidate pairs by |Δt|, take greedily while both sides
    are unused).  Only each `a` entry's few nearest `b` neighbours are
    candidates, which gives the full algorithm's result whenever
    `max_difference` is far below the frame period."""
    ta = np.array([t for t, _ in a])
    tb = np.array([t + offset for t, _ in b])
    order = np.argsort(tb)
    tb_sorted = tb[order]
    pos = np.searchsorted(tb_sorted, ta)
    pairs = []
    for k in range(-2, 3):
        j_sorted = np.clip(pos + k, 0, len(tb_sorted) - 1)
        d = np.abs(ta - tb_sorted[j_sorted])
        ok = d < max_difference
        for i in np.nonzero(ok)[0]:
            pairs.append((float(d[i]), int(i), int(order[j_sorted[i]])))
    pairs = sorted(set(pairs))
    used_a: set[int] = set()
    used_b: set[int] = set()
    matches = []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            matches.append((i, j))
    matches.sort()
    return matches


def horn_align(est: np.ndarray, gt: np.ndarray):
    """Closed-form rigid alignment (Horn/Umeyama, scale fixed to 1).

    Args:
      est, gt: (N, 3) matched translation samples.
    Returns:
      (R, t) minimizing Σ|R·est + t − gt|².
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    W = E.T @ G
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt).round(12) or 1.0)
    R = (U @ S @ Vt).T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_ts, est_poses, gt_ts, gt_poses, max_difference: float = 0.02):
    """Absolute trajectory error RMSE after time association + Horn alignment.

    Args:
      est_ts: (F,) timestamps; est_poses: (F, 4, 4) world←cam.
      gt_ts / gt_poses: likewise for groundtruth.
    Returns:
      dict with rmse, mean, median, max (metres) and num_pairs.
    """
    a = [(float(t), []) for t in est_ts]
    b = [(float(t), []) for t in gt_ts]
    matches = associate(a, b, max_difference=max_difference)
    if len(matches) < 3:
        raise ValueError(f"only {len(matches)} matched timestamps")
    e = np.asarray([est_poses[i][:3, 3] for i, _ in matches])
    g = np.asarray([gt_poses[j][:3, 3] for _, j in matches])
    R, t = horn_align(e, g)
    res = (e @ R.T + t) - g
    norms = np.linalg.norm(res, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(norms**2))),
        "mean": float(norms.mean()),
        "median": float(np.median(norms)),
        "max": float(norms.max()),
        "num_pairs": len(matches),
    }


def rpe(est_ts, est_poses, gt_ts, gt_poses, delta: int = 1,
        max_difference: float = 0.02):
    """Relative pose error over a fixed index delta (drift per frame-step).

    Returns dict with translational rmse (m) and rotational rmse (rad).
    """
    a = [(float(t), []) for t in est_ts]
    b = [(float(t), []) for t in gt_ts]
    matches = associate(a, b, max_difference=max_difference)
    est = np.asarray([est_poses[i] for i, _ in matches])
    gt = np.asarray([gt_poses[j] for _, j in matches])
    t_errs, r_errs = [], []
    for k in range(len(est) - delta):
        de = np.linalg.inv(est[k]) @ est[k + delta]
        dg = np.linalg.inv(gt[k]) @ gt[k + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(
            np.arccos(np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
        )
    return {
        "trans_rmse": float(np.sqrt(np.mean(np.square(t_errs)))),
        "rot_rmse": float(np.sqrt(np.mean(np.square(r_errs)))),
        "num_pairs": len(t_errs),
    }
