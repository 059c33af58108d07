"""Plain reference of the measured entry points' semantics.

Written from the algorithm, in plain PyTorch on the device for the
per-pixel work and NumPy on the host for everything small, so that it
shares no code, no kernel and no captured program with the port:

- preprocessing: backprojection of a depth pyramid (stride-2 decimation),
  organized normals by central differences, the packed float16 target
  tables, the keyframe's voxel cloud;
- point-to-plane ICP, coarse to fine: projective association at the
  current pose, then `inner_steps` Gauss-Newton solves against it (Huber
  weights, damped normal equations, a trust region, the SE(3) update),
  with the early exit on the step's size;
- frame-to-keyframe tracking with the damped constant-velocity warm
  start, the lost and promotion gates, boundary promotion (a sub-chunk
  tracks against a frozen keyframe and promotes its last frame);
- in the SLAM system: proximity proposal of loop closures, their
  verification by projective ICP against the retained level-1 table, the
  acceptance gates, and Gauss-Newton over the keyframe pose graph with
  Huber-weighted relative-pose residuals.

The GN normal equations are reduced on the device with matrix products
and solved on the host in float64, so a lower matmul precision (TF32)
reaches every transform and every reduction: that is the control.

`work` collects what each association and GN solve had to do (rows,
valid rows, matched rows): the roofline readers count the stage's bytes
and operations from it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
_SERIES = 0.0625            # θ² below which the sinc family uses series


# --- SE(3) on the host (float64) -------------------------------------------

def hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def _coeffs(t2: float):
    if t2 < _SERIES:
        return (1 - t2 / 6 + t2 * t2 / 120, 0.5 - t2 / 24 + t2 * t2 / 720,
                1 / 6 - t2 / 120 + t2 * t2 / 5040)
    th = math.sqrt(t2)
    return (math.sin(th) / th, (1 - math.cos(th)) / t2,
            (th - math.sin(th)) / (t2 * th))


def se3_exp(tau) -> np.ndarray:
    """(ρ, φ) twist → 4×4 pose."""
    rho, phi = np.asarray(tau[:3], float), np.asarray(tau[3:], float)
    a, b, c = _coeffs(float(phi @ phi))
    W = hat(phi)
    W2 = W @ W
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + a * W + b * W2
    T[:3, 3] = (np.eye(3) + b * W + c * W2) @ rho
    return T


def so3_log(R) -> np.ndarray:
    cos_t = float(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    theta = math.acos(cos_t)
    if theta > 3.0:                       # near π: the axis from R + Rᵀ
        M = 0.5 * (R + R.T) - cos_t * np.eye(3)
        axis = M[:, int(np.argmax(np.sum(M * M, axis=0)))]
        if axis @ w < 0:
            axis = -axis
        return axis / max(np.linalg.norm(axis), 1e-12) * theta
    u = 1 - cos_t
    if u < 1e-3:
        scale = 1 + u / 3 + (2 / 15) * u * u
    else:
        c = min(max(cos_t, -1 + 1e-6), 1 - 1e-6)
        scale = math.acos(c) / math.sqrt(1 - c * c)
    return w * scale


def se3_log(T) -> np.ndarray:
    phi = so3_log(T[:3, :3])
    t2 = float(phi @ phi)
    a, b, _ = _coeffs(t2)
    W = hat(phi)
    if t2 < _SERIES:
        coeff = 1 / 12 + t2 / 720 + t2 * t2 / 30240
    else:
        coeff = (1 - a / (2 * max(b, 1e-8))) / t2
    Vinv = np.eye(3) - 0.5 * W + coeff * (W @ W)
    return np.concatenate([Vinv @ T[:3, 3], phi])


def inv(T) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _se3_jl_inv(xi) -> np.ndarray:
    """Inverse left Jacobian of SE(3) at twist ξ = (ρ, φ) (Barfoot, State
    Estimation for Robotics, eq. 7.86)."""
    rho, phi = xi[:3], xi[3:]
    W, P = hat(phi), hat(rho)
    t2 = float(phi @ phi)
    if t2 < _SERIES:
        c1 = 1 / 6 - t2 / 120 + t2 * t2 / 5040
        c2 = 1 / 24 - t2 / 720 + t2 * t2 / 40320
        c3 = 1 / 120 - t2 / 2520 + t2 * t2 / 120960
    else:
        th = math.sqrt(t2)
        sn, cs = math.sin(th), math.cos(th)
        c1 = (th - sn) / (t2 * th)
        c2 = (t2 + 2 * cs - 2) / (2 * t2 * t2)
        c3 = (2 * th - 3 * sn + th * cs) / (2 * t2 * t2 * th)
    WP, PW, WW = W @ P, P @ W, W @ W
    WPW = WP @ W
    Q = (0.5 * P + c1 * (WP + PW + WPW) + c2 * (WW @ P + PW @ W - 3 * WPW)
         + c3 * (WPW @ W + WW @ P @ W))
    a, b, _ = _coeffs(t2)
    coeff = (1 / 12 + t2 / 720 + t2 * t2 / 30240 if t2 < _SERIES
             else (1 - a / (2 * max(b, 1e-8))) / t2)
    Ji = np.eye(3) - 0.5 * W + coeff * WW
    out = np.zeros((6, 6))
    out[:3, :3] = Ji
    out[:3, 3:] = -Ji @ Q @ Ji
    out[3:, 3:] = Ji
    return out


def _adjoint(T) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    out = np.zeros((6, 6))
    out[:3, :3] = R
    out[:3, 3:] = hat(t) @ R
    out[3:, 3:] = R
    return out


def _f32(T) -> np.ndarray:
    return np.asarray(T, dtype=np.float32)


# --- preprocessing (device) -------------------------------------------------

def scaled(K: tuple, f: float) -> tuple:
    fx, fy, cx, cy = K
    return (fx * f, fy * f, (cx + 0.5) * f - 0.5, (cy + 0.5) * f - 0.5)


def _normals(p, m, disc: float = 0.1):
    def roll(t, s, d):
        return torch.roll(t, s, dims=d)
    r, l, dn, up = roll(p, -1, 1), roll(p, 1, 1), roll(p, -1, 0), roll(p, 1, 0)
    du, dv = r - l, dn - up
    z = p[..., 2]
    ok = (m & roll(m, -1, 1) & roll(m, 1, 1) & roll(m, -1, 0) & roll(m, 1, 0)
          & ((r[..., 2] - z).abs() < disc) & ((l[..., 2] - z).abs() < disc)
          & ((dn[..., 2] - z).abs() < disc) & ((up[..., 2] - z).abs() < disc))
    n = torch.stack([du[..., 1] * dv[..., 2] - du[..., 2] * dv[..., 1],
                     du[..., 2] * dv[..., 0] - du[..., 0] * dv[..., 2],
                     du[..., 0] * dv[..., 1] - du[..., 1] * dv[..., 0]], -1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    ok = ok & (norm[..., 0] > 1e-12)
    n = n / torch.clamp(norm, min=1e-12)
    n = torch.where(torch.sum(n * p, dim=-1, keepdim=True) > 0, -n, n)
    border = torch.zeros_like(m)
    border[1:-1, 1:-1] = True
    ok = ok & border
    return torch.where(ok[..., None], n, 0.0), ok


def preprocess(depth: torch.Tensor, K: tuple, icp: dict) -> list:
    """[finest … coarsest] levels of (points, normals, mask)."""
    d = depth.to(F32)
    levels = []
    for li in range(icp["pyramid_levels"]):
        fx, fy, cx, cy = scaled(K, 1.0 / 2 ** li)
        h, w = d.shape
        v = torch.arange(h, dtype=F32, device=d.device)[:, None].expand(h, w)
        u = torch.arange(w, dtype=F32, device=d.device)[None, :].expand(h, w)
        x = (u - cx) / torch.full((), fx, dtype=F32, device=d.device) * d
        y = (v - cy) / torch.full((), fy, dtype=F32, device=d.device) * d
        m = (d > icp["depth_min"]) & (d < icp["depth_max"]) & torch.isfinite(d)
        p = torch.where(m[..., None], torch.stack([x, y, d], -1), 0.0)
        n, nm = _normals(p, m)
        levels.append((p, n, m & nm))
        d = d[::2, ::2]
    return levels


def pack_tables(levels: list, icp: dict) -> list:
    """Each level as an (H·W, 8) row table [q, n, valid, 0]."""
    dtype = {"float16": torch.float16, "float32": F32}[icp["packed_dtype"]]
    out = []
    for p, n, m in levels:
        h, w = m.shape
        ok = m & (torch.sum(n * n, dim=-1) > 0.5)
        out.append((torch.cat([p.reshape(-1, 3), n.reshape(-1, 3),
                               ok.reshape(-1, 1).to(F32),
                               torch.zeros((h * w, 1), dtype=F32,
                                           device=p.device)], 1).to(dtype),
                    h, w))
    return out


def _as_cloud(p, n, m):
    n = n.reshape(-1, 3)
    return (p.reshape(-1, 3), n, m.reshape(-1) & (torch.sum(n * n, -1) > 0.5))


def level_source(levels: list, li: int, icp: dict):
    """The ICP source cloud of level `li` (every other row at the finest
    level when `finest_subsample` is 2)."""
    p, n, m = levels[li]
    lvl = icp.get("level_subsample")
    f = int(lvl[li]) if lvl is not None and li < len(lvl) else (
        int(icp["finest_subsample"]) if li == 0 else 1)
    if f == 4 and li + 1 < len(levels):
        return _as_cloud(*levels[li + 1])
    if f == 2:
        return _as_cloud(p[0::2], n[0::2], m[0::2])
    if f == 4:
        return _as_cloud(p[::2, ::2], n[::2, ::2], m[::2, ::2])
    return _as_cloud(p, n, m)


def voxel_cloud(levels: list, voxel: dict):
    """The finest level's voxel-grid centroids (≤ capacity rows, masked),
    with the renormalized mean normal of each voxel."""
    pts, nrm, mask = _as_cloud(*levels[0])
    vs, cap = float(voxel["voxel_size"]), int(voxel["capacity"])
    origin, extent = float(voxel["origin"]), float(voxel["extent"])
    dims = int(-(-extent // vs))
    c = torch.floor((pts - origin) / torch.full((), vs, dtype=F32,
                                                device=pts.device))
    c = c.clamp(-1.0, float(dims)).to(torch.int64)
    valid = torch.all((c >= 0) & (c < dims), dim=-1) & mask
    c = c.clamp(0, dims - 1)
    big = 2 ** 31 - 1
    hi = torch.where(valid, c[:, 0] * dims + c[:, 1], big)
    lo = torch.where(valid, c[:, 2], big)
    order = torch.sort(hi * 2 ** 31 + lo, stable=True).indices
    key = (hi * 2 ** 31 + lo)[order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    seg = torch.clamp(torch.cumsum(new.to(torch.int64), 0) - 1, max=cap)
    w = valid.to(torch.float64)[order]
    vals = torch.cat([pts[order].double() * w[:, None],
                      nrm[order].double() * w[:, None], w[:, None]], 1)
    sums = torch.zeros((cap + 1, 7), dtype=torch.float64, device=pts.device)
    sums.index_add_(0, seg, vals)
    sums = sums[:cap].to(F32)
    cnt = sums[:, 6]
    out_m = cnt > 0
    den = torch.clamp(cnt, min=1.0)[:, None]
    cen = torch.where(out_m[:, None], sums[:, :3] / den, 0.0)
    nm = sums[:, 3:6] / den
    nn = torch.linalg.norm(nm, dim=-1, keepdim=True)
    nrm_out = torch.where(nn > 1e-8, nm / torch.clamp(nn, min=1e-8), 0.0)
    return cen, nrm_out, out_m


# --- ICP ----------------------------------------------------------------------

class Work:
    """What the ICP loops did: one (rows, valid rows) an association and
    one (rows, matched rows) a GN solve."""

    def __init__(self) -> None:
        self.assoc: list = []
        self.gn: list = []


def _gn_step(s: np.ndarray, T: np.ndarray, icp: dict):
    """The damped GN solve and the pose update from the reduced sums
    [H (36), b (6), Σw·r², Σvalid, Σw]: (T_new, δ², H)."""
    H = s[:36].reshape(6, 6)
    b = s[36:42]
    if not np.all(np.isfinite(s)):
        return T, float("nan"), H
    lam = icp["damping_abs"] * np.trace(H) / 6.0 + 1e-9
    A = H + icp["damping"] * np.diag(np.diag(H)) + lam * np.eye(6)
    try:
        delta = np.linalg.solve(A, -b)
    except np.linalg.LinAlgError:
        delta = np.zeros(6)
    if not np.all(np.isfinite(delta)):
        delta = np.zeros(6)
    tn = np.linalg.norm(delta[:3])
    rn = np.linalg.norm(delta[3:])
    scale = min(icp["max_trans_step"] / max(tn, 1e-12),
                icp["max_rot_step"] / max(rn, 1e-12), 1.0)
    delta = delta * scale
    T_new = _f32(se3_exp(delta) @ T.astype(np.float64))
    return T_new, float(delta @ delta), H


def icp_loop(src, table, K: tuple, T0: np.ndarray, icp: dict,
             max_iters: int, work: Work | None = None) -> dict:
    """One level's ICP of `src` = (points, normals, mask) onto the
    organized target `table` = (rows, h, w) from T0 (target ← source)."""
    pts, nrm, mask = (t.contiguous() for t in src)
    rows, h, w = table
    fx, fy, cx, cy = K
    inner = max(1, int(icp["inner_steps"]))
    tol_sq = float(icp["tol_delta"]) ** 2
    md2 = float(icp["max_corr_dist"]) ** 2
    ndmin = float(icp["normal_dot_min"])
    huber = float(icp["huber_delta"])
    n_rows = pts.shape[0]
    n_valid = float(mask.sum())
    T = _f32(T0)
    out = {"T": T, "iters": 0, "rms": float("inf"), "inl": 0.0,
           "ninl": 0.0, "delta_sq": float("inf"), "H": np.zeros((6, 6))}
    dev = pts.device
    it = 0
    for _ in range(-(-max_iters // inner) if max_iters > 0 else 0):
        Tt = torch.as_tensor(T, device=dev)
        x = torch.addmm(Tt[:3, 3], pts, Tt[:3, :3].T)
        z = x[:, 2]
        front = z > 1e-6
        zs = torch.where(front, z, 1.0)
        uv = torch.stack([x[:, 0] / zs * fx + cx, x[:, 1] / zs * fy + cy], -1)
        uvi = torch.round(uv).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)
        ui, vi = uvi[:, 0], uvi[:, 1]
        inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        flat = vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
        r = rows[flat].to(F32)
        q, n = r[:, :3], r[:, 3:6]
        valid = (mask & front & inb & (r[:, 6] > 0.5)
                 & (torch.sum((x - q) ** 2, -1) < md2))
        if ndmin > 0:
            nx = torch.mm(nrm, Tt[:3, :3].T)
            valid = valid & (torch.sum(n * nx, -1) > ndmin)
        wv = valid.to(F32)
        if work is not None:
            work.assoc.append((n_rows, n_valid))
        for k in range(inner):
            Tt = torch.as_tensor(T, device=dev)
            x = torch.addmm(Tt[:3, 3], pts, Tt[:3, :3].T)
            res = torch.sum(n * (x - q), -1)
            ar = res.abs()
            wt = wv * torch.where(ar <= huber, 1.0,
                                  huber / torch.clamp(ar, min=1e-12))
            J = torch.cat([n, torch.linalg.cross(x, n)], 1)
            Jw = J * wt[:, None]
            s = torch.cat([torch.mm(Jw.T, J).reshape(36),
                           torch.mv(Jw.T, res),
                           torch.stack([torch.sum(wt * res * res),
                                        wv.sum(), wt.sum()])])
            s = s.double().cpu().numpy()
            if work is not None:
                work.gn.append((n_rows, float(s[43])))
            T, delta_sq, H = _gn_step(s, T, icp)
            if k == inner - 1:
                it += inner
                ninl = float(s[43])
                out.update(T=T, iters=it, delta_sq=delta_sq, H=H, ninl=ninl,
                           rms=math.sqrt(s[42] / max(ninl, 1.0)),
                           inl=ninl / max(n_valid, 1.0))
        out["T"] = T
        if not (it < max_iters and out["delta_sq"] > tol_sq):
            break
    out["converged"] = out["delta_sq"] <= tol_sq
    return out


def align(levels: list, tables: list, K: tuple, T0: np.ndarray, icp: dict,
          work: Work | None = None) -> dict:
    """Coarse-to-fine ICP of a frame's pyramid onto a keyframe's tables."""
    T, res = T0, None
    ipl = icp["iters_per_level"]
    for li in range(len(levels) - 1, -1, -1):
        iters = ipl[li] if li < len(ipl) else icp["max_iters"]
        res = icp_loop(level_source(levels, li, icp), tables[li],
                       scaled(K, 1.0 / 2 ** li), T, icp, int(iters), work)
        T = res["T"]
    return res


def _damped(delta: np.ndarray, gamma: float) -> np.ndarray:
    if gamma == 0.0:
        return np.eye(4)
    if gamma == 1.0:
        return delta.astype(np.float64)
    return se3_exp(gamma * se3_log(delta.astype(np.float64)))


def track(tables, levels, K, T_kf_cam, last_delta, cfg: dict,
          work: Work | None = None):
    """One frame against a keyframe: (T_kf_cam, promote, lost, ICP result,
    the inter-frame motion for the next warm start)."""
    kf = cfg["keyframe"]
    T0 = _f32(T_kf_cam.astype(np.float64)
              @ _damped(last_delta, float(cfg["cv_damping"])))
    res = align(levels, tables, K, T0, cfg["icp"], work)
    T = res["T"]
    lost = res["inl"] < kf["lost_inlier_fraction"] or not np.all(
        np.isfinite(T))
    if lost:
        T = T0
    t = np.float32(np.sqrt(np.sum(T[:3, 3] * T[:3, 3], dtype=np.float32)))
    ang = np.float32(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) * 0.5,
                                       -1.0, 1.0)))
    promote = (not lost) and bool(
        t > np.float32(kf["max_translation"])
        or ang > np.float32(kf["max_rotation"])
        or np.float32(res["inl"]) < np.float32(kf["min_inlier_fraction"]))
    delta = _f32(inv(T_kf_cam.astype(np.float64)) @ T.astype(np.float64))
    return T, promote, lost, res, delta


# --- boundary odometry --------------------------------------------------------

def scan_boundary(depths: torch.Tensor, K: tuple, cfg: dict, chunk: int,
                  work: Work | None = None):
    """Frame-to-keyframe odometry with boundary promotion: every frame
    (frame 0 too) tracked against a keyframe frozen for a chunk; where any
    frame of a chunk flags promotion its last frame becomes the keyframe.
    Returns (world poses (F, 4, 4) float32, promote flags (F,))."""
    icp = cfg["icp"]
    eye = np.eye(4, dtype=np.float32)
    tables = pack_tables(preprocess(depths[0], K, icp), icp)
    T_world_kf, T_kf, last = eye, eye, eye
    poses, flags = [], []
    for c0 in range(0, depths.shape[0], chunk):
        rels, promo = [], []
        for i in range(c0, c0 + chunk):
            levels = preprocess(depths[i], K, icp)
            T, p, _lost, _res, delta = track(tables, levels, K, T_kf, last,
                                             cfg, work)
            T_kf, last = T, delta
            rels.append(T)
            promo.append(p)
        world = [_f32(T_world_kf @ r) for r in rels]
        poses += world
        flags += promo
        if any(promo):
            tables = pack_tables(levels, icp)
            T_kf = eye
            T_world_kf = world[-1]
    return np.stack(poses), np.asarray(flags)


# --- the SLAM system ----------------------------------------------------------

LC_WEIGHT = 2.0


class TrackingLost(RuntimeError):
    """The reference lost tracking: no frame of the benchmark's traffic may."""


class Slam:
    """The SLAM system in boundary chunk mode with a synchronous backend:
    `process_chunk` (the first call tracks its first sub-chunk frame by
    frame to seed the keyframe), `finalize`, `trajectory`."""

    def __init__(self, K: tuple, cfg: dict, chunk_sub: int,
                 work: Work | None = None) -> None:
        self.K, self.cfg, self.sub, self.work = K, cfg, int(chunk_sub), work
        eye = np.eye(4, dtype=np.float32)
        self.T_world_kf, self.T_kf, self.last = eye, eye, eye
        self.tables = None
        self.kfs: list = []          # dict(index, T, tables, cloud)
        self.refs: list = []         # (keyframe id, T_kf_cam)
        self.frame_idx = 0
        self.nodes: list = []        # graph poses, float32
        self.edges: list = []        # (i, j, T_ij float32, weight)
        self.known: set = set()
        self.failed: set = set()
        self.closures: list = []

    # keyframes and graph
    def _promote(self, levels, index: int) -> None:
        icp = self.cfg["icp"]
        self.tables = pack_tables(levels, icp)
        self.kfs.append({"index": index, "T": self.T_world_kf.copy(),
                         "tables": self.tables,
                         "cloud": voxel_cloud(levels, self.cfg["voxel"])})

    def _sync_graph(self) -> bool:
        added = False
        while len(self.nodes) < len(self.kfs):
            k = len(self.nodes)
            self.nodes.append(self.kfs[k]["T"].copy())
            if k > 0:
                T_ij = (np.linalg.inv(self.kfs[k - 1]["T"].astype(np.float64))
                        @ self.kfs[k]["T"].astype(np.float64))
                self.edges.append((k - 1, k, _f32(T_ij), 1.0))
                self.known.add((k - 1, k))
            added = True
        return added

    def _apply(self, poses: np.ndarray) -> None:
        n = len(self.nodes)
        self.nodes = [_f32(p) for p in poses[:n]]
        self.failed.clear()
        self.T_world_kf = self.nodes[n - 1].copy()
        for k in range(n):
            self.kfs[k]["T"] = self.nodes[k].copy()

    def _propose(self) -> list:
        pg = self.cfg["posegraph"]
        pos = np.asarray([T[:3, 3] for T in self.nodes], dtype=np.float32)
        k = len(pos)
        if k < 2:
            return []
        pos = pos - pos.mean(axis=0)
        sq = np.einsum("kd,kd->k", pos, pos)
        d = np.sqrt(np.maximum(sq[:, None] + sq[None, :]
                               - 2.0 * (pos @ pos.T), 0.0))
        ok = (d < pg["lc_max_dist"]) & (
            np.arange(k)[None, :] - np.arange(k)[:, None] > pg["lc_min_gap"])
        ii, jj = np.nonzero(ok)
        exclude = self.known | self.failed
        out = []
        for o in np.argsort(d[ii, jj], kind="stable"):
            pair = (int(ii[o]), int(jj[o]))
            if pair not in exclude:
                out.append(pair)
                if len(out) >= 4:
                    break
        return out

    def _verify(self, i: int, j: int, T_init: np.ndarray) -> dict:
        icp, pg = self.cfg["icp"], self.cfg["posegraph"]
        lvl = min(int(self.cfg["keyframe"]["verify_level"]),
                  len(self.kfs[i]["tables"]) - 1)
        res = icp_loop(self.kfs[j]["cloud"], self.kfs[i]["tables"][lvl],
                       scaled(self.K, 1.0 / 2 ** lvl), T_init, icp,
                       int(icp["max_iters"]), self.work)
        Hr = res["H"][:3, :3]
        cov = float(np.linalg.eigvalsh(Hr / max(np.trace(Hr), 1e-9))[0])
        T = res["T"]
        f = np.float32
        res["accept"] = bool(
            res["converged"] and f(res["rms"]) <= f(pg["lc_max_residual"])
            and f(res["inl"]) >= f(pg["lc_min_inliers"])
            and f(cov) >= f(pg["lc_min_normal_coverage"])
            and np.all(np.isfinite(T)))
        return res

    def solve_graph(self, edges: list) -> np.ndarray:
        """Gauss-Newton over the node poses (node 0 held by a prior)."""
        pg = self.cfg["posegraph"]
        P = [T.astype(np.float64) for T in self.nodes]
        n = len(P)
        info = np.array([pg["trans_weight"]] * 3 + [pg["rot_weight"]] * 3)
        prior = np.full(n, pg["damping"] + 1e-6)
        prior[0] += 1e6
        live = [(i, j, Tm.astype(np.float64), w) for i, j, Tm, w in edges
                if w > 0]
        for _ in range(int(pg["gn_iters"])):
            H = np.zeros((6 * n, 6 * n))
            b = np.zeros(6 * n)
            for i, j, Tm, w in live:
                r = se3_log(inv(Tm) @ inv(P[i]) @ P[j])
                wr2 = float(r @ (info * r))
                rn = math.sqrt(max(wr2, 1e-18))
                ww = w * (1.0 if rn <= 0.5 else 0.5 / rn)
                Jj = _se3_jl_inv(-r) @ _adjoint(inv(P[j]))
                Wj = Jj * (ww * info)[:, None]
                si, sj = slice(6 * i, 6 * i + 6), slice(6 * j, 6 * j + 6)
                Hjj = Wj.T @ Jj
                H[si, si] += Hjj
                H[sj, sj] += Hjj
                H[si, sj] -= Hjj
                H[sj, si] -= Hjj
                b[si] -= Wj.T @ r
                b[sj] += Wj.T @ r
            H += np.diag(np.repeat(prior, 6) + pg["damping"]
                         * np.abs(np.diag(H)))
            delta = -np.linalg.solve(H, b).reshape(n, 6)
            if not np.all(np.isfinite(delta)):
                delta = np.zeros((n, 6))
            P = [se3_exp(delta[k]) @ P[k] for k in range(n)]
        return np.stack([_f32(p) for p in P])

    def _attempt(self) -> bool:
        pairs = self._propose()
        if not pairs:
            return False
        nodes = [T.astype(np.float64) for T in self.nodes]
        live = [(i, j, _f32(np.linalg.inv(nodes[i]) @ nodes[j]))
                for i, j in pairs]
        rows = [self._verify(i, j, T0) for i, j, T0 in live]
        cand = []
        for (i, j, _), r in zip(live, rows):
            T = r["T"] if np.all(np.isfinite(r["T"])) else np.eye(
                4, dtype=np.float32)
            cand.append((i, j, T, LC_WEIGHT * float(r["accept"])))
        poses = self.solve_graph(self.edges + cand)
        accepted = {(i, j) for (i, j, _), r in zip(live, rows)
                    if r["accept"]}
        self.failed |= set(pairs) - accepted
        added = False
        for (i, j, _), r in zip(live, rows):
            if not r["accept"] or (i, j) in self.known:
                continue
            self.edges.append((i, j, _f32(r["T"]), LC_WEIGHT))
            self.known.add((i, j))
            self.closures.append((i, j))
            added = True
        if added:
            self._apply(poses)
        return bool(accepted)

    # frames
    def _process_frame(self, depth) -> np.ndarray:
        icp = self.cfg["icp"]
        levels = preprocess(depth, self.K, icp)
        eye = np.eye(4, dtype=np.float32)
        if self.tables is None:
            self._promote(levels, self.frame_idx)
            self.refs.append((len(self.kfs) - 1, np.eye(4)))
        else:
            T, promote, lost, _res, delta = track(
                self.tables, levels, self.K, self.T_kf, self.last, self.cfg,
                self.work)
            if lost:
                raise TrackingLost(f"frame {self.frame_idx}")
            self.last, self.T_kf = delta, T
            T_world_cam = _f32(self.T_world_kf @ T)
            if promote:
                self.T_world_kf = T_world_cam
                self.T_kf = eye
                self._promote(levels, self.frame_idx)
                self.refs.append((len(self.kfs) - 1, np.eye(4)))
            else:
                self.refs.append((len(self.kfs) - 1, T.astype(np.float64)))
        self.frame_idx += 1
        if self._sync_graph():
            self._attempt()
        k, T_rel = self.refs[-1]
        return self.kfs[k]["T"].astype(np.float64) @ T_rel

    def _boundary(self, depths) -> list:
        icp = self.cfg["icp"]
        n = depths.shape[0]
        sub = self.sub if n >= self.sub and n % self.sub == 0 else n
        out = []
        base = self.T_world_kf.astype(np.float64)
        for g0 in range(0, n, sub):
            rels, flags = [], []
            for i in range(g0, g0 + sub):
                levels = preprocess(depths[i], self.K, icp)
                T, promote, lost, _res, delta = track(
                    self.tables, levels, self.K, self.T_kf, self.last,
                    self.cfg, self.work)
                if lost:
                    raise TrackingLost(f"frame {self.frame_idx + i - g0}")
                self.T_kf, self.last = T, delta
                rels.append(T.astype(np.float64))
                flags.append(promote)
            kf_id = len(self.kfs) - 1
            p = sub - 1 if any(flags) else -1
            ref0 = len(self.refs)
            for i in range(sub):
                self.refs.append((kf_id, rels[i]))
                out.append(base @ rels[i])
            self.frame_idx += sub
            if p >= 0:
                self.T_world_kf = _f32(base @ rels[p])
                self._promote(levels, self.frame_idx - sub + p)
                self.refs[ref0 + p] = (len(self.kfs) - 1, np.eye(4))
                self.T_kf = np.eye(4, dtype=np.float32)
                base = base @ rels[p]
        if self._sync_graph():
            self._attempt()
        return out

    def process_chunk(self, depths) -> np.ndarray:
        n = depths.shape[0]
        if self.tables is None:
            if n > self.sub and n % self.sub == 0:
                head = [self._process_frame(depths[i])
                        for i in range(self.sub)]
                return np.stack(head + self._boundary(depths[self.sub:]))
            return np.stack([self._process_frame(depths[i])
                             for i in range(n)])
        return np.stack(self._boundary(depths))

    def finalize(self) -> None:
        self._attempt()
        if self.edges:
            self._apply(self.solve_graph(self.edges))

    def trajectory(self) -> np.ndarray:
        return np.stack([self.kfs[k]["T"].astype(np.float64) @ T
                         for k, T in self.refs])

    def keyframe_frames(self) -> list:
        return [kf["index"] for kf in self.kfs]
