"""Pose-graph backend — port of `tpuslam/backend/posegraph.py`.

Keyframe nodes + odometry / loop-closure edges, Gauss-Newton over the
relative-pose residuals r = log(T_meas⁻¹ · T_i⁻¹ · T_j).  The graph has a
fixed, padded capacity (masked nodes, zero-weight edges); `GraphHost`
doubles its host storage when full and hands the device power-of-two
buckets.  Per-edge Jacobians (left-twist parametrization) are closed-form
where the reference uses `jax.jacfwd`.  Two inner solvers: dense (assemble
the (6N, 6N) system and solve it) and matrix-free block-Jacobi-
preconditioned CG.  Node 0 is gauge-fixed by a strong prior.

The dense solve of a CUDA graph whose node bucket is at most 32 is one
launch of `kernels/posegraph_dense.py` (`csrc/posegraph_dense.cu`: every
round in one block's shared memory, a Cholesky solve).  The CPU and larger
buckets run its plain twin `optimize_dense_reference`, which assembles the
system by scatter-adds and LU-solves it.

Nothing here reads a tensor back to the host: the twin's solve is
`solve_ex` / `inv_ex` (their plain forms check the solver's status on the
host), and CG runs a fixed budget of `cg_iters` iterations with a
device-side convergence flag after which iterations leave x unchanged —
the reference's while-loop exit, without a host round trip.  So each
solver is one CUDA graph on the card (tpuslam_torch/graphs.py), keyed by
the node and edge buckets, the config and the Huber width: the twin's
~11,700 ops a solve become one replay.  On the CPU, or with
`eager=True`, it runs op by op.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.geom import se3
from tpuslam_torch.kernels import posegraph_dense
from tpuslam_torch.transfer import resolve_device, upload


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (all shapes static per bucket)."""

    poses: torch.Tensor       # (N, 4, 4) node poses (world←node)
    node_mask: torch.Tensor   # (N,) bool
    edge_i: torch.Tensor      # (E,) int32 source node
    edge_j: torch.Tensor      # (E,) int32 target node
    edge_T: torch.Tensor      # (E, 4, 4) measured T_i⁻¹·T_j
    edge_weight: torch.Tensor  # (E,) float ≥ 0 (0 = unused slot)


class GraphHost:
    """Host-side mutable store behind the fixed-capacity PoseGraph.

    `cfg.max_nodes` / `cfg.max_edges` are initial paddings; storage doubles
    when full (amortized O(1) per add).  `graph()` copies a snapshot to
    `device` without waiting for the device (transfer.upload).
    """

    def __init__(self, cfg: PoseGraphConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_nodes = 0
        self.num_edges = 0
        self.node_capacity = cfg.max_nodes
        self.edge_capacity = cfg.max_edges
        self._poses = np.tile(np.eye(4, dtype=np.float32),
                              (self.node_capacity, 1, 1))
        self._edge_i = np.zeros((self.edge_capacity,), dtype=np.int32)
        self._edge_j = np.zeros((self.edge_capacity,), dtype=np.int32)
        self._edge_T = np.tile(np.eye(4, dtype=np.float32),
                               (self.edge_capacity, 1, 1))
        self._edge_w = np.zeros((self.edge_capacity,), dtype=np.float32)

    @staticmethod
    def _grown(arr: np.ndarray, new_cap: int, eye: bool) -> np.ndarray:
        if eye:
            out = np.tile(np.eye(4, dtype=arr.dtype), (new_cap, 1, 1))
        else:
            out = np.zeros((new_cap,) + arr.shape[1:], dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def ensure_capacity(self, nodes: int | None = None,
                        edges: int | None = None) -> None:
        """Grow storage (pow-2 doubling) to hold ≥ `nodes`/`edges` entries."""
        if nodes is not None and nodes > self.node_capacity:
            cap = self.node_capacity
            while cap < nodes:
                cap *= 2
            self._poses = self._grown(self._poses, cap, eye=True)
            self.node_capacity = cap
        if edges is not None and edges > self.edge_capacity:
            cap = self.edge_capacity
            while cap < edges:
                cap *= 2
            self._edge_i = self._grown(self._edge_i, cap, eye=False)
            self._edge_j = self._grown(self._edge_j, cap, eye=False)
            self._edge_T = self._grown(self._edge_T, cap, eye=True)
            self._edge_w = self._grown(self._edge_w, cap, eye=False)
            self.edge_capacity = cap

    def add_node(self, T_world: np.ndarray) -> int:
        self.ensure_capacity(nodes=self.num_nodes + 1)
        self._poses[self.num_nodes] = T_world
        self.num_nodes += 1
        return self.num_nodes - 1

    def add_edge(self, i: int, j: int, T_ij: np.ndarray,
                 weight: float = 1.0) -> None:
        self.ensure_capacity(edges=self.num_edges + 1)
        e = self.num_edges
        self._edge_i[e] = i
        self._edge_j[e] = j
        self._edge_T[e] = T_ij
        self._edge_w[e] = weight
        self.num_edges += 1

    @staticmethod
    def _bucket(n: int, floor: int, cap: int) -> int:
        """Smallest power of two ≥ max(n, floor), clamped to `cap`."""
        b = floor
        while b < n:
            b *= 2
        return min(b, cap)

    def graph(self, bucketed: bool = False) -> PoseGraph:
        """Snapshot as a fixed-capacity PoseGraph on the device.

        `bucketed=True` slices the padded storage down to the smallest
        power-of-two bucket holding the live node/edge counts, so the
        solver's cost tracks the trajectory, not its high-water mark.
        """
        n_cap, e_cap = self.node_capacity, self.edge_capacity
        if bucketed:
            n_cap = self._bucket(self.num_nodes, 32, n_cap)
            e_cap = self._bucket(self.num_edges, 64, e_cap)
        mask = np.zeros((n_cap,), dtype=bool)
        mask[: self.num_nodes] = True
        dev = self.device
        return PoseGraph(
            poses=upload(self._poses[:n_cap], dev),
            node_mask=upload(mask, dev),
            edge_i=upload(self._edge_i[:e_cap], dev),
            edge_j=upload(self._edge_j[:e_cap], dev),
            edge_T=upload(self._edge_T[:e_cap], dev),
            edge_weight=upload(self._edge_w[:e_cap], dev),
        )

    def set_poses(self, poses: np.ndarray) -> None:
        self._poses[: self.num_nodes] = poses[: self.num_nodes]

    def snapshot(self) -> "GraphHost":
        """A copy of the store that later adds and `set_poses` do not reach
        (the SLAM backend's worker takes one under the system's lock and
        reads it after releasing the lock)."""
        snap = copy.copy(self)
        for name in ("_poses", "_edge_i", "_edge_j", "_edge_T", "_edge_w"):
            setattr(snap, name, getattr(self, name).copy())
        return snap


def edge_residual(T_i, T_j, T_meas):
    """r = log(T_meas⁻¹ · T_i⁻¹ · T_j) ∈ R⁶ (zero when consistent)."""
    return se3.log(se3.inv(T_meas) @ se3.inv(T_i) @ T_j)


def _se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3), (E, 6) twists (ρ, φ) → (E, 6, 6):
    [[J⁻¹, −J⁻¹·Q·J⁻¹], [0, J⁻¹]] with J the SO(3) left Jacobian of φ and
    Q(ρ, φ) Barfoot's coupling block (State Estimation for Robotics, eq.
    7.86); its coefficients switch to their Taylor series below θ² = 0.0625
    like the se3 module's."""
    rho, phi = xi[:, :3], xi[:, 3:]
    W, P = se3.hat(phi), se3.hat(rho)
    t2 = torch.sum(phi * phi, dim=-1)
    small = t2 < 0.0625
    safe = torch.clamp(t2, min=0.0625)
    th = torch.sqrt(safe)
    sn, cs = torch.sin(th), torch.cos(th)
    c1 = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040,
                     (th - sn) / (safe * th))
    c2 = torch.where(small, 1 / 24 - t2 / 720 + t2 * t2 / 40320,
                     (safe + 2 * cs - 2) / (2 * safe * safe))
    c3 = torch.where(small, 1 / 120 - t2 / 2520 + t2 * t2 / 120960,
                     (2 * th - 3 * sn + th * cs) / (2 * safe * safe * th))
    WP, PW, WW = W @ P, P @ W, W @ W
    WPW = WP @ W
    Q = (0.5 * P + c1[:, None, None] * (WP + PW + WPW)
         + c2[:, None, None] * (WW @ P + PW @ W - 3 * WPW)
         + c3[:, None, None] * (WPW @ W + WW @ P @ W))
    Ji = se3._left_jacobian_inv(phi)
    zero = torch.zeros_like(Ji)
    return torch.cat([torch.cat([Ji, -Ji @ Q @ Ji], dim=-1),
                      torch.cat([zero, Ji], dim=-1)], dim=-2)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint (E, 4, 4) → (E, 6, 6) in the (ρ, φ) twist order."""
    R, t = se3.to_rt(T)
    return torch.cat([torch.cat([R, se3.hat(t) @ R], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def _edge_residual_jacobians(T_i, T_j, T_meas):
    """Residuals (E, 6) + Jacobians (E, 6, 6) w.r.t. left-twist updates
    exp(δ)·T of nodes i and j.

    The reference differentiates the residual with `jax.jacfwd`; here the
    derivative is closed-form: with E₀ = T_meas⁻¹·T_i⁻¹·T_j,
    log(E₀·exp(ε)) ≈ r₀ + J_r⁻¹(r₀)·ε and the updates enter as
    ε = ±Ad(T_j⁻¹)·δ, so J_j = J_l⁻¹(−r₀)·Ad(T_j⁻¹) and J_i = −J_j.
    Computed in float64 and rounded once; it agrees with forward-mode
    differentiation to float32 noise for residual rotations below π.
    """
    r = edge_residual(T_i, T_j, T_meas)
    Jj = (_se3_left_jacobian_inv(-r.to(torch.float64))
          @ _adjoint(se3.inv(T_j).to(torch.float64))).to(r.dtype)
    return r, -Jj, Jj


def _huber_scale(r_norm_sq: torch.Tensor, delta: float) -> torch.Tensor:
    r_norm = torch.sqrt(torch.clamp(r_norm_sq, min=1e-18))
    return torch.where(r_norm <= delta, 1.0, delta / r_norm)


def _info_vector(cfg: PoseGraphConfig, like: torch.Tensor) -> torch.Tensor:
    def full(v):
        return torch.full((3,), v, dtype=like.dtype, device=like.device)

    return torch.cat([full(cfg.trans_weight), full(cfg.rot_weight)])


def edge_blocks(poses, edge_i, edge_j, edge_T, edge_weight, info,
                huber_delta: float):
    """Per-edge GN blocks without assembling the dense system: (Hii, Hjj,
    Hij (E, 6, 6), bi, bj (E, 6), cost ())."""
    T_i = poses[edge_i.long()]
    T_j = poses[edge_j.long()]
    r, Ji, Jj = _edge_residual_jacobians(T_i, T_j, edge_T)
    wr2 = torch.einsum("ek,k,ek->e", r, info, r)
    w = edge_weight * _huber_scale(wr2, huber_delta)
    Wi = Ji * (w[:, None, None] * info[None, :, None])
    Wj = Jj * (w[:, None, None] * info[None, :, None])
    Hii = torch.einsum("eki,ekj->eij", Wi, Ji)
    Hjj = torch.einsum("eki,ekj->eij", Wj, Jj)
    Hij = torch.einsum("eki,ekj->eij", Wi, Jj)
    bi = torch.einsum("eki,ek->ei", Wi, r)
    bj = torch.einsum("eki,ek->ei", Wj, r)
    return Hii, Hjj, Hij, bi, bj, torch.sum(w * wr2)


def _scatter_add(out: torch.Tensor, index, values) -> torch.Tensor:
    """out[index] += values with repeated indices summed (the sorting
    implementation: deterministic on the GPU, unlike atomic adds)."""
    return out.index_put(index, values, accumulate=True)


def edge_normal_system(poses, edge_i, edge_j, edge_T, edge_weight, info,
                       huber_delta: float):
    """The (6N, 6N) GN normal system of a set of edges: (H, b, cost)."""
    N = poses.shape[0]
    Hii, Hjj, Hij, bi, bj, cost = edge_blocks(
        poses, edge_i, edge_j, edge_T, edge_weight, info, huber_delta)
    ei, ej = edge_i.long(), edge_j.long()
    Hb = torch.zeros((N, N, 6, 6), dtype=poses.dtype, device=poses.device)
    Hb = _scatter_add(Hb, (ei, ei), Hii)
    Hb = _scatter_add(Hb, (ej, ej), Hjj)
    Hb = _scatter_add(Hb, (ei, ej), Hij)
    Hb = _scatter_add(Hb, (ej, ei), Hij.transpose(-1, -2))
    b = torch.zeros((N, 6), dtype=poses.dtype, device=poses.device)
    b = _scatter_add(b, (ei,), bi)
    b = _scatter_add(b, (ej,), bj)
    H = Hb.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    return H, b.reshape(6 * N), cost


def _prior(node_mask: torch.Tensor, cfg: PoseGraphConfig) -> torch.Tensor:
    """(N,) gauge prior + damping, 1e6-scaled on masked (padding) nodes."""
    N = node_mask.shape[0]
    diag_scale = torch.where(node_mask, 1.0, 1e6)
    prior = torch.zeros((N,), device=node_mask.device)
    prior[0].fill_(1e6)       # a fill: no copy from host memory
    return (prior + cfg.damping + 1e-6) * diag_scale


def solve_and_update(poses, node_mask, H, b, cfg: PoseGraphConfig):
    """Apply gauge prior + damping, solve, and left-update all poses."""
    N = poses.shape[0]
    prior = _prior(node_mask, cfg).repeat_interleave(6)
    H = H + torch.diag(prior + cfg.damping * torch.abs(torch.diagonal(H)))
    x, _ = torch.linalg.solve_ex(H, b)
    delta = -x.reshape(N, 6)
    ok = torch.all(torch.isfinite(delta))
    delta = torch.where(ok, delta, 0.0)
    return se3.exp(delta) @ poses


def _solve_update_cg(poses, node_mask, blocks, b, cfg: PoseGraphConfig,
                     cg_iters: int, cg_tol: float):
    """One GN step via block-Jacobi-preconditioned conjugate gradient: H
    is only applied (O(E) batched 6×6 products), the preconditioner is the
    inverted (N, 6, 6) block diagonal; same regularized system as the
    dense path.  A fixed budget of `cg_iters` iterations; once the
    reference's loop condition fails (`done`) an iteration changes
    nothing."""
    Hii, Hjj, Hij, edge_i, edge_j = blocks
    ei, ej = edge_i.long(), edge_j.long()
    N = poses.shape[0]
    D = torch.zeros((N, 6, 6), dtype=poses.dtype, device=poses.device)
    D = _scatter_add(D, (ei,), Hii)
    D = _scatter_add(D, (ej,), Hjj)
    prior = _prior(node_mask, cfg)
    dvec = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))      # (N, 6)
    reg = prior[:, None] + cfg.damping * dvec
    D = D + torch.diag_embed(reg)

    def apply_H(x):                                             # (N, 6)
        xi, xj = x[ei], x[ej]
        y = _scatter_add(reg * x, (ei,),
                         torch.einsum("eij,ej->ei", Hii, xi)
                         + torch.einsum("eij,ej->ei", Hij, xj))
        return _scatter_add(y, (ej,),
                            torch.einsum("eij,ej->ei", Hjj, xj)
                            + torch.einsum("eji,ej->ei", Hij, xi))

    M_inv, _ = torch.linalg.inv_ex(D)

    def precond(x):
        return torch.einsum("nij,nj->ni", M_inv, x)

    b2 = -b
    x = torch.zeros_like(b2)
    r = b2
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b_norm = torch.clamp(torch.sum(b2 * b2), min=1e-30)
    for _ in range(cg_iters):
        go = torch.sum(r * r) > cg_tol ** 2 * b_norm
        Hp = apply_H(p)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Hp
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        p_n = z + (rz_n / torch.clamp(rz, min=1e-30)) * p
        x, r, p, rz = (torch.where(go, a, o) for a, o in
                       ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    ok = torch.all(torch.isfinite(x))
    delta = torch.where(ok, x, 0.0)
    return se3.exp(delta) @ poses


def _optimize_cg(_state, graph: PoseGraph, *, cfg: PoseGraphConfig,
                 huber_delta: float, cg_iters: int, cg_tol: float):
    info = _info_vector(cfg, graph.poses)
    poses = graph.poses
    cost = torch.full((), float("inf"), device=poses.device)
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    N = poses.shape[0]
    for _ in range(cfg.gn_iters):
        Hii, Hjj, Hij, bi, bj, cost = edge_blocks(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, huber_delta)
        b = torch.zeros((N, 6), dtype=poses.dtype, device=poses.device)
        b = _scatter_add(_scatter_add(b, (ei,), bi), (ej,), bj)
        poses = _solve_update_cg(poses, graph.node_mask,
                                 (Hii, Hjj, Hij, graph.edge_i, graph.edge_j),
                                 b, cfg, cg_iters, cg_tol)
    return (), (poses, cost)


_CG = graphs.Program("optimize_pose_graph_cg", _optimize_cg)


def optimize_pose_graph_cg(graph: PoseGraph, cfg: PoseGraphConfig,
                           huber_delta: float = 0.5, cg_iters: int = 128,
                           cg_tol: float = 1e-6, eager: bool = False):
    """Gauss-Newton with the matrix-free block-CG inner solver; returns
    (poses, cost of the last round's linearization point).  One replay of
    a CUDA graph on the card, unless `eager`."""
    return _CG.run(graph, eager=eager, cfg=cfg, huber_delta=huber_delta,
                   cg_iters=cg_iters, cg_tol=cg_tol)


def optimize_dense_reference(graph: PoseGraph, cfg: PoseGraphConfig,
                             huber_delta: float):
    """Plain PyTorch twin of `csrc/posegraph_dense.cu`, op by op:
    `gn_iters` rounds of the normal system by scatter-adds, an LU solve and
    the left update.  Returns (poses, cost of the last round's
    linearization point)."""
    posegraph_dense.counter.plain()
    info = _info_vector(cfg, graph.poses)
    poses = graph.poses
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(cfg.gn_iters):
        H, b, cost = edge_normal_system(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, huber_delta)
        poses = solve_and_update(poses, graph.node_mask, H, b, cfg)
    return poses, cost


def _optimize_dense(_state, graph: PoseGraph, *, cfg: PoseGraphConfig,
                    huber_delta: float):
    if posegraph_dense.engages(graph.poses.device.type, graph.poses.shape[0],
                               graph.edge_i.shape[0]):
        return (), posegraph_dense.launch(*graph, cfg, huber_delta)
    return (), optimize_dense_reference(graph, cfg, huber_delta)


_DENSE = graphs.Program("optimize_pose_graph", _optimize_dense)


def optimize_pose_graph(graph: PoseGraph, cfg: PoseGraphConfig,
                        huber_delta: float = 0.5, eager: bool = False):
    """Gauss-Newton over all node poses with the dense solve; returns
    (poses, cost of the last round's linearization point).  One replay of
    a CUDA graph on the card, unless `eager`: one kernel launch at node
    buckets up to 32 (`kernels/posegraph_dense.py`), the twin's ops beyond.

    Edge weights scale a diagonal information diag(trans_weight·I₃,
    rot_weight·I₃); a Huber factor on the whole-edge residual norm
    robustifies bad loop closures.
    """
    return _DENSE.run(graph, eager=eager, cfg=cfg, huber_delta=huber_delta)


def resolve_solver(cfg: PoseGraphConfig, live_nodes: int | None = None,
                   capacity: int | None = None) -> str:
    """The "auto" solver decision as a host-side predicate: dense up to
    `cfg.dense_max_nodes` live nodes (or capacity), CG beyond."""
    solver = cfg.solver
    if solver == "auto":
        n = live_nodes if live_nodes is not None else capacity
        solver = "dense" if n <= cfg.dense_max_nodes else "cg"
    return solver


def optimize(graph: PoseGraph, cfg: PoseGraphConfig,
             huber_delta: float = 0.5, live_nodes: int | None = None,
             eager: bool = False):
    """Solver-dispatching entry point: cfg.solver ∈ {"auto", "dense", "cg"}."""
    solver = resolve_solver(cfg, live_nodes, capacity=graph.poses.shape[0])
    if solver == "cg":
        return optimize_pose_graph_cg(graph, cfg, huber_delta,
                                      cg_iters=int(cfg.cg_iters),
                                      cg_tol=float(cfg.cg_tol), eager=eager)
    return optimize_pose_graph(graph, cfg, huber_delta, eager=eager)


def graph_cost(graph: PoseGraph, cfg: PoseGraphConfig) -> torch.Tensor:
    """Unweighted total squared residual (diagnostics)."""
    T_i = graph.poses[graph.edge_i.long()]
    T_j = graph.poses[graph.edge_j.long()]
    r = edge_residual(T_i, T_j, graph.edge_T)
    return torch.sum(graph.edge_weight * torch.sum(r * r, dim=-1))
