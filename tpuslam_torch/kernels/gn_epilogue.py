"""The GN-step epilogue and the ICP loop carry — port of
`tpuslam/kernels/pallas_epilogue.py`.

`gn_epilogue` folds a partials table (kernels/gn_partials.py), solves the
damped 6×6 system by Gauss elimination without pivoting, applies the
non-finite guard and the trust region, takes the SE(3) exp and composes
T ← exp(δ)·T — the reference's `_epilogue_math` — and then updates the ICP
loop's carry on the device.  On a CUDA tensor it launches
`csrc/gn_epilogue.cu`; on a CPU tensor it runs the plain twin
`gn_epilogue_reference`, which follows the reference op for op.  Both
fold the partials rows in the kernel's order (`fold_rows`).  The ICP loop
on one card runs the same fold and solve inside `kernels/gn_step.py`'s
launch, and the fused loop inside `kernels/gn_fused.py`'s; this wrapper
serves the ring ICP.

The carry is one float32[64] tensor (layout below).  It stands for the
reference's `lax.while_loop` state plus the loop predicate: once DONE is
set the epilogue passes the carry through unchanged, so a fixed budget of
outer iterations reproduces the reference's early exit without reading
anything back to the host.
"""

from __future__ import annotations

import torch

from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels.gn_partials import ROW

counter = _build.LaunchCounter("gn_epilogue")

# carry layout — mirrored in csrc/gn_solve.cuh
DONE, IT, DELTA_SQ, RMS, INLIER_FRACTION, NUM_INLIERS = 0, 1, 2, 3, 4, 5
T_SLICE = slice(6, 22)
H_SLICE = slice(22, 58)
CARRY_SIZE = 64
# step layout — mirrored in csrc/gn_solve.cuh
STEP_T = slice(0, 16)
STEP_H = slice(16, 52)
STEP_DELTA_SQ, STEP_WSQ, STEP_NINL, STEP_WSUM = 52, 53, 54, 55
STEP_SIZE = 64
FOLD_WARPS = 8            # warps of the kernels' fold (csrc/gn_solve.cuh)

_SINC_SERIES_THETA_SQ = 0.0625           # geom/se3.py threshold (θ < 0.25)


def init_carry(T0: torch.Tensor, max_iters: int) -> torch.Tensor:
    """Carry of a fresh ICP loop at pose T0 (the reference's `init`:
    it 0, δ² and rms ∞, H 0), DONE already set when the budget is 0."""
    head = torch.zeros(6, dtype=torch.float32, device=T0.device)
    # fills, not element assignment: a Python scalar assigned to an element
    # of a CUDA tensor is a copy from host memory, which waits for the
    # stream and which a CUDA graph cannot capture
    head[DONE].fill_(0.0 if max_iters > 0 else 1.0)
    head[DELTA_SQ].fill_(float("inf"))
    head[RMS].fill_(float("inf"))
    tail = torch.zeros(CARRY_SIZE - T_SLICE.stop, dtype=torch.float32,
                       device=T0.device)
    return torch.cat([head, T0.reshape(16).to(torch.float32), tail])


def _epilogue_math(sums, T, damping, damping_abs, max_trans, max_rot):
    """The reference's `_epilogue_math` with the same masked vector ops.

    Args:
      sums: (32, 1) column of folded partials (rows ≥ 30 are padding).
      T: (4, 4) current pose.
    Returns: (T_new, H, delta_sq, wsq, ninl, wsum).
    """
    f32, dev = sums.dtype, sums.device

    def iota(shape, axis):
        return torch.arange(shape[axis], device=dev).reshape(
            [-1 if a == axis else 1 for a in range(len(shape))]).expand(shape)

    i6, j6 = iota((6, 6), 0), iota((6, 6), 1)
    i4, j4 = iota((4, 4), 0), iota((4, 4), 1)
    i67, j67 = iota((6, 7), 0), iota((6, 7), 1)
    rows6 = iota((6, 1), 0)

    def pat(cond):
        return cond.to(f32)

    # The reference reads sum k as sum(sums * onehot_k): one non-finite sum
    # makes every other sum NaN (0 * inf).
    s = sums[:, 0]
    bad = ~torch.isfinite(s)
    s = torch.where(bad.sum() - bad.to(torch.int64) > 0, float("nan"), s)
    H = torch.zeros((6, 6), dtype=f32, device=dev)
    k = 0
    for pi in range(6):
        for pj in range(pi, 6):
            mask = ((i6 == pi) & (j6 == pj)) | ((i6 == pj) & (j6 == pi))
            H = H + s[k] * pat(mask)
            k += 1
    b = s[21:27].reshape(6, 1)
    wsq, ninl, wsum = s[27], s[28], s[29]

    eye6 = pat(i6 == j6)
    diag = H * eye6
    trace = torch.sum(diag)
    lam_abs = damping_abs * (trace / 6.0) + 1e-9
    A = H + damping * diag + lam_abs * eye6

    aug = torch.cat([A, -b], dim=1)                          # (6, 7)
    for k in range(6):
        akk = aug[k, k]
        colk = aug[:, k:k + 1]
        rowk = aug[k:k + 1, :]
        below = pat(rows6 > k)
        aug = aug - (below * colk / akk) * rowk
    for k in range(5, -1, -1):
        akk = aug[k, k]
        rowk = aug[k:k + 1, :] / akk
        colk = aug[:, k:k + 1]
        above = pat(rows6 < k)
        aug = aug - (above * colk) * rowk
        sel = pat(i67 == k)
        aug = aug * (1.0 - sel) + sel * rowk
    delta = aug[:, 6:7]                                      # (6, 1)

    finite = torch.min(torch.isfinite(delta).to(f32))
    delta = torch.where(torch.isfinite(delta), delta, 0.0) * finite
    rho_mask = pat(rows6 < 3)
    t_norm = torch.sqrt(torch.sum((delta * rho_mask) ** 2))
    r_norm = torch.sqrt(torch.sum((delta * (1.0 - rho_mask)) ** 2))
    scale = torch.clamp(
        torch.minimum(max_trans / torch.clamp(t_norm, min=1e-12),
                      max_rot / torch.clamp(r_norm, min=1e-12)),
        max=1.0)
    delta = delta * scale
    delta_sq = torch.sum(delta * delta)

    phx, phy, phz = delta[3, 0], delta[4, 0], delta[5, 0]
    gx = pat((i4 == 2) & (j4 == 1)) - pat((i4 == 1) & (j4 == 2))
    gy = pat((i4 == 0) & (j4 == 2)) - pat((i4 == 2) & (j4 == 0))
    gz = pat((i4 == 1) & (j4 == 0)) - pat((i4 == 0) & (j4 == 1))
    W = phx * gx + phy * gy + phz * gz                       # (4, 4)
    W2 = W @ W
    theta_sq = phx * phx + phy * phy + phz * phz
    ts_safe = torch.clamp(theta_sq, min=_SINC_SERIES_THETA_SQ)
    theta = torch.sqrt(ts_safe)
    small = theta_sq < _SINC_SERIES_THETA_SQ
    t2 = theta_sq
    a_co = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                       torch.sin(theta) / theta)
    b_co = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                       (1.0 - torch.cos(theta)) / ts_safe)
    c_co = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                       (theta - torch.sin(theta)) / (ts_safe * theta))
    i3_4 = pat((i4 == j4) & (i4 < 3))
    R4 = i3_4 + a_co * W + b_co * W2
    V4 = i3_4 + b_co * W + c_co * W2
    rho4 = torch.cat([delta[0:3], torch.zeros((1, 1), dtype=f32, device=dev)])
    t4 = V4 @ rho4                                           # (4, 1)
    e3row = pat(torch.arange(4, device=dev) == 3).reshape(1, 4)
    e33 = pat((i4 == 3) & (j4 == 3))
    E = R4 + t4 @ e3row + e33
    T_new = E @ T
    return T_new, H, delta_sq, wsq, ninl, wsum


def fold_rows(partials: torch.Tensor) -> torch.Tensor:
    """(32,) column sums of a partials table in the kernels' grouping
    (csrc/gn_solve.cuh `fold_rows`): warp w adds rows [w·R/8, (w+1)·R/8),
    then the eight warp sums are added in warp order."""
    rows = partials.shape[0]
    total = torch.zeros(ROW, dtype=partials.dtype, device=partials.device)
    for w in range(FOLD_WARPS):
        r0, r1 = w * rows // FOLD_WARPS, (w + 1) * rows // FOLD_WARPS
        total = total + partials[r0:r1].sum(dim=0)
    return total


def epilogue_plain(partials, carry, num_valid_src, damping: float,
                   damping_abs: float, max_trans: float, max_rot: float,
                   is_last: bool, inner: int, max_iters: int, tol_sq: float):
    """`gn_epilogue_reference` without counting a call (for other twins)."""
    sums = fold_rows(partials).reshape(ROW, 1)
    T = carry[T_SLICE].reshape(4, 4)
    T_new, H, delta_sq, wsq, ninl, wsum = _epilogue_math(
        sums, T, damping, damping_abs, max_trans, max_rot)
    step = torch.cat([
        T_new.reshape(16), H.reshape(36),
        torch.stack([delta_sq, wsq, ninl, wsum]),
        torch.zeros(STEP_SIZE - 56, dtype=carry.dtype, device=carry.device),
    ])
    new = carry.clone()
    new[T_SLICE] = T_new.reshape(16)
    if is_last:
        it = carry[IT] + float(inner)
        new[IT] = it
        new[DELTA_SQ] = delta_sq
        new[RMS] = torch.sqrt(wsq / torch.clamp(ninl, min=1.0))
        new[INLIER_FRACTION] = ninl / torch.clamp(num_valid_src, min=1.0)
        new[NUM_INLIERS] = ninl
        new[H_SLICE] = H.reshape(36)
        keep_going = (it < float(max_iters)) & (delta_sq > tol_sq)
        new[DONE] = (~keep_going).to(carry.dtype)
    carry_out = torch.where(carry[DONE] != 0, carry, new)
    return carry_out, step


def gn_epilogue_reference(partials, carry, num_valid_src, damping: float,
                          damping_abs: float, max_trans: float,
                          max_rot: float, is_last: bool, inner: int,
                          max_iters: int, tol_sq: float):
    """Plain twin of the epilogue kernel.  Returns (carry_out, step)."""
    counter.plain()
    return epilogue_plain(partials, carry, num_valid_src, damping,
                          damping_abs, max_trans, max_rot, is_last, inner,
                          max_iters, tol_sq)


def gn_epilogue(partials: torch.Tensor, carry: torch.Tensor,
                num_valid_src: torch.Tensor, damping: float,
                damping_abs: float, max_trans: float, max_rot: float,
                is_last: bool, inner: int, max_iters: int, tol_sq: float):
    """One GN step's epilogue and carry update.

    Args:
      partials: (B, 32) float32 table from `gn_reduce_partials_at_pose`.
      carry: (64,) float32 ICP loop carry (layout above).
      num_valid_src: () float32 Σ source mask (inlier-fraction denominator).
      damping/damping_abs/max_trans/max_rot: solve parameters.
      is_last: True on the last inner solve of an outer iteration: only
        then are `it`, the stats and DONE updated (T is updated on every
        solve while DONE is clear).
      inner/max_iters/tol_sq: the loop predicate it < max_iters ∧ δ² > tol².
    Returns:
      (carry_out (64,), step (64,)): step holds this solve's T_new, its
      undamped H and [δ², Σw·r², Σvalid, Σw], whether or not DONE was set.
    """
    if partials.device.type == "cpu":
        return gn_epilogue_reference(
            partials, carry, num_valid_src, damping, damping_abs, max_trans,
            max_rot, is_last, inner, max_iters, tol_sq)
    if partials.device.type != "cuda":
        raise ValueError(f"gn_epilogue: no kernel for {partials.device}")
    dev = partials.device
    if partials.dim() != 2 or partials.shape[1] != ROW or partials.shape[0] < 1:
        raise ValueError(f"partials: shape {tuple(partials.shape)}, kernel "
                         f"takes (B ≥ 1, {ROW})")
    _build.require(partials, "partials", dtype=torch.float32, device=dev)
    _build.require(carry, "carry", dtype=torch.float32, shape=(CARRY_SIZE,),
                   device=dev)
    _build.require(num_valid_src, "num_valid_src", dtype=torch.float32,
                   shape=(), device=dev)
    carry_out = torch.empty(CARRY_SIZE, dtype=torch.float32, device=dev)
    step = torch.empty(STEP_SIZE, dtype=torch.float32, device=dev)
    stream = _build.stream_handle(partials)
    err = _build.library().tpuslam_gn_epilogue(
        partials.data_ptr(), partials.shape[0], carry.data_ptr(),
        num_valid_src.data_ptr(), damping, damping_abs, max_trans, max_rot,
        int(is_last), int(inner), int(max_iters), tol_sq,
        carry_out.data_ptr(), step.data_ptr(), stream)
    _build.check_launch(err, "gn_epilogue")
    counter.launched(stream)
    return carry_out, step

