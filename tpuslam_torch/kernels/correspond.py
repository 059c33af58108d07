"""Projective correspondence — port of the organized-target path of
`tpuslam/kernels/correspond.py`.

`pack_organized_target` packs a keyframe level into one (H·W, 8) float16
row table ``[q, n, mask·has_normal, 0]``.  `projective_correspond_at_pose`
moves each source point (and normal) into the target camera by the ICP
loop carry's pose, projects it, rounds to a pixel and gathers that one
16-byte row: the ICP loop's association, one launch.
`projective_correspond_packed` is the reference-shaped call, on points
already in the target camera.  On a CUDA tensor both are the hand kernel
`csrc/correspond.cu`; on a CPU tensor they are the plain twins
`projective_correspond_at_pose_reference` and
`projective_correspond_packed_reference`, which have the same semantics
and rounding (q, n, flat and w are bit-equal on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.config import Intrinsics
from tpuslam_torch.geom.backproject import project
from tpuslam_torch.geom.se3 import (
    rotate_vectors_ordered,
    transform_points_ordered,
)
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import gn_epilogue as ep

counter = _build.LaunchCounter()


class Correspondence(NamedTuple):
    q: torch.Tensor      # (N, 3) matched target points
    n: torch.Tensor      # (N, 3) matched target normals
    w: torch.Tensor      # (N,) validity weight in {0, 1}
    idx: torch.Tensor    # (N,) int32 flat pixel index of the match


def pack_organized_target(dst_points: torch.Tensor, dst_normals: torch.Tensor,
                          dst_mask: torch.Tensor,
                          dtype: torch.dtype | None = torch.float16
                          ) -> torch.Tensor:
    """Pack an organized target into one (H·W, 8) row-major table.

    Row = [qx qy qz nx ny nz mask·has_normal 0].  The cast to float16 rounds
    to nearest even, as the reference's does.
    """
    h, w = dst_mask.shape
    has_normal = torch.sum(dst_normals * dst_normals, dim=-1) > 0.5
    packed = torch.cat(
        [
            dst_points.reshape(h * w, 3),
            dst_normals.reshape(h * w, 3),
            (dst_mask & has_normal).reshape(h * w, 1).to(dst_points.dtype),
            torch.zeros((h * w, 1), dtype=dst_points.dtype,
                        device=dst_points.device),
        ],
        dim=1,
    )
    if dtype is not None:
        packed = packed.to(dtype)
    return packed


def projective_correspond_packed_reference(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    packed: torch.Tensor,
    height: int,
    width: int,
    K: Intrinsics,
    max_dist: float,
    src_normals_in_dst: torch.Tensor | None = None,
    normal_dot_min: float = 0.0,
) -> Correspondence:
    """Plain PyTorch twin of the correspond kernel (the reference's ops)."""
    counter.plain_calls += 1
    uv, in_front = project(x, K)
    # The clamp keeps the float→int conversion defined; any value it
    # changes is out of bounds either way.
    uvi = torch.round(uv).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int32)
    ui, vi = uvi[..., 0], uvi[..., 1]
    in_bounds = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    flat = (torch.clamp(vi, 0, height - 1) * width
            + torch.clamp(ui, 0, width - 1))
    rows = packed[flat.long()].to(x.dtype)
    q = rows[:, :3]
    n = rows[:, 3:6]
    dmask = rows[:, 6] > 0.5
    d2 = torch.sum((x - q) ** 2, dim=-1)
    valid = x_mask & in_front & in_bounds & dmask & (d2 < max_dist * max_dist)
    if src_normals_in_dst is not None and normal_dot_min > 0.0:
        dot = torch.sum(n * src_normals_in_dst, dim=-1)
        valid = valid & (dot > normal_dot_min)
    return Correspondence(q=q, n=n, w=valid.to(x.dtype), idx=flat)


def projective_correspond_packed(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    packed: torch.Tensor,
    height: int,
    width: int,
    K: Intrinsics,
    max_dist: float,
    src_normals_in_dst: torch.Tensor | None = None,
    normal_dot_min: float = 0.0,
    done: torch.Tensor | None = None,
) -> Correspondence:
    """Projective association via one row gather from a packed target.

    Args:
      x: (N, 3) float32 source points already in the target camera frame.
      x_mask: (N,) bool source validity.
      packed: (H·W, 8) float16 table from `pack_organized_target`.
      height/width: target image shape.
      K: target camera intrinsics (level-scaled for pyramids).
      max_dist: Euclidean rejection radius.
      src_normals_in_dst: optional (N, 3) source normals rotated into the
        target frame for the compatibility gate.
      normal_dot_min: reject if n_dst · n_src is not above this cosine.
      done: optional float32 tensor whose element 0, when non-zero, makes
        the kernel skip all work (the ICP loop's device-side early exit;
        the outputs are then unspecified).  The CPU twin ignores it.
    """
    if x.device.type == "cpu":
        return projective_correspond_packed_reference(
            x, x_mask, packed, height, width, K, max_dist,
            src_normals_in_dst, normal_dot_min)
    gate = src_normals_in_dst is not None and normal_dot_min > 0.0
    return _launch("projective_correspond_packed", x, x_mask,
                   src_normals_in_dst if gate else None, None, packed, height,
                   width, K, max_dist, normal_dot_min, done)


def projective_correspond_at_pose_reference(
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    packed: torch.Tensor,
    height: int,
    width: int,
    K: Intrinsics,
    max_dist: float,
    normal_dot_min: float,
    T: torch.Tensor,
) -> Correspondence:
    """Plain twin of the posed kernel: the ordered transform and rotation
    (the kernel's rounding), then `projective_correspond_packed_reference`."""
    gate = normal_dot_min > 0.0
    return projective_correspond_packed_reference(
        transform_points_ordered(T, points), mask, packed, height, width, K,
        max_dist, rotate_vectors_ordered(T, normals) if gate else None,
        normal_dot_min)


def projective_correspond_at_pose(
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    packed: torch.Tensor,
    height: int,
    width: int,
    K: Intrinsics,
    max_dist: float,
    normal_dot_min: float,
    carry: torch.Tensor,
    out: Correspondence | None = None,
) -> Correspondence:
    """The ICP loop's association at the carry's pose, in one launch.

    Args:
      points, normals: (N, 3) float32 source points and normals in the
        source frame; the kernel applies the carry's pose T (x = R p + t,
        n_rot = R n, in registers).
      mask: (N,) bool source validity.
      packed, height, width, K, max_dist, normal_dot_min: as
        `projective_correspond_packed` (the normal gate applies when
        `normal_dot_min > 0`).
      carry: (64,) float32 ICP loop carry (layout in kernels/gn_epilogue.py):
        the pose is read from its T and, once its DONE is set, the kernel
        reads and writes nothing.  The CPU twin ignores DONE.
      out: optional `correspondence_buffers(N)` to write into (and
        return), so an ICP loop allocates its outputs once; new tensors
        otherwise.
    """
    if points.device.type == "cpu":
        T = carry[ep.T_SLICE].reshape(4, 4)
        corr = projective_correspond_at_pose_reference(
            points, mask, normals, packed, height, width, K, max_dist,
            normal_dot_min, T)
        if out is None:
            return corr
        for o, c in zip(out, corr):
            o.copy_(c)
        return out
    _build.require(carry, "carry", dtype=torch.float32,
                   shape=(ep.CARRY_SIZE,), device=points.device)
    return _launch("projective_correspond_at_pose", points, mask,
                   normals if normal_dot_min > 0.0 else None,
                   carry.data_ptr() + 4 * ep.T_SLICE.start, packed, height,
                   width, K, max_dist, normal_dot_min, carry, out)


def correspondence_buffers(n: int, device) -> Correspondence:
    """Output tensors for N points (`projective_correspond_at_pose`'s
    `out`)."""
    return Correspondence(
        q=torch.empty((n, 3), dtype=torch.float32, device=device),
        n=torch.empty((n, 3), dtype=torch.float32, device=device),
        w=torch.empty((n,), dtype=torch.float32, device=device),
        idx=torch.empty((n,), dtype=torch.int32, device=device))


def _launch(name, pts, mask, normals, pose_ptr, packed, height, width, K,
            max_dist, normal_dot_min, done, out=None) -> Correspondence:
    """Check the inputs and launch the kernel; `normals` None turns the
    normal gate off, `pose_ptr` None means `pts` is in the target frame,
    `out` None allocates the outputs."""
    if pts.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {pts.device}")
    dev = pts.device
    n_pts = pts.shape[0]
    _build.require(pts, "points", dtype=torch.float32, shape=(n_pts, 3),
                   device=dev)
    _build.require(mask, "mask", dtype=torch.bool, shape=(n_pts,), device=dev)
    _build.require(packed, "packed", dtype=torch.float16,
                   shape=(height * width, 8), device=dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    if normals is not None:
        _build.require(normals, "normals", dtype=torch.float32,
                       shape=(n_pts, 3), device=dev)
    if done is not None:
        _build.require(done, "done", dtype=torch.float32, device=dev)
    if out is None:
        out = correspondence_buffers(n_pts, dev)
    q, n, w, flat = out
    for t, dtype, shape in ((q, torch.float32, (n_pts, 3)),
                            (n, torch.float32, (n_pts, 3)),
                            (w, torch.float32, (n_pts,)),
                            (flat, torch.int32, (n_pts,))):
        _build.require(t, "out", dtype=dtype, shape=shape, device=dev)
    if n_pts == 0:
        return out
    lib = _build.library()
    err = lib.tpuslam_correspond(
        pts.data_ptr(), mask.data_ptr(),
        normals.data_ptr() if normals is not None else None, pose_ptr,
        packed.data_ptr(), n_pts, height, width, K.fx, K.fy, K.cx, K.cy,
        max_dist * max_dist, normal_dot_min, int(normals is not None),
        done.data_ptr() if done is not None else None,
        q.data_ptr(), n.data_ptr(), w.data_ptr(), flat.data_ptr(),
        _build.stream_handle(pts))
    _build.check_launch(err, "correspond")
    counter.launches += 1
    return out
