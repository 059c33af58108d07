"""Correspondence search — port of `tpuslam/kernels/correspond.py`.

Organized targets: `pack_organized_target` packs a keyframe level into one
(H·W, 8) float16 row table ``[q, n, mask·has_normal, 0]``.
`projective_correspond_at_pose` moves each source point (and normal) into
the target camera by the ICP loop carry's pose, projects it, rounds to a
pixel and gathers that one 16-byte row: the ICP loop's association, one
launch.  `projective_correspond_packed` is the reference-shaped call, on
points already in the target camera.  On a CUDA tensor both are the hand
kernel `csrc/correspond.cu`; on a CPU tensor they are the plain twins
`projective_correspond_at_pose_reference` and
`projective_correspond_packed_reference`, which have the same semantics
and rounding (q, n, flat and w are bit-equal on the card).

Unorganized targets (a voxel map, map-BA control points):
`build_grid_index` sorts the target by a packed 256³ cell key (a stable
sort) into one (M, 8) float32 row table ``[p, n, 0, 0]``.
`grid_correspond_at_pose` (posed, the ICP loop's association) and
`grid_hash_correspond` (the reference-shaped call, on points already in the
target's frame) probe the 27 cells around each query: a lookup of the
cell's run in the index's table of occupied cells (built with the index on
the card, `with_cell_table`), then up to 16 slots of the cell.  On a CUDA
tensor both are the hand kernel `csrc/grid_correspond.cu`; on a CPU tensor
the plain twins `grid_correspond_at_pose_reference` and
`grid_hash_correspond_reference`, which follow the reference's loop (q, n,
w and idx are bit-equal on the card) and need no table;
`cell_runs_reference` states what the table returns.
`brute_force_correspond` is the reference's O(N·M) oracle, plain PyTorch
on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import Intrinsics
from tpuslam_torch.geom.backproject import device_scalar, project
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.se3 import (
    rotate_vectors_ordered,
    transform_points_ordered,
)
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import gn_epilogue as ep

counter = _build.LaunchCounter("correspond")   # csrc/correspond.cu
grid_counter = _build.LaunchCounter("grid_correspond")  # csrc/grid_correspond.cu
table_counter = _build.LaunchCounter("grid_table")  # its table of occupied cells


class Correspondence(NamedTuple):
    q: torch.Tensor      # (N, 3) matched target points
    n: torch.Tensor      # (N, 3) matched target normals
    w: torch.Tensor      # (N,) validity weight in {0, 1}
    idx: torch.Tensor    # (N,) int32 index of the match in the target's
    #                      storage: flat pixel (projective), sorted row
    #                      (grid), target row (brute force)


def _copy_into(out: Correspondence | None,
               corr: Correspondence) -> Correspondence:
    """`corr`, or `corr` copied into `out` when one is given."""
    if out is None:
        return corr
    for o, c in zip(out, corr):
        o.copy_(c)
    return out


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
    counter.plain()
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
        return _copy_into(out, projective_correspond_at_pose_reference(
            points, mask, normals, packed, height, width, K, max_dist,
            normal_dot_min, T))
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
    stream = _build.stream_handle(pts)
    lib = _build.library()
    err = lib.tpuslam_correspond(
        pts.data_ptr(), mask.data_ptr(),
        normals.data_ptr() if normals is not None else None, pose_ptr,
        packed.data_ptr(), n_pts, height, width, K.fx, K.fy, K.cx, K.cy,
        max_dist * max_dist, normal_dot_min, int(normals is not None),
        done.data_ptr() if done is not None else None,
        q.data_ptr(), n.data_ptr(), w.data_ptr(), flat.data_ptr(), stream)
    _build.check_launch(err, "correspond")
    counter.launched(stream)
    return out


# ---------------------------------------------------------------------------
# Unorganized targets: brute force and the grid-hash probe.
# ---------------------------------------------------------------------------


def brute_force_correspond(x: torch.Tensor, x_mask: torch.Tensor,
                           dst: PointCloud, max_dist: float
                           ) -> Correspondence:
    """Exact NN via a full (N, M) distance matrix (the reference's test
    oracle; small clouds only).  Plain PyTorch on any device."""
    d2 = torch.sum((x[:, None, :] - dst.points[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(dst.mask[None, :], d2, float("inf"))
    j = torch.argmin(d2, dim=1)
    best = torch.gather(d2, 1, j[:, None])[:, 0]
    q = dst.points[j]
    n = dst.normals[j]
    has_normal = torch.sum(n * n, dim=-1) > 0.5
    valid = (x_mask & (best < max_dist * max_dist) & torch.isfinite(best)
             & has_normal)
    return Correspondence(q=q, n=n, w=valid.to(x.dtype),
                          idx=j.to(torch.int32))


_GRID_DIMS = 256          # per-axis cells; 8 bits each pack into an int32
_INVALID_KEY = torch.iinfo(torch.int32).max
CANDIDATES_PER_CELL = 16
_TABLE_HASH = 0x9E3779B1  # the table's multiplicative hash (top bits)
_TABLE_EMPTY = 0xFFFFFFFF  # an empty entry's key field (no key is −1)


class GridIndex(NamedTuple):
    """A target cloud sorted by packed cell key (the reference's
    `GridIndex`).  Each row holds a point and its normal in 32 bytes, so a
    candidate costs the kernel one memory sector.  On the card `table`
    holds the occupied cells' runs (`with_cell_table`); the CPU twins
    search the keys and leave it None."""

    keys: torch.Tensor     # (M,) int32 sorted packed cell keys
    rows: torch.Tensor     # (M, 8) float32 [p, n, 0, 0] in key order
    origin: torch.Tensor   # (3,) float32 grid anchor
    cell: float            # cell edge length (float32 in the arithmetic)
    table: torch.Tensor | None = None  # (cell_table_size(M),) int64

    @property
    def points(self) -> torch.Tensor:
        return self.rows[:, 0:3]

    @property
    def normals(self) -> torch.Tensor:
        return self.rows[:, 3:6]


def _cell_coords(points: torch.Tensor, origin: torch.Tensor,
                 cell: float) -> torch.Tensor:
    """floor((p − origin) / cell) as int32, by a true divide (a Python
    divisor is a reciprocal multiply on CUDA).  The float is clamped to
    [−2, 257] (NaN to −2) before the cast, whose result is undefined out of
    range: a clamped coordinate and its ±1 neighbours stay outside the
    grid, as the unclamped ones are."""
    c = torch.floor((points - origin) / device_scalar(cell, points))
    return torch.nan_to_num(c, nan=-2.0).clamp(-2.0, 257.0).to(torch.int32)


def _pack_keys(points: torch.Tensor, mask: torch.Tensor, cell: float,
               origin: torch.Tensor):
    """Quantize to the local 256³ grid anchored at `origin`; pack to int32
    (cx << 16 | cy << 8 | cz); rows outside the grid or masked out get
    `_INVALID_KEY`, so they sort last."""
    c = _cell_coords(points, origin, cell)
    ok = torch.all((c >= 0) & (c < _GRID_DIMS), dim=-1) & mask
    c = torch.clamp(c, 0, _GRID_DIMS - 1)
    key = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
    return torch.where(ok, key, _INVALID_KEY), c, ok


def build_grid_index(dst: PointCloud, cell: float,
                     origin: torch.Tensor | None = None) -> GridIndex:
    """Sort the target cloud by packed cell key.

    The sort is stable: points of one cell keep their input order, which
    decides which 16 of a crowded cell the probe scans (the reference's
    `lax.sort` keeps it too).  `origin` defaults to the centroid less half
    the grid's span, so the 256³ grid covers a room-scale cloud.
    """
    if origin is None:
        origin = dst.centroid() - float(0.5 * _GRID_DIMS * cell)
    origin = origin.to(torch.float32)
    keys, _, _ = _pack_keys(dst.points, dst.mask, cell, origin)
    order = torch.sort(keys, stable=True).indices
    pad = torch.zeros((dst.points.shape[0], 2), dtype=torch.float32,
                      device=dst.points.device)
    rows = torch.cat([dst.points, dst.normals, pad], dim=1)[order]
    return with_cell_table(GridIndex(
        keys=keys[order].contiguous(), rows=rows.contiguous(),
        origin=origin.contiguous(), cell=float(cell)))


def _build_grid_index_program(_state, dst, origin, *, cell: float):
    return (), build_grid_index(dst, cell, origin)


# one graph a (rows, cell, whether `origin` is given): the centroid, the key
# packing, the stable sort, the row gather and the table's launches
_BUILD_GRID_INDEX = graphs.Program("build_grid_index",
                                   _build_grid_index_program)


def build_grid_index_jit(dst: PointCloud, cell: float,
                         origin: torch.Tensor | None = None,
                         eager: bool = False) -> GridIndex:
    """`build_grid_index` as one CUDA graph on the card, unless `eager`.
    The cloud (and `origin`) are copied in at every call and the index
    (keys, rows, origin, table) is copied out, so a build after an insert
    sorts the map as it is now and no index is a buffer a later replay
    writes."""
    return _BUILD_GRID_INDEX.run(dst, origin, eager=eager, cell=float(cell))


def cell_table_size(m: int) -> int:
    """Entries of the table of an M-row index: a power of two ≥ 2M (at
    most half of it is filled) and ≥ 64."""
    return max(64, 1 << (2 * m - 1).bit_length())


def with_cell_table(index: GridIndex) -> GridIndex:
    """`index` with its table of occupied cells, built on the card by
    csrc/grid_correspond.cu (a fill, then one thread a sorted row: each
    run's first row inserts its key with (start << 5 | min(run, 16)) by
    atomicCAS into an open-addressing hash).  The probe reads a cell's run
    there in place of a search of the keys.  On the CPU `index` as it is:
    the plain twins search the keys.  Every index that reaches the probe
    on the card goes through here."""
    keys = index.keys
    if keys.device.type == "cpu":
        return index
    if keys.device.type != "cuda":
        raise ValueError(f"with_cell_table: no kernel for {keys.device}")
    m = keys.shape[0]
    _build.require(keys, "keys", dtype=torch.int32, shape=(m,))
    if m >= 1 << 27:
        raise ValueError(f"with_cell_table: {m} rows; a run's start takes "
                         "27 bits")
    size = cell_table_size(m)
    table = torch.empty(size, dtype=torch.int64, device=keys.device)
    stream = _build.stream_handle(keys)
    err = _build.library().tpuslam_grid_table(
        keys.data_ptr(), m, table.data_ptr(), size, stream)
    _build.check_launch(err, "grid_table")
    table_counter.launched(stream)
    return index._replace(table=table)


def cell_runs_reference(keys: torch.Tensor):
    """What the table returns, in plain PyTorch: (cell keys, start,
    count) of each distinct valid key of the sorted `keys`, its first row
    and min(run length, 16).  The probe scans exactly those rows of a
    cell (the reference's 16 slots less those of another key)."""
    valid = keys[keys != _INVALID_KEY]       # a prefix: invalid sorts last
    cells, runs = torch.unique_consecutive(valid, return_counts=True)
    start = torch.cumsum(runs, 0) - runs
    return cells, start, runs.clamp(max=CANDIDATES_PER_CELL)


def cell_table_lookup(table: torch.Tensor, keys: torch.Tensor):
    """(start, count) of each key in a table, by the kernel's probe rule
    in plain PyTorch: the slot is the top log2(size) bits of key ·
    0x9E3779B1 mod 2³², then the next slot until the key or an empty
    entry; a key the table lacks gives (0, 0)."""
    size = table.shape[0]
    bits = size.bit_length() - 1
    key = keys.to(torch.int64) & 0xFFFFFFFF
    h = ((key * _TABLE_HASH) & 0xFFFFFFFF) >> (32 - bits)
    start = torch.zeros_like(key)
    count = torch.zeros_like(key)
    open_ = torch.ones_like(key, dtype=torch.bool)
    for _ in range(size):
        e = table[h]
        k = e & 0xFFFFFFFF
        hit = open_ & (k == key)
        run = (e >> 32) & 0xFFFFFFFF
        start = torch.where(hit, run >> 5, start)
        count = torch.where(hit, run & 31, count)
        open_ &= ~hit & (k != _TABLE_EMPTY)
        if not bool(open_.any()):
            break
        h = (h + 1) & (size - 1)
    return start, count


def cell_table_entries(table: torch.Tensor):
    """(cell keys, start, count) of a table's filled entries in key
    order: the table's content, whatever its layout."""
    e = table[(table & 0xFFFFFFFF) != _TABLE_EMPTY]
    k = e & 0xFFFFFFFF
    order = torch.argsort(k)
    run = (e[order] >> 32) & 0xFFFFFFFF
    return k[order].to(torch.int32), run >> 5, run & 31


def grid_hash_correspond_reference(x: torch.Tensor, x_mask: torch.Tensor,
                                   index: GridIndex,
                                   max_dist: float) -> Correspondence:
    """Plain twin of the grid kernel: the reference's loop over the 27
    cells (dz innermost), each a searchsorted-left of the cell's key and
    16 slots clipped to the last row; the first of equal minima inside a
    cell, a strict `<` across cells.  d2 is ((dx² + dy²) + dz²), each step
    rounded, as the kernel computes it."""
    grid_counter.plain()
    kq = CANDIDATES_PER_CELL
    dev = x.device
    c = _cell_coords(x, index.origin, index.cell)
    best_d2 = torch.full(x.shape[:1], float("inf"), dtype=x.dtype,
                         device=dev)
    best_q = torch.zeros_like(x)
    best_n = torch.zeros_like(x)
    best_i = torch.zeros(x.shape[:1], dtype=torch.int32, device=dev)
    m = index.keys.shape[0]
    slots = torch.arange(kq, dtype=torch.int64, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = c + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                      device=dev)
                ok = torch.all((cc >= 0) & (cc < _GRID_DIMS), dim=-1)
                key = (cc[..., 0] << 16) | (cc[..., 1] << 8) | cc[..., 2]
                start = torch.searchsorted(index.keys, key)
                idx = torch.clamp(start[:, None] + slots[None, :], 0, m - 1)
                cand_ok = (index.keys[idx] == key[:, None]) & ok[:, None]
                cand = index.rows[idx]                        # (N, kq, 8)
                d = x[:, None, :] - cand[..., 0:3]
                d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                    + d[..., 2] * d[..., 2]
                d2 = torch.where(cand_ok, d2, float("inf"))
                jbest = torch.argmin(d2, dim=1, keepdim=True)
                dbest = torch.gather(d2, 1, jbest)[:, 0]
                rbest = torch.gather(
                    cand, 1, jbest[:, :, None].expand(-1, 1, 8))[:, 0]
                ibest = torch.gather(idx, 1, jbest)[:, 0]
                better = dbest < best_d2
                best_d2 = torch.where(better, dbest, best_d2)
                best_q = torch.where(better[:, None], rbest[:, 0:3], best_q)
                best_n = torch.where(better[:, None], rbest[:, 3:6], best_n)
                best_i = torch.where(better, ibest.to(torch.int32), best_i)
    has_normal = (best_n[:, 0] * best_n[:, 0] + best_n[:, 1] * best_n[:, 1]
                  + best_n[:, 2] * best_n[:, 2]) > 0.5
    valid = (x_mask & torch.isfinite(best_d2)
             & (best_d2 < max_dist * max_dist) & has_normal)
    return Correspondence(q=best_q, n=best_n, w=valid.to(x.dtype),
                          idx=best_i)


def grid_correspond_at_pose_reference(points: torch.Tensor,
                                      mask: torch.Tensor, index: GridIndex,
                                      max_dist: float, T: torch.Tensor
                                      ) -> Correspondence:
    """Plain twin of the posed kernel: the ordered transform (the kernel's
    rounding), then `grid_hash_correspond_reference`."""
    return grid_hash_correspond_reference(
        transform_points_ordered(T, points), mask, index, max_dist)


def grid_hash_correspond(x: torch.Tensor, x_mask: torch.Tensor,
                         index: GridIndex, max_dist: float) -> Correspondence:
    """Approximate NN of points already in the index's frame, by probing
    the 27 cells around each (the reference-shaped, pose-less call; map BA
    probes every keyframe point with one launch of it).

    Exact within `max_dist` where the index's cell ≥ `max_dist` and no
    cell holds more than 16 points; in a crowded cell only the first 16 in
    the index's order are scanned.
    """
    if x.device.type == "cpu":
        return grid_hash_correspond_reference(x, x_mask, index, max_dist)
    return _grid_launch("grid_hash_correspond", x, x_mask, None, index,
                        max_dist, None, None)


def grid_correspond_at_pose(points: torch.Tensor, mask: torch.Tensor,
                            index: GridIndex, max_dist: float,
                            carry: torch.Tensor,
                            out: Correspondence | None = None
                            ) -> Correspondence:
    """The grid ICP loop's association at the carry's pose, in one launch.

    Args:
      points: (N, 3) float32 source points in the source frame; the kernel
        applies the carry's pose T (x = R p + t, in registers, in
        `transform_points_ordered`'s order).
      mask: (N,) bool source validity.
      index: `build_grid_index` of the target.
      max_dist: Euclidean rejection radius.
      carry: (64,) float32 ICP loop carry (layout in kernels/gn_epilogue.py):
        the pose is read from its T and, once its DONE is set, the kernel
        reads and writes nothing.  The CPU twin ignores DONE.
      out: optional `correspondence_buffers(N)` to write into (and return).
    """
    if points.device.type == "cpu":
        T = carry[ep.T_SLICE].reshape(4, 4)
        return _copy_into(out, grid_correspond_at_pose_reference(
            points, mask, index, max_dist, T))
    _build.require(carry, "carry", dtype=torch.float32,
                   shape=(ep.CARRY_SIZE,), device=points.device)
    return _grid_launch("grid_correspond_at_pose", points, mask,
                        carry.data_ptr() + 4 * ep.T_SLICE.start, index,
                        max_dist, carry, out)


def _grid_launch(name, pts, mask, pose_ptr, index: GridIndex, max_dist,
                 done, out) -> Correspondence:
    """Check the inputs and launch the grid kernel; `pose_ptr` None means
    `pts` is in the index's frame, `out` None allocates the outputs."""
    if pts.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {pts.device}")
    dev = pts.device
    n_pts = pts.shape[0]
    m = index.keys.shape[0]
    _build.require(pts, "points", dtype=torch.float32, shape=(n_pts, 3),
                   device=dev)
    _build.require(mask, "mask", dtype=torch.bool, shape=(n_pts,), device=dev)
    _build.require(index.keys, "keys", dtype=torch.int32, shape=(m,),
                   device=dev)
    _build.require(index.rows, "rows", dtype=torch.float32, shape=(m, 8),
                   device=dev)
    _build.require(index.origin, "origin", dtype=torch.float32, shape=(3,),
                   device=dev)
    if index.rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned")
    if m < 1:
        raise ValueError("index: no rows")
    if index.table is None:
        raise ValueError(f"{name}: the index has no table of its cells "
                         "(build_grid_index or with_cell_table on the card)")
    size = cell_table_size(m)
    _build.require(index.table, "table", dtype=torch.int64, shape=(size,),
                   device=dev)
    if out is None:
        out = correspondence_buffers(n_pts, dev)
    q, n, w, idx = out
    for t, dtype, shape in ((q, torch.float32, (n_pts, 3)),
                            (n, torch.float32, (n_pts, 3)),
                            (w, torch.float32, (n_pts,)),
                            (idx, torch.int32, (n_pts,))):
        _build.require(t, "out", dtype=dtype, shape=shape, device=dev)
    if n_pts == 0:
        return out
    stream = _build.stream_handle(pts)
    err = _build.library().tpuslam_grid_correspond(
        pts.data_ptr(), mask.data_ptr(), pose_ptr, index.keys.data_ptr(),
        index.rows.data_ptr(), m, index.table.data_ptr(), size,
        index.origin.data_ptr(), index.cell,
        n_pts, max_dist * max_dist,
        done.data_ptr() if done is not None else None,
        q.data_ptr(), n.data_ptr(), w.data_ptr(), idx.data_ptr(), stream)
    _build.check_launch(err, "grid_correspond")
    grid_counter.launched(stream)
    return out
