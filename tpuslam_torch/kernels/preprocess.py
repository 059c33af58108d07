"""Depth preprocessing — the organized pyramid of one depth frame.

`preprocess` turns an (H, W) depth image into the pyramid [finest..coarsest]
of `Frame`s (points, normals, mask) that tracking and promotion consume.
On a CUDA tensor it is the hand kernel `csrc/preprocess.cu`: every level in
one launch, bit-equal to the plain twin's eager ops on the same tensors.
On a CPU tensor it is the plain twin `preprocess_reference`, the port of
the reference's `tpuslam/frontend.py` preprocess: decimate, backproject
each level with its scaled intrinsics, estimate organized normals.
`level_intrinsics` and `gate_constants` are the float32 numbers the kernel
is given: PyTorch's rounding of the Python scalars the twin computes with.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuslam_torch.config import Intrinsics, SLAMConfig
from tpuslam_torch.geom.backproject import backproject, device_scalar
from tpuslam_torch.geom.normals import DEPTH_DISC, NORM_EPS, organized_normals
from tpuslam_torch.icp import Frame
from tpuslam_torch.kernels import _build

counter = _build.LaunchCounter("preprocess")    # csrc/preprocess.cu

MAX_LEVELS = 16     # the kernel's table of levels
# the depth dtypes the kernel reads, by its code
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.uint16: 2,
           torch.float64: 3}


def decimate2(d: torch.Tensor) -> torch.Tensor:
    """Stride-2 decimation of an (H, W) plane (the reference's CPU path;
    its TPU one-hot matmul is bit-identical to this slice)."""
    return d[::2, ::2]


def preprocess_reference(depth: torch.Tensor, K: Intrinsics,
                         cfg: SLAMConfig):
    """Plain PyTorch twin of the kernel, op by op.

    The depth image is decimated first and each level backprojected with
    its own scaled intrinsics.  Input dtypes: float32 metres; uint16 raw
    counts, divided here by `cfg.depth_scale` with a true IEEE divide (a 0-d
    device tensor divisor — a Python-scalar divisor would become a multiply
    by the reciprocal on CUDA), so the result is bit-equal to host-divided
    float32 depth; float16 metres.
    """
    counter.plain()
    d = depth.to(torch.float32)
    if depth.dtype == torch.uint16:
        d = d / device_scalar(cfg.depth_scale, d)
    pyr = []
    for li in range(cfg.icp.pyramid_levels):
        pts, mask = backproject(d, K.scaled(1.0 / (2 ** li)),
                                depth_min=cfg.icp.depth_min,
                                depth_max=cfg.icp.depth_max)
        nrm, nmask = organized_normals(pts, mask)
        pyr.append(Frame(points=pts, normals=nrm, mask=mask & nmask))
        if li + 1 < cfg.icp.pyramid_levels:
            d = decimate2(d)
    return tuple(pyr)


def level_shapes(height: int, width: int, levels: int) -> list:
    """(H_l, W_l) of each level: H_l = ceil(H_{l-1} / 2), as `[::2]`."""
    out = []
    for _ in range(levels):
        out.append((height, width))
        height, width = (height + 1) // 2, (width + 1) // 2
    return out


def level_intrinsics(K: Intrinsics, levels: int) -> np.ndarray:
    """(levels, 4) float32 fx, fy, cx, cy of each level: `K.scaled(1/2^l)`
    in double, rounded to float32 as PyTorch rounds a Python scalar."""
    rows = [K.scaled(1.0 / (2 ** li)) for li in range(levels)]
    return np.array([[k.fx, k.fy, k.cx, k.cy] for k in rows],
                    dtype=np.float32)


def gate_constants(cfg: SLAMConfig) -> np.ndarray:
    """float32 [depth_scale, depth_min, depth_max, depth_disc, norm_eps]:
    the twin's scalars as its ops round them."""
    return np.array([cfg.depth_scale, cfg.icp.depth_min, cfg.icp.depth_max,
                     DEPTH_DISC, NORM_EPS], dtype=np.float32)


def preprocess(depth: torch.Tensor, K: Intrinsics, cfg: SLAMConfig):
    """depth (H, W) → organized pyramid [finest..coarsest] of Frames.

    Level l is ceil(H / 2^l) × ceil(W / 2^l): points (H_l, W_l, 3) float32
    camera-frame (zero where the depth gates fail), unit normals (H_l, W_l,
    3) float32 oriented toward the camera (zero where none is estimated)
    and the mask of pixels with both.  Depth dtypes: float32 or float16
    metres, uint16 counts of `cfg.depth_scale` a metre (float64 too).  One
    kernel launch on a CUDA tensor; the twin on a CPU tensor.
    """
    if depth.device.type == "cpu":
        return preprocess_reference(depth, K, cfg)
    return _launch(depth, K, cfg)


def _launch(depth: torch.Tensor, K: Intrinsics, cfg: SLAMConfig):
    """Check the input, allocate every level's outputs and launch."""
    if depth.device.type != "cuda":
        raise ValueError(f"preprocess: no kernel for {depth.device}")
    if depth.dim() != 2:
        raise ValueError(f"preprocess: depth of shape {tuple(depth.shape)}, "
                         "kernel takes (H, W)")
    code = _DTYPES.get(depth.dtype)
    if code is None:
        raise TypeError(f"preprocess: depth dtype {depth.dtype}, kernel "
                        f"takes {sorted(map(str, _DTYPES))}")
    levels = cfg.icp.pyramid_levels
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"preprocess: {levels} pyramid levels, kernel "
                         f"takes 1 to {MAX_LEVELS}")
    if max(depth.stride()) >= 2 ** 31:
        raise ValueError(f"preprocess: depth strides {depth.stride()} do "
                         "not fit the kernel's int")
    dev = depth.device
    h, w = depth.shape
    pyr = tuple(
        Frame(points=torch.empty((hl, wl, 3), dtype=torch.float32,
                                 device=dev),
              normals=torch.empty((hl, wl, 3), dtype=torch.float32,
                                  device=dev),
              mask=torch.empty((hl, wl), dtype=torch.bool, device=dev))
        for hl, wl in level_shapes(h, w, levels))
    # host arrays, read by the C entry point before it returns: each
    # level's intrinsics, then its points', normals' and masks' pointers
    intr = level_intrinsics(K, levels).ravel().tolist()
    host = [(ctypes.c_float * len(intr))(*intr)] + [
        (ctypes.c_void_p * levels)(*(t.data_ptr() for t in field))
        for field in zip(*pyr)]
    scale, dmin, dmax, disc, eps = gate_constants(cfg).tolist()
    stream = _build.stream_handle(depth)
    err = _build.library().tpuslam_preprocess(
        depth.data_ptr(), code, h, w, depth.stride(0), depth.stride(1),
        scale, dmin, dmax, disc, eps, levels,
        *(ctypes.addressof(a) for a in host), stream)
    _build.check_launch(err, "preprocess")
    counter.launched(stream)
    return pyr
