"""The warm start in one launch — `csrc/warm_start.cu`.

`frontend._track` starts a frame's ICP at T0 = T_kf_cam · exp(γ · log Δ):
the last inter-frame motion Δ, damped by γ (`SLAMConfig.cv_damping`),
applied to the last pose.  On a CUDA tensor the whole expression is one
launch of the hand kernel; on a CPU tensor the plain twin
`warm_start_reference` (`damped_velocity` and the product, op by op) runs
and counts `counter.plain()`.  γ = 0 (the identity) and γ = 1 (Δ itself)
need no logarithm: they take the product alone, on any device, and count
neither.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geom import se3
from tpuslam_torch.kernels import _build

counter = _build.LaunchCounter("warm_start")    # csrc/warm_start.cu


def damped_velocity(delta: torch.Tensor, gamma: float) -> torch.Tensor:
    """Scale an inter-frame motion twist for the warm start (see
    SLAMConfig.cv_damping for why γ < 1 is required for stability)."""
    if gamma == 0.0:
        return torch.eye(4, dtype=delta.dtype, device=delta.device)
    if gamma == 1.0:
        return delta
    return se3.exp(gamma * se3.log(delta))


def warm_start_reference(T_kf_cam: torch.Tensor, last_delta: torch.Tensor,
                         gamma: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, op by op."""
    counter.plain()
    return T_kf_cam @ damped_velocity(last_delta, gamma)


def warm_start(T_kf_cam: torch.Tensor, last_delta: torch.Tensor,
               gamma: float) -> torch.Tensor:
    """T_kf_cam · exp(γ · log last_delta), (4, 4): one kernel launch on a
    CUDA tensor, the twin on a CPU tensor, the product alone for γ ∈ {0,
    1}."""
    if gamma in (0.0, 1.0):
        return T_kf_cam @ damped_velocity(last_delta, gamma)
    if T_kf_cam.device.type == "cpu":
        return warm_start_reference(T_kf_cam, last_delta, gamma)
    return _launch(T_kf_cam, last_delta, gamma)


def _launch(T_kf_cam: torch.Tensor, last_delta: torch.Tensor,
            gamma: float) -> torch.Tensor:
    """Check the poses, allocate the output and launch."""
    _build.require(T_kf_cam, "T_kf_cam", dtype=torch.float32, shape=(4, 4))
    _build.require(last_delta, "last_delta", dtype=torch.float32,
                   shape=(4, 4), device=T_kf_cam.device)
    if T_kf_cam.device.type != "cuda":
        raise ValueError(f"warm_start: no kernel for {T_kf_cam.device}")
    out = torch.empty((4, 4), dtype=torch.float32, device=T_kf_cam.device)
    stream = _build.stream_handle(out)
    # γ as ctypes passes a float: its float32 rounding, as the twin's
    # product with a Python scalar rounds it
    err = _build.library().tpuslam_warm_start(
        T_kf_cam.data_ptr(), last_delta.data_ptr(), gamma, out.data_ptr(),
        stream)
    _build.check_launch(err, "warm_start")
    counter.launched(stream)
    return out
