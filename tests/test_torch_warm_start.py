"""The warm start's host side on the CPU: the CPU path runs the plain twin
(and counts it), the twin is `damped_velocity` and the product bit for
bit, γ ∈ {0, 1} launches nothing, a tensor on another device never falls
back to the twin, and the wrapper refuses what the kernel does not take.
The kernel itself against the twin is in tests/test_torch_cuda.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_warm_start_cases import random_cases, warm_start_cases

from tpuslam_torch import frontend
from tpuslam_torch.config import ICPConfig, Intrinsics, SLAMConfig
from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import warm_start as ws
from tpuslam_torch.kernels.warm_start import damped_velocity

CASES = {**warm_start_cases(), **random_cases(8)}
CSRC = Path(ws.__file__).resolve().parent.parent / "csrc"


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def as_tensors(case, device="cpu"):
    return tuple(torch.as_tensor(a, device=device) for a in case)


@pytest.mark.parametrize("gamma", [0.5, 0.25])
@pytest.mark.parametrize("name", list(CASES))
def test_cpu_path_runs_the_twin_and_counts_a_plain_call(name, gamma):
    T, D = as_tensors(CASES[name])
    ws.counter.reset()
    got = ws.warm_start(T, D, gamma)
    assert (ws.counter.plain_calls, ws.counter.launches) == (1, 0)
    assert got.shape == (4, 4) and got.dtype == torch.float32
    assert torch.isfinite(got).all(), name


@pytest.mark.parametrize("name", list(CASES))
def test_twin_is_the_damped_velocity_product_bit_for_bit(name):
    T, D = as_tensors(CASES[name])
    for gamma in (0.5, 0.25, 1.0 / 3.0):
        want = T @ damped_velocity(D, gamma)
        assert same_bits(ws.warm_start_reference(T, D, gamma), want)
        assert same_bits(ws.warm_start(T, D, gamma), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gamma_zero_and_one_launch_nothing(device):
    T, D = as_tensors(CASES["log exact, exp series"], device)
    ws.counter.reset()
    identity = ws.warm_start(T, D, 0.0)
    motion = ws.warm_start(T, D, 1.0)
    assert (ws.counter.plain_calls, ws.counter.launches) == (0, 0)
    assert identity.device.type == motion.device.type == device
    if device == "cpu":
        assert same_bits(identity, T @ torch.eye(4))
        assert same_bits(motion, T @ D)


def test_a_tensor_off_the_cpu_never_falls_back_to_the_twin():
    T, D = as_tensors(CASES["theta^2 above 0.0625"], "meta")
    ws.counter.reset()
    with pytest.raises(ValueError, match="no kernel for meta"):
        ws.warm_start(T, D, 0.5)
    assert (ws.counter.plain_calls, ws.counter.launches) == (0, 0)


@pytest.mark.parametrize("bad", ["float64 pose", "float64 motion", "(3, 4)",
                                 "(16,)", "transposed", "devices differ"])
def test_wrong_dtype_shape_or_layout_raises(bad):
    T, D = (torch.empty((4, 4), device="meta") for _ in range(2))
    error = ValueError
    if bad == "float64 pose":
        T, error = T.double(), TypeError
    elif bad == "float64 motion":
        D, error = D.double(), TypeError
    elif bad == "(3, 4)":
        T = torch.empty((3, 4), device="meta")
    elif bad == "(16,)":
        D = torch.empty(16, device="meta")
    elif bad == "transposed":
        T = torch.empty((4, 4), device="meta").t()
    else:
        D = torch.eye(4)
    ws.counter.reset()
    with pytest.raises(error):
        ws.warm_start(T, D, 0.5)
    assert (ws.counter.plain_calls, ws.counter.launches) == (0, 0)


def test_the_kernel_is_registered():
    assert "warm_start.cu" in _build.SOURCES
    assert _build._SIGNATURES["tpuslam_warm_start"] == [
        _build._P, _build._P, _build._F, _build._P, _build._P]
    from tpuslam_torch.bench.harness import kernel_counters

    assert kernel_counters()["warm_start"] is ws.counter
    assert ws.counter.name == "warm_start"


def test_the_source_notes_what_it_replaces_and_keeps_float32():
    text = (CSRC / "warm_start.cu").read_text()
    head = text[:4000]
    assert "Replaces no Pallas kernel" in head
    assert "tpuslam/frontend.py damped_velocity" in head
    assert "What bounds it on the H100" in head
    assert "What the design does about it" in head
    # full-precision float32: no fast intrinsics, no fast-math build
    assert not re.search(r"__(sinf|cosf|expf|logf|fdividef|powf)\b", text)
    assert "use_fast_math" not in " ".join(_build.COMPILE_FLAGS)


def test_one_twin_call_a_tracked_frame_on_the_cpu():
    """Every frame `scan_odometry` tracks (frame 0 too) starts from one
    warm start; at the configuration's γ = 0.5 that is one twin call."""
    K = Intrinsics(80.0, 80.0, 39.5, 29.5)
    cfg = SLAMConfig(height=60, width=80,
                     icp=ICPConfig(pyramid_levels=2, iters_per_level=(4, 4)))
    assert cfg.cv_damping == 0.5
    gt = orbit_trajectory(5)
    d = np.stack([render_depth(gt[i], K, 60, 80, seed=i) for i in range(5)])
    ws.counter.reset()
    poses, _, _ = frontend.scan_odometry(torch.as_tensor(d), K, cfg)
    assert (ws.counter.plain_calls, ws.counter.launches) == (5, 0)
    assert torch.isfinite(poses).all()
