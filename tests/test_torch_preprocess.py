"""The preprocessing kernel's host side on the CPU: the CPU path runs the
plain twin (and counts it), a tensor on another device never falls back to
it, and the numbers the wrapper hands the kernel (level shapes, float32
intrinsics and gates) are what the twin's ops compute with.  The kernel
itself against the twin, bit for bit, is in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from tpuslam_torch.config import ICPConfig, Intrinsics, SLAMConfig
from tpuslam_torch.frontend import preprocess as frontend_preprocess
from tpuslam_torch.geom.backproject import backproject, device_scalar
from tpuslam_torch.geom.normals import DEPTH_DISC, NORM_EPS, organized_normals
from tpuslam_torch.kernels import preprocess as pp

INTRINSICS = [Intrinsics.tum_fr1(), Intrinsics.tum_fr2(),
              Intrinsics.tum_fr3(), Intrinsics.tum_default(),
              Intrinsics(160.0, 160.0, 79.5, 59.5),
              Intrinsics(0.1 + 0.2, 1.0 / 3.0, 2.0 / 7.0, 1e-3)]
SIZES = [(480, 640), (479, 641), (61, 83), (3, 5), (1, 1)]


def cfg_with(levels=3, **kw):
    icp = ICPConfig(pyramid_levels=levels,
                    iters_per_level=(4,) * levels, **kw)
    return SLAMConfig(icp=icp)


def seeded_depth(h, w, seed=0):
    """Depth with holes, NaN, ±inf, out-of-range values and steps."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 4.0, size=(h, w)).astype(np.float32)
    d[:, w // 2:] += 0.5                       # a step over depth_disc
    d[rng.uniform(size=(h, w)) < 0.05] = 0.0
    d[rng.uniform(size=(h, w)) < 0.01] = np.nan
    d[rng.uniform(size=(h, w)) < 0.01] = np.inf
    d[rng.uniform(size=(h, w)) < 0.01] = -np.inf
    d[rng.uniform(size=(h, w)) < 0.01] = 12.0
    return torch.as_tensor(d)


def old_pipeline(depth, K, cfg):
    """The op sequence the twin keeps: decimate, backproject, normals."""
    d = depth.to(torch.float32)
    if depth.dtype == torch.uint16:
        d = d / device_scalar(cfg.depth_scale, d)
    out = []
    for li in range(cfg.icp.pyramid_levels):
        p, m = backproject(d, K.scaled(1.0 / 2 ** li), cfg.icp.depth_min,
                           cfg.icp.depth_max)
        n, nm = organized_normals(p, m)
        out.append((p, n, m & nm))
        d = d[::2, ::2]
    return out


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.uint16])
def test_cpu_path_runs_the_twin_and_counts_a_plain_call(dtype):
    K, cfg = INTRINSICS[4], cfg_with()
    d = seeded_depth(120, 160)
    if dtype == torch.uint16:
        d = torch.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
        d = torch.round(d.clamp(0, 13) * cfg.depth_scale).to(torch.int32)
    d = d.to(dtype)
    pp.counter.reset()
    pyr = frontend_preprocess(d, K, cfg)
    assert (pp.counter.plain_calls, pp.counter.launches) == (1, 0)
    assert len(pyr) == cfg.icp.pyramid_levels
    for f, (p, n, m) in zip(pyr, old_pipeline(d, K, cfg)):
        assert same_bits(f.points, p) and same_bits(f.normals, n)
        assert torch.equal(f.mask, m) and f.mask.dtype == torch.bool


def test_a_tensor_off_the_cpu_never_falls_back_to_the_twin():
    pp.counter.reset()
    with pytest.raises(ValueError, match="no kernel for meta"):
        pp.preprocess(torch.empty((8, 8), device="meta"), INTRINSICS[0],
                      cfg_with())
    assert (pp.counter.plain_calls, pp.counter.launches) == (0, 0)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_level_shapes_are_the_twins(h, w, levels):
    pyr = pp.preprocess_reference(seeded_depth(h, w), INTRINSICS[3],
                                  cfg_with(levels))
    assert pp.level_shapes(h, w, levels) == [
        tuple(f.mask.shape) for f in pyr]
    assert all(tuple(f.points.shape) == (*f.mask.shape, 3) for f in pyr)


@pytest.mark.parametrize("K", INTRINSICS)
def test_level_intrinsics_are_torchs_rounding(K):
    levels = 5
    got = pp.level_intrinsics(K, levels)
    assert got.dtype == np.float32 and got.shape == (levels, 4)
    u = torch.arange(9, dtype=torch.float32)
    for li in range(levels):
        k = K.scaled(1.0 / 2 ** li)
        want = [torch.tensor(v, dtype=torch.float32) for v in k]
        assert all(got[li, c] == want[c].item() for c in range(4))
        # and the twin's ops round their scalars so: u - cx, / fx
        assert torch.equal(u - k.cx, u - want[2])
        assert torch.equal(u / device_scalar(k.fx, u), u / want[0])


@pytest.mark.parametrize("cfg", [
    cfg_with(),
    cfg_with(depth_min=0.3, depth_max=7.7).replace(depth_scale=1000.0),
    cfg_with(depth_min=1.0 / 3.0, depth_max=2.0 / 3.0).replace(
        depth_scale=5000.0 / 3.0)])
def test_gate_constants_are_torchs_rounding(cfg):
    got = pp.gate_constants(cfg)
    scalars = (cfg.depth_scale, cfg.icp.depth_min, cfg.icp.depth_max,
               DEPTH_DISC, NORM_EPS)
    assert got.dtype == np.float32
    assert got.tolist() == [torch.tensor(v, dtype=torch.float32).item()
                            for v in scalars]
    # a comparison with a Python scalar compares with its float32 rounding
    x = torch.tensor(np.nextafter(got, np.float32(np.inf)))
    y = torch.tensor(got)
    for i, v in enumerate(scalars):
        assert bool(x[i] > v) and not bool(y[i] > v)
