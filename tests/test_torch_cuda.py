"""The port's hand CUDA kernels against their plain PyTorch twins, on the
card.  Every test here needs a CUDA GPU and nvcc: it is marked `cuda` and
skips without a GPU.  The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
from tpuslam_torch.frontend import preprocess, scan_odometry
from tpuslam_torch.geom import se3
from tpuslam_torch.icp import align_frames, pack_pyramid, select_level_source
from tpuslam_torch.kernels import correspond, gn_epilogue, gn_partials

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
ARGS = (1e-6, 1e-4, 0.3, 0.3)   # damping, damping_abs, max_trans, max_rot
CFG = SLAMConfig(
    height=H, width=W,
    icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                  max_corr_dist=0.25, huber_delta=0.05),
    keyframe=KeyframeConfig(max_translation=0.03, max_rotation=0.15))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand kernels have no CPU mode)")
    return torch.device("cuda:0")


def depths(n=12):
    poses = orbit_trajectory(n)
    return np.stack([render_depth(poses[i], K, H, W, seed=i)
                     for i in range(n)])


def random_points(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    q = (x + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    w = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return x, q, nn.astype(np.float32), w


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_correspond_kernel_bit_equal_to_twin(dev, level):
    d = torch.as_tensor(depths(4), device=dev)
    pyr_a, pyr_b = preprocess(d[0], K, CFG), preprocess(d[3], K, CFG)
    packed = pack_pyramid(pyr_a, CFG.icp)[level]
    src = select_level_source(pyr_b, level, CFG.icp)
    h, w, _ = pyr_b[level].points.shape
    T = se3.exp(torch.tensor([0.01, -0.01, 0.01, 0.01, 0.0, -0.01],
                             device=dev))
    args = (se3.transform_points(T, src.points), src.mask, packed, h, w,
            K.scaled(1.0 / 2 ** level), 0.25,
            se3.rotate_vectors(T, src.normals), 0.5)
    done = gn_epilogue.init_carry(T, 4)
    k = correspond.projective_correspond_packed(*args, done=done)
    r = correspond.projective_correspond_packed_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(k, r):
        assert torch.equal(a, b)
    assert 0.3 < float(k.w.mean()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 5000, 153600, 1_000_000])
def test_partials_kernel_matches_twin(dev, n):
    x, q, nn, w = (torch.as_tensor(a, device=dev) for a in random_points(n))
    pk = gn_partials.gn_reduce_partials(x, q, nn, w, 0.05)
    pr = gn_partials.gn_reduce_partials_reference(x, q, nn, w, 0.05)
    torch.cuda.synchronize()
    assert pk.shape == pr.shape == (gn_partials.num_blocks(n), 32)
    for a, b in zip(gn_partials.fold_partials(pk),
                    gn_partials.fold_partials(pr)):
        assert rel(a, b) <= 1e-4
    assert torch.equal(pk, gn_partials.gn_reduce_partials(x, q, nn, w, 0.05))
    done = gn_epilogue.init_carry(torch.eye(4, device=dev), 0)
    assert torch.all(gn_partials.gn_reduce_partials(x, q, nn, w, 0.05,
                                                    done=done) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "zero", "non_finite", "last",
                                  "done"])
def test_epilogue_kernel_matches_twin(dev, case):
    x, q, nn, w = (torch.as_tensor(a, device=dev)
                   for a in random_points(5000, seed=1))
    partials = gn_partials.gn_reduce_partials(x, q, nn, w, 0.05)
    if case == "zero":
        partials = torch.zeros_like(partials)
    if case == "non_finite":
        partials[0, 22] = float("inf")
    T = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.01, -0.02, 0.01],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 0 if case == "done" else 12)
    nvs = torch.tensor(5000.0, device=dev)
    args = (partials, carry, nvs, *ARGS, case != "plain", 2, 12, 1e-8)
    ck, sk = gn_epilogue.gn_epilogue(*args)
    cr, sr = gn_epilogue.gn_epilogue_reference(*args)
    torch.cuda.synchronize()
    st = gn_epilogue.STEP_T
    assert float((sk[st] - sr[st]).abs().max()) <= 1e-5
    assert torch.equal(torch.isfinite(ck), torch.isfinite(cr))
    fin = torch.isfinite(cr)
    assert float((ck[fin] - cr[fin]).abs().max()) <= 1e-3 * max(
        1.0, float(cr[fin].abs().max()))
    for i in (gn_epilogue.DONE, gn_epilogue.IT):
        assert float(ck[i]) == float(cr[i])
    if case == "done":
        assert torch.equal(ck, carry)


@pytest.mark.cuda
def test_align_frames_gpu_matches_cpu_twins(dev):
    d = depths(4)
    pa_c, pb_c = preprocess(torch.as_tensor(d[0]), K, CFG), preprocess(
        torch.as_tensor(d[3]), K, CFG)
    pa_g, pb_g = (tuple(type(f)(*(t.to(dev) for t in f)) for f in p)
                  for p in (pa_c, pb_c))
    rc = align_frames(pb_c, pa_c, K, torch.eye(4), CFG.icp)
    rg = align_frames(pb_g, pa_g, K, torch.eye(4, device=dev), CFG.icp)
    assert int(rg.iters) == int(rc.iters)
    assert bool(rg.converged) == bool(rc.converged)
    assert float((rg.T.cpu() - rc.T).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_scan_gpu_matches_cpu_twins_and_counts_launches(dev):
    d = depths(12)
    counters = (correspond.counter, gn_partials.counter, gn_epilogue.counter)
    pc, fc, ic = scan_odometry(torch.as_tensor(d), K, CFG)
    for c in counters:
        c.reset()
    pg, fg, ig = scan_odometry(torch.as_tensor(d, device=dev), K, CFG)
    torch.cuda.synchronize()
    assert all(c.launches > 0 and c.plain_calls == 0 for c in counters)
    assert torch.equal(fg.cpu(), fc)
    assert float((pg.cpu() - pc).abs().max()) <= 1e-4
    assert float((ig.cpu() - ic).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_uint16_divide_bit_equal_on_device(dev):
    d = depths(3)
    raw = np.round(d * CFG.depth_scale).astype(np.uint16)
    host = raw.astype(np.float32) / np.float32(CFG.depth_scale)
    for i in range(3):
        pu = preprocess(torch.as_tensor(raw[i], device=dev), K, CFG)
        ph = preprocess(torch.as_tensor(host[i], device=dev), K, CFG)
        for a, b in zip(pu, ph):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
