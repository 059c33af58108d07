"""The port's hand CUDA kernels against their plain PyTorch twins, on the
card.  Every test here needs a CUDA GPU and nvcc: it is marked `cuda` and
skips without a GPU.  The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=""
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpuslam_torch.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
from tpuslam_torch.frontend import preprocess, scan_odometry
from tpuslam_torch.geom import se3
from tpuslam_torch.icp import (
    align_frames,
    pack_pyramid,
    select_level_source,
)
from tpuslam_torch.kernels import (
    correspond,
    gn_epilogue,
    gn_fused,
    gn_partials,
    gn_step,
    ring_nn,
)

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
@pytest.mark.parametrize("rows", [1, 7, 264])
def test_epilogue_parallel_fold_matches_twin(dev, rows):
    """The 256-thread epilogue's fold (8 warps of contiguous rows, then
    warp order) over random partials: the sums it solves with (H, Σw·r²,
    Σvalid, Σw in the step) agree with the twin's fold."""
    rng = np.random.default_rng(rows)
    part = torch.as_tensor(rng.normal(size=(rows, 32)).astype(np.float32),
                           device=dev)
    part[:, 30:] = 0.0
    carry = gn_epilogue.init_carry(torch.eye(4, device=dev), 12)
    args = (part, carry, torch.tensor(100.0, device=dev), *ARGS, True, 2, 12,
            1e-8)
    ck, sk = gn_epilogue.gn_epilogue(*args)
    cr, sr = gn_epilogue.gn_epilogue_reference(*args)
    torch.cuda.synchronize()
    assert rel(sk[gn_epilogue.STEP_H], sr[gn_epilogue.STEP_H]) <= 1e-6
    for i in (gn_epilogue.STEP_WSQ, gn_epilogue.STEP_NINL,
              gn_epilogue.STEP_WSUM):
        assert abs(float(sk[i]) - float(sr[i])) <= 1e-5 * max(
            1.0, abs(float(sr[i])))
    # the fold is in a fixed order: a second launch gives the same bits
    # (the random sums make the carry's RMS NaN, so compare bytes)
    assert torch.equal(gn_epilogue.gn_epilogue(*args)[0].view(torch.int32),
                       ck.view(torch.int32))


VGA = SLAMConfig()


@functools.cache
def vga_pair():
    from tpuslam_torch.bench.harness import _render_sequence

    Kv, _, dv = _render_sequence(2, 480, 640)
    return Kv, dv


def vga_step_inputs(dev, level: int):
    """A 640×480 frame pair's source at `level`, its association at a pose
    T and the carry at T: what `_icp_loop` hands gn_step."""
    Kv, dv = vga_pair()
    d = torch.as_tensor(dv, device=dev)
    pyr_a, pyr_b = preprocess(d[0], Kv, VGA), preprocess(d[1], Kv, VGA)
    packed = pack_pyramid(pyr_a, VGA.icp)[level]
    src = select_level_source(pyr_b, level, VGA.icp)
    h, w, _ = pyr_b[level].points.shape
    T = se3.exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.006, 0.003],
                             device=dev))
    corr = correspond.projective_correspond_packed(
        se3.transform_points(T, src.points), src.mask, packed, h, w,
        Kv.scaled(1.0 / 2 ** level), VGA.icp.max_corr_dist,
        se3.rotate_vectors(T, src.normals), VGA.icp.normal_dot_min)
    nvs = torch.sum(src.mask.to(torch.float32))
    return (src.points.contiguous(), corr.q, corr.n, corr.w), nvs, T


def step_args(nvs, is_last=True):
    icp = VGA.icp
    return (nvs, icp.huber_delta, icp.damping, icp.damping_abs,
            icp.max_trans_step, icp.max_rot_step, is_last, icp.inner_steps,
            12, icp.tol_delta ** 2)


def assert_step_close(ck, cr):
    """T within 1e-5, H within 1e-6 of max |H|, Σvalid, it and DONE equal
    (the kernel and the twin sum the same terms in other orders)."""
    e = gn_epilogue
    assert float((ck[e.T_SLICE] - cr[e.T_SLICE]).abs().max()) <= 1e-5
    assert rel(ck[e.H_SLICE], cr[e.H_SLICE]) <= 1e-6
    for i in (e.NUM_INLIERS, e.IT, e.DONE):
        assert float(ck[i]) == float(cr[i])
    assert abs(float(ck[e.DELTA_SQ]) - float(cr[e.DELTA_SQ])) <= 1e-4 * abs(
        float(cr[e.DELTA_SQ])) + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("blocks", [132, 264])
def test_gn_step_kernel_matches_twin(dev, level, blocks):
    """At the three 640×480 levels and both grids; the carry is updated in
    place and the kernel's result is the same bits on every launch."""
    pts, nvs, T = vga_step_inputs(dev, level)
    carry0 = gn_epilogue.init_carry(T, 12)
    cr = gn_step.gn_step_reference(*pts, carry0, *step_args(nvs),
                                   blocks=blocks)
    ck = carry0.clone()
    out = gn_step.gn_step(*pts, ck, *step_args(nvs), blocks=blocks)
    torch.cuda.synchronize()
    assert out is ck
    assert_step_close(ck, cr)
    assert float(ck[gn_epilogue.NUM_INLIERS]) > 0.3 * float(nvs)
    mid = carry0.clone()
    gn_step.gn_step(*pts, mid, *step_args(nvs, is_last=False),
                    blocks=blocks)
    assert torch.equal(mid[gn_epilogue.T_SLICE], ck[gn_epilogue.T_SLICE])
    assert float(mid[gn_epilogue.IT]) == 0.0


@pytest.mark.cuda
def test_gn_step_repeated_launches_are_bit_identical(dev):
    """50 launches on fresh copies of one carry give the same bits: the
    ticket is back at 0 after every launch, so no launch folds early."""
    pts, nvs, T = vga_step_inputs(dev, 0)
    carry0 = gn_epilogue.init_carry(T, 12)
    outs = []
    for _ in range(50):
        c = carry0.clone()
        gn_step.gn_step(*pts, c, *step_args(nvs))
        outs.append(c)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    ticket, _ = gn_step.scratch(pts[0].device)
    assert int(ticket) == 0


@pytest.mark.cuda
def test_gn_step_done_writes_nothing(dev):
    pts, nvs, T = vga_step_inputs(dev, 1)
    carry = gn_epilogue.init_carry(T, 0)
    before = carry.clone()
    gn_step.gn_step(*pts, carry, *step_args(nvs))
    torch.cuda.synchronize()
    assert torch.equal(carry.view(torch.int32), before.view(torch.int32))
    ticket, _ = gn_step.scratch(pts[0].device)
    assert int(ticket) == 0


@pytest.mark.cuda
def test_gn_step_non_finite_sum(dev):
    """An infinite target point: H NaN, a zero step, the pose kept, δ² = 0
    and DONE set, as the twin (and the reference) do."""
    (p, q, n, w), nvs, T = vga_step_inputs(dev, 2)
    q = q.clone()
    q[int(torch.nonzero(w)[0])] = float("inf")
    carry0 = gn_epilogue.init_carry(T, 12)
    cr = gn_step.gn_step_reference(p, q, n, w, carry0, *step_args(nvs))
    ck = carry0.clone()
    gn_step.gn_step(p, q, n, w, ck, *step_args(nvs))
    torch.cuda.synchronize()
    e = gn_epilogue
    assert bool(torch.isnan(ck[e.H_SLICE]).all())
    assert bool(torch.isnan(cr[e.H_SLICE]).all())
    assert float(ck[e.DELTA_SQ]) == float(cr[e.DELTA_SQ]) == 0.0
    assert torch.equal(ck[e.T_SLICE], carry0[e.T_SLICE])
    assert float(ck[e.DONE]) == float(cr[e.DONE]) == 1.0


def fused_inputs(dev, level: int, case: str, first: bool):
    """A 120×160 frame pair's source at `level`, the target's table, and
    the fused step's carry (at T_res) and gate buffer (NaN on `is_first`,
    when the kernel must not read it; else T_gate's rows)."""
    d = torch.as_tensor(depths(4), device=dev)
    icp = dataclasses.replace(CFG.icp, packed_dtype="float32"
                              if case == "f32" else "float16")
    pyr_a, pyr_b = preprocess(d[0], K, CFG), preprocess(d[3], K, CFG)
    packed = pack_pyramid(pyr_a, icp)[level]
    src = select_level_source(pyr_b, level, icp)
    h, w, _ = pyr_b[level].points.shape
    T_gate = se3.exp(torch.tensor([0.01, -0.01, 0.01, 0.01, 0.0, -0.01],
                                  device=dev))
    T_res = T_gate if first else se3.exp(torch.tensor(
        [0.002, 0.0, -0.001, 0.001, -0.002, 0.0], device=dev)) @ T_gate
    gate = (torch.full((12,), float("nan"), device=dev) if first
            else T_gate[:3].reshape(12).clone())
    ndmin = -2.0 if case == "normal_gate_off" else 0.5
    args = (src.points.contiguous(), src.normals.contiguous(),
            src.mask.contiguous(), packed)
    geo = (K.scaled(1.0 / 2 ** level), w, h, 0.25, ndmin, 0.05,
           torch.sum(src.mask.to(torch.float32)), *ARGS)
    return args, geo, gn_epilogue.init_carry(T_res, 12), gate, T_gate


def fused_step(args, geo, carry, gate, first, is_last=True):
    return gn_fused.gn_fused_step(*args, carry, gate, first, *geo, is_last,
                                  2, 12, 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False],
                         ids=["is_first", "gate_ne_carry"])
@pytest.mark.parametrize("case", ["f16", "f32", "normal_gate_off"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_gn_fused_step_kernel_matches_twin(dev, level, case, first):
    """One fused solve against its twin: each block's Σvalid exact (the
    row index and w are bit-equal, and the twin's rows are in the kernel's
    grouping), the carry within gn_step's tolerances, the gate buffer
    bit-equal (on `is_first` the carry's T)."""
    args, geo, carry0, gate0, T_gate = fused_inputs(dev, level, case, first)
    ck, gk = carry0.clone(), gate0.clone()
    out = fused_step(args, geo, ck, gk, first)
    _, rows = gn_step.scratch(dev)
    nb = gn_step.num_blocks(args[0].shape[0])
    kernel_valid = rows[:nb, 28].clone()
    cr, gr = gn_fused.gn_fused_step_reference(*args, carry0, gate0, first,
                                              *geo, True, 2, 12, 1e-8)
    twin_rows = gn_fused.fused_rows(
        *args, T_gate[:3], carry0[gn_epilogue.T_SLICE].reshape(4, 4),
        *geo[:6], nb)
    torch.cuda.synchronize()
    assert out is ck
    assert torch.equal(kernel_valid, twin_rows[:, 28])
    assert_step_close(ck, cr)
    assert torch.equal(gk, gr)
    assert torch.equal(gk, T_gate[:3].reshape(12))
    assert float(ck[gn_epilogue.NUM_INLIERS]) > 0.3 * float(geo[6])


@pytest.mark.cuda
def test_gn_fused_step_repeated_launches_are_bit_identical(dev):
    """50 launches on fresh copies of one carry give the same bits; the
    ticket is back at 0."""
    args, geo, carry0, gate0, _ = fused_inputs(dev, 0, "f16", False)
    outs = []
    for _ in range(50):
        c = carry0.clone()
        fused_step(args, geo, c, gate0.clone(), False)
        outs.append(c)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    ticket, _ = gn_step.scratch(dev)
    assert int(ticket) == 0


@pytest.mark.cuda
def test_gn_fused_step_done_writes_nothing(dev):
    args, geo, carry, gate, _ = fused_inputs(dev, 1, "f16", True)
    carry = gn_epilogue.init_carry(carry[gn_epilogue.T_SLICE].reshape(4, 4), 0)
    gate.fill_(3.0)
    before = carry.clone(), gate.clone()
    for first in (True, False):
        fused_step(args, geo, carry, gate, first)
    torch.cuda.synchronize()
    assert torch.equal(carry.view(torch.int32), before[0].view(torch.int32))
    assert torch.equal(gate, before[1])
    ticket, _ = gn_step.scratch(dev)
    assert int(ticket) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5000, 16384, 153600])
def test_posed_partials_kernel_matches_twin(dev, n):
    """The ring ICP's reduction at the carry's pose: the folded sums within
    1e-4 of the twin's; the same bits as the reference-shaped call on the
    points moved in the kernel's order; zero rows after DONE.  16,384 is
    the ring's frame shard on one rank."""
    p, q, nn, w = (torch.as_tensor(a, device=dev)
                   for a in random_points(n, seed=3))
    T = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.01, -0.02, 0.01],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 12)
    ts = carry[gn_epilogue.T_SLICE]
    pk = gn_partials.gn_reduce_partials_at_pose(p, q, nn, w, ts, 0.05,
                                                done=carry)
    pr = gn_partials.gn_reduce_partials_at_pose_reference(p, q, nn, w, T,
                                                          0.05)
    pu = gn_partials.gn_reduce_partials(
        se3.transform_points_ordered(T, p), q, nn, w, 0.05)
    done = gn_epilogue.init_carry(T, 0)
    pd = gn_partials.gn_reduce_partials_at_pose(
        p, q, nn, w, done[gn_epilogue.T_SLICE], 0.05, done=done)
    torch.cuda.synchronize()
    for a, b in zip(gn_partials.fold_partials(pk),
                    gn_partials.fold_partials(pr)):
        assert rel(a, b) <= 1e-4
    assert torch.equal(pk, pu)
    assert torch.all(pd == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_align_frames_gpu_matches_cpu_twins(dev, fused):
    d = depths(4)
    icp = dataclasses.replace(CFG.icp, fused_gn=fused)
    pa_c, pb_c = preprocess(torch.as_tensor(d[0]), K, CFG), preprocess(
        torch.as_tensor(d[3]), K, CFG)
    pa_g, pb_g = (tuple(type(f)(*(t.to(dev) for t in f)) for f in p)
                  for p in (pa_c, pb_c))
    counter = gn_fused.counter if fused else gn_step.counter
    counter.reset()
    rc = align_frames(pb_c, pa_c, K, torch.eye(4), icp)
    rg = align_frames(pb_g, pa_g, K, torch.eye(4, device=dev), icp)
    assert counter.launches > 0
    assert int(rg.iters) == int(rc.iters)
    assert bool(rg.converged) == bool(rc.converged)
    assert float((rg.T.cpu() - rc.T).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_scan_gpu_matches_cpu_twins_and_counts_launches(dev):
    d = depths(12)
    counters = (correspond.counter, gn_step.counter)
    pc, fc, ic = scan_odometry(torch.as_tensor(d), K, CFG)
    for c in counters + (gn_partials.counter, gn_epilogue.counter):
        c.reset()
    pg, fg, ig = scan_odometry(torch.as_tensor(d, device=dev), K, CFG)
    torch.cuda.synchronize()
    assert all(c.launches > 0 and c.plain_calls == 0 for c in counters)
    # one association and two solves an outer iteration, ⌈12/2⌉ + ⌈8/2⌉ +
    # ⌈8/2⌉ = 14 outer iterations a tracked frame; the standalone
    # reduction and epilogue are the ring's
    assert gn_step.counter.launches == 2 * correspond.counter.launches
    assert correspond.counter.launches % 14 == 0
    assert gn_partials.counter.launches == gn_epilogue.counter.launches == 0
    assert torch.equal(fg.cpu(), fc)
    assert float((pg.cpu() - pc).abs().max()) <= 1e-4
    assert float((ig.cpu() - ic).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_slam_gpu_matches_cpu_twins(dev, fused):
    """SlamSystem on the 48-frame two-lap loop (boundary chunks, deferred
    backend): the card's kernels take the CPU twins' keyframe and closure
    decisions, and every kernel of the path launches."""
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.slam import SlamSystem

    cfg = SLAMConfig(
        height=H, width=W,
        icp=dataclasses.replace(CFG.icp, fused_gn=fused),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                                  lc_min_gap=3, lc_max_dist=0.6,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15))
    gt = loop_trajectory(48, cycles=2, radius=0.35)
    d = np.stack([render_depth(gt[i], K, H, W, seed=i)
                  for i in range(48)]).astype(np.float32)
    ts = np.arange(48) / 30.0

    def run(device):
        slam = SlamSystem(K, cfg, chunk_mode="boundary", async_backend=True,
                          device=device)
        dd = torch.as_tensor(d, device=device)
        for i in range(0, 48, 8):
            slam.process_chunk(dd[i:i + 8], ts[i:i + 8])
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes],
                [(c.i, c.j) for c in slam.closures], slam.trajectory()[1])

    kc, cc, ec = run("cpu")
    counters = ((gn_fused.counter,) if fused else
                (correspond.counter, gn_step.counter))
    for c in counters + (gn_partials.counter, gn_epilogue.counter):
        c.reset()
    kg, cg, eg = run(dev)
    assert all(c.launches > 0 and c.plain_calls == 0 for c in counters)
    # the standalone reduction and epilogue are the ring's alone
    assert gn_partials.counter.launches == gn_epilogue.counter.launches == 0
    assert kg == kc and cg == cc and len(cc) >= 1
    assert float(np.abs(eg - ec).max()) <= 1e-4


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (300, 1000), (513, 2049),
                                 (4096, 20_000)])
@pytest.mark.parametrize("case", ["half_valid", "all_invalid", "ties"])
def test_ring_nn_kernel_bit_equal_to_twin(dev, n, m, case):
    """One hop and two hops (a ring of two shards) on ragged shapes: the
    kernel's scores and rows equal the twin's bit for bit, a non-finite
    query keeps +inf and a zero row, and DONE leaves the best as it is."""
    rng = np.random.default_rng(n + m)
    q = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    if case == "ties":
        q = np.round(q * 4.0) / 4.0          # many exact duplicate rows
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) > (1.0 if case == "all_invalid" else 0.5)
    x = q[rng.integers(0, m, n)] + rng.normal(scale=0.01, size=(n, 3))
    x = x.astype(np.float32)
    if case == "ties":
        x = np.round(x * 4.0) / 4.0
    x[n // 2] = np.nan
    shard = ring_nn.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                    torch.as_tensor(valid))
    xt = torch.as_tensor(x)
    half = m // 2
    for parts in ((shard,), (shard[:half], shard[half:])):
        bc = ring_nn.init_best(n, "cpu")
        bg = ring_nn.init_best(n, dev)
        for p in parts:
            ring_nn.ring_nn_hop(xt, p.contiguous(), *bc)
            ring_nn.ring_nn_hop(xt.to(dev), p.contiguous().to(dev), *bg)
        assert torch.equal(bg[0].cpu(), bc[0])
        assert torch.equal(bg[1].cpu(), bc[1])
    assert float(bg[0][n // 2]) == float("inf") and not bool(bg[1][n // 2].any())
    hd = ring_nn.init_best(n, dev)
    ring_nn.ring_nn_hop(xt.to(dev), shard.to(dev), *hd,
                        done=torch.ones(1, device=dev))
    assert bool(torch.isinf(hd[0]).all()) and not bool(hd[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_map_tracking_gpu_matches_cpu_twins(dev, sharded):
    """SlamSystem(track_against_map=True) on a 16-frame loop: the card takes
    the CPU twins' keyframes and refinement gates, poses within 1e-4, and
    the sharded map's refinement launches ring_nn."""
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.slam import SlamSystem

    cfg = SLAMConfig(
        height=H, width=W, icp=CFG.icp,
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256),
        voxel=VoxelConfig(capacity=1 << 11, map_capacity=1 << 13),
        map_refine_min_inliers=100)
    gt = loop_trajectory(16, cycles=1, radius=0.35)
    d = np.stack([render_depth(gt[i], K, H, W, seed=i)
                  for i in range(16)]).astype(np.float32)

    def run(device):
        slam = SlamSystem(K, cfg, enable_loop_closure=False,
                          track_against_map=True, sharded_map=sharded,
                          device=device)
        dd = torch.as_tensor(d, device=device)
        for i in range(16):
            slam.process(dd[i], timestamp=i / 30.0)
        return ([r.index for r in slam.odo.keyframes],
                [s["ok"] for s in slam.map_refine_stats],
                slam.trajectory()[1])

    kc, oc, ec = run("cpu")
    ring_nn.counter.reset()
    kg, og, eg = run(dev)
    assert (ring_nn.counter.launches > 0) == sharded
    assert ring_nn.counter.plain_calls == 0
    assert kg == kc and og == oc and np.mean(oc) > 0.5
    assert float(np.abs(eg - ec).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_correspond_at_pose_bit_equal_to_twin(dev, level):
    """The posed association from the untransformed 640×480 source and the
    carry's pose: q, n, flat and w bit-equal to the twin (the transform in
    the kernel's order), at every level; nothing written after DONE."""
    Kv, dv = vga_pair()
    d = torch.as_tensor(dv, device=dev)
    pyr_a, pyr_b = preprocess(d[0], Kv, VGA), preprocess(d[1], Kv, VGA)
    packed = pack_pyramid(pyr_a, VGA.icp)[level]
    src = select_level_source(pyr_b, level, VGA.icp)
    h, w, _ = pyr_b[level].points.shape
    T = se3.exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.006, 0.003],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 12)
    pts, nrm = src.points.contiguous(), src.normals.contiguous()
    args = (pts, src.mask, nrm, packed, h, w, Kv.scaled(1.0 / 2 ** level),
            VGA.icp.max_corr_dist, VGA.icp.normal_dot_min)
    k = correspond.projective_correspond_at_pose(*args, carry)
    r = correspond.projective_correspond_at_pose_reference(*args, T)
    torch.cuda.synchronize()
    for a, b in zip(k, r):
        assert torch.equal(a, b)
    assert 0.3 < float(k.w.mean()) <= 1.0
    # into given buffers, and after DONE nothing is written
    out = correspond.correspondence_buffers(pts.shape[0], dev)
    for t in out:
        t.fill_(7)
    before = [t.clone() for t in out]
    res = correspond.projective_correspond_at_pose(
        *args, gn_epilogue.init_carry(T, 0), out=out)
    torch.cuda.synchronize()
    assert res is out
    assert all(torch.equal(a, b) for a, b in zip(out, before))
    correspond.projective_correspond_at_pose(*args, carry, out=out)
    assert all(torch.equal(a, b) for a, b in zip(out, k))


def ring_problem(n, m, case, seed=0):
    """Frame points, their mask and a packed shard: half the rows valid (or
    none), a NaN query, rounded coordinates for exact ties."""
    rng = np.random.default_rng(seed + n + m)
    q = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    if case == "ties":
        q = np.round(q * 4.0) / 4.0
    nrm = rng.normal(size=(m, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nrm[::7] = 0.0                           # rows without a normal
    valid = rng.uniform(size=m) > (1.0 if case == "all_invalid" else 0.5)
    p = q[rng.integers(0, m, n)] + rng.normal(scale=0.02, size=(n, 3))
    p = p.astype(np.float32)
    if case == "ties":
        p = np.round(p * 4.0) / 4.0
    p[n // 2] = np.nan
    mask = rng.uniform(size=n) > 0.1
    shard = ring_nn.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                    torch.as_tensor(valid))
    return torch.as_tensor(p), torch.as_tensor(mask), shard


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other has NaN (the NaN query's x)."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def ring_pose(device):
    return se3.exp(torch.tensor([0.01, -0.02, 0.015, 0.03, -0.01, 0.02],
                                device=device))


def run_ring(points, mask, parts, state, carry, max_dist=0.05,
             twin=False):
    """One ring correspondence over `parts` (hop s holds parts[s])."""
    for s, p in enumerate(parts):
        flags = (s == 0, s == len(parts) - 1, max_dist)
        if twin:
            ring_nn.ring_correspond_hop_reference(
                points, mask, p, state, carry[gn_epilogue.T_SLICE].reshape(
                    4, 4), *flags)
        else:
            ring_nn.ring_correspond_hop(points, mask, p, state, carry,
                                        *flags)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (300, 1000), (1025, 2049),
                                 (4096, 20_000)])
@pytest.mark.parametrize("case", ["half_valid", "all_invalid", "ties"])
def test_ring_correspond_hop_bit_equal_to_twin(dev, n, m, case):
    """The ring ICP's hop at the carry's pose on ragged shapes, as one hop
    and as a ring of four: score, row, x, q, n and w bit-equal to the twin;
    four hops over four shards equal one; the tickets are back at zero."""
    p, mask, shard = ring_problem(n, m, case)
    carry = gn_epilogue.init_carry(ring_pose(dev), 12)
    pg, mg, sg = p.to(dev), mask.to(dev), shard.to(dev)
    quarter = -(-m // 4)
    results = []
    for parts in ((sg,), tuple(sg[i:i + quarter].contiguous()
                               for i in range(0, m, quarter))):
        sk = ring_nn.ring_state(n, dev)
        st = ring_nn.ring_state(n, dev)
        run_ring(pg, mg, parts, sk, carry)
        run_ring(pg, mg, parts, st, carry, twin=True)
        torch.cuda.synchronize()
        for a, b in zip(sk, st):
            assert same_bits(a, b)
        results.append(sk)
    for a, b in zip(*results):
        assert same_bits(a, b)
    one = results[0]
    assert float(one.score[n // 2]) == float("inf")
    assert not bool(one.row[n // 2].any()) and float(one.w[n // 2]) == 0.0
    if case == "all_invalid":
        assert not bool(one.w.any()) and not bool(one.row[:, 6].any())
    tickets, _ = ring_nn._scratch(dev, 1, 1)
    assert not bool(tickets.any())


@pytest.mark.cuda
def test_ring_correspond_hop_done_writes_nothing(dev):
    p, mask, shard = ring_problem(2000, 5000, "half_valid")
    carry = gn_epilogue.init_carry(ring_pose(dev), 0)        # DONE
    state = ring_nn.ring_state(2000, dev)
    for t in state:
        t.fill_(3.0)
    before = [t.clone() for t in state]
    run_ring(p.to(dev), mask.to(dev), (shard.to(dev),), state, carry)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    tickets, _ = ring_nn._scratch(dev, 1, 1)
    assert not bool(tickets.any())


@pytest.mark.cuda
def test_prefetch_to_device_keeps_uint16(dev):
    from tpuslam_torch.data.tum import TumFrame
    from tpuslam_torch.frontend import prefetch_to_device

    raw = np.round(depths(3) * CFG.depth_scale).astype(np.uint16)
    frames = [TumFrame(timestamp=i / 30.0, depth=raw[i], gt_pose=None)
              for i in range(3)]
    out = list(prefetch_to_device(frames, lookahead=2, device=dev))
    for f, r in zip(out, raw):
        assert f.depth.device == dev and f.depth.dtype == torch.uint16
        assert np.array_equal(f.depth.cpu().numpy(), r)
    # preprocess divides on the device: bit-equal to host-divided float32
    host = raw[0].astype(np.float32) / np.float32(CFG.depth_scale)
    pu = preprocess(out[0].depth, K, CFG)
    pf = preprocess(torch.as_tensor(host, device=dev), K, CFG)
    assert all(torch.equal(u, v) for a, b in zip(pu, pf) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("save_on", ["cuda", "cpu"])
def test_checkpoint_moves_between_card_and_cpu(dev, tmp_path, save_on):
    """A SlamSystem checkpoint saved on one device resumes on the other:
    the same keyframes, tables and graph, and the continued run's poses
    within the GPU-vs-twin tolerance of the saver's own continuation."""
    from tpuslam_torch.slam import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    d = depths(16)
    load_on = "cpu" if save_on == "cuda" else dev
    save_dev = dev if save_on == "cuda" else "cpu"

    def new(device):
        return SlamSystem(K, CFG, chunk_mode="boundary", async_backend=True,
                          device=device)

    def feed(slam, lo, hi):
        x = torch.as_tensor(d[lo:hi], device=slam.device)
        slam.process_chunk(x, np.arange(lo, hi) / 30.0)
        return slam

    a = feed(new(save_dev), 0, 8)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a, a.odo.frame_idx)
    b = new(load_on)
    assert load_checkpoint(path, b) == 8
    for ra, rb in zip(a.odo.keyframes, b.odo.keyframes):
        assert rb.verify.packed.device == b.device
        assert rb.verify.packed.dtype == torch.float16
        assert torch.equal(ra.verify.packed.cpu(), rb.verify.packed.cpu())
        assert all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(ra.cloud, rb.cloud))
    feed(a, 8, 16).finalize()
    feed(b, 8, 16).finalize()
    assert ([r.index for r in a.odo.keyframes]
            == [r.index for r in b.odo.keyframes])
    np.testing.assert_allclose(a.trajectory()[1], b.trajectory()[1],
                               atol=1e-4)


def grid_target(m, seed=0):
    """Two 2 m planes of m points (cells of 0.25 m hold ~m/128: > 16 at
    the map's sizes), a tenth masked out, an eighth duplicates (ties), a
    few rows far outside the grid."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (m // 2, 2))
    b = rng.uniform(-1.0, 1.0, (m - m // 2, 2))
    pts = np.concatenate([np.c_[a, np.zeros(m // 2)],
                          np.c_[np.ones(m - m // 2), b]]).astype(np.float32)
    nrm = np.zeros_like(pts)
    nrm[: m // 2, 2] = 1.0
    nrm[m // 2:, 0] = -1.0
    dup = m // 8
    if dup:
        pts[-dup:] = pts[rng.integers(0, m - dup, dup)]
    pts[:5] += 200.0
    return pts, nrm, rng.uniform(size=m) > 0.1


def grid_queries(pts, n, seed=1):
    rng = np.random.default_rng(seed)
    x = (pts[rng.integers(0, pts.shape[0], n)]
         + rng.normal(scale=0.06, size=(n, 3))).astype(np.float32)
    x[:3] += 500.0                     # outside the grid
    x[3] = np.nan
    return x, rng.uniform(size=n) > 0.05


def grid_faces_target(m, seed=0):
    """m points in cells 0-1 and 254-255 of each axis of a 256³ grid at
    the origin (cell 0.25): the grid's faces and corners."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.5, (m // 2, 3))
    hi = rng.uniform(63.5, 64.0, (m - m // 2, 3))
    pts = np.concatenate([lo, hi]).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (m, 1))
    return pts, nrm, rng.uniform(size=m) > 0.1


def grid_last_row_target(m, seed=0):
    """m − 20 points of the planes, no row masked or outside the grid, and
    20 points within 0.05 m of (1.6, 1.6, 1.6), beyond them: with the
    origin at −32 a crowded cell ([1.5, 1.75)³) whose run ends at the last
    row."""
    pts, nrm, _ = grid_target(m - 20, seed)
    pts[:5] -= 200.0
    rng = np.random.default_rng(seed + 1)
    crowd = (1.6 + rng.uniform(-0.05, 0.05, (20, 3))).astype(np.float32)
    return (np.concatenate([pts, crowd]),
            np.concatenate([nrm, np.tile(nrm[:1], (20, 1))]), np.ones(m, bool))


def voxel_order(x):
    """x's rows in the order voxel_downsample leaves a frame cloud (its
    voxel key)."""
    from tpuslam_torch.config import VoxelConfig
    from tpuslam_torch.geom.voxel import voxel_keys

    vc = VoxelConfig()
    t = torch.as_tensor(x)
    hi, lo, _ = voxel_keys(t, torch.ones(t.shape[0], dtype=torch.bool),
                           vc.voxel_size, vc.origin, vc.extent)
    return torch.sort(hi.long() * 2 ** 31 + lo.long(), stable=True).indices


GRID_CASES = [
    pytest.param(1, 1, "random", id="1-1"),
    pytest.param(300, 1000, "random", id="300-1000"),
    pytest.param(16384, 131072, "random", id="16384-131072"),
    pytest.param(4096, 8192, "faces", id="faces"),
    pytest.param(2048, 4096, "last-row", id="last-row"),
    pytest.param(16384, 131072, "voxel-order", id="voxel-order"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("posed", [True, False], ids=["posed", "pose-less"])
@pytest.mark.parametrize("n,m,kind", GRID_CASES)
def test_grid_correspond_bit_equal_to_twin(dev, n, m, kind, posed):
    """The 27-cell probe: q, n, w and idx bit-equal to the twin on the same
    device, posed (the carry's T, the transform in the kernel's order) and
    pose-less; a query outside the grid or NaN matches nothing.  Also on
    the grid's faces (cells 0 and 255, queries beyond them), a crowded cell
    whose run ends at the last row, and queries in voxel-key order."""
    from tpuslam_torch.geom.cloud import PointCloud

    origin = None
    if kind == "faces":
        pts, nrm, mask = grid_faces_target(m)
        origin = torch.zeros(3, device=dev)
    elif kind == "last-row":
        pts, nrm, mask = grid_last_row_target(m)
        origin = torch.full((3,), -32.0, device=dev)
    else:
        pts, nrm, mask = grid_target(max(m, 8))
        pts, nrm, mask = pts[:m], nrm[:m], mask[:m]
    index = correspond.build_grid_index(
        PointCloud(*(torch.as_tensor(a, device=dev) for a in (pts, nrm,
                                                             mask))), 0.25,
        origin=origin)
    if kind == "last-row":
        keys = index.keys.cpu()
        assert int((keys == keys[-1]).sum()) == 20
    src = pts[-20:] if kind == "last-row" else np.concatenate([pts, pts])
    x, xm = grid_queries(src, max(n, 4))
    x, xm = x[:n], xm[:n]
    if kind == "voxel-order":
        order = voxel_order(x).numpy()
        x, xm = x[order], xm[order]
    x, xm = (torch.as_tensor(a, device=dev) for a in (x, xm))
    T = se3.exp(torch.tensor([0.01, -0.02, 0.015, 0.02, -0.01, 0.03],
                             device=dev))
    if posed and kind == "faces":
        # 64 m from the origin T moves a point by ~2 m: start the queries
        # at T⁻¹ so that the pose brings them back onto the faces
        x = se3.transform_points(se3.inv(T), x).contiguous()
    correspond.grid_counter.reset()
    if posed:
        ck = correspond.grid_correspond_at_pose(
            x, xm, index, 0.2, gn_epilogue.init_carry(T, 10))
        cr = correspond.grid_correspond_at_pose_reference(x, xm, index, 0.2,
                                                          T)
    else:
        ck = correspond.grid_hash_correspond(x, xm, index, 0.2)
        cr = correspond.grid_hash_correspond_reference(x, xm, index, 0.2)
    torch.cuda.synchronize()
    assert correspond.grid_counter.launches == 1
    for a, b in zip(ck, cr):
        assert torch.equal(a, b)
    if n >= 4 and kind != "voxel-order":
        assert not bool(ck.w[:4].any()) and not bool(ck.idx[:4].any())
        assert bool(torch.isfinite(ck.q).all())
    if n > 1000:
        assert 0.5 < float(ck.w.mean()) < 1.0
    if kind == "last-row":
        # the crowded cell's first 16 rows are the only candidates
        assert bool(((ck.idx[4:] >= m - 20) & (ck.idx[4:] < m - 4)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["131072", "masked", "one"])
def test_grid_table_on_card_equals_runs(dev, kind):
    """The index's table, read back: its entries are cell_runs_reference's
    (key, start, count), and the host copy of the probe rule finds every
    valid key and misses absent ones, at 131,072 rows, with every row
    masked, and at M = 1."""
    from tpuslam_torch.geom.cloud import PointCloud

    pts, nrm, mask = grid_target(131072)
    if kind == "masked":
        mask = np.zeros_like(mask)
    elif kind == "one":
        pts, nrm, mask = pts[5:6], nrm[5:6], np.ones(1, bool)
    correspond.table_counter.reset()
    index = correspond.build_grid_index(
        PointCloud(*(torch.as_tensor(a, device=dev) for a in (pts, nrm,
                                                             mask))), 0.25,
        origin=torch.full((3,), -32.0, device=dev))
    assert correspond.table_counter.launches == 1
    table = index.table.cpu()
    assert table.dtype == torch.int64
    assert table.shape[0] == correspond.cell_table_size(pts.shape[0])
    cells, start, count = (t.cpu().long() for t in
                           correspond.cell_runs_reference(index.keys))
    assert cells.numel() == {"masked": 0, "one": 1}.get(kind, cells.numel())
    got = correspond.cell_table_entries(table)
    for a, b in zip(got, (cells, start, count)):
        assert torch.equal(a.long(), b)
    s, c = correspond.cell_table_lookup(table, cells)
    assert torch.equal(s, start) and torch.equal(c, count)
    near = torch.unique(torch.cat([cells + d for d in (1, -1, 256, -256)]
                                  + [torch.tensor([0, 1 << 24])]))
    absent = near[~torch.isin(near, cells)]
    s, c = correspond.cell_table_lookup(table, absent)
    assert not bool(c.any()) and not bool(s.any())


@pytest.mark.cuda
def test_grid_index_without_table_raises(dev):
    """No fallback: the card's probe needs the table."""
    from tpuslam_torch.geom.cloud import PointCloud

    pts, nrm, mask = grid_target(4096)
    index = correspond.build_grid_index(
        PointCloud(*(torch.as_tensor(a, device=dev) for a in (pts, nrm,
                                                             mask))), 0.25)
    bare = index._replace(table=None)
    x, xm = (torch.as_tensor(a, device=dev) for a in grid_queries(pts, 64))
    correspond.grid_counter.reset()
    with pytest.raises(ValueError, match="table"):
        correspond.grid_hash_correspond(x, xm, bare, 0.2)
    with pytest.raises(ValueError, match="table"):
        correspond.grid_correspond_at_pose(
            x, xm, bare, 0.2, gn_epilogue.init_carry(torch.eye(4, device=dev),
                                                     10))
    assert correspond.grid_counter.launches == 0
    assert correspond.grid_counter.plain_calls == 0


@pytest.mark.cuda
def test_grid_correspond_done_writes_nothing(dev):
    from tpuslam_torch.geom.cloud import PointCloud

    pts, nrm, mask = grid_target(4096)
    index = correspond.build_grid_index(
        PointCloud(*(torch.as_tensor(a, device=dev) for a in (pts, nrm,
                                                             mask))), 0.25)
    x, xm = (torch.as_tensor(a, device=dev) for a in grid_queries(pts, 512))
    out = correspond.correspondence_buffers(512, dev)
    for t in out:
        t.fill_(7)
    correspond.grid_correspond_at_pose(
        x, xm, index, 0.2, gn_epilogue.init_carry(torch.eye(4, device=dev),
                                                  0), out=out)
    torch.cuda.synchronize()
    assert all(bool((t == 7).all()) for t in out)


@pytest.mark.cuda
def test_grid_index_on_card_equals_cpu(dev):
    """The stable sort on the card gives the CPU's keys and rows bit for
    bit (the origin given; from the centroid within 1e-5)."""
    from tpuslam_torch.geom.cloud import PointCloud

    pts, nrm, mask = grid_target(131072)
    cpu = PointCloud(*(torch.as_tensor(a) for a in (pts, nrm, mask)))
    ic = correspond.build_grid_index(cpu, 0.25)
    ig = correspond.build_grid_index(
        PointCloud(*(t.to(dev) for t in cpu)), 0.25,
        origin=ic.origin.to(dev))
    assert torch.equal(ig.keys.cpu(), ic.keys)
    assert torch.equal(ig.rows.cpu(), ic.rows)
    og = correspond.build_grid_index(PointCloud(*(t.to(dev) for t in cpu)),
                                     0.25).origin
    assert float((og.cpu() - ic.origin).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "brute"])
def test_align_clouds_gpu_matches_cpu_twins(dev, use_grid):
    from tpuslam_torch.data.synthetic import default_scene, sample_cloud
    from tpuslam_torch.geom.cloud import PointCloud
    from tpuslam_torch.icp import align_clouds

    n = 4096 if use_grid else 1536
    dst_p, dst_n = sample_cloud(default_scene(), n, seed=0)
    src_p, src_n = sample_cloud(default_scene(), n, seed=1)
    T_true = se3.exp(torch.tensor([0.04, -0.03, 0.05, 0.02, -0.03, 0.025]))
    src = PointCloud.from_points(torch.as_tensor(src_p),
                                 torch.as_tensor(src_n)).transform(
        se3.inv(T_true))
    dst = PointCloud.from_points(torch.as_tensor(dst_p),
                                 torch.as_tensor(dst_n))
    cfg = ICPConfig(max_iters=30, max_corr_dist=0.3, huber_delta=0.1)
    rc = align_clouds(src, dst, torch.eye(4), cfg, use_grid=use_grid)
    correspond.grid_counter.reset()
    rg = align_clouds(PointCloud(*(t.to(dev) for t in src)),
                      PointCloud(*(t.to(dev) for t in dst)),
                      torch.eye(4, device=dev), cfg, use_grid=use_grid)
    assert (correspond.grid_counter.launches > 0) == use_grid
    assert correspond.grid_counter.plain_calls == 0
    assert int(rg.iters) == int(rc.iters)
    assert bool(rg.converged) == bool(rc.converged)
    assert float((rg.T.cpu() - rc.T).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_map_ba_gpu_matches_cpu_on_the_same_inputs(dev):
    """build_map_ba_problem (one pose-less probe launch) and optimize_map_ba
    on the card against the CPU twins on the same inputs."""
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.backend.posegraph import GraphHost
    from tpuslam_torch.config import PoseGraphConfig

    rng = np.random.default_rng(4)
    pts, nrm, mask = grid_target(3000)
    N, C = 6, 512
    poses, kf_pts = [], []
    for _ in range(N):
        T = se3.exp(torch.as_tensor(0.1 * rng.normal(size=6),
                                    dtype=torch.float32)).numpy()
        Ti = np.linalg.inv(T.astype(np.float64))
        pw = pts[rng.integers(5, 3000, C)] + 0.01 * rng.normal(size=(C, 3))
        poses.append(T)
        kf_pts.append(pw @ Ti[:3, :3].T + Ti[:3, 3])
    args = [np.stack(poses).astype(np.float32),
            np.stack(kf_pts).astype(np.float32),
            rng.uniform(size=(N, C)) > 0.05, pts, nrm, mask]
    cfg = PoseGraphConfig(max_nodes=8, max_edges=16, gn_iters=10)

    def run(device):
        g = GraphHost(cfg, device=device)
        for T in args[0]:
            g.add_node(T)
        for i in range(1, N):
            g.add_edge(i - 1, i, np.linalg.inv(args[0][i - 1]) @ args[0][i],
                       weight=1.0)
        prob = map_ba.build_map_ba_problem(
            *(torch.as_tensor(a, device=device) for a in args), max_dist=0.1)
        return prob, map_ba.optimize_map_ba(g.graph(), prob, cfg)

    pc_, (tc, mc, cc) = run("cpu")
    correspond.grid_counter.reset()
    pg, (tg, mg, cg) = run(dev)
    assert correspond.grid_counter.launches == 1
    same = ((pg.obs_map.cpu() == pc_.obs_map) & (pg.obs_w.cpu() == pc_.obs_w))
    assert float(same.float().mean()) >= 0.999
    np.testing.assert_allclose(float(cg), float(cc), rtol=1e-4)
    assert float((tg.cpu() - tc).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_grid_map_tracking_and_map_ba_gpu_matches_cpu_twins(dev):
    """SlamSystem(track_against_map=True, map_track_mode="grid",
    map_ba=True) on a 16-frame loop at 0.1 m map voxels (the probe exact,
    tests/test_torch_grid.py): the card takes the CPU twins' keyframes and
    gates, the same control points, observations within 1%, poses within
    1e-3, and launches grid_correspond, no twin."""
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.slam import SlamSystem

    cfg = SLAMConfig(
        height=H, width=W, icp=CFG.icp,
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256),
        voxel=VoxelConfig(capacity=1 << 11, map_capacity=1 << 13,
                          map_voxel_size=0.1),
        map_refine_min_inliers=100)
    gt = loop_trajectory(16, cycles=1, radius=0.35)
    d = np.stack([render_depth(gt[i], K, H, W, seed=i)
                  for i in range(16)]).astype(np.float32)

    def run(device):
        slam = SlamSystem(K, cfg, enable_loop_closure=False,
                          track_against_map=True, map_track_mode="grid",
                          map_ba=True, device=device)
        dd = torch.as_tensor(d, device=device)
        for i in range(16):
            slam.process(dd[i], timestamp=i / 30.0)
        slam.finalize()
        return ([r.index for r in slam.odo.keyframes],
                [s["ok"] for s in slam.map_refine_stats],
                slam.trajectory()[1], slam.map_ba_stats)

    kc, oc, ec, sc = run("cpu")
    correspond.grid_counter.reset()
    kg, og, eg, sg = run(dev)
    assert correspond.grid_counter.launches > 0
    assert correspond.grid_counter.plain_calls == 0
    assert kg == kc and og == oc and np.mean(oc) > 0.5
    assert sg["num_control"] == sc["num_control"]
    assert abs(sg["num_obs"] - sc["num_obs"]) <= 0.01 * sc["num_obs"]
    assert float(np.abs(eg - ec).max()) <= 1e-3


def drift_cfg(verify_level=1):
    """tests/test_descriptor_lc.py's config: descriptor proposal on,
    lc_max_dist far below the injected drift."""
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig

    return SLAMConfig(
        height=H, width=W,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8)),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12,
                                verify_level=verify_level),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=20,
                                  lc_min_gap=3, lc_max_dist=0.02,
                                  lc_max_residual=0.05, lc_min_inliers=0.3,
                                  lc_descriptor=True),
        voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15))


def loop_depths(n=48):
    from tpuslam_torch.data.synthetic import loop_trajectory

    gt = loop_trajectory(n, cycles=2, radius=0.35)
    return np.stack([render_depth(gt[i], K, H, W, seed=i)
                     for i in range(n)]).astype(np.float32)


@pytest.mark.cuda
def test_depth_descriptor_on_card_equals_cpu(dev):
    from tpuslam_torch.frontend import depth_descriptor, promote_bundle_jit

    for i, d in enumerate(loop_depths(12)[::3]):
        pc = preprocess(torch.as_tensor(d), K, CFG)
        pg = preprocess(torch.as_tensor(d, device=dev), K, CFG)
        want = depth_descriptor(pc[-1].points, pc[-1].mask)
        got = depth_descriptor(pg[-1].points, pg[-1].mask)
        assert got.device == dev
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-6, atol=0)
        *_, desc = promote_bundle_jit(torch.as_tensor(d, device=dev), K,
                                      CFG, True)
        assert torch.equal(desc, got), i


@pytest.mark.cuda
def test_descriptor_is_host_memory_read_straight_after_promotion(dev):
    """Promotion on the card starts the descriptor's copy without waiting;
    the record holds a numpy array, never a device tensor, and reading it
    at once (the event's wait) gives the device's value — also with a long
    queue of work issued after the promotion."""
    from tpuslam_torch.frontend import (
        Odometry,
        depth_descriptor,
        host_descriptor,
    )

    d = torch.as_tensor(loop_depths(4), device=dev)
    odo = Odometry(K, drift_cfg(), device=dev)
    for i in range(d.shape[0]):
        odo._promote(preprocess(d[i], K, odo.cfg), float(i))
        rec = odo.keyframes[-1]
        assert isinstance(rec.desc, np.ndarray)
        busy = torch.randn(2048, 2048, device=dev)
        for _ in range(20):                 # queued after the copy
            busy = busy @ busy / 2048.0
        got = host_descriptor(rec.desc)
        pyr = preprocess(d[i], K, odo.cfg)
        want = depth_descriptor(pyr[-1].points, pyr[-1].mask).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    torch.cuda.synchronize()


def card_records(records, dev):
    """The same keyframe records with their tensors on the card."""
    out = []
    for r in records:
        cloud = (None if r.cloud is None else
                 type(r.cloud)(*(t.to(dev) for t in r.cloud)))
        verify = (None if r.verify is None else
                  r.verify._replace(packed=r.verify.packed.to(dev)))
        out.append(r._replace(cloud=cloud, verify=verify))
    return out


@pytest.mark.cuda
def test_grid_find_closures_and_relocalize_on_card_match_cpu(dev):
    """The grid-hash verification batch (`find_closures` with K=None) and
    relocalization without tables, on the card against the CPU twins on
    the same records: the same closures and anchor, T within 1e-4, through
    grid_correspond and gn_step only."""
    import dataclasses as dc

    from tpuslam_torch.backend.loopclosure import find_closures
    from tpuslam_torch.backend.relocalize import relocalize
    from tpuslam_torch.frontend import Odometry

    d = loop_depths(16)
    odo = Odometry(K, drift_cfg(), device="cpu")
    for i in range(d.shape[0]):
        odo.process(d[i], timestamp=i / 30.0)
    kfs = odo.keyframes
    assert len(kfs) >= 4
    pg = dc.replace(odo.cfg.posegraph, lc_min_gap=1, lc_max_dist=2.0,
                    lc_descriptor=False)
    poses = [r.T_world_kf.astype(np.float64) for r in kfs]
    want, _ = find_closures(kfs, poses, odo.cfg.icp, pg, K=None)
    for c in (correspond.grid_counter, gn_step.counter, correspond.counter):
        c.reset()
    got, _ = find_closures(card_records(kfs, dev), poses, odo.cfg.icp, pg,
                           K=None)
    assert correspond.grid_counter.launches > 0
    assert gn_step.counter.launches > 0 and correspond.counter.launches == 0
    assert correspond.grid_counter.plain_calls == 0
    assert gn_step.counter.plain_calls == 0
    assert [(c.i, c.j) for c in got] == [(c.i, c.j) for c in want]
    assert len(want) >= 1
    for g, w in zip(got, want):
        assert np.abs(g.T_ij - w.T_ij).max() <= 1e-4
    # keyframe 1's cloud seen from an offset pose (tests/test_reloc.py)
    T_off = se3.exp(torch.tensor([0.02, -0.015, 0.01, 0.01, -0.01, 0.008]))
    q = kfs[1].cloud.transform(T_off)
    T_last = kfs[1].T_world_kf.astype(np.float64) @ np.linalg.inv(
        T_off.numpy().astype(np.float64))
    rc = relocalize(q, kfs, T_last, odo.cfg.icp, pg, K=None)
    rg = relocalize(type(q)(*(t.to(dev) for t in q)), card_records(kfs, dev),
                    T_last, odo.cfg.icp, pg, K=None)
    assert rc is not None and rg is not None and rg.kf_id == rc.kf_id
    assert np.abs(rg.T_kf_cam - rc.T_kf_cam).max() <= 1e-4


@pytest.mark.cuda
def test_grid_fallback_attempt_on_card_matches_cpu(dev, tmp_path):
    """A SlamSystem at verify_level=1 resumed from a verify_level=2 file
    (tables of two shapes: the grid attempt) on the 48-frame loop of
    tests/test_torch_verify_resume.py, descriptor proposal on, on the card
    against the CPU twins: the same closure pairs, poses within 1e-4, the
    grid attempt run on both."""
    import dataclasses as dc

    from tpuslam_torch.slam import SlamSystem
    from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    d = loop_depths(48)
    ts = np.arange(48) / 30.0

    def cfg_at(level):
        c = drift_cfg(level)
        return c.replace(
            icp=dc.replace(c.icp, max_corr_dist=0.25, huber_delta=0.05),
            posegraph=dc.replace(c.posegraph, gn_iters=15, lc_max_dist=0.6))

    def feed(slam, lo, hi):
        x = torch.as_tensor(d, device=slam.device)
        for i in range(lo, hi, 8):
            slam.process_chunk(x[i:i + 8], ts[i:i + 8])
        return slam

    w = feed(SlamSystem(K, cfg_at(2), chunk_mode="boundary",
                        device="cpu"), 0, 8)
    path = str(tmp_path / "level2.npz")
    save_checkpoint(path, w, w.odo.frame_idx)
    out = {}
    for device in ("cpu", dev):
        slam = SlamSystem(K, cfg_at(1), chunk_mode="boundary",
                          device=device)
        load_checkpoint(path, slam)
        grid = []
        real = slam._chain_attempt_fallback

        def counted(*a, _real=real, _grid=grid):
            _grid.append(1)
            return _real(*a)

        slam._chain_attempt_fallback = counted
        feed(slam, 8, 48).finalize()
        out[str(device)] = ([(c.i, c.j) for c in slam.closures],
                            slam.trajectory()[1], len(grid),
                            [r.desc for r in slam.odo.keyframes])
    (cc, ec, nc, _), (cg, eg, ng, descs) = out["cpu"], out[str(dev)]
    assert nc >= 1 and ng == nc
    assert cg == cc and len(cc) >= 1
    assert np.abs(eg - ec).max() <= 1e-4
    assert all(isinstance(x, np.ndarray) for x in descs if x is not None)


def _graph_and_problem(device, seed=5, N=6, C=512):
    """A keyframe chain with noisy poses, and its map BA problem built by
    the grid probe, on `device`."""
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.backend.posegraph import GraphHost
    from tpuslam_torch.config import PoseGraphConfig

    rng = np.random.default_rng(seed)
    pts, nrm, mask = grid_target(3000)
    poses, kf_pts = [], []
    for _ in range(N):
        T = se3.exp(torch.as_tensor(0.1 * rng.normal(size=6),
                                    dtype=torch.float32)).numpy()
        Ti = np.linalg.inv(T.astype(np.float64))
        pw = pts[rng.integers(5, 3000, C)] + 0.01 * rng.normal(size=(C, 3))
        poses.append(T)
        kf_pts.append(pw @ Ti[:3, :3].T + Ti[:3, 3])
    cfg = PoseGraphConfig(max_nodes=8, max_edges=16, gn_iters=10)
    g = GraphHost(cfg, device=device)
    noise = rng.normal(scale=0.01, size=(N, 3))
    for i, T in enumerate(poses):
        T = T.copy()
        T[:3, 3] += noise[i]
        g.add_node(T)
    for i in range(1, N):
        g.add_edge(i - 1, i, np.linalg.inv(poses[i - 1]) @ poses[i])
    g.add_edge(0, N - 1, np.linalg.inv(poses[0]) @ poses[N - 1], weight=2.0)
    prob = map_ba.build_map_ba_problem(
        *(torch.as_tensor(a, device=device) for a in (
            np.stack(poses).astype(np.float32),
            np.stack(kf_pts).astype(np.float32),
            rng.uniform(size=(N, C)) > 0.05, pts, nrm, mask)), max_dist=0.1)
    return g.graph(), prob, cfg


@pytest.mark.cuda
def test_sharded_icp_one_rank_on_card_matches_align_frames(dev):
    """align_frames_spmd on a one-rank mesh (no group) at 3 levels: its
    kernels launched (correspond, gn_partials at the pose, gn_epilogue),
    no twin, and the pose of align_frames on the card within 1e-5,
    iterations within ±3."""
    from tpuslam_torch.dist.mesh import make_mesh
    from tpuslam_torch.dist.sharded_icp import align_frames_spmd

    d = torch.as_tensor(depths(2), device=dev)
    pyr_a, pyr_b = preprocess(d[0], K, CFG), preprocess(d[1], K, CFG)
    counters = (correspond.counter, gn_partials.counter,
                gn_epilogue.counter, gn_step.counter)
    for c in counters:
        c.reset()
    res = align_frames_spmd(pyr_b, pyr_a, K, torch.eye(4, device=dev),
                            CFG.icp, make_mesh(dev))
    torch.cuda.synchronize()
    assert all(c.launches > 0 for c in counters[:3])
    assert gn_step.counter.launches == 0
    assert all(c.plain_calls == 0 for c in counters)
    ref = align_frames(pyr_b, pyr_a, K, torch.eye(4, device=dev), CFG.icp)
    assert res.T.device == dev
    assert float((res.T - ref.T).abs().max()) <= 1e-5
    assert abs(int(res.iters) - int(ref.iters)) <= 3


@pytest.mark.cuda
def test_distributed_pose_graph_one_rank_on_card(dev):
    """optimize_pose_graph_spmd on a one-rank mesh against
    optimize_pose_graph on the card: poses within 5e-4."""
    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.backend.posegraph import optimize_pose_graph
    from tpuslam_torch.dist.mesh import make_mesh

    graph, _prob, cfg = _graph_and_problem(dev)
    poses, cost = optimize_pose_graph_spmd(graph, cfg, make_mesh(dev))
    ref, _ = optimize_pose_graph(graph, cfg)
    assert poses.device == dev and bool(torch.isfinite(cost))
    assert float((poses - ref).abs().max()) <= 5e-4


@pytest.mark.cuda
def test_map_ba_spmd_one_rank_on_card(dev):
    """optimize_map_ba_spmd on a one-rank mesh against optimize_map_ba on
    the card, on a problem the grid probe built: poses and map within
    5e-5."""
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.dist.mesh import make_mesh

    graph, prob, cfg = _graph_and_problem(dev)
    poses, map_pts, _cost = map_ba.optimize_map_ba_spmd(graph, prob, cfg,
                                                        make_mesh(dev))
    rp, rm, _rc = map_ba.optimize_map_ba(graph, prob, cfg)
    assert map_pts.shape == prob.map_points.shape
    assert float((poses - rp).abs().max()) <= 5e-5
    assert float((map_pts - rm).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_batched_aligner_one_rank_on_card(dev):
    """make_batched_aligner on a one-rank mesh: each of 4 pairs within
    2e-4 of its own align_frames on the card."""
    from tpuslam_torch.dist.batch_eval import make_batched_aligner
    from tpuslam_torch.dist.mesh import make_mesh
    from tpuslam_torch.icp import Frame

    d = torch.as_tensor(depths(5), device=dev)
    pyrs = [preprocess(d[i], K, CFG) for i in range(5)]

    def stack(ps):
        return tuple(Frame(*(torch.stack([p[li][k] for p in ps])
                             for k in range(3))) for li in range(3))

    T0s = torch.eye(4, device=dev).repeat(4, 1, 1)
    res = make_batched_aligner(make_mesh(dev), CFG.icp)(
        stack(pyrs[1:]), stack(pyrs[:4]), K, T0s)
    for b in range(4):
        ref = align_frames(pyrs[b + 1], pyrs[b], K, T0s[b], CFG.icp)
        assert float((res.T[b] - ref.T).abs().max()) <= 2e-4
        assert int(res.iters[b]) == int(ref.iters)


# ---- two streams: the SLAM backend's worker beside tracking ------------


@pytest.mark.cuda
def test_kernels_bit_equal_on_two_streams(dev):
    """correspond, gn_step, gn_fused and ring_nn launched 100 times on each
    of two streams at once (different inputs, the queues held behind a
    device sleep so the streams' kernels overlap): every result bit-equal
    to the same launch alone, every ticket back at zero."""
    from tpuslam_torch.bench.two_streams import check_two_streams

    r = check_two_streams(dev, H, W, ring_n=2048, ring_m=16384)
    assert r["tickets_zero"], r
    assert all(k["mismatches"] == 0 and k["launches_per_stream"] == 100
               for k in r["kernels"].values()), r


def worker_loop_cfg():
    """tests/test_chunked_slam.py's config."""
    from tpuslam_torch.config import PoseGraphConfig, VoxelConfig

    return SLAMConfig(
        height=H, width=W,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
        posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                                  lc_min_gap=3, lc_max_dist=0.6,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15))


def inline_chunks(device, async_backend, d_np):
    from tpuslam_torch.slam import SlamSystem

    slam = SlamSystem(K, worker_loop_cfg(), async_backend=async_backend,
                      chunk_mode="inline", device=device)
    d = torch.as_tensor(d_np, device=device)
    ts = np.arange(d.shape[0]) / 30.0
    for i in range(0, d.shape[0], 8):
        slam.process_chunk(d[i:i + 8], ts[i:i + 8])
    return slam


@pytest.mark.cuda
def test_worker_attempts_launch_on_their_own_stream(dev):
    """The worker's attempts launch correspond and gn_step on the worker's
    stream, tracking on the main stream; no twin is called."""
    d_np = loop_depths()
    for c in (correspond.counter, gn_step.counter):
        c.reset()
    slam = inline_chunks(dev, True, d_np)
    worker = slam._worker_stream.cuda_stream
    main = torch.cuda.current_stream(dev).cuda_stream
    assert worker != main
    slam.finalize()
    for c in (correspond.counter, gn_step.counter):
        assert c.by_stream.get(worker, 0) > 0, c.by_stream
        assert c.by_stream.get(main, 0) > 0, c.by_stream
        assert c.plain_calls == 0
        assert sum(c.by_stream.values()) == c.launches
    assert len(slam.closures) >= 1


@pytest.mark.cuda
def test_inline_worker_on_card_matches_cpu_twins(dev):
    """Inline chunks of 8 with the worker on the card against the same run
    synchronous through the CPU twins: the same keyframes, closures ≥
    max(1, sync // 2), ATE < 0.02 m (tests/test_chunked_slam.py:99-122)."""
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.eval.ate import ate_rmse

    d_np = loop_depths()
    gt = loop_trajectory(d_np.shape[0], cycles=2, radius=0.35)
    card = inline_chunks(dev, True, d_np)
    card.finalize()
    cpu = inline_chunks("cpu", False, d_np)
    cpu.finalize()
    assert ([r.index for r in card.odo.keyframes]
            == [r.index for r in cpu.odo.keyframes])
    assert len(card.closures) >= max(1, len(cpu.closures) // 2)
    ts, est = card.trajectory()
    assert ate_rmse(ts, est, ts, gt, max_difference=0.005)["rmse"] < 0.02


# ---- the captured programs (tpuslam_torch/graphs.py) -------------------


def _flat(tree):
    from tpuslam_torch import graphs

    return graphs.flatten(tree)[0]


def _bits_equal(a, b):
    ta, tb = _flat(a), _flat(b)
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            view = {2: torch.int16, 4: torch.int32}[x.element_size()]
            x, y = x.contiguous().view(view), y.contiguous().view(view)
        if not torch.equal(x, y):
            return False
    return True


def _program_calls(dev):
    """Each of the six programs at 120×160, as call(eager) → outputs."""
    from tpuslam_torch.backend import loopclosure, posegraph
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.frontend import (
        SuperChunkCarry,
        initial_state,
        process_frame_jit,
        promote_bundle_jit,
        scan_chunk,
        scan_superchunk_frozen,
    )

    cfg = worker_loop_cfg()
    gt = loop_trajectory(48, cycles=2, radius=0.35)
    d = torch.as_tensor(loop_depths(), device=dev)
    eye = torch.eye(4, device=dev)
    st = initial_state(d[0], K, cfg)
    carry = SuperChunkCarry(st.kf_packed, eye, eye)
    host = posegraph.GraphHost(cfg.posegraph, device=dev)
    for k in range(20):
        host.add_node(gt[k].astype(np.float32))
        if k:
            host.add_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k])
    g = host.graph(bucketed=True)
    pairs = [(0, 24), (4, 28), (0, 24), (0, 24)]
    tables = [pack_pyramid(preprocess(d[i], K, cfg), cfg.icp)[1]
              for i, _ in pairs]
    clouds = [promote_bundle_jit(d[j], K, cfg, False)[2] for _, j in pairs]
    T_inits = torch.as_tensor(np.stack([
        (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)
        for i, j in pairs]), device=dev)
    ci = torch.tensor([0, 4, 0, 0], dtype=torch.int32, device=dev)
    cj = torch.tensor([14, 16, 14, 14], dtype=torch.int32, device=dev)
    pg = cfg.posegraph
    return {
        "scan_odometry": lambda e: scan_odometry(d[:12], K, cfg, eager=e),
        "process_frame_jit": lambda e: process_frame_jit(
            d[3], st.kf_packed, K, eye, eye, cfg, eager=e),
        "scan_chunk": lambda e: scan_chunk(d[1:9], K, st, cfg, eager=e),
        "scan_superchunk_frozen": lambda e: scan_superchunk_frozen(
            d[1:17], K, carry, cfg, 8, eager=e),
        "optimize_pose_graph": lambda e: posegraph.optimize_pose_graph(
            g, pg, eager=e),
        "optimize_pose_graph_cg": lambda e: posegraph.optimize_pose_graph_cg(
            g, pg, cg_iters=32, eager=e),
        "fused_attempt_jit": lambda e: loopclosure.fused_attempt_jit(
            tables, [c.points for c in clouds], [c.normals for c in clouds],
            [c.mask for c in clouds], K.scaled(0.5), T_inits, 2, g, ci, cj,
            H // 2, W // 2, cfg.icp, pg, True, 2.0, eager=e),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("program", [
    "scan_odometry", "process_frame_jit", "scan_chunk",
    "scan_superchunk_frozen", "optimize_pose_graph", "optimize_pose_graph_cg",
    "fused_attempt_jit"])
def test_program_replay_bit_equal_to_eager(dev, program):
    """The first call (the warm-up), the second (capture and replay) and a
    replay give the eager run's bits; the replays count the graph's kernel
    launches."""
    from tpuslam_torch import graphs

    graphs.clear()
    call = _program_calls(dev)[program]
    ref = [t.clone() for t in _flat(call(True))]
    for c in (correspond.counter, gn_step.counter):
        c.reset()
    got = [[t.clone() for t in _flat(call(False))] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(_bits_equal(g, ref) for g in got)
    entries = [e for e in graphs.stats() if e["replays"] >= 2]
    assert entries, graphs.stats()
    if program not in ("optimize_pose_graph", "optimize_pose_graph_cg"):
        assert gn_step.counter.launches > 0
        assert gn_step.counter.plain_calls == 0
        # three calls: the warm-up's launches and two replays' records
        # (the scans: a warm-up frame, then a replay a frame)
        rec = sum(e["kernel_launches"].get("gn_step", 0) for e in entries)
        assert gn_step.counter.launches % 3 == 0 and rec > 0
    graphs.clear()


@pytest.mark.cuda
def test_a_changed_K_or_bucket_never_replays_a_stale_graph(dev):
    from tpuslam_torch import graphs
    from tpuslam_torch.backend import posegraph
    from tpuslam_torch.frontend import process_frame_jit

    graphs.clear()
    d = torch.as_tensor(depths(4), device=dev)
    kf = pack_pyramid(preprocess(d[0], K, CFG), CFG.icp)
    eye = torch.eye(4, device=dev)
    Ks = (K, K._replace(fx=K.fx * 1.02), K._replace(cx=K.cx + 1.5))
    for Ki in Ks + Ks + Ks[1:2]:     # warm-ups, captures, a replay
        got = process_frame_jit(d[2], kf, Ki, eye, eye, CFG)
        assert _bits_equal(got, process_frame_jit(d[2], kf, Ki, eye, eye,
                                                  CFG, eager=True))
    assert len(graphs.stats()) == 3
    assert all(e["captured"] for e in graphs.stats())
    rng = np.random.default_rng(0)
    for n in (10, 40, 12, 45, 13):
        host = posegraph.GraphHost(CFG.posegraph, device=dev)
        while host.num_nodes < n:
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.normal(scale=0.1, size=3)
            host.add_node(T)
            if host.num_nodes > 1:
                host.add_edge(host.num_nodes - 2, host.num_nodes - 1,
                              np.eye(4))
        g = host.graph(bucketed=True)
        assert _bits_equal(posegraph.optimize_pose_graph(g, CFG.posegraph),
                           posegraph.optimize_pose_graph(g, CFG.posegraph,
                                                         eager=True))
    # buckets 32 and 64, each warmed up, then captured and replayed
    assert sum(e["program"] == "optimize_pose_graph"
               for e in graphs.stats()) == 2
    graphs.clear()


@pytest.mark.cuda
def test_graphs_bit_equal_on_two_streams(dev):
    """process_frame_jit's graph (a graph a stream) and the pose-graph
    solve's replayed 100 times on each of two streams at once: every
    result bit-equal to the call alone, every ticket back at zero."""
    from tpuslam_torch.bench.two_streams import check_two_streams

    r = check_two_streams(dev, H, W, ring_n=2048, ring_m=16384)
    assert r["tickets_zero"], r
    graphed = {k: v for k, v in r["kernels"].items()
               if k.startswith("graph:")}
    assert set(graphed) == {"graph:process_frame_jit",
                            "graph:optimize_pose_graph"}, r
    assert all(k["mismatches"] == 0 and k["launches_per_stream"] == 100
               for k in graphed.values()), r


@pytest.mark.cuda
def test_a_capture_failure_raises(dev):
    """A body that reads a tensor back to the host cannot be captured:
    the key's first call (the warm-up, eager) runs, its second raises
    CaptureError, as does every later one, and only eager=True runs it."""
    from tpuslam_torch import graphs

    prog = graphs.Program("reads_back", lambda s, x: (
        (), x * float(x.sum().item())))
    x = torch.ones(4, device=dev)
    assert prog.run(x).tolist() == [4.0] * 4
    for _ in range(2):
        with pytest.raises(graphs.CaptureError, match="reads_back"):
            prog.run(x)
    assert [e.graph for e in prog.entries()] == [None]
    assert prog.run(x, eager=True).tolist() == [4.0] * 4
    torch.cuda.synchronize()
    # the card is still usable, and a good program captures after it
    ok = graphs.Program("adds", lambda s, x: ((), x + 1))
    assert ok.run(x).tolist() == ok.run(x).tolist() == [2.0] * 4
    graphs.clear()


# ---- the map-tracking programs -------------------------------------------


def _map_inputs(dev):
    """A map of three keyframes of the 48-frame loop fused at their true
    poses, its grid index, frame 6's pyramid and cloud, a warm start 1 cm
    off, and a map BA problem over the three keyframes, on `dev`."""
    from tpuslam_torch.backend import map_ba, posegraph
    from tpuslam_torch.data.synthetic import loop_trajectory
    from tpuslam_torch.frontend import _kf_cloud_jit, promote_bundle_jit
    from tpuslam_torch.geom.voxel import voxel_downsample
    from tpuslam_torch.mapping import VoxelMap

    cfg = worker_loop_cfg()
    v = cfg.voxel
    gt = loop_trajectory(48, cycles=2, radius=0.35)
    d = torch.as_tensor(loop_depths(), device=dev)
    kfs = (0, 4, 8)
    clouds = [promote_bundle_jit(d[i], K, cfg, False, eager=True)[2]
              for i in kfs]
    vmap = VoxelMap(v, device=dev)
    for c, i in zip(clouds, kfs):
        vmap.insert(c, gt[i])
    pyr = preprocess(d[6], K, cfg)
    T0 = gt[6].astype(np.float32)
    T0[:3, 3] += 0.01
    ctrl = voxel_downsample(vmap.cloud, 2.0 * v.map_voxel_size, 4096,
                            v.origin, v.extent)
    host = posegraph.GraphHost(cfg.posegraph, device=dev)
    for k, i in enumerate(kfs):
        host.add_node(gt[i].astype(np.float32))
        if k:
            host.add_edge(k - 1, k, np.linalg.inv(gt[kfs[k - 1]]) @ gt[i])
    prob = map_ba.build_map_ba_problem(
        torch.as_tensor(np.stack([gt[i] for i in kfs]).astype(np.float32),
                        device=dev),
        torch.stack([c.points[:512] for c in clouds]),
        torch.stack([c.mask[:512] for c in clouds]), ctrl.points,
        ctrl.normals, ctrl.mask, max_dist=float(cfg.icp.max_corr_dist))
    return {"cfg": cfg, "gt": gt, "d": d, "clouds": clouds, "vmap": vmap,
            "pyr": pyr, "T0": torch.as_tensor(T0, device=dev),
            "index": vmap.build_index(cell=float(cfg.icp.max_corr_dist)),
            "cloud": _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity,
                                   v.origin, v.extent, eager=True),
            "graph": host.graph(bucketed=True), "prob": prob}


def _map_program_calls(mi):
    """Each map-tracking program as call(eager) → outputs."""
    from tpuslam_torch import mapping
    from tpuslam_torch import slam as slam_mod
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.dist.mesh import Mesh
    from tpuslam_torch.dist.ring_map import make_ring_align_fn
    from tpuslam_torch.frontend import (
        _kf_cloud_jit,
        pack_pyramid_jit,
        promote_bundle_jit,
    )

    cfg = mi["cfg"]
    icp, v = cfg.icp, cfg.voxel
    ring = make_ring_align_fn(Mesh(None, 0, 1, mi["d"].device), icp)
    gt4 = mi["gt"][4]
    return {
        "_refine_projective_jit": lambda e: slam_mod._refine_projective_jit(
            mi["vmap"].cloud, mi["pyr"][0], K, mi["T0"], icp, eager=e),
        "_refine_grid_jit": lambda e: slam_mod._refine_grid_jit(
            mi["cloud"], mi["index"], mi["T0"], icp, eager=e),
        "_kf_cloud_jit": lambda e: _kf_cloud_jit(
            mi["pyr"][0], v.voxel_size, v.capacity, v.origin, v.extent,
            eager=e),
        "_fuse": lambda e: mapping.fuse_jit(
            mi["vmap"].cloud, mi["clouds"][1],
            torch.as_tensor(gt4.astype(np.float32), device=mi["d"].device),
            v.map_capacity, v.map_voxel_size, v.origin, v.extent, eager=e),
        "promote_bundle_jit": lambda e: promote_bundle_jit(
            mi["d"][9], K, cfg, True, eager=e),
        "pack_pyramid_jit": lambda e: pack_pyramid_jit(mi["pyr"], cfg,
                                                       eager=e),
        "optimize_map_ba": lambda e: map_ba.optimize_map_ba(
            mi["graph"], mi["prob"], cfg.posegraph, eager=e),
        "ring_align": lambda e: ring(mi["cloud"], mi["vmap"].cloud,
                                     mi["T0"], eager=e),
    }


MAP_PROGRAMS = ("_refine_projective_jit", "_refine_grid_jit",
                "_kf_cloud_jit", "_fuse", "promote_bundle_jit",
                "pack_pyramid_jit", "optimize_map_ba", "ring_align")


@pytest.mark.cuda
@pytest.mark.parametrize("program", MAP_PROGRAMS)
def test_map_program_replay_bit_equal_to_eager(dev, program):
    """The first call (the warm-up), the second (capture and replay) and a
    replay of each map-tracking program give the eager run's bits; the
    replays count the graph's kernel launches."""
    from tpuslam_torch import graphs

    mi = _map_inputs(dev)
    graphs.clear()
    call = _map_program_calls(mi)[program]
    ref = [t.clone() for t in _flat(call(True))]
    counters = (correspond.counter, correspond.grid_counter, gn_step.counter,
                gn_partials.counter, gn_epilogue.counter, ring_nn.counter)
    for c in counters:
        c.reset()
    got = [[t.clone() for t in _flat(call(False))] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(_bits_equal(g, ref) for g in got)
    (entry,) = [e for e in graphs.stats() if e["program"] == program]
    assert entry["captured"] and entry["replays"] == 2, graphs.stats()
    assert all(c.plain_calls == 0 for c in counters)
    kernel = {"_refine_projective_jit": gn_step.counter,
              "_refine_grid_jit": correspond.grid_counter,
              "ring_align": ring_nn.counter}.get(program)
    if kernel is not None:
        rec = entry["kernel_launches"].get(kernel.name, 0)
        assert rec > 0 and kernel.launches % 3 == 0
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["projective", "grid"])
def test_map_refinement_replay_sees_the_new_map(dev, mode):
    """Captured against a three-keyframe map, then a fourth keyframe fused
    in (a replay of the fusion, equal to the eager fusion) and, in grid
    mode, the index rebuilt: the next replay is the eager refinement
    against the new map, and differs from the replay before."""
    from tpuslam_torch import graphs, mapping
    from tpuslam_torch import slam as slam_mod
    from tpuslam_torch.geom.voxel import voxel_downsample

    mi = _map_inputs(dev)
    graphs.clear()
    cfg, vmap = mi["cfg"], mi["vmap"]
    icp, v = cfg.icp, cfg.voxel

    def refine(eager=False):
        if mode == "projective":
            return slam_mod._refine_projective_jit(
                vmap.cloud, mi["pyr"][0], K, mi["T0"], icp, eager=eager)
        index = vmap.build_index(cell=float(icp.max_corr_dist))
        return slam_mod._refine_grid_jit(mi["cloud"], index, mi["T0"], icp,
                                         eager=eager)

    before = [refine() for _ in range(2)]
    assert _bits_equal(before[1], refine(eager=True))
    new = preprocess(mi["d"][12], K, cfg)
    cloud = voxel_downsample(new[0].as_cloud(), v.voxel_size, v.capacity,
                             v.origin, v.extent)
    T = torch.as_tensor(mi["gt"][12].astype(np.float32), device=dev)
    for _ in range(2):                      # the fusion's warm-up, capture
        mapping.fuse_jit(vmap.cloud, cloud, T, v.map_capacity,
                         v.map_voxel_size, v.origin, v.extent)
    eager_map = mapping.fuse_jit(vmap.cloud, cloud, T, v.map_capacity,
                                 v.map_voxel_size, v.origin, v.extent,
                                 eager=True)
    vmap.insert(cloud, mi["gt"][12])        # a replay
    assert _bits_equal(vmap.cloud, eager_map)
    after = refine()
    assert _bits_equal(after, refine(eager=True))
    assert not torch.equal(after, before[1])
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_ring_on_a_one_rank_group(dev, backend):
    """The ring under a one-rank process group on the card: over NCCL it
    is captured with its all-reduces inside and replays bit-equal to the
    eager run; over gloo it never captures and runs op by op."""
    import socket

    import torch.distributed as dist

    from tpuslam_torch import graphs
    from tpuslam_torch.dist import ring_map
    from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

    mi = _map_inputs(dev)
    graphs.clear()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", world_size=1, rank=0,
                           backend=backend, timeout_s=60)
    try:
        mesh = make_mesh(dev)
        assert mesh.backend == backend
        assert ring_map.captures(mesh) == (backend == "nccl")
        call = ring_map.make_ring_align_fn(mesh, mi["cfg"].icp)
        args = (mi["cloud"], mi["vmap"].cloud, mi["T0"])
        ref = [t.clone() for t in _flat(call(*args, eager=True))]
        ring_nn.counter.reset()
        got = [[t.clone() for t in _flat(call(*args))] for _ in range(3)]
        torch.cuda.synchronize()
        assert all(_bits_equal(g, ref) for g in got)
        assert ring_nn.counter.launches > 0
        entries = ring_map._RING_ALIGN.entries()
        if backend == "nccl":
            assert len(entries) == 1 and entries[0].graph is not None
            assert entries[0].replays == 2
        else:
            assert entries == []
    finally:
        ring_map.drop_graphs()    # they hold NCCL collectives
        dist.destroy_process_group()
        graphs.clear()


# ---- the last compiled programs ------------------------------------------


def _last_program_calls(mi, mesh=None):
    """The boundary scan, the alignments, the index build, the
    verification batches (B = 4, 2 live) and, on `mesh` (default: one
    rank without a group), the sharded fusion and ICP, as call(eager) →
    outputs."""
    from tpuslam_torch.backend import loopclosure, relocalize
    from tpuslam_torch.dist.map_fusion import make_fuse_fn
    from tpuslam_torch.dist.mesh import Mesh
    from tpuslam_torch.dist.sharded_icp import make_aligned_spmd_fn
    from tpuslam_torch.frontend import (
        promote_bundle_jit,
        scan_odometry_boundary_jit,
    )
    from tpuslam_torch.icp import align_clouds_jit, align_frames_jit
    from tpuslam_torch.kernels.correspond import build_grid_index_jit

    cfg, d, gt = mi["cfg"], mi["d"], mi["gt"]
    icp, v = cfg.icp, cfg.voxel
    dev = d.device
    mesh = mesh or Mesh(None, 0, 1, dev)
    b = {i: promote_bundle_jit(d[i], K, cfg, False, eager=True)
         for i in (0, 4, 8)}
    pairs = ((0, 4), (4, 8), (0, 4), (0, 4))
    T_inits = torch.as_tensor(np.stack([
        (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)
        for i, j in pairs]), device=dev)
    tables = [b[i][1][1] for i, _ in pairs]
    ci = [b[i][2] for i, _ in pairs]
    cj = [b[j][2] for _, j in pairs]
    pyr5 = preprocess(d[5], K, cfg)
    eye = torch.eye(4, device=dev)
    fuse = make_fuse_fn(mesh, v, v.capacity)[0]
    spmd = make_aligned_spmd_fn(mesh, icp)
    T4 = torch.as_tensor(gt[4].astype(np.float32), device=dev)
    return {
        "scan_odometry_boundary_jit": lambda e: scan_odometry_boundary_jit(
            d[:24], K, cfg, 8, eager=e),
        "align_frames_jit": lambda e: align_frames_jit(
            pyr5, mi["pyr"], K, eye, icp, eager=e),
        "align_clouds_jit": lambda e: align_clouds_jit(
            b[0][2], b[4][2], T_inits[0], icp, eager=e),
        "build_grid_index": lambda e: build_grid_index_jit(
            mi["vmap"].cloud, float(icp.max_corr_dist), eager=e),
        "_verify_pairs_jit": lambda e: loopclosure.verify_batch_grid(
            ci, cj, T_inits, 2, icp, eager=e),
        "_verify_projective_pairs_jit": lambda e: loopclosure.verify_batch(
            tables, [c.points for c in cj], [c.normals for c in cj],
            [c.mask for c in cj], K.scaled(0.5), T_inits, 2, H // 2, W // 2,
            icp, eager=e),
        "_batch_verify_jit": lambda e: relocalize._batch_verify_jit(
            mi["cloud"], ci, T_inits, icp, eager=e),
        "_batch_verify_projective_jit": lambda e: (
            relocalize._batch_verify_projective_jit(
                mi["cloud"], tables, K.scaled(0.5), T_inits, H // 2, W // 2,
                icp, eager=e)),
        "fuse_sharded": lambda e: fuse(mi["vmap"].cloud, b[8][2], T4,
                                       eager=e),
        "align_frames_spmd": lambda e: spmd(pyr5, mi["pyr"], K, eye,
                                            eager=e),
    }


LAST_PROGRAMS = ("scan_odometry_boundary_jit", "align_frames_jit",
                 "align_clouds_jit", "build_grid_index", "_verify_pairs_jit",
                 "_verify_projective_pairs_jit", "_batch_verify_jit",
                 "_batch_verify_projective_jit", "fuse_sharded",
                 "align_frames_spmd")
# each program's kernel whose launches a replay must count
LAST_KERNELS = {"build_grid_index": "grid_table",
                "align_clouds_jit": "grid_correspond",
                "_verify_pairs_jit": "grid_correspond",
                "_batch_verify_jit": "grid_correspond",
                "fuse_sharded": None, "align_frames_spmd": "gn_partials"}


@pytest.mark.cuda
@pytest.mark.parametrize("program", LAST_PROGRAMS)
def test_last_program_replay_bit_equal_to_eager(dev, program):
    """The first call (the warm-up), the second (capture and replay) and a
    replay of each program give the eager run's bits; the replays count
    the graph's kernel launches and no plain twin runs."""
    from tpuslam_torch import graphs
    from tpuslam_torch.bench.harness import kernel_counters

    mi = _map_inputs(dev)
    graphs.clear()
    call = _last_program_calls(mi)[program]
    ref = [t.clone() for t in _flat(call(True))]
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    got = [[t.clone() for t in _flat(call(False))] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(_bits_equal(g, ref) for g in got)
    (entry,) = [e for e in graphs.stats() if e["program"] == program]
    assert entry["captured"] and entry["replays"] >= 2, graphs.stats()
    assert all(c.plain_calls == 0 for c in counters.values())
    name = LAST_KERNELS.get(program, "gn_step")
    if name is not None:
        kernel = counters[name]
        assert entry["kernel_launches"].get(kernel.name, 0) > 0
        assert kernel.launches % 3 == 0 and kernel.launches > 0
    graphs.clear()


@pytest.mark.cuda
def test_index_build_replay_after_an_insert_is_a_fresh_build(dev):
    """The index build captured against a three-keyframe map, a fourth
    fused in: the next replay equals a fresh eager build (keys, rows,
    origin and the table), and differs from the build before."""
    from tpuslam_torch import graphs
    from tpuslam_torch.geom.voxel import voxel_downsample
    from tpuslam_torch.kernels.correspond import build_grid_index

    mi = _map_inputs(dev)
    graphs.clear()
    cfg, vmap = mi["cfg"], mi["vmap"]
    cell = float(cfg.icp.max_corr_dist)
    before = [vmap.build_index(cell) for _ in range(2)]
    assert _bits_equal(before[1], before[0])
    new = preprocess(mi["d"][12], K, cfg)
    v = cfg.voxel
    vmap.insert(voxel_downsample(new[0].as_cloud(), v.voxel_size,
                                 v.capacity, v.origin, v.extent),
                mi["gt"][12])
    correspond.table_counter.reset()
    after = vmap.build_index(cell)
    assert correspond.table_counter.launches > 0
    fresh = build_grid_index(vmap.cloud, cell)
    assert _bits_equal(after, fresh)
    assert not torch.equal(after.keys, before[1].keys)
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["fuse_sharded", "align_frames_spmd"])
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_sharded_programs_on_a_one_rank_group(dev, backend, program):
    """The sharded fusion and the point-sharded ICP under a one-rank
    process group on the card: over NCCL each is captured with its
    collectives inside and replays bit-equal to the eager run; over gloo
    neither ever captures."""
    import socket

    import torch.distributed as dist

    from tpuslam_torch import graphs
    from tpuslam_torch.dist import mesh as mesh_mod
    from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

    mi = _map_inputs(dev)
    graphs.clear()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", world_size=1, rank=0,
                           backend=backend, timeout_s=60)
    try:
        mesh = make_mesh(dev)
        assert mesh_mod.captures(mesh) == (backend == "nccl")
        call = _last_program_calls(mi, mesh)[program]
        ref = [t.clone() for t in _flat(call(True))]
        got = [[t.clone() for t in _flat(call(False))] for _ in range(3)]
        torch.cuda.synchronize()
        assert all(_bits_equal(g, ref) for g in got)
        entries = [e for e in graphs.stats() if e["program"] == program]
        if backend == "nccl":
            assert len(entries) == 1 and entries[0]["captured"]
            assert entries[0]["replays"] == 2
        else:
            assert entries == []
    finally:
        mesh_mod.drop_graphs()    # they hold NCCL collectives
        dist.destroy_process_group()
        graphs.clear()


# ---- the distributed programs ---------------------------------------------


def _dist_program_calls(mi, mesh):
    """The edge-sharded pose graph and the landmark-sharded map BA on
    `_graph_and_problem`'s chain, and the batched aligner on two pairs
    (frame 5 against frame 6, from the identity and from 1 cm off), on
    `mesh`, as call(eager) → outputs."""
    from tpuslam_torch.backend import map_ba
    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.dist.batch_eval import make_batched_aligner
    from tpuslam_torch.icp import Frame

    dev = mi["d"].device
    graph, prob, pg = _graph_and_problem(dev)
    pyr5 = preprocess(mi["d"][5], K, mi["cfg"])
    src, dst = (tuple(Frame(*(torch.stack([t, t]) for t in f)) for f in p)
                for p in (pyr5, mi["pyr"]))
    T0s = torch.eye(4, device=dev).repeat(2, 1, 1)
    T0s[1, 0, 3] = 0.01
    batched = make_batched_aligner(mesh, mi["cfg"].icp)
    return {
        "optimize_pose_graph_spmd": lambda e: optimize_pose_graph_spmd(
            graph, pg, mesh, eager=e),
        "optimize_map_ba_spmd": lambda e: map_ba.optimize_map_ba_spmd(
            graph, prob, pg, mesh, eager=e),
        "batched_align_frames": lambda e: batched(src, dst, K, T0s,
                                                  eager=e),
    }


DIST_PROGRAMS = ("optimize_pose_graph_spmd", "optimize_map_ba_spmd",
                 "batched_align_frames")


@pytest.mark.cuda
@pytest.mark.parametrize("program", DIST_PROGRAMS)
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_distributed_programs_on_a_one_rank_group(dev, backend, program):
    """The edge-sharded pose graph, the landmark-sharded map BA and the
    batched aligner under a one-rank process group on the card: over NCCL
    each is captured with its collectives inside and replays bit-equal to
    the eager run, its replays counting the graph's hand-kernel launches
    (the aligner's gn_step and correspond); over gloo none ever captures.
    No plain twin runs."""
    import socket

    import torch.distributed as dist

    from tpuslam_torch import graphs
    from tpuslam_torch.bench.harness import kernel_counters
    from tpuslam_torch.dist import mesh as mesh_mod
    from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

    mi = _map_inputs(dev)
    graphs.clear()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", world_size=1, rank=0,
                           backend=backend, timeout_s=60)
    try:
        mesh = make_mesh(dev)
        assert mesh_mod.captures(mesh) == (backend == "nccl")
        call = _dist_program_calls(mi, mesh)[program]
        ref = [t.clone() for t in _flat(call(True))]
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        got = [[t.clone() for t in _flat(call(False))] for _ in range(3)]
        torch.cuda.synchronize()
        assert all(_bits_equal(g, ref) for g in got)
        assert all(c.plain_calls == 0 for c in counters.values())
        entries = [e for e in graphs.stats() if e["program"] == program]
        if backend == "nccl":
            assert len(entries) == 1 and entries[0]["captured"]
            assert entries[0]["replays"] == 2
            if program == "batched_align_frames":
                for name in ("gn_step", "correspond"):
                    assert entries[0]["kernel_launches"][
                        counters[name].name] > 0
                    assert counters[name].launches % 3 == 0
        else:
            assert entries == []
    finally:
        mesh_mod.drop_graphs()    # they hold NCCL collectives
        dist.destroy_process_group()
        graphs.clear()
