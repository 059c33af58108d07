"""The port's three kernel modules against the reference.

On the CPU each wrapper runs its plain PyTorch twin; those twins are held
here to the reference's functions on the same numpy inputs (the Pallas
kernels in interpret mode, as the reference's own tests run them).  The
hand kernels themselves are held to the twins on the card by
tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.geom.se3 as rse3
import tpuslam_torch.geom.se3 as pse3
from tpuslam.config import Intrinsics
from tpuslam.data.synthetic import orbit_trajectory, render_depth
from tpuslam.geom.backproject import backproject as r_backproject
from tpuslam.geom.normals import organized_normals as r_normals
from tpuslam.kernels.correspond import pack_organized_target as r_pack
from tpuslam.kernels.correspond import projective_correspond_packed as r_corr
from tpuslam.kernels.gn_reduce import gn_reduce as r_gn_reduce
from tpuslam.kernels.pallas_epilogue import gn_epilogue_reference as r_epi
from tpuslam.kernels.pallas_gn import gn_reduce_partials_pallas, gn_reduce_pallas
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.kernels import _build, correspond, gn_epilogue, gn_partials
from tpuslam_torch.kernels.gn_reduce import gn_reduce as p_gn_reduce
from tpuslam_torch.kernels.gn_reduce import solve_gn_step as p_solve

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
ARGS = (1e-6, 1e-4, 0.3, 0.3)   # damping, damping_abs, max_trans, max_rot
PKG = Path(__file__).resolve().parent.parent / "tpuslam_torch"


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def scene_pair(tau=(0.01, -0.008, 0.01, 0.006, -0.01, 0.004)):
    """Keyframe table + transformed source of a rendered frame pair."""
    poses = orbit_trajectory(12)
    d0 = render_depth(poses[0], K, H, W)
    d1 = render_depth(poses[3], K, H, W)
    pa, ma = r_backproject(jnp.asarray(d0), K, depth_max=5.0)
    na, ga = r_normals(pa, ma)
    pb, mb = r_backproject(jnp.asarray(d1), K, depth_max=5.0)
    nb, gb = r_normals(pb, mb)
    table = r_pack(pa, na, ma & ga, dtype=jnp.float16)
    T = rse3.exp(jnp.asarray(tau, jnp.float32))
    src_pts = pb.reshape(-1, 3)
    src_n = nb.reshape(-1, 3)
    src_mask = (mb & gb).reshape(-1) & (jnp.sum(src_n * src_n, -1) > 0.5)
    x = rse3.transform_points(T, src_pts)
    n_rot = rse3.rotate_vectors(T, src_n)
    return (pa, na, ma & ga), table, x, src_mask, n_rot


# ---------------------------------------------------------------- correspond

def test_pack_table_bit_equal():
    (pa, na, ga), table, *_ = scene_pair()
    ours = correspond.pack_organized_target(t(pa), t(na), t(ga))
    assert ours.dtype == torch.float16
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                  np.array(table).view(np.int16))


@pytest.mark.parametrize("gate", [0.5, 0.0])
def test_correspond_plain_matches_reference(gate):
    _, table, x, mask, n_rot = scene_pair()
    ref = r_corr(x, mask, table, H, W, K, 0.25, src_normals_in_dst=n_rot,
                 normal_dot_min=gate)
    ours = correspond.projective_correspond_packed_reference(
        t(x), t(mask), t(table), H, W, PIntrinsics(*K), 0.25,
        src_normals_in_dst=t(n_rot), normal_dot_min=gate)
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(ours.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(ours.w.numpy(), np.asarray(ref.w))
    assert 0.3 < float(ours.w.mean()) < 1.0


def test_correspond_off_half_pixel_points():
    """Points placed away from half-pixel boundaries, some out of bounds,
    behind the camera or masked: every output exact."""
    rng = np.random.default_rng(7)
    n = 4000
    u = rng.integers(-20, W + 20, n) + rng.uniform(-0.4, 0.4, n)
    v = rng.integers(-20, H + 20, n) + rng.uniform(-0.4, 0.4, n)
    z = rng.uniform(0.5, 3.0, n)
    z[:50] = -z[:50]
    x = np.stack([(u - K.cx) / K.fx * z, (v - K.cy) / K.fy * z, z],
                 -1).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    (pa, na, ga), table, *_ = scene_pair()
    ref = r_corr(jnp.asarray(x), jnp.asarray(mask), table, H, W, K, 0.5)
    ours = correspond.projective_correspond_packed_reference(
        t(x), t(mask), t(table), H, W, PIntrinsics(*K), 0.5)
    for a, b in ((ours.q, ref.q), (ours.n, ref.n), (ours.idx, ref.idx),
                 (ours.w, ref.w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def pyramid_pair(levels=3):
    """Per level: the keyframe table, the source points, normals and mask
    (untransformed) and the level's intrinsics, of scene_pair's frames."""
    poses = orbit_trajectory(12)
    out = []
    pa, ma = r_backproject(jnp.asarray(render_depth(poses[0], K, H, W)), K,
                           depth_max=5.0)
    pb, mb = r_backproject(jnp.asarray(render_depth(poses[3], K, H, W)), K,
                           depth_max=5.0)
    for li in range(levels):
        f = 2 ** li
        a, am, b, bm = pa[::f, ::f], ma[::f, ::f], pb[::f, ::f], mb[::f, ::f]
        na, ga = r_normals(a, am)
        nb, gb = r_normals(b, bm)
        src_n = nb.reshape(-1, 3)
        mask = (bm & gb).reshape(-1) & (jnp.sum(src_n * src_n, -1) > 0.5)
        out.append((r_pack(a, na, am & ga, dtype=jnp.float16),
                    b.reshape(-1, 3), src_n, mask, a.shape[:2],
                    Intrinsics(*K).scaled(1.0 / f)))
    return out


# The posed twin transforms in a fixed unfused order; XLA's product can
# round a coordinate 1 ulp apart, which moves a point lying on a half-pixel
# boundary (or on the distance / normal gate) to the other side.  Such rows
# must stay rare; every other row is bit-equal.
POSED_MISMATCH_SHARE = 1e-3


@pytest.mark.parametrize("level", [0, 1, 2])
def test_correspond_at_pose_matches_reference(level):
    """The posed association (untransformed source, pose in the carry)
    against the reference's se3.transform_points / rotate_vectors →
    projective_correspond_packed, at the three levels of a frame pair."""
    table, pts, nrm, mask, (h, w), K_l = pyramid_pair()[level]
    T = rse3.exp(jnp.asarray([0.01, -0.008, 0.01, 0.006, -0.01, 0.004],
                             jnp.float32))
    ref = r_corr(rse3.transform_points(T, pts), mask, table, h, w, K_l,
                 0.25, src_normals_in_dst=rse3.rotate_vectors(T, nrm),
                 normal_dot_min=0.5)
    carry = gn_epilogue.init_carry(t(T), 12)
    args = (t(pts), t(mask), t(nrm), t(table), h, w, PIntrinsics(*K_l), 0.25,
            0.5)
    ours = correspond.projective_correspond_at_pose(*args, carry)
    twin = correspond.projective_correspond_at_pose_reference(*args, t(T))
    for a, b in zip(ours, twin):
        assert torch.equal(a, b)
    differ = ((ours.idx.numpy() != np.asarray(ref.idx))
              | (ours.w.numpy() != np.asarray(ref.w)))
    assert differ.mean() <= POSED_MISMATCH_SHARE, differ.sum()
    for a, b in ((ours.q, ref.q), (ours.n, ref.n), (ours.idx, ref.idx),
                 (ours.w, ref.w)):
        np.testing.assert_array_equal(a.numpy()[~differ],
                                      np.asarray(b)[~differ])
    assert 0.2 < float(ours.w.mean()) < 1.0
    # the ICP loop's buffers: written in place and returned
    out = correspond.correspondence_buffers(pts.shape[0], "cpu")
    assert correspond.projective_correspond_at_pose(*args, carry,
                                                    out=out) is out
    for a, b in zip(out, ours):
        assert torch.equal(a, b)


def test_posed_association_on_degraded_depth_parts_only_by_the_transform():
    """bench_pathology's degraded 640×480 depth (Kinect z² noise, dropout
    holes, 2% pixel dropout), frame 2 against frame 0 at their true
    relative pose: the posed association parts from the reference's in a
    few rows, and every one of them is the ordered transform's 1-ulp
    rounding: fed the port's transformed points and normals, the
    reference's association gives the port's rows exactly.  On such depth
    a flipped row moves a converged pose by ~1e-5, and the reference's own
    pathology pass moves by up to 8.0e-5 when its depth moves by 1-2 ulp
    (tests/torch_reference_poses.py, `pathology_rounding_spread`)."""
    from tpuslam.data.synthetic import burst_trajectory, degrade_depth
    from tpuslam.geom.backproject import backproject

    Kv = Intrinsics(525.0, 525.0, 319.5, 239.5)
    gt = burst_trajectory(60, burst_start=30, burst_len=8, burst_rate=0.05)
    pts, nrm, msk = [], [], []
    for i in (0, 2):
        d = degrade_depth(render_depth(gt[i], Kv, 480, 640, seed=i),
                          seed=100 + i, z_noise_coeff=0.0019,
                          dropout_holes=3,
                          edge_dropout=0.02).astype(np.float32)
        p, m = backproject(jnp.asarray(d), Kv)
        n, g = r_normals(p, m)
        pts.append(p), nrm.append(n), msk.append(m & g)
    table = r_pack(pts[0], nrm[0], msk[0], dtype=jnp.float16)
    src, src_n = pts[1].reshape(-1, 3), nrm[1].reshape(-1, 3)
    mask = msk[1].reshape(-1)
    T = jnp.asarray(np.linalg.inv(gt[0]) @ gt[2], jnp.float32)
    ref = r_corr(rse3.transform_points(T, src), mask, table, 480, 640, Kv,
                 0.25, src_normals_in_dst=rse3.rotate_vectors(T, src_n),
                 normal_dot_min=0.5)
    ours = correspond.projective_correspond_at_pose(
        t(src), t(mask), t(src_n), t(table), 480, 640, PIntrinsics(*Kv),
        0.25, 0.5, gn_epilogue.init_carry(t(T), 12))
    x = pse3.transform_points_ordered(t(T), t(src)).numpy()
    n_rot = pse3.rotate_vectors_ordered(t(T), t(src_n)).numpy()
    ulp = np.abs(x - np.asarray(rse3.transform_points(T, src)))
    fed = r_corr(jnp.asarray(x), mask, table, 480, 640, Kv, 0.25,
                 src_normals_in_dst=jnp.asarray(n_rot), normal_dot_min=0.5)

    def differ(a):
        return ((ours.idx.numpy() != np.asarray(a.idx))
                | (ours.w.numpy() != np.asarray(a.w)))

    print(f"{int(differ(ref).sum())} of {int(mask.sum())} rows differ; "
          f"{int((ulp > 0).any(-1).sum())} points 1 ulp apart "
          f"(max {ulp.max():.2e})")
    assert differ(ref).mean() <= POSED_MISMATCH_SHARE
    assert ulp.max() <= 2.4e-7 and (ulp > 0).any()
    assert not differ(fed).any()
    for a, b in ((ours.q, fed.q), (ours.n, fed.n)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ordered_transform_rounds_each_step():
    """transform_points_ordered / rotate_vectors_ordered round every
    product and sum to float32 in the kernels' order (numpy float32)."""
    rng = np.random.default_rng(3)
    T = np.array(rse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.5, -0.4, 0.2])))
    p = rng.normal(size=(1000, 3)).astype(np.float32)
    x = np.stack([((T[i, 0] * p[:, 0] + T[i, 1] * p[:, 1])
                   + T[i, 2] * p[:, 2]) + T[i, 3] for i in range(3)], -1)
    r = np.stack([(T[i, 0] * p[:, 0] + T[i, 1] * p[:, 1])
                  + T[i, 2] * p[:, 2] for i in range(3)], -1)
    np.testing.assert_array_equal(
        pse3.transform_points_ordered(t(T), t(p)).numpy(), x)
    np.testing.assert_array_equal(
        pse3.rotate_vectors_ordered(t(T), t(p)).numpy(), r)


# --------------------------------------------------------------- gn_partials

def random_points(rng, n=5000, valid_frac=0.8):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    q = (x + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    w = (rng.uniform(size=n) < valid_frac).astype(np.float32)
    return x, q, nn.astype(np.float32), w


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("n", [1, 300, 5000, 70001])
def test_partials_fold_matches_pallas_and_gn_reduce(rng, n):
    x, q, nn, w = random_points(rng, n)
    partials = gn_partials.gn_reduce_partials_reference(
        t(x), t(q), t(nn), t(w), 0.05)
    assert partials.shape == (gn_partials.num_blocks(n), 32)
    Hp, bp, ninl, wsq, wsum = gn_partials.fold_partials(partials)
    Hr, br, ninl_r, wsq_r, wsum_r = gn_reduce_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(nn), jnp.asarray(w), 0.05,
        interpret=True)
    for a, b in ((Hp, Hr), (bp, br), (ninl, ninl_r), (wsq, wsq_r),
                 (wsum, wsum_r)):
        assert rel(a.numpy(), b) <= 1e-4
    stats = r_gn_reduce(jnp.asarray(x), jnp.asarray(q), jnp.asarray(nn),
                        jnp.asarray(w), jnp.asarray(w) > 0, 0.05)
    assert rel(Hp.numpy(), stats.H) <= 1e-4
    assert rel(bp.numpy(), stats.b) <= 1e-4
    assert rel(wsq.numpy(), stats.weighted_sq_sum) <= 1e-4
    ours = p_gn_reduce(t(x), t(q), t(nn), t(w), t(w) > 0, 0.05)
    assert rel(ours.H.numpy(), stats.H) <= 1e-4
    assert rel(ours.b.numpy(), stats.b) <= 1e-4


def test_partials_zero_rows_are_padding(rng):
    x, q, nn, w = random_points(rng, 1000)
    partials = gn_partials.gn_reduce_partials_reference(
        t(x), t(q), t(nn), t(w), 0.05)
    assert torch.all(partials[:, 30:] == 0)
    assert float(partials[:, 28].sum()) == float(w.sum())


# --------------------------------------------------------------- gn_epilogue

def lane_partials_to_rows(p) -> torch.Tensor:
    """Reference (G·32, 128) lane partials → the port's (G·128, 32) rows
    (the same sums, one block row per reference lane)."""
    p = np.asarray(p)
    g = p.shape[0] // 32
    return t(p.reshape(g, 32, 128).transpose(0, 2, 1).reshape(g * 128, 32))


def run_epilogue(lane_partials, T, **kw):
    carry = gn_epilogue.init_carry(t(T), 12)
    nvs = torch.tensor(1000.0)
    opts = dict(is_last=True, inner=2, max_iters=12, tol_sq=1e-8)
    opts.update(kw)
    return gn_epilogue.gn_epilogue(lane_partials_to_rows(lane_partials),
                                   carry, nvs, *ARGS, **opts)


def make_partials(rng, boost_b=1.0):
    x, q, nn, w = random_points(rng)
    p = np.array(gn_reduce_partials_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(nn), jnp.asarray(w), 0.05,
        interpret=True))
    row = np.arange(p.shape[0]) % 32
    p[(row >= 21) & (row < 27)] *= boost_b
    return p


@pytest.mark.parametrize("case", ["plain", "trust_region", "all_invalid",
                                  "non_finite"])
def test_epilogue_plain_matches_reference(rng, case):
    T = np.array(rse3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01])))
    if case == "all_invalid":
        p = np.zeros((32, 128), np.float32)
    else:
        p = make_partials(rng, 500.0 if case == "trust_region" else 1.0)
    if case == "non_finite":
        p[22, :] = np.inf
    T_r, H_r, dsq_r, wsq_r, ninl_r, wsum_r = r_epi(jnp.asarray(p),
                                                   jnp.asarray(T), *ARGS)
    carry, step = run_epilogue(p, T)
    T_p = step[gn_epilogue.STEP_T].reshape(4, 4).numpy()
    np.testing.assert_allclose(T_p, np.asarray(T_r), atol=1e-6)
    # H: the fold adds the same partials in another order (rel 1e-6 of |H|)
    H_r = np.asarray(H_r).reshape(36)
    scale = np.nanmax(np.abs(H_r)) if np.isfinite(H_r).any() else 0.0
    np.testing.assert_allclose(step[gn_epilogue.STEP_H].numpy(), H_r,
                               rtol=0, atol=1e-6 * max(scale, 1.0))
    assert np.all(np.isfinite(T_p))
    np.testing.assert_allclose(float(step[gn_epilogue.STEP_DELTA_SQ]),
                               float(dsq_r), rtol=1e-4, atol=1e-12)
    for i, v in ((gn_epilogue.STEP_NINL, ninl_r),
                 (gn_epilogue.STEP_WSQ, wsq_r), (gn_epilogue.STEP_WSUM, wsum_r)):
        np.testing.assert_allclose(float(step[i]), float(v), rtol=1e-5)
    if case in ("all_invalid", "non_finite"):
        np.testing.assert_allclose(T_p, T, atol=1e-6)
        assert float(step[gn_epilogue.STEP_DELTA_SQ]) == 0.0
    if case == "trust_region":
        assert float(step[gn_epilogue.STEP_DELTA_SQ]) > 0.0
    np.testing.assert_array_equal(carry[gn_epilogue.T_SLICE].numpy(),
                                  step[gn_epilogue.STEP_T].numpy())


def test_epilogue_matches_lu_solve_chain(rng):
    """Gauss elimination without pivoting reproduces the LU solve + exp."""
    x, q, nn, w = random_points(rng)
    partials = gn_partials.gn_reduce_partials_reference(
        t(x), t(q), t(nn), t(w), 0.05)
    T = pse3.exp(torch.tensor([0.02, -0.01, 0.03, 0.01, -0.02, 0.01]))
    carry = gn_epilogue.init_carry(T, 12)
    _, step = gn_epilogue.gn_epilogue(partials, carry, torch.tensor(5000.0),
                                      *ARGS, is_last=True, inner=2,
                                      max_iters=12, tol_sq=1e-8)
    stats = p_gn_reduce(t(x), t(q), t(nn), t(w), t(w) > 0, 0.05)
    delta = p_solve(stats.H, stats.b, *ARGS)
    np.testing.assert_allclose(step[gn_epilogue.STEP_T].reshape(4, 4).numpy(),
                               (pse3.exp(delta) @ T).numpy(), atol=1e-6)


def test_carry_update_semantics(rng):
    """T moves on every solve; it/stats/DONE only on the last inner solve;
    a DONE carry passes through unchanged."""
    p = make_partials(rng)
    T = np.eye(4, dtype=np.float32)
    c_mid, _ = run_epilogue(p, T, is_last=False)
    assert float(c_mid[gn_epilogue.IT]) == 0.0
    assert float(c_mid[gn_epilogue.DONE]) == 0.0
    assert float(c_mid[gn_epilogue.DELTA_SQ]) == float("inf")
    assert not np.allclose(c_mid[gn_epilogue.T_SLICE].numpy(), T.reshape(16))
    c_last, step = run_epilogue(p, T)
    assert float(c_last[gn_epilogue.IT]) == 2.0
    assert float(c_last[gn_epilogue.DONE]) == 0.0     # δ² > tol², 2 < 12
    assert float(c_last[gn_epilogue.DELTA_SQ]) == float(
        step[gn_epilogue.STEP_DELTA_SQ])
    np.testing.assert_allclose(
        float(c_last[gn_epilogue.RMS]),
        np.sqrt(float(step[gn_epilogue.STEP_WSQ])
                / max(float(step[gn_epilogue.STEP_NINL]), 1.0)), rtol=1e-6)
    c_budget, _ = run_epilogue(p, T, max_iters=2)
    assert float(c_budget[gn_epilogue.DONE]) == 1.0  # it reached max_iters
    c_tol, _ = run_epilogue(p, T, tol_sq=1.0)
    assert float(c_tol[gn_epilogue.DONE]) == 1.0     # converged
    c_again, _ = gn_epilogue.gn_epilogue(
        lane_partials_to_rows(p), c_tol, torch.tensor(1000.0), *ARGS,
        is_last=True, inner=2, max_iters=12, tol_sq=1.0)
    assert torch.equal(c_again, c_tol)
    assert float(gn_epilogue.init_carry(t(T), 0)[gn_epilogue.DONE]) == 1.0


# ------------------------------------------------------- wrappers and build

def test_cpu_tensors_take_the_plain_twins(rng):
    x, q, nn, w = random_points(rng, 100)
    counters = (correspond.counter, gn_partials.counter, gn_epilogue.counter)
    before = [(c.launches, c.plain_calls) for c in counters]
    _, table, xs, mask, n_rot = scene_pair()
    carry = gn_epilogue.init_carry(torch.eye(4), 4)
    correspond.projective_correspond_at_pose(
        t(xs), t(mask), t(n_rot), t(table), H, W, PIntrinsics(*K), 0.25, 0.5,
        carry)
    partials = gn_partials.gn_reduce_partials_at_pose(
        t(x), t(q), t(nn), t(w), carry[gn_epilogue.T_SLICE], 0.05)
    gn_epilogue.gn_epilogue(partials, carry, torch.tensor(1.0), *ARGS,
                            is_last=True, inner=2, max_iters=4, tol_sq=0.0)
    after = [(c.launches, c.plain_calls) for c in counters]
    for (l0, p0), (l1, p1) in zip(before, after):
        assert l1 == l0 and p1 == p0 + 1


def test_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        correspond.projective_correspond_at_pose(
            x, torch.empty(8, dtype=torch.bool, device=meta), x,
            torch.empty((H * W, 8), dtype=torch.float16, device=meta), H, W,
            PIntrinsics(*K), 0.25, 0.5, torch.empty(64, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        gn_partials.gn_reduce_partials_at_pose(
            x, x, x, torch.empty(8, device=meta), torch.empty(16, device=meta),
            0.05)
    with pytest.raises(ValueError, match="no kernel"):
        gn_epilogue.gn_epilogue(torch.empty((1, 32), device=meta),
                                torch.empty(64, device=meta),
                                torch.empty((), device=meta), *ARGS,
                                is_last=True, inner=2, max_iters=4,
                                tol_sq=0.0)


def test_require_rejects_what_kernels_do_not_take():
    a = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        _build.require(a.double(), "a", dtype=torch.float32)
    with pytest.raises(ValueError):
        _build.require(a, "a", dtype=torch.float32, shape=(4, 2))
    with pytest.raises(ValueError):
        _build.require(a.t(), "a", dtype=torch.float32)
    _build.require(a, "a", dtype=torch.float32, shape=(4, 3))


def test_find_nvcc_error_is_clear(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc at /usr/local/cuda/bin")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_sources_note_what_they_replace():
    for name, ref in (("correspond.cu", "tpuslam/kernels/correspond.py"),
                      ("gn_partials.cu", "tpuslam/kernels/pallas_gn.py"),
                      ("gn_epilogue.cu", "tpuslam/kernels/pallas_epilogue.py"),
                      ("gn_fused.cu", "tpuslam/kernels/gn_fused.py")):
        text = (PKG / "csrc" / name).read_text()
        head = text[:3000]
        assert "Replaces:" in head and ref in head, name
        assert "What bounds it on the H100" in head, name
        assert "What the design does about it" in head, name
        if name == "gn_fused.cu":
            # one launch a solve: the last block folds after a ticket that
            # resets itself, as gn_step.cu's
            assert "atomicInc(ticket, gridDim.x - 1)" in text, name
        else:
            assert "atomic" not in text.replace("No atomics", ""), name
    assert set(_build.SOURCES) == {p.name for p in (PKG / "csrc").glob("*.cu")}


def test_signatures_match_the_c_entry_points():
    """ctypes passes what `_SIGNATURES` lists, so each entry point's list
    has one type a C parameter: a pointer for `void*`, an int for `int`, a
    float for `float`, in order."""
    kinds = {"void*": _build._P, "int": _build._I, "float": _build._F}
    found = {}
    for src in _build.SOURCES:
        text = (PKG / "csrc" / src).read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                words = p.replace("const ", "").replace("*", "* ").split()
                types.append(kinds["".join(words[:-1])] if words else None)
            found[name] = [t for t in types if t is not None]
    assert found == _build._SIGNATURES


def test_port_imports_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tpuslam)(\.|\s|$)",
                         re.MULTILINE)
    files = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    for f in files:
        assert not pattern.search(f.read_text()), f
