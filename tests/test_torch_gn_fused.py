"""The port's fused GN step (tpuslam_torch/kernels/gn_fused.py) and its ICP
loop against the reference.

On the CPU `gn_fused_step` runs its plain twin.  Its per-point terms
(`fused_terms`, `gn_fused_reference`) are held to the reference's oracle
`gn_fused_reference` and to its Pallas kernel in interpret mode, on the
same numpy inputs as tests/test_gn_fused.py: a bumpy organized target with
invalid rows and outliers, gates at T_gate ≠ T_res, the normal gate
disabled (threshold -2) and float16 rows.  Tolerances: the validity sum
(Σvalid) is exact; H, b and Σw·r² agree to 1e-5 relative (same elementwise
formulation, summed in another order).  The whole solve — the row index
from the kernel's own projection, the gather, the sums, the fold, the
damped solve and the carry — is held to the reference's fused solve at
the three levels of a frame pair (below).  The fused ICP loop
(`align_frames` with `fused_gn=True`) must give the reference's iteration
count and convergence exactly and T within 5e-5, the bound of
tests/test_torch_icp.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.icp as ricp
import tpuslam_torch.icp as picp
from tpuslam.config import ICPConfig, Intrinsics
from tpuslam.data.synthetic import render_depth
from tpuslam.geom import se3 as rse3
from tpuslam.geom.backproject import backproject as r_backproject
from tpuslam.geom.backproject import project as r_project
from tpuslam.geom.normals import organized_normals as r_normals
from tpuslam.kernels.correspond import pack_organized_target as r_pack
from tpuslam.kernels.gn_fused import gn_fused_pallas as r_pallas
from tpuslam.kernels.gn_fused import gn_fused_reference as r_ref
from tpuslam.kernels.gn_reduce import solve_gn_step as r_solve
from tpuslam_torch import config as pc
from tpuslam_torch.geom.backproject import backproject as p_backproject
from tpuslam_torch.geom.normals import organized_normals as p_normals
from tpuslam_torch.kernels.correspond import pack_organized_target
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels import gn_fused, gn_partials, gn_step

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

H, W = 24, 32
K = Intrinsics(20.0, 20.0, W / 2 - 0.5, H / 2 - 0.5)
PK = pc.Intrinsics(*K)
T_GATE = [0.02, -0.01, 0.015, 0.01, -0.02, 0.005]
T_STEP = [0.0, 0.01, 0.0, 0.005, 0.0, -0.01]
REL = 1e-5
ARGS = (1e-6, 1e-4, 0.3, 0.3)   # damping, damping_abs, max_trans, max_rot


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def organized_scene(seed=0):
    """tests/test_gn_fused.py's scene: bumpy organized target (two invalid
    rows) + a perturbed, 90%-masked source with 17 wild outliers."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    z = 2.0 + 0.2 * np.sin(u / 5.0) * np.cos(v / 4.0)
    x = (u - K.cx) / K.fx * z
    y = (v - K.cy) / K.fy * z
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    n = np.zeros_like(pts)
    n[1:-1, 1:-1] = np.cross(pts[1:-1, 2:] - pts[1:-1, :-2],
                             pts[2:, 1:-1] - pts[:-2, 1:-1])
    nn = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nn > 1e-9, n / np.maximum(nn, 1e-9), 0.0).astype(np.float32)
    mask = np.ones((H, W), bool)
    mask[:2] = False
    packed = np.asarray(r_pack(jnp.asarray(pts), jnp.asarray(n),
                               jnp.asarray(mask)))
    m = H * W
    src = (pts.reshape(m, 3)
           + rng.normal(scale=0.01, size=(m, 3))).astype(np.float32)
    src[:17] += 5.0
    return packed, src, n.reshape(m, 3), rng.uniform(size=m) < 0.9


def poses(same: bool):
    Tg = np.asarray(rse3.exp(jnp.asarray(T_GATE)), np.float32)
    Tr = Tg if same else (np.asarray(rse3.exp(jnp.asarray(T_STEP)))
                          @ Tg).astype(np.float32)
    return Tg, Tr


def flat_rows(packed, src, Tg):
    """The association index at T_gate, as the reference computes it."""
    uv, _ = r_project(rse3.transform_points(jnp.asarray(Tg),
                                            jnp.asarray(src)), K)
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    return np.asarray(jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1))


def assert_sums_close(ours, ref):
    (Hp, bp, ip, wp), (Hr, br, ir, wr) = ours, ref
    scale = float(np.abs(np.asarray(Hr)).max())
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hr), rtol=REL,
                               atol=REL * scale)
    np.testing.assert_allclose(bp.numpy(), np.asarray(br), rtol=REL,
                               atol=REL * float(np.abs(np.asarray(br)).max()))
    assert float(ip) == float(ir)
    assert float(wp) == pytest.approx(float(wr), rel=REL)


CASES = {
    "same_pose": dict(same=True, ndmin=0.5, f16=False),
    "gate_ne_res": dict(same=False, ndmin=0.5, f16=False),
    "normal_gate_off": dict(same=False, ndmin=-2.0, f16=False),
    "f16_rows": dict(same=False, ndmin=0.5, f16=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_reference_oracle(case):
    c = CASES[case]
    packed, src, sn, m = organized_scene()
    Tg, Tr = poses(c["same"])
    rows = packed[flat_rows(packed, src, Tg)]
    if c["f16"]:
        rows = rows.astype(np.float16)
    ref = r_ref(jnp.asarray(src), jnp.asarray(sn), jnp.asarray(m),
                jnp.asarray(rows), jnp.asarray(Tg), jnp.asarray(Tr), K, W, H,
                0.25, c["ndmin"], 0.05)
    ours = gn_fused.gn_fused_reference(t(src), t(sn), t(m), t(rows), t(Tg),
                                       t(Tr), PK, W, H, 0.25, c["ndmin"],
                                       0.05)
    assert_sums_close(ours, ref)
    assert float(ref[2]) > 100          # the scene exercises the gates


@pytest.mark.parametrize("case", ["gate_ne_res", "f16_rows"])
def test_twin_matches_pallas_interpret(case):
    c = CASES[case]
    packed, src, sn, m = organized_scene(seed=1)
    Tg, Tr = poses(c["same"])
    rows = packed[flat_rows(packed, src, Tg)]
    if c["f16"]:
        rows = rows.astype(np.float16)
    ref = r_pallas(jnp.asarray(src), jnp.asarray(sn), jnp.asarray(m),
                   jnp.asarray(rows), jnp.asarray(Tg), jnp.asarray(Tr), K, W,
                   H, 0.25, c["ndmin"], 0.05, interpret=True)
    ours = gn_fused.gn_fused_reference(t(src), t(sn), t(m), t(rows), t(Tg),
                                       t(Tr), PK, W, H, 0.25, c["ndmin"],
                                       0.05)
    assert_sums_close(ours, ref)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_partials_gather_flat_and_fold(dtype):
    """The fused step's rows before its fold (`fused_rows`): it computes
    the association's row itself (here the reference's index, point for
    point), and its (num_blocks, 32) rows in the kernel's grouping fold to
    the oracle's sums."""
    packed, src, sn, m = organized_scene(seed=2)
    Tg, Tr = poses(False)
    flat = flat_rows(packed, src, Tg)
    table = packed.astype(dtype)
    own = gn_fused.association_rows_ordered(t(Tg), t(src), PK, H, W)
    np.testing.assert_array_equal(own.numpy(), flat)
    nb = gn_step.num_blocks(src.shape[0])
    rows = gn_fused.fused_rows(t(src), t(sn), t(m), t(table), t(Tg), t(Tr),
                               PK, W, H, 0.25, 0.5, 0.05, nb)
    assert rows.shape == (nb, 32)
    assert torch.all(rows[:, 30:] == 0)
    Hm, b, ninl, wsq, _ = gn_partials.fold_partials(rows)
    ref = r_ref(jnp.asarray(src), jnp.asarray(sn), jnp.asarray(m),
                jnp.asarray(table[flat]), jnp.asarray(Tg), jnp.asarray(Tr),
                K, W, H, 0.25, 0.5, 0.05)
    assert_sums_close((Hm, b, ninl, wsq), ref)


def test_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        gn_fused.gn_fused_step(
            x, x, torch.empty(8, dtype=torch.bool, device=meta),
            torch.empty((H * W, 8), dtype=torch.float16, device=meta),
            torch.empty(64, device=meta), torch.empty(12, device=meta), True,
            PK, W, H, 0.25, 0.5, 0.05, torch.empty((), device=meta), *ARGS,
            True, 2, 12, 1e-8)


# ------------------------------------------------------------ fused ICP loop

FH, FW = 120, 160
FK = Intrinsics(160.0, 160.0, 79.5, 59.5)


def frames(T_world_cam):
    d = render_depth(np.asarray(T_world_cam, np.float64), FK, FH, FW)
    p, m = r_backproject(jnp.asarray(d), FK, depth_min=0.1, depth_max=8.0)
    n, g = r_normals(p, m)
    pp, mp = p_backproject(torch.as_tensor(d), pc.Intrinsics(*FK),
                           depth_min=0.1, depth_max=8.0)
    np_, gp = p_normals(pp, mp)
    return ricp.Frame(p, n, m & g), picp.Frame(pp, np_, mp & gp)


@pytest.fixture(scope="module")
def pair():
    Tb = np.asarray(rse3.exp(jnp.asarray([0.03, -0.02, 0.02, 0.015, 0.025,
                                          -0.01])))
    return frames(np.eye(4)), frames(Tb), Tb


ICP_CASES = {
    "default": {},
    "inner_1_normal_gate_off": {"inner_steps": 1, "normal_dot_min": 0.0},
    "float32_table": {"packed_dtype": "float32", "finest_subsample": 1},
}


@pytest.mark.parametrize("case", list(ICP_CASES))
def test_align_frames_fused_matches_reference(pair, case):
    (ra, pa), (rb, pb), Tb = pair
    kw = dict(pyramid_levels=3, iters_per_level=(12, 8, 8),
              max_corr_dist=0.25, huber_delta=0.05, fused_gn=True)
    kw.update(ICP_CASES[case])
    cfg = ICPConfig(**kw)
    rr = ricp.align_frames(ricp.build_pyramid(rb, 3),
                           ricp.build_pyramid(ra, 3), FK, jnp.eye(4), cfg)
    pr = picp.align_frames(picp.build_pyramid(pb, 3),
                           picp.build_pyramid(pa, 3), pc.Intrinsics(*FK),
                           torch.eye(4),
                           pc.ICPConfig(**dataclasses.asdict(cfg)))
    assert int(pr.iters) == int(rr.iters)
    assert bool(pr.converged) == bool(rr.converged)
    np.testing.assert_allclose(pr.T.numpy(), np.asarray(rr.T), atol=5e-5)
    np.testing.assert_allclose(float(pr.inlier_fraction),
                               float(rr.inlier_fraction), atol=1e-4)
    np.testing.assert_allclose(pr.T.numpy(), Tb, atol=4e-3)


# ------------------------------------------------- one fused solve, one launch
#
# `gn_fused_step` on the CPU runs its twin: the association's row from the
# kernel's own projection at the gate pose, the gather, the gates, the
# residual at the carry's pose, the 30 sums in the kernel's grouping, the
# fold and the epilogue.  It is held to the reference's fused solve
# (tpuslam/icp.py:257-291): the reference's index at T_gate, the gather,
# `gn_fused_reference`, `solve_gn_step` and `se3.exp(δ) @ T_res`, on the
# same numpy inputs at the three levels of the frame pair.  Tolerances, as
# tests/test_torch_gn_step.py's: T within 1e-5 and H within 1e-6 of max |H|
# (the same terms summed in another order); Σvalid, `it` and DONE exactly.
# The in-kernel index agrees with the reference's for every point of these
# levels (test_in_kernel_flat_matches_reference_index), so both solve the
# same system.

STEP = [0.004, -0.003, 0.002, 0.003, -0.002, 0.001]   # one GN update
TOL_SQ = 1e-8


def level_inputs(pair, level: int, table: str):
    """Level `level` as numpy: frame b's source cloud, frame a's table, the
    level's intrinsics and shape, and a gate pose near the pair's motion."""
    (_, pa), (_, pb), Tb = pair
    src = picp.build_pyramid(pb, 3)[level].as_cloud()
    tgt = picp.build_pyramid(pa, 3)[level]
    packed = pack_organized_target(
        tgt.points, tgt.normals, tgt.mask,
        dtype=torch.float16 if table == "f16" else torch.float32)
    h, w = tgt.mask.shape
    Kl = FK.scaled(1.0 / 2 ** level)
    Tg = (np.asarray(rse3.exp(jnp.asarray([0.003, 0.002, -0.002, 0.002,
                                             -0.001, 0.002])))
          @ Tb).astype(np.float32)
    return ([a.numpy() for a in src], packed.numpy(), Kl, h, w, Tg)


def reference_index(pts, Tg, Kl, h, w):
    """tpuslam/icp.py:257-262: transform, project, round, clip."""
    uv, _ = r_project(rse3.transform_points(jnp.asarray(Tg),
                                            jnp.asarray(pts)), Kl)
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    return np.asarray(jnp.clip(vi, 0, h - 1) * w + jnp.clip(ui, 0, w - 1))


def reference_solve(src, packed, Kl, h, w, Tg, Tr, ndmin):
    """The reference's fused solve: (H, num_inliers, T_new, δ²)."""
    pts, nrm, m = src
    flat = reference_index(pts, Tg, Kl, h, w)
    Hr, br, ninl, _ = r_ref(jnp.asarray(pts), jnp.asarray(nrm),
                            jnp.asarray(m), jnp.asarray(packed[flat]),
                            jnp.asarray(Tg), jnp.asarray(Tr), Kl, w, h, 0.25,
                            ndmin, 0.05)
    delta = r_solve(Hr, br, *ARGS)
    T_new = rse3.exp(delta) @ jnp.asarray(Tr)
    return (np.asarray(Hr), float(ninl), np.asarray(T_new),
            float(jnp.sum(delta * delta)))


def port_step(src, packed, Kl, h, w, carry, gate, is_first, ndmin,
              is_last=True):
    pts, nrm, m = (t(a) for a in src)
    return gn_fused.gn_fused_step(
        pts, nrm, m, t(packed), carry, gate, is_first, pc.Intrinsics(*Kl), w,
        h, 0.25, ndmin, 0.05, torch.sum(m.to(torch.float32)), *ARGS, is_last,
        2, 12, TOL_SQ)


def assert_solve_close(carry, ref, it0=0.0):
    Hr, ninl, T_new, dsq = ref
    np.testing.assert_allclose(carry[ep.T_SLICE].reshape(4, 4).numpy(), T_new,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(carry[ep.H_SLICE].numpy(), Hr.reshape(36),
                               rtol=0, atol=1e-6 * float(np.abs(Hr).max()))
    assert float(carry[ep.NUM_INLIERS]) == ninl
    assert float(carry[ep.IT]) == it0 + 2
    assert float(carry[ep.DONE]) == float(not (it0 + 2 < 12 and dsq > TOL_SQ))


STEP_CASES = {"f16": ("f16", 0.5), "f32": ("f32", 0.5),
              "normal_gate_off": ("f16", -2.0)}


@pytest.mark.parametrize("first", [True, False],
                         ids=["is_first", "gate_ne_carry"])
@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("level", [0, 1, 2])
def test_step_twin_matches_reference_solve(pair, level, case, first):
    """`is_first`: the gate pose is the carry's T (the buffer, full of NaN,
    is not read) and is stored in the buffer; otherwise the gate pose is
    the buffer's and the carry's T is one GN update past it."""
    table, ndmin = STEP_CASES[case]
    src, packed, Kl, h, w, Tg = level_inputs(pair, level, table)
    Tr = Tg if first else (np.asarray(rse3.exp(jnp.asarray(STEP)))
                           @ Tg).astype(np.float32)
    carry = ep.init_carry(t(Tr), 12)
    gate = (torch.full((12,), float("nan")) if first
            else t(Tg[:3].reshape(12)))
    port_step(src, packed, Kl, h, w, carry, gate, first, ndmin)
    assert_solve_close(carry, reference_solve(src, packed, Kl, h, w, Tg, Tr,
                                              ndmin))
    np.testing.assert_array_equal(gate.numpy(), Tg[:3].reshape(12))
    assert float(carry[ep.NUM_INLIERS]) > 0.3 * float(src[2].sum())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_in_kernel_flat_matches_reference_index(pair, level):
    """The kernel's row index (its ordered transform and the projection
    that gates the point) against the reference's (XLA's transform and
    projection, tpuslam/icp.py:257-262): the share of points whose row
    differs stays at most 1e-3 (ROADMAP.md Queue 3 records the count)."""
    (pts, _, _), _, Kl, h, w, Tg = level_inputs(pair, level, "f16")
    own = gn_fused.association_rows_ordered(t(Tg), t(pts),
                                            pc.Intrinsics(*Kl), h, w)
    differ = int((own.numpy() != reference_index(pts, Tg, Kl, h, w)).sum())
    print(f"level {level}: {differ} of {pts.shape[0]} rows differ")
    assert differ <= 1e-3 * pts.shape[0]


def test_gate_buffer_and_carry_follow_one_outer_iteration(pair):
    """One outer iteration of two solves against the reference's loop body
    (tpuslam/icp.py:252-301): the first solve stores state.T in the buffer
    and moves the carry's T to the first T_new; the second gates at the
    buffer's pose and ends the iteration (it, H, Σvalid, DONE).  With DONE
    set a solve writes nothing."""
    src, packed, Kl, h, w, T0 = level_inputs(pair, 1, "f16")
    carry = ep.init_carry(t(T0), 12)
    gate = torch.full((12,), float("nan"))
    port_step(src, packed, Kl, h, w, carry, gate, True, 0.5, is_last=False)
    np.testing.assert_array_equal(gate.numpy(), T0[:3].reshape(12))
    _, _, T1, _ = reference_solve(src, packed, Kl, h, w, T0, T0, 0.5)
    np.testing.assert_allclose(carry[ep.T_SLICE].reshape(4, 4).numpy(), T1,
                               rtol=0, atol=1e-5)
    assert float(carry[ep.IT]) == 0.0 and float(carry[ep.DONE]) == 0.0
    # the reference's second solve: gates at state.T, residuals at T_new
    T1_port = carry[ep.T_SLICE].reshape(4, 4).numpy().copy()
    port_step(src, packed, Kl, h, w, carry, gate, False, 0.5)
    np.testing.assert_array_equal(gate.numpy(), T0[:3].reshape(12))
    assert_solve_close(carry, reference_solve(src, packed, Kl, h, w, T0,
                                              T1_port, 0.5))

    done = ep.init_carry(t(T0), 0)
    full = torch.full((12,), 3.0)
    before = (done.clone(), full.clone())
    for first in (True, False):
        port_step(src, packed, Kl, h, w, done, full, first, 0.5)
    assert torch.equal(done, before[0]) and torch.equal(full, before[1])
