"""The port's fused GN step (tpuslam_torch/kernels/gn_fused.py) and its ICP
loop against the reference.

On the CPU `gn_fused_partials` runs its plain twin; the twin is held here
to the reference's oracle `gn_fused_reference` and to its Pallas kernel in
interpret mode, on the same numpy inputs as tests/test_gn_fused.py: a bumpy
organized target with invalid rows and outliers, gates at T_gate ≠ T_res,
the normal gate disabled (threshold -2) and float16 rows.  Tolerances:
the validity sum (Σvalid) is exact; H, b and Σw·r² agree to 1e-5 relative
(same elementwise formulation, summed in another order).  The fused ICP
loop (`align_frames` with `fused_gn=True`) must give the reference's
iteration count and convergence exactly and T within 5e-5, the bound of
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
from tpuslam_torch import config as pc
from tpuslam_torch.geom.backproject import backproject as p_backproject
from tpuslam_torch.geom.normals import organized_normals as p_normals
from tpuslam_torch.kernels import gn_fused, gn_partials

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
    """`gn_fused_partials` on the CPU: gathers packed[flat] itself, and its
    (num_blocks, 32) table folds to the oracle's sums."""
    packed, src, sn, m = organized_scene(seed=2)
    Tg, Tr = poses(False)
    flat = flat_rows(packed, src, Tg)
    table = packed.astype(dtype)
    before = gn_fused.counter.plain_calls
    partials = gn_fused.gn_fused_partials(
        t(src), t(sn), t(m), t(table), t(flat.astype(np.int32)),
        t(Tg).reshape(16), t(Tr).reshape(16), PK, W, H, 0.25, 0.5, 0.05)
    assert gn_fused.counter.plain_calls == before + 1
    assert partials.shape == (gn_partials.num_blocks(src.shape[0]), 32)
    assert torch.all(partials[:, 30:] == 0)
    Hm, b, ninl, wsq, _ = gn_partials.fold_partials(partials)
    ref = r_ref(jnp.asarray(src), jnp.asarray(sn), jnp.asarray(m),
                jnp.asarray(table[flat]), jnp.asarray(Tg), jnp.asarray(Tr),
                K, W, H, 0.25, 0.5, 0.05)
    assert_sums_close((Hm, b, ninl, wsq), ref)


def test_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        gn_fused.gn_fused_partials(
            x, x, torch.empty(8, dtype=torch.bool, device=meta),
            torch.empty((H * W, 8), dtype=torch.float16, device=meta),
            torch.empty(8, dtype=torch.int32, device=meta),
            torch.empty(16, device=meta), torch.empty(16, device=meta), PK,
            W, H, 0.25, 0.5, 0.05)


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
