"""The port's coarse-to-fine ICP (tpuslam_torch/icp.py) against the
reference's on the frame pairs of tests/test_icp_synthetic.py.

The reference runs its kernel path in interpret mode
(TPUSLAM_FORCE_PALLAS=1): reduce partials → epilogue with Gauss
elimination without pivoting, the algorithm the port's kernels implement.
The port runs its plain twins on the CPU with the fixed-budget loop and
the device-side DONE flag; iteration counts and convergence must be
identical and the pose within 5e-5 (the bound tests/test_gn_epilogue.py
uses for the kernel path against the jnp path).
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
from tpuslam.geom.normals import organized_normals as r_normals
from tpuslam_torch import config as pc
from tpuslam_torch.geom.backproject import backproject as p_backproject
from tpuslam_torch.geom.normals import organized_normals as p_normals

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
TAU = [0.03, -0.02, 0.02, 0.015, 0.025, -0.01]


def frames(T_world_cam):
    """The same rendered depth as a reference Frame and a port Frame."""
    d = render_depth(np.asarray(T_world_cam, np.float64), K, H, W)
    p, m = r_backproject(jnp.asarray(d), K, depth_min=0.1, depth_max=8.0)
    n, g = r_normals(p, m)
    pp, mp = p_backproject(torch.as_tensor(d), pc.Intrinsics(*K),
                           depth_min=0.1, depth_max=8.0)
    np_, gp = p_normals(pp, mp)
    return ricp.Frame(p, n, m & g), picp.Frame(pp, np_, mp & gp)


@pytest.fixture(scope="module")
def pair():
    Tb = np.asarray(rse3.exp(jnp.asarray(TAU)))
    return frames(np.eye(4)), frames(Tb), Tb


CASES = {
    "frame_to_frame": {},
    "subsample_2": {"finest_subsample": 2},
    "subsample_4": {"finest_subsample": 4},
    "subsample_1": {"finest_subsample": 1},
    "inner_per_level": {"inner_steps_per_level": (2, 4, 4)},
    "inner_1": {"inner_steps": 1},
    "inner_3_odd_budget": {"inner_steps": 3, "iters_per_level": (11, 7, 5)},
    "tol_per_level": {"tol_delta_per_level": (1e-4, 1e-3, 2e-3)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_align_frames_matches_reference(pair, monkeypatch, case):
    monkeypatch.setenv("TPUSLAM_FORCE_PALLAS", "1")
    (ra, pa), (rb, pb), Tb = pair
    kw = dict(pyramid_levels=3, iters_per_level=(12, 8, 8),
              max_corr_dist=0.25, huber_delta=0.05)
    kw.update(CASES[case])
    cfg = ICPConfig(**kw)
    rr = ricp.align_frames(ricp.build_pyramid(rb, 3), ricp.build_pyramid(ra, 3),
                           K, jnp.eye(4), cfg)
    pr = picp.align_frames(picp.build_pyramid(pb, 3), picp.build_pyramid(pa, 3),
                           pc.Intrinsics(*K), torch.eye(4),
                           pc.ICPConfig(**dataclasses.asdict(cfg)))
    assert int(pr.iters) == int(rr.iters)
    assert bool(pr.converged) == bool(rr.converged)
    np.testing.assert_allclose(pr.T.numpy(), np.asarray(rr.T), atol=5e-5)
    np.testing.assert_allclose(float(pr.rms), float(rr.rms), rtol=1e-3)
    np.testing.assert_allclose(float(pr.inlier_fraction),
                               float(rr.inlier_fraction), atol=1e-4)
    np.testing.assert_allclose(pr.H.numpy(), np.asarray(rr.H),
                               rtol=1e-3, atol=1e-3 * np.abs(rr.H).max())
    # and the pose is the true one (the reference's own bound)
    np.testing.assert_allclose(pr.T.numpy(), Tb, atol=4e-3)


@pytest.mark.parametrize("max_iters", [0, 1, 5])
def test_single_level_budget_matches_reference(pair, monkeypatch, max_iters):
    """One level, tiny budgets: the fixed-budget loop stops exactly where
    the reference's while-loop does (max_iters 0 runs nothing)."""
    monkeypatch.setenv("TPUSLAM_FORCE_PALLAS", "1")
    (ra, pa), (rb, pb), _ = pair
    cfg = ICPConfig(pyramid_levels=1, iters_per_level=(max_iters,),
                    max_corr_dist=0.25, huber_delta=0.05)
    T0 = rse3.exp(jnp.asarray([0.01, 0.0, 0.0, 0.0, 0.01, 0.0]))
    rr = ricp.align_frames((rb,), (ra,), K, T0, cfg)
    pr = picp.align_frames((pb,), (pa,), pc.Intrinsics(*K),
                           torch.as_tensor(np.array(T0)),
                           pc.ICPConfig(**dataclasses.asdict(cfg)))
    assert int(pr.iters) == int(rr.iters)
    assert bool(pr.converged) == bool(rr.converged)
    np.testing.assert_allclose(pr.T.numpy(), np.asarray(rr.T), atol=5e-5)


def test_pack_and_select_source_shapes(pair):
    (_, pa), _, _ = pair
    cfg = pc.ICPConfig()
    pyr = picp.build_pyramid(pa, 3)
    packed = picp.pack_pyramid(pyr, cfg)
    assert [t.shape for t in packed] == [(H * W, 8), (H * W // 4, 8),
                                         (H * W // 16, 8)]
    assert all(t.dtype == torch.float16 for t in packed)
    assert picp.select_level_source(pyr, 0, cfg).points.shape == (H // 2 * W, 3)
    assert picp.select_level_source(pyr, 1, cfg).points.shape == (H * W // 4, 3)
    with pytest.raises(ValueError, match="share pyramid shapes"):
        picp.align_frames_packed(pyr, packed[::-1], pc.Intrinsics(*K),
                                 torch.eye(4), cfg)
    # fused_gn runs (tests/test_torch_gn_fused.py holds it to the reference)
    fused, plain = (picp.align_frames_packed(
        pyr, packed, pc.Intrinsics(*K), torch.eye(4),
        dataclasses.replace(cfg, fused_gn=f)) for f in (True, False))
    np.testing.assert_allclose(fused.T.numpy(), plain.T.numpy(), atol=5e-5)


def test_outer_iteration_is_one_association_and_the_steps(pair, monkeypatch):
    """`_icp_loop` runs each outer iteration as one posed association (the
    transform inside it) and `inner` GN steps: no se3 product is called,
    and the CPU twins count one association and two steps an iteration
    until DONE."""
    from tpuslam_torch.kernels import correspond, gn_step

    def no_product(*a, **k):
        raise AssertionError("the ICP loop called an se3 product")

    (_, pa), (_, pb), Tb = pair
    cfg = pc.ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                       max_corr_dist=0.25, huber_delta=0.05)
    pyr_a, pyr_b = picp.build_pyramid(pa, 3), picp.build_pyramid(pb, 3)
    packed = picp.pack_pyramid(pyr_a, cfg)
    monkeypatch.setattr(picp.se3, "transform_points", no_product)
    monkeypatch.setattr(picp.se3, "rotate_vectors", no_product)
    c0, s0 = correspond.counter.plain_calls, gn_step.counter.plain_calls
    res = picp.align_frames_packed(pyr_b, packed, pc.Intrinsics(*K),
                                   torch.eye(4), cfg)
    assoc = correspond.counter.plain_calls - c0
    assert gn_step.counter.plain_calls - s0 == 2 * assoc
    assert 3 <= assoc <= 14       # ⌈12/2⌉ + ⌈8/2⌉ + ⌈8/2⌉ at most
    np.testing.assert_allclose(res.T.numpy(), Tb, atol=4e-3)
