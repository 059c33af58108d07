"""The merged GN step (tpuslam_torch/kernels/gn_step.py) against the
reference's GN step (tpuslam/icp.py:129-139): x = se3.transform_points(T,
points), `gn_reduce_partials_pallas` in interpret mode, then the
epilogue (`gn_epilogue_reference`, and `gn_epilogue_pallas` in interpret
mode), with the ICP loop's carry update worked out here.

On the CPU `gn_step` runs its plain twin `gn_step_reference`; the CUDA
kernel is held to that twin on the card by tests/test_torch_cuda.py.
Tolerances: T within 1e-5 and H within 1e-6 of max |H| (the reference
adds the same terms in another order), δ² within 1e-4 relative (a
difference of squares of a solved step, as in tests/test_torch_kernels.py);
Σvalid, `it` and DONE exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.geom.se3 as rse3
from tpuslam.kernels.pallas_epilogue import gn_epilogue_pallas
from tpuslam.kernels.pallas_epilogue import gn_epilogue_reference as r_epi
from tpuslam.kernels.pallas_gn import gn_reduce_partials_pallas
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels import gn_partials, gn_step

# One intra-op thread per worker process (the tests run under xdist).
torch.set_num_threads(1)

HUBER = 0.05
ARGS = (1e-6, 1e-4, 0.3, 0.3)   # damping, damping_abs, max_trans, max_rot
INNER, MAX_ITERS, TOL_SQ = 2, 12, 1e-8
TAU = [0.02, -0.01, 0.03, 0.01, -0.02, 0.01]


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def make_inputs(rng, n=5000, valid_frac=0.8):
    """Untransformed source points, the pose, and an association at it."""
    T = np.array(rse3.exp(jnp.asarray(TAU, jnp.float32)))
    p = rng.normal(size=(n, 3)).astype(np.float32)
    x = p.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    q = (x + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    w = (rng.uniform(size=n) < valid_frac).astype(np.float32)
    return p, q, nn.astype(np.float32), w, T


def reference_step(p, q, nn, w, T, pallas_epilogue=False):
    x = rse3.transform_points(jnp.asarray(T), jnp.asarray(p))
    lanes = gn_reduce_partials_pallas(x, jnp.asarray(q), jnp.asarray(nn),
                                      jnp.asarray(w), HUBER, interpret=True)
    if pallas_epilogue:
        out = gn_epilogue_pallas(lanes, jnp.asarray(T), *ARGS, interpret=True)
    else:
        out = r_epi(lanes, jnp.asarray(T), *ARGS)
    return [np.asarray(v) for v in out]


def run_step(p, q, nn, w, carry, is_last=True, **kw):
    return gn_step.gn_step_reference(
        t(p), t(q), t(nn), t(w), carry, torch.tensor(float(w.sum())), HUBER,
        *ARGS, is_last, INNER, kw.pop("max_iters", MAX_ITERS),
        kw.pop("tol_sq", TOL_SQ), **kw)


def check_against_reference(carry, carry0, ref, is_last):
    T_r, H_r, dsq_r, _wsq_r, ninl_r, _ = ref
    np.testing.assert_allclose(carry[ep.T_SLICE].reshape(4, 4).numpy(), T_r,
                               rtol=0, atol=1e-5)
    if not is_last:
        keep = torch.ones(ep.CARRY_SIZE, dtype=torch.bool)
        keep[ep.T_SLICE] = False
        assert torch.equal(carry[keep], carry0[keep])
        return
    H_r = H_r.reshape(36)
    scale = np.nanmax(np.abs(H_r)) if np.isfinite(H_r).any() else 0.0
    np.testing.assert_allclose(carry[ep.H_SLICE].numpy(), H_r, rtol=0,
                               atol=1e-6 * max(scale, 1.0))
    np.testing.assert_allclose(float(carry[ep.DELTA_SQ]), float(dsq_r),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_array_equal(float(carry[ep.NUM_INLIERS]),
                                  float(ninl_r))
    it = float(carry0[ep.IT]) + INNER
    assert float(carry[ep.IT]) == it
    done = not (it < MAX_ITERS and float(dsq_r) > TOL_SQ)
    assert float(carry[ep.DONE]) == float(done)


@pytest.mark.parametrize("is_last", [False, True], ids=["mid", "last"])
@pytest.mark.parametrize("n", [200, 5000, 70001])
def test_step_twin_matches_reference_step(rng, is_last, n):
    """n = 200 is a one-block input; 70,001 fills the default grid."""
    p, q, nn, w, T = make_inputs(rng, n)
    carry0 = ep.init_carry(t(T), MAX_ITERS)
    carry = run_step(p, q, nn, w, carry0, is_last)
    assert gn_step.num_blocks(n) == (1 if n == 200 else
                                     min(-(-n // 256), gn_step.MAX_BLOCKS))
    check_against_reference(carry, carry0, reference_step(p, q, nn, w, T),
                            is_last)


def test_step_twin_matches_pallas_epilogue(rng):
    p, q, nn, w, T = make_inputs(rng)
    carry0 = ep.init_carry(t(T), MAX_ITERS)
    carry = run_step(p, q, nn, w, carry0)
    check_against_reference(
        carry, carry0, reference_step(p, q, nn, w, T, pallas_epilogue=True),
        True)


def test_done_at_entry_leaves_the_carry(rng):
    p, q, nn, w, T = make_inputs(rng)
    carry = ep.init_carry(t(T), 0)            # budget 0: DONE set
    before = carry.clone()
    assert float(carry[ep.DONE]) == 1.0
    out = gn_step.gn_step(t(p), t(q), t(nn), t(w), carry,
                          torch.tensor(float(w.sum())), HUBER, *ARGS, True,
                          INNER, MAX_ITERS, TOL_SQ)
    assert out is carry
    assert torch.equal(carry, before)


def test_non_finite_sum_gives_nan_system_and_zero_step(rng):
    """One infinite target point: its 0·inf terms make sums NaN; the
    reference reads every other sum as NaN too, so H is all NaN, the step
    is zero and the pose stays; δ² = 0 ends the loop."""
    p, q, nn, w, T = make_inputs(rng)
    q[5] = np.inf
    carry0 = ep.init_carry(t(T), MAX_ITERS)
    carry = run_step(p, q, nn, w, carry0)
    ref = reference_step(p, q, nn, w, T)
    assert np.isnan(ref[1]).all() and float(ref[2]) == 0.0
    assert torch.isnan(carry[ep.H_SLICE]).all()
    assert float(carry[ep.DELTA_SQ]) == 0.0
    assert np.isnan(float(carry[ep.NUM_INLIERS]))
    np.testing.assert_array_equal(carry[ep.T_SLICE].numpy(), T.reshape(16))
    check_against_reference(carry, carry0, ref, True)
    assert float(carry[ep.DONE]) == 1.0


@pytest.mark.parametrize("case", ["budget", "converged"])
def test_loop_predicate_sets_done(rng, case):
    p, q, nn, w, T = make_inputs(rng)
    carry0 = ep.init_carry(t(T), MAX_ITERS)
    kw = {"max_iters": INNER} if case == "budget" else {"tol_sq": 1.0}
    carry = run_step(p, q, nn, w, carry0, **kw)
    assert float(carry[ep.DONE]) == 1.0
    assert float(carry[ep.IT]) == INNER


def test_transform_is_the_kernels_rounding(rng):
    """((R₀p₀ + R₁p₁) + R₂p₂) + t, each step rounded to float32: bit-equal
    to numpy float32 in that order, and within 1e-6 of se3's matmul."""
    p, _, _, _, T = make_inputs(rng, 3000)
    x = gn_step.transform_points_ordered(t(T), t(p)).numpy()
    R, tr = T[:3, :3], T[:3, 3]
    expect = np.stack([((R[i, 0] * p[:, 0] + R[i, 1] * p[:, 1])
                        + R[i, 2] * p[:, 2]) + tr[i] for i in range(3)], -1)
    assert expect.dtype == np.float32
    np.testing.assert_array_equal(x, expect)
    np.testing.assert_allclose(
        x, np.asarray(rse3.transform_points(jnp.asarray(T), jnp.asarray(p))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows", [1, 7, 8, 132, 264])
def test_fold_rows_grouping(rng, rows):
    """The kernels' fold (8 warps of contiguous rows, then warp order)
    sums every row once."""
    part = t(rng.normal(size=(rows, 32)).astype(np.float32))
    folded = ep.fold_rows(part)
    np.testing.assert_allclose(folded.numpy(),
                               part.double().sum(0).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("blocks", [132, 264])
def test_grids_agree(rng, blocks):
    """The twin at a 132- or 264-row grid, as the kernel's two grids."""
    p, q, nn, w, T = make_inputs(rng, 153_600 // 8)
    carry0 = ep.init_carry(t(T), MAX_ITERS)
    carry = run_step(p, q, nn, w, carry0, blocks=blocks)
    check_against_reference(carry, carry0, reference_step(p, q, nn, w, T),
                            True)


def test_cpu_wrapper_updates_in_place_and_counts_only_its_twin(rng):
    p, q, nn, w, T = make_inputs(rng, 1000)
    carry = ep.init_carry(t(T), MAX_ITERS)
    expect = run_step(p, q, nn, w, carry)
    counters = (gn_step.counter, gn_partials.counter, ep.counter)
    before = [(c.launches, c.plain_calls) for c in counters]
    out = gn_step.gn_step(t(p), t(q), t(nn), t(w), carry,
                          torch.tensor(float(w.sum())), HUBER, *ARGS, True,
                          INNER, MAX_ITERS, TOL_SQ)
    after = [(c.launches, c.plain_calls) for c in counters]
    assert out is carry and torch.equal(carry, expect)
    assert after[0] == (before[0][0], before[0][1] + 1)
    assert after[1:] == before[1:]


def test_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        gn_step.gn_step(x, x, x, torch.empty(8, device=meta),
                        torch.empty(64, device=meta),
                        torch.empty((), device=meta), HUBER, *ARGS, True,
                        INNER, MAX_ITERS, TOL_SQ)


def test_icp_loop_takes_one_step_a_solve():
    """`_icp_loop` solves through gn_step alone: the standalone reduction
    and epilogue are left to the ring."""
    from tpuslam_torch.config import ICPConfig, Intrinsics, SLAMConfig
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
    from tpuslam_torch.frontend import preprocess
    from tpuslam_torch.icp import align_frames

    K = Intrinsics(80.0, 80.0, 39.5, 29.5)
    cfg = SLAMConfig(height=60, width=80,
                     icp=ICPConfig(pyramid_levels=2, iters_per_level=(6, 4),
                                   max_corr_dist=0.25, huber_delta=0.05))
    poses = orbit_trajectory(8)
    pyr = [preprocess(torch.as_tensor(render_depth(poses[i], K, 60, 80)), K,
                      cfg) for i in (0, 2)]
    counters = (gn_step.counter, gn_partials.counter, ep.counter)
    before = [c.plain_calls for c in counters]
    res = align_frames(pyr[1], pyr[0], K, torch.eye(4), cfg.icp)
    calls = [c.plain_calls - b for c, b in zip(counters, before)]
    assert calls[0] >= int(res.iters) > 0
    assert calls[1:] == [0, 0]


def test_source_notes_and_the_header_in_the_build_hash(tmp_path,
                                                       monkeypatch):
    """gn_step.cu says what it replaces, what bounds it and what its design
    does; the shared header is part of the library's hash, so editing it
    rebuilds every kernel that includes it."""
    import shutil

    from tpuslam_torch.kernels import _build

    text = (_build.CSRC / "gn_step.cu").read_text()[:4000]
    for key in ("Replaces:", "tpuslam/icp.py:129-139", "pallas_gn.py",
                "pallas_epilogue.py", "What bounds it on the H100",
                "What the design does about it", "one of each per stream"):
        assert key in text, key
    assert "gn_step.cu" in _build.SOURCES
    assert "gn_solve.cuh" in _build.HEADERS
    for name in ("gn_partials.cu", "gn_epilogue.cu", "gn_step.cu"):
        assert '#include "gn_solve.cuh"' in (_build.CSRC / name).read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build._source_hash()
    with open(copy / "gn_solve.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._source_hash() != before
