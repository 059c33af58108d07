"""The port's data-parallel batched alignment (tpuslam_torch/dist/
batch_eval.py) against each member aligned alone and against the
reference's batched aligner (tests/test_batch_eval.py's 8 pairs, the
reference on the 8 fake CPU devices of tests/conftest.py): every member's
T within 2e-4 (the reference test's bound), iterations equal to the
member's own.  The port runs its batch on one rank in this process and
split over four gloo ranks (2 pairs a rank, tests/torch_dist_worker.py);
every rank ends with the whole batch in batch order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_worker as worker
from tests.test_icp_synthetic import K, depth_frame
from tests.test_torch_dist import PK, port_pyramid, slam_cfg
from tpuslam.config import ICPConfig as RICPConfig
from tpuslam.dist.batch_eval import make_batched_aligner as r_batched
from tpuslam.dist.batch_eval import shard_batch as r_shard_batch
from tpuslam.dist.mesh import make_mesh as r_make_mesh
from tpuslam.geom import se3 as rse3
from tpuslam.icp import build_pyramid as r_build_pyramid
from tpuslam_torch.bench.dist_ranks import pack_inputs
from tpuslam_torch.dist.batch_eval import make_batched_aligner, shard_batch
from tpuslam_torch.dist.mesh import Mesh, make_mesh
from tpuslam_torch.icp import Frame, ICPResult, align_frames

torch.set_num_threads(1)

BATCH = 8
WORLD = 4
TOL_T = 2e-4
CFG = RICPConfig(pyramid_levels=2, iters_per_level=(8, 8),
                 max_corr_dist=0.25, huber_delta=0.05)


@pytest.fixture(scope="module")
def pairs():
    """The 8 pairs (src pyramids, the shared dst pyramid), stacked over
    the batch as the port's and the reference's trees, each member
    aligned alone by the port, and the reference's batched result."""
    rng = np.random.default_rng(0)
    taus = rng.normal(scale=[0.02, 0.02, 0.02, 0.01, 0.01, 0.01],
                      size=(BATCH, 6)).astype(np.float32)
    r_dst = tuple(r_build_pyramid(depth_frame(np.eye(4)), 2))
    r_srcs = [tuple(r_build_pyramid(depth_frame(
        np.asarray(rse3.exp(jnp.asarray(t)))), 2)) for t in taus]
    cfg = slam_cfg(icp=CFG).icp
    dst = port_pyramid(r_dst)
    srcs = [port_pyramid(s) for s in r_srcs]
    alone = [align_frames(s, dst, PK, torch.eye(4), cfg) for s in srcs]

    def stack(pyrs):
        return tuple(Frame(*(torch.stack([p[li][k] for p in pyrs])
                             for k in range(3))) for li in range(2))

    mesh = r_make_mesh()
    r_stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    ref = r_batched(mesh, CFG)(
        r_shard_batch(r_stack(r_srcs), mesh),
        r_shard_batch(r_stack([r_dst] * BATCH), mesh), K,
        r_shard_batch(jnp.tile(jnp.eye(4), (BATCH, 1, 1)), mesh))
    return (stack(srcs), stack([dst] * BATCH),
            torch.eye(4).repeat(BATCH, 1, 1), alone, ref)


def check(res_T, res_iters, pairs):
    alone, ref = pairs[3], pairs[4]
    assert res_T.shape == (BATCH, 4, 4)
    for b in range(BATCH):
        np.testing.assert_allclose(res_T[b], alone[b].T.numpy(), atol=TOL_T)
        np.testing.assert_allclose(res_T[b], np.asarray(ref.T[b]),
                                   atol=TOL_T)
        assert int(res_iters[b]) == int(alone[b].iters)


def test_batched_alignment_one_rank_matches_individual(pairs):
    mesh = make_mesh("cpu")
    src, dst, T0s = (shard_batch(t, mesh) for t in pairs[:3])
    res = make_batched_aligner(mesh, slam_cfg(icp=CFG).icp)(src, dst, PK,
                                                           T0s)
    assert isinstance(res, ICPResult)
    assert res.iters.dtype == torch.int32 and res.converged.dtype == torch.bool
    assert res.H.shape == (BATCH, 6, 6)
    check(res.T.numpy(), res.iters.numpy(), pairs)
    for b in (0, BATCH - 1):
        for f in ("rms", "inlier_fraction", "num_inliers", "H", "converged"):
            np.testing.assert_array_equal(
                getattr(res, f)[b].numpy(),
                getattr(pairs[3][b], f).numpy(), err_msg=f)


def test_shard_batch_takes_each_rank_its_block(pairs):
    src = pairs[0]
    for r in range(WORLD):
        local = shard_batch(src, Mesh(None, r, WORLD, torch.device("cpu")))
        assert isinstance(local[0], Frame)
        n = BATCH // WORLD
        assert torch.equal(local[1].points, src[1].points[r * n:(r + 1) * n])
    with pytest.raises(ValueError, match="multiple"):
        shard_batch(torch.zeros(6, 4, 4), Mesh(None, 0, WORLD,
                                               torch.device("cpu")))


def test_batched_alignment_four_ranks_matches_individual(pairs, tmp_path):
    pack_inputs(tmp_path / "in.npz", batch=(pairs[0], pairs[1], PK, pairs[2],
                                            slam_cfg(icp=CFG)))
    outs = worker.run_ranks("stages", tmp_path,
                            dict(np.load(tmp_path / "in.npz")), WORLD)
    for o in outs[1:]:
        for k in ("batch_T", "batch_iters", "batch_H"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    check(outs[0]["batch_T"], outs[0]["batch_iters"], pairs)
    kernels = list(outs[0]["kernels"])
    for o in outs:                    # each rank aligned its own 2 pairs
        plain = o["batch_plain"]
        assert plain[kernels.index("correspond")] > 0
        assert plain[kernels.index("gn_step")] > 0
