"""The port's Schur-complement map BA (tpuslam_torch/backend/map_ba.py) and
`SlamSystem(map_ba=True)` against the reference's, on the CPU.

- `map_ba_partials`, `schur_reduce`, `backsub_landmarks` on the reference
  test's random problem: within 1e-5 of max |·| (float32 sums in other
  orders).
- `optimize_map_ba` on the reference test's SLAM-like problem: poses
  within 1e-4, the cost within a relative 1e-4.
- `build_map_ba_problem`: obs_map and obs_w equal on a share ≥ 0.999 of
  the rows (the keyframe points are moved into the world by two libraries'
  products, which differ in the last bit), map rows bit for bit.
- `SlamSystem(map_ba=True)` on the 48-frame loop of
  tests/test_torch_slam.py after `finalize`: the same keyframes, closures
  and `map_ba_stats` counts, poses within 1e-3 (the test says why not
  1e-4); the reference's BA inputs replayed through the port: the same
  counts, the cost within a relative 1e-4, poses within 1e-4.
- A direct `refine_map_ba` with a deferred attempt pending: the reference
  leaves it pending (the next chunk would apply its pre-BA poses over
  BA's); the port drains it first.
- The landmark-sharded BA: `optimize_map_ba_spmd` on one rank within
  5e-5 of the port's and the reference's `optimize_map_ba`
  (tests/test_map_ba.py:194-197), and `partition_observations` equal to
  the reference's array for array, `dropped` too, also when buckets
  overflow (four ranks: tests/test_torch_dist.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_map_ba import _make_slam_like, _random_problem, _surface_world
from tests.test_torch_slam import CFG, CHUNK, FRAMES, K, POSE_TOL, loop  # noqa: F401
from tpuslam.backend import map_ba as rba
from tpuslam.geom import se3 as rse3
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch.backend import map_ba as pba
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.dist.mesh import make_mesh
from tpuslam_torch.interop import (
    config_from_reference,
    map_ba_problem_from_reference,
    pose_graph_from_reference,
)
from tpuslam_torch.slam import SlamSystem as PSlam

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

REL = 1e-5


def close_rel(a, b, rel=REL):
    b = np.asarray(b)
    err = np.abs(np.asarray(a) - b).max()
    assert err <= rel * max(np.abs(b).max(), 1e-30), err


@pytest.mark.parametrize("huber", [1e9, 0.05], ids=["quadratic", "huber"])
def test_partials_schur_backsub_match_reference(huber):
    poses, prob = _random_problem(np.random.default_rng(3))
    r = rba.map_ba_partials(poses, prob, huber_delta=huber)
    pp = map_ba_problem_from_reference(prob, "cpu")
    p = pba.map_ba_partials(torch.as_tensor(np.array(poses)), pp, huber)
    for a, b in zip(p, r):
        close_rel(a.numpy(), b)
    H_red, b_red = rba.schur_reduce(*r[:5])
    pH, pb = pba.schur_reduce(*p[:5])
    close_rel(pH.numpy(), H_red)
    close_rel(pb.numpy(), b_red)
    delta = np.asarray(np.random.default_rng(0).normal(
        scale=0.01, size=b_red.shape[0]), np.float32)
    close_rel(pba.backsub_landmarks(torch.as_tensor(delta), *p[2:5]).numpy(),
              rba.backsub_landmarks(jnp.asarray(delta), *r[2:5]))
    # the block-diagonal embedding puts each pose's block on the diagonal
    blocks = torch.arange(2 * 36, dtype=torch.float32).reshape(2, 6, 6)
    emb = pba._embed_block_diag(blocks)
    assert torch.equal(emb, torch.block_diag(*blocks))


def test_optimize_map_ba_matches_reference():
    gt, _init, prob, graph, cfg, _m = _make_slam_like(
        np.random.default_rng(0))
    rp, rm, rc = rba.optimize_map_ba(graph, prob, cfg, huber_delta=10.0)
    pp, pm, pc_ = pba.optimize_map_ba(
        pose_graph_from_reference(graph, "cpu"),
        map_ba_problem_from_reference(prob, "cpu"), cfg, huber_delta=10.0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), atol=1e-4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(rm), atol=1e-4)
    np.testing.assert_allclose(float(pc_), float(rc), rtol=1e-4,
                               atol=1e-12)
    # and BA did its job: the reference test's bound on the pose error
    assert np.abs(pp.numpy() - gt).max() < 5e-3


def test_build_map_ba_problem_matches_reference():
    rng = np.random.default_rng(4)
    mpts, mnrm = _surface_world(rng, M=3000)
    N, C = 6, 512
    kf_poses, kf_points, kf_mask = [], [], []
    for _ in range(N):
        T = np.asarray(rse3.exp(jnp.asarray(
            0.2 * rng.normal(size=6).astype(np.float32))))
        T_inv = np.linalg.inv(T.astype(np.float64))
        sel = rng.integers(0, mpts.shape[0], size=C)
        pw = mpts[sel] + 0.01 * rng.normal(size=(C, 3))
        kf_poses.append(T)
        kf_points.append(pw @ T_inv[:3, :3].T + T_inv[:3, 3])
        kf_mask.append(rng.uniform(size=C) > 0.05)
    args = (np.stack(kf_poses).astype(np.float32),
            np.stack(kf_points).astype(np.float32), np.stack(kf_mask),
            mpts, mnrm, rng.uniform(size=mpts.shape[0]) > 0.02)
    ids = np.array([0, 2, 3, 5, 6, 9], np.int32)
    r = rba.build_map_ba_problem(*(jnp.asarray(a) for a in args),
                                 max_dist=0.1, kf_ids=jnp.asarray(ids))
    p = pba.build_map_ba_problem(*(torch.as_tensor(a) for a in args),
                                 max_dist=0.1, kf_ids=torch.as_tensor(ids))
    for name in ("map_points", "map_normals", "map_mask", "obs_pose",
                 "obs_p"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    same = ((p.obs_map.numpy() == np.asarray(r.obs_map))
            & (p.obs_w.numpy() == np.asarray(r.obs_w)))
    assert same.mean() >= 0.999, (~same).sum()
    assert 0.8 < p.obs_w.numpy().mean() < 1.0


def drive(slam, depths):
    ts = np.arange(FRAMES) / 30.0
    for i in range(0, FRAMES, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    return slam


def test_slam_map_ba_matches_reference(loop, monkeypatch):  # noqa: F811
    """The whole system, and the reference's BA replayed through the port.

    Whole system: the same keyframes, closures and `map_ba_stats` counts,
    poses within 1e-3.  Not 1e-4: a keyframe cloud of the port holds a
    point one voxel over now and then (tests/test_torch_frontend.py), which
    shifts the compacted cloud's rows by one, so BA's strided subsample of
    that keyframe is other points (7% of the observations differ here) and
    the poses move by ~2e-4.  Replayed: the port's `build_map_ba_problem`
    and `optimize_map_ba` on the reference's inputs (keyframe poses, clouds,
    control points, graph): the same counts, the cost within a relative
    1e-4, poses within 1e-4."""
    calls = {}
    build, optimize = rba.build_map_ba_problem, rba.optimize_map_ba

    def record_build(*args, **kw):
        calls["build"] = (args, kw)
        return build(*args, **kw)

    def record_optimize(graph, prob, cfg, **kw):
        calls["optimize"] = (graph, kw)
        return optimize(graph, prob, cfg, **kw)

    monkeypatch.setattr(rba, "build_map_ba_problem", record_build)
    monkeypatch.setattr(rba, "optimize_map_ba", record_optimize)
    _, depths = loop
    ref = drive(RSlam(K, CFG, enable_loop_closure=True,
                      chunk_mode="boundary", map_ba=True), depths)
    port = drive(PSlam(PIntrinsics(*K), config_from_reference(CFG),
                       enable_loop_closure=True, chunk_mode="boundary",
                       map_ba=True, device="cpu"), depths)
    ref.finalize()
    port.finalize()
    rs, ps = ref.map_ba_stats, port.map_ba_stats
    assert rs is not None and ps is not None
    assert ps["num_obs"] == rs["num_obs"] > 100
    assert ps["num_control"] == rs["num_control"] > 100
    assert ([r.index for r in port.odo.keyframes]
            == [r.index for r in ref.odo.keyframes])
    assert ([(c.i, c.j) for c in port.closures]
            == [(c.i, c.j) for c in ref.closures])
    np.testing.assert_allclose(port.trajectory()[1], ref.trajectory()[1],
                               atol=1e-3)

    (args, kw), (graph, okw) = calls["build"], calls["optimize"]
    pcfg = config_from_reference(CFG).posegraph
    prob = pba.build_map_ba_problem(
        *(torch.as_tensor(np.array(a)) for a in args),
        max_dist=kw["max_dist"],
        kf_ids=torch.as_tensor(np.array(kw["kf_ids"])))
    poses, _, cost = pba.optimize_map_ba(
        pose_graph_from_reference(graph, "cpu"), prob, pcfg, **okw)
    assert int(prob.obs_w.sum()) == rs["num_obs"]
    np.testing.assert_allclose(float(cost), rs["cost"], rtol=1e-4)
    n = ref.graph.num_nodes
    np.testing.assert_allclose(poses.numpy()[:n],
                               np.asarray(ref.graph._poses[:n]),
                               atol=POSE_TOL)


def test_refine_map_ba_drains_a_pending_attempt(loop):  # noqa: F811
    """The deferred backend leaves the last chunk's attempt pending.  A
    direct `refine_map_ba`: the reference runs BA and keeps the attempt
    pending, so the next chunk applies the attempt's pre-BA poses over
    BA's; the port applies the attempt first, then runs BA."""
    _, depths = loop
    depths = depths[:40]

    def run(cls, **kw):
        slam = cls(**kw)
        ts = np.arange(40) / 30.0
        for i in range(0, 40, CHUNK):
            slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
        pending = slam._pending_attempt is not None
        closures = len(slam.closures)
        assert slam.refine_map_ba()
        return slam, pending, closures

    ref, r_pending, r_closures = run(
        RSlam, K=K, cfg=CFG, enable_loop_closure=True,
        chunk_mode="boundary", async_backend=True, map_ba=True)
    port, p_pending, p_closures = run(
        PSlam, K=PIntrinsics(*K), cfg=config_from_reference(CFG),
        enable_loop_closure=True, chunk_mode="boundary", async_backend=True,
        map_ba=True, device="cpu")
    assert r_pending and p_pending and r_closures == p_closures
    # the reference keeps the attempt; its closures are not in the graph
    assert ref._pending_attempt is not None
    assert len(ref.closures) == r_closures
    # the port drained it before BA: its closures joined the graph BA saw
    assert port._pending_attempt is None
    assert len(port.closures) > p_closures
    ref._drain_pending()
    assert ([(c.i, c.j) for c in port.closures]
            == [(c.i, c.j) for c in ref.closures])


# ---- the landmark-sharded BA (optimize_map_ba_spmd); on four gloo ranks
# in tests/test_torch_dist.py ----


def test_map_ba_spmd_one_rank_matches_single_device():
    """One rank: poses and map within 5e-5 (tests/test_map_ba.py:194-197)
    of the port's and the reference's single-device BA, on the reference
    SPMD test's problem (default Huber)."""
    _gt, _init, prob, graph, cfg, _m = _make_slam_like(
        np.random.default_rng(1))
    pg = pose_graph_from_reference(graph, "cpu")
    pp = map_ba_problem_from_reference(prob, "cpu")
    poses, map_pts, cost = pba.optimize_map_ba_spmd(pg, pp, cfg,
                                                    make_mesh("cpu"))
    assert map_pts.shape == pp.map_points.shape and np.isfinite(float(cost))
    sp, sm, _sc = pba.optimize_map_ba(pg, pp, cfg)
    rp, rm, _rc = rba.optimize_map_ba(graph, prob, cfg)
    for want_p, want_m in ((sp.numpy(), sm.numpy()),
                           (np.asarray(rp), np.asarray(rm))):
        np.testing.assert_allclose(poses.numpy(), want_p, atol=5e-5)
        np.testing.assert_allclose(map_pts.numpy(), want_m, atol=5e-5)


@pytest.mark.parametrize("case", ["random", "slam_like", "overflow"])
@pytest.mark.parametrize("n_dev", [4, 8])
def test_partition_observations_equals_reference(case, n_dev):
    """Every array, the landmarks a rank and `dropped` equal to the
    reference's; "overflow" puts every observation in the first landmarks'
    block under a tight cap, so buckets fill and drop."""
    rng = np.random.default_rng(2)
    if case == "random":
        _poses, prob = _random_problem(rng, N=3, M=20, obs_per=4)
    else:
        _gt, _init, prob, _g, _cfg, _m = _make_slam_like(rng)
    cap_factor = 0.5 if case == "overflow" else 1.5
    if case == "overflow":
        prob = prob._replace(obs_map=prob.obs_map % 7)
    want, want_m, want_dropped = rba.partition_observations(prob, n_dev,
                                                            cap_factor)
    got, m_per, dropped = pba.partition_observations(
        map_ba_problem_from_reference(prob, "cpu"), n_dev, cap_factor)
    assert (m_per, dropped) == (want_m, want_dropped)
    assert case != "overflow" or dropped > 0
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
