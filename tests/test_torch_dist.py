"""The port's distributed stages against the reference's, on the CPU:
`dist/mesh.replicate` / `shard_leading`, the point-sharded ICP
(`dist/sharded_icp.py`), the edge-sharded pose graph (`backend/distba.py`),
the landmark-sharded map BA (`backend/map_ba.optimize_map_ba_spmd`) and
the all-reduced GN partials.

The reference runs on the 8 fake CPU devices of tests/conftest.py.  The
port runs on one rank in this process and on four gloo ranks, processes
of tests/torch_dist_worker.py that import no JAX (its `stages` case runs
tpuslam_torch/bench/dist_ranks.py, the rank program of the GPU check).
Inputs are made from seeds with numpy, as the reference's own tests make
them.  Tolerances are the reference's own:

- sharded ICP: T within 1e-5 of the reference's `align_frames_spmd` and
  `align_frames`, iterations within ±3 (tests/test_dist.py:67-71);
- pose graph: poses within 5e-4 of `optimize_pose_graph_spmd` and
  `optimize_pose_graph` (tests/test_dist.py:101-103); the final graph of
  the config-5 40-frame loop (tests/test_config5_e2e.py, here from the
  port's SlamSystem) within 1e-3;
- map BA on four ranks: poses and map within 5e-5
  (tests/test_map_ba.py:194-197) of the port's and the reference's
  `optimize_map_ba`, and of the reference's `optimize_map_ba_spmd` on 8
  devices (one rank and `partition_observations`:
  tests/test_torch_map_ba.py);
- GN partials of 4 shards all-reduced: the single-device sums within 1e-5
  relative (tests/test_dist.py:107-139).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_worker as worker
from tests.test_icp_synthetic import K, depth_frame
from tests.test_map_ba import _make_slam_like
from tests.test_posegraph import ring_poses
from tests.test_slam import CFG as R_SLAM_CFG
from tests.test_slam import loop_trajectory
from tpuslam.backend import map_ba as rba
from tpuslam.backend.distba import optimize_pose_graph_spmd as r_pg_spmd
from tpuslam.backend.posegraph import GraphHost as RGraphHost
from tpuslam.backend.posegraph import optimize_pose_graph as r_pg
from tpuslam.config import ICPConfig as RICPConfig
from tpuslam.config import PoseGraphConfig as RPGConfig
from tpuslam.config import SLAMConfig as RSLAMConfig
from tpuslam.data.synthetic import render_depth
from tpuslam.dist.mesh import make_mesh as r_make_mesh
from tpuslam.dist.mesh import shard_leading as r_shard_leading
from tpuslam.dist.sharded_icp import make_aligned_spmd_fn as r_spmd_fn
from tpuslam.geom import se3 as rse3
from tpuslam.icp import align_frames as r_align
from tpuslam.icp import build_pyramid as r_build_pyramid
from tpuslam.kernels.gn_reduce import gn_reduce as r_gn_reduce
from tpuslam_torch.backend import map_ba as pba
from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
from tpuslam_torch.backend.posegraph import optimize_pose_graph
from tpuslam_torch.bench.dist_ranks import pack_inputs
from tpuslam_torch.config import Intrinsics
from tpuslam_torch.dist import sharded_icp
from tpuslam_torch.dist.mesh import Mesh, make_mesh, replicate, shard_leading
from tpuslam_torch.icp import Frame, align_frames, select_level_source
from tpuslam_torch.interop import (
    config_from_reference,
    map_ba_problem_from_reference,
    pose_graph_from_reference,
)
from tpuslam_torch.kernels.gn_epilogue import fold_rows
from tpuslam_torch.kernels.gn_partials import (
    fold_partials,
    gn_reduce_partials_reference,
)
from tpuslam_torch.slam import SlamSystem

torch.set_num_threads(1)

WORLD = 4
TOL_ICP_T = 1e-5
TOL_ICP_ITERS = 3
TOL_PG = 5e-4
TOL_PG_LOOP = 1e-3
TOL_BA = 5e-5
TOL_PARTIALS_REL = 1e-5
PK = Intrinsics(*(float(v) for v in K))
ICP_CFG = RICPConfig(pyramid_levels=2, iters_per_level=(8, 10),
                     max_corr_dist=0.25, huber_delta=0.05)
TAU = [0.02, -0.015, 0.02, 0.01, 0.02, -0.01]


def slam_cfg(**kw):
    """The port's SLAMConfig of a reference ICP / pose-graph config."""
    return config_from_reference(RSLAMConfig(height=120, width=160, **kw))


def port_pyramid(pyr):
    return tuple(Frame(*(torch.as_tensor(np.array(a)) for a in f))
                 for f in pyr)


@pytest.fixture(scope="module")
def icp_pair():
    """tests/test_dist.py's pair: the reference's pyramids, the port's
    copies, and the reference's single-device and 8-device results."""
    T_b = np.asarray(rse3.exp(jnp.asarray(TAU)))
    pyr_a = r_build_pyramid(depth_frame(np.eye(4)), ICP_CFG.pyramid_levels)
    pyr_b = r_build_pyramid(depth_frame(T_b), ICP_CFG.pyramid_levels)
    ref = r_align(pyr_b, pyr_a, K, rse3.identity(), ICP_CFG)
    ref_spmd = r_spmd_fn(r_make_mesh(), ICP_CFG)(pyr_b, pyr_a, K,
                                                 rse3.identity())
    return port_pyramid(pyr_b), port_pyramid(pyr_a), T_b, ref, ref_spmd


def ring_graph():
    """tests/test_dist.py's noisy 10-node ring with one loop edge."""
    cfg = RPGConfig(max_nodes=16, max_edges=64, gn_iters=10, damping=1e-6)
    gt = ring_poses(10)
    rng = np.random.default_rng(7)
    g = RGraphHost(cfg)
    noisy = [gt[0]]
    for k in range(9):
        T_rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        pert = np.asarray(rse3.exp(jnp.asarray(
            rng.normal(scale=0.01, size=6).astype(np.float32))))
        noisy.append(noisy[-1] @ T_rel @ pert)
    for T in noisy:
        g.add_node(T)
    for k in range(9):
        g.add_edge(k, k + 1, np.linalg.inv(noisy[k]) @ noisy[k + 1])
    g.add_edge(0, 9, np.linalg.inv(gt[0]) @ gt[9], weight=2.0)
    return g.graph(), cfg


@pytest.fixture(scope="module")
def loop_graph():
    """The final graph of the config-5 loop (tests/test_config5_e2e.py:
    40 frames of tests/test_slam.py's loop and config), from the port's
    SlamSystem on the CPU."""
    n = 40
    gt = loop_trajectory(n)
    cfg = config_from_reference(R_SLAM_CFG)
    slam = SlamSystem(PK, cfg, enable_loop_closure=True, device="cpu")
    for i in range(n):
        slam.process(render_depth(gt[i], K, 120, 160, seed=i),
                     timestamp=i / 30.0)
    return slam.graph.graph(), cfg


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_map_ba.py's SLAM-like problem of its SPMD test."""
    _gt, _init, prob, graph, cfg, _m = _make_slam_like(
        np.random.default_rng(1))
    return graph, prob, cfg


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, icp_pair, ba_problem):
    """The stages on 4 gloo ranks: the sharded ICP, the ring graph and map
    BA in one run; their outputs by rank."""
    src, dst, _T, _r, _rs = icp_pair
    graph, cfg = ring_graph()
    bgraph, prob, bcfg = ba_problem
    tmp = tmp_path_factory.mktemp("stages")
    pack_inputs(tmp / "in.npz",
                icp=(src, dst, PK, torch.eye(4), slam_cfg(icp=ICP_CFG)),
                pg=(pose_graph_from_reference(graph, "cpu"),
                    slam_cfg(posegraph=cfg), 0.5),
                ba=(pose_graph_from_reference(bgraph, "cpu"),
                    map_ba_problem_from_reference(prob, "cpu"),
                    slam_cfg(posegraph=bcfg), 0.05, 0.5))
    return worker.run_ranks("stages", tmp,
                            dict(np.load(tmp / "in.npz")), WORLD)


def same_on_every_rank(outs, prefix):
    for o in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith(prefix) and not k.endswith("_ms"):
                np.testing.assert_array_equal(o[k], v, err_msg=k)


# ---- mesh layouts --------------------------------------------------------


def test_replicate_and_shard_leading_layouts():
    """shard_leading gives rank r the block the reference's P("shard")
    puts on device r; replicate moves every tensor of a tree and keeps
    other leaves."""
    x = np.arange(8 * 5 * 3, dtype=np.float32).reshape(40, 3)
    rx = r_shard_leading(jnp.asarray(x), r_make_mesh(8))
    blocks = {s.device.id: np.asarray(s.data) for s in rx.addressable_shards}
    for r in range(8):
        mesh = Mesh(group=None, rank=r, size=8, device=torch.device("cpu"))
        np.testing.assert_array_equal(
            shard_leading(torch.as_tensor(x), mesh).numpy(), blocks[r])
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        shard_leading(torch.zeros(10, 3), Mesh(None, 0, 4,
                                               torch.device("cpu")))
    mesh = make_mesh("cpu")
    f = Frame(torch.ones(2, 2, 3), torch.zeros(2, 2, 3),
              torch.ones(2, 2, dtype=torch.bool))
    tree = replicate(((f, [torch.eye(4)]), 0.5, None), mesh)
    assert isinstance(tree[0][0], Frame) and isinstance(tree[0][1], list)
    assert tree[1:] == (0.5, None)
    assert all(t.device == mesh.device for t in tree[0][0])
    assert torch.equal(tree[0][1][0], torch.eye(4))


# ---- point-sharded ICP ---------------------------------------------------


def check_icp(T, iters, icp_pair):
    _src, _dst, T_b, ref, ref_spmd = icp_pair
    for r in (ref, ref_spmd):
        np.testing.assert_allclose(T, np.asarray(r.T), atol=TOL_ICP_T)
        assert abs(int(iters) - int(r.iters)) <= TOL_ICP_ITERS
    E = np.linalg.inv(np.asarray(T)) @ T_b
    assert np.linalg.norm(E[:3, 3]) < 5e-3


def test_sharded_icp_one_rank_matches_reference(icp_pair):
    src, dst = icp_pair[:2]
    out = sharded_icp.make_aligned_spmd_fn(make_mesh("cpu"),
                                           slam_cfg(icp=ICP_CFG).icp)(
        src, dst, PK, torch.eye(4))
    check_icp(out.T.numpy(), out.iters, icp_pair)
    # one rank: the single-device loop's pose (partials + epilogue in place
    # of the merged step)
    single = align_frames(src, dst, PK, torch.eye(4),
                          slam_cfg(icp=ICP_CFG).icp)
    np.testing.assert_allclose(out.T.numpy(), single.T.numpy(),
                               atol=TOL_ICP_T)
    assert int(out.iters) == int(single.iters)


def test_sharded_icp_four_ranks_matches_reference(four_ranks, icp_pair):
    same_on_every_rank(four_ranks, "icp_")
    o = four_ranks[0]
    check_icp(o["icp_T"], o["icp_iters"], icp_pair)
    # the ranks launched (here: called the twins of) the path's kernels
    kernels = list(o["kernels"])
    for k in ("correspond", "gn_partials", "gn_epilogue"):
        assert o["icp_plain"][kernels.index(k)] > 0, k
    assert o["icp_plain"][kernels.index("gn_step")] == 0


def test_sharded_icp_pads_each_level_to_eight_ranks():
    """Each rank's block of each level is the padded source's: 8·D rows
    a multiple, the padding masked."""
    src = port_pyramid(r_build_pyramid(depth_frame(np.eye(4)), 2))
    seen = []
    orig = sharded_icp._icp_level_spmd

    def spy(local, *a, **k):
        seen.append(local)
        return orig(local, *a, **k)

    sharded_icp._icp_level_spmd = spy
    try:
        for r in range(3):
            mesh = Mesh(None, r, 3, torch.device("cpu"))
            sharded_icp.align_frames_spmd(src, src, PK, torch.eye(4),
                                          slam_cfg(icp=ICP_CFG).icp, mesh)
    finally:
        sharded_icp._icp_level_spmd = orig
    # each rank visits level 1, then level 0
    for k, li in enumerate((1, 0)):
        full = select_level_source(src, li, slam_cfg(icp=ICP_CFG).icp).mask
        blocks = seen[k::2]
        n = full.shape[0]
        assert all(b.mask.shape[0] == -(-n // 24) * 8 for b in blocks)
        mask = torch.cat([b.mask for b in blocks])
        assert torch.equal(mask[:n], full) and not mask[n:].any()


# ---- edge-sharded pose graph ---------------------------------------------


def test_pose_graph_one_rank_matches_reference():
    graph, cfg = ring_graph()
    ref_single, _ = r_pg(graph, cfg)
    ref_spmd, ref_cost = r_pg_spmd(graph, cfg, r_make_mesh())
    poses, cost = optimize_pose_graph_spmd(
        pose_graph_from_reference(graph, "cpu"), slam_cfg(posegraph=cfg)
        .posegraph, make_mesh("cpu"))
    for r in (ref_single, ref_spmd):
        np.testing.assert_allclose(poses.numpy(), np.asarray(r),
                                   atol=TOL_PG)
    assert np.isfinite(float(cost))
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-3)


def test_pose_graph_four_ranks_matches_reference(four_ranks):
    graph, cfg = ring_graph()
    same_on_every_rank(four_ranks, "pg_")
    for r in (r_pg(graph, cfg)[0], r_pg_spmd(graph, cfg, r_make_mesh())[0]):
        np.testing.assert_allclose(four_ranks[0]["pg_poses"], np.asarray(r),
                                   atol=TOL_PG)
    assert np.isfinite(four_ranks[0]["pg_cost"])


def test_pose_graph_padding_edges_add_nothing():
    """Edges padded to a multiple of D (identity, node 0, weight 0): the
    one-rank system equals the summed systems of 3 ranks' blocks."""
    from tpuslam_torch.backend.distba import shard_edges
    from tpuslam_torch.backend.posegraph import (
        _info_vector,
        edge_normal_system,
    )

    graph, cfg = ring_graph()
    g = pose_graph_from_reference(graph, "cpu")
    pcfg = slam_cfg(posegraph=cfg).posegraph
    info = _info_vector(pcfg, g.poses)
    whole = edge_normal_system(g.poses, g.edge_i, g.edge_j, g.edge_T,
                               g.edge_weight, info, 0.5)
    parts = []
    for r in range(3):
        edges = shard_edges(g, Mesh(None, r, 3, torch.device("cpu")))
        assert edges[0].shape[0] == -(-g.edge_i.shape[0] // 3)
        parts.append(edge_normal_system(g.poses, *edges, info, 0.5))
    for k in range(3):
        total = sum(p[k] for p in parts)
        np.testing.assert_allclose(total.numpy(), whole[k].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def loop_four_ranks(tmp_path_factory, loop_graph):
    graph, cfg = loop_graph
    tmp = tmp_path_factory.mktemp("loop")
    pack_inputs(tmp / "in.npz", pg=(graph, cfg, 0.5))
    return worker.run_ranks("stages", tmp, dict(np.load(tmp / "in.npz")),
                            WORLD)


def test_config5_loop_graph_matches_single_device(loop_graph,
                                                  loop_four_ranks):
    """The 40-frame loop's graph (closures included), re-optimized on one
    rank and on four: within 1e-3 of the port's and the reference's
    single-device optimizers."""
    graph, cfg = loop_graph
    assert int(graph.node_mask.sum()) > 5
    assert float((graph.edge_weight > 0).sum()) > float(
        graph.node_mask.sum())             # a loop closure besides odometry
    single, _ = optimize_pose_graph(graph, cfg.posegraph)
    ref, _ = r_pg(_reference_graph(graph), R_SLAM_CFG.posegraph)
    one, cost = optimize_pose_graph_spmd(graph, cfg.posegraph,
                                         make_mesh("cpu"))
    assert np.isfinite(float(cost))
    same_on_every_rank(loop_four_ranks, "pg_")
    for got in (one.numpy(), loop_four_ranks[0]["pg_poses"]):
        np.testing.assert_allclose(got, single.numpy(), atol=TOL_PG_LOOP)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL_PG_LOOP)


def _reference_graph(graph):
    from tpuslam.backend.posegraph import PoseGraph as RPoseGraph

    return RPoseGraph(*(jnp.asarray(t.numpy()) for t in graph))


# ---- landmark-sharded map BA ----------------------------------------------


def check_ba(poses, map_pts, ba_problem):
    graph, prob, cfg = ba_problem
    pcfg = slam_cfg(posegraph=cfg).posegraph
    pp, pm, _c = pba.optimize_map_ba(pose_graph_from_reference(graph, "cpu"),
                                     map_ba_problem_from_reference(prob,
                                                                   "cpu"),
                                     pcfg)
    np.testing.assert_allclose(poses, pp.numpy(), atol=TOL_BA)
    np.testing.assert_allclose(map_pts, pm.numpy(), atol=TOL_BA)
    rp, rm, _rc = rba.optimize_map_ba(graph, prob, cfg)
    np.testing.assert_allclose(poses, np.asarray(rp), atol=TOL_BA)
    np.testing.assert_allclose(map_pts, np.asarray(rm),
                               atol=TOL_BA)


def test_map_ba_spmd_four_ranks_matches_single_device(four_ranks,
                                                      ba_problem):
    same_on_every_rank(four_ranks, "ba_")
    o = four_ranks[0]
    assert int(o["ba_dropped"]) == 0
    assert o["ba_map"].shape == ba_problem[1].map_points.shape
    check_ba(o["ba_poses"], o["ba_map"], ba_problem)
    # and the reference's landmark-sharded BA on 8 devices
    graph, prob, cfg = ba_problem
    rp, rm, _ = rba.optimize_map_ba_spmd(graph, prob, cfg, r_make_mesh())
    np.testing.assert_allclose(o["ba_poses"], np.asarray(rp),
                               atol=TOL_BA)
    np.testing.assert_allclose(o["ba_map"], np.asarray(rm),
                               atol=TOL_BA)


# ---- run_bench over the process group ----------------------------------


def test_run_bench_two_ranks_times_the_sharded_icp(tmp_path):
    """run_bench(devices=2) on 2 gloo ranks (the `bench` stage): the
    reference's keys, finite; every rank's odometry the same."""
    from tpuslam_torch.bench.harness import _render_sequence

    pack_inputs(tmp_path / "in.npz", bench=_render_sequence(3, 48, 64))
    outs = worker.run_ranks("stages", tmp_path,
                            dict(np.load(tmp_path / "in.npz")), 2)
    rs = [json.loads(str(o["bench_json"])) for o in outs]
    for r in rs:
        assert r["n_devices"] == 2 and r["frames"] == 3
        for k in ("spmd_align_ms", "single_align_ms", "scaling_efficiency"):
            assert np.isfinite(r[k]) and r[k] > 0, k
    assert rs[0]["ate_rmse_m"] == rs[1]["ate_rmse_m"]


def test_run_bench_devices_must_match_the_group():
    from tpuslam_torch.bench.harness import run_bench

    with pytest.raises(ValueError, match="devices=2"):
        run_bench(3, 48, 64, device="cpu", devices=2)


# ---- the partial systems --------------------------------------------------


def partial_inputs():
    """tests/test_dist.py's 128 points (its psum check)."""
    rng = np.random.default_rng(0)
    n = 128
    x = rng.normal(size=(n, 3)).astype(np.float32)
    q = (x + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return x, q, nrm, np.ones((n,), np.float32)


def check_partials(partials, x, q, nrm, w):
    H, b, *_ = fold_partials(torch.as_tensor(partials))
    whole = gn_reduce_partials_reference(
        *(torch.as_tensor(a) for a in (x, q, nrm, w)), 0.05)
    H1, b1, *_ = fold_partials(whole)
    ref = r_gn_reduce(jnp.asarray(x), jnp.asarray(q), jnp.asarray(nrm),
                      jnp.asarray(w), jnp.ones((x.shape[0],), bool), 0.05)
    for got, want in ((H, H1), (b, b1), (H, np.asarray(ref.H)),
                      (b, np.asarray(ref.b))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=TOL_PARTIALS_REL,
                                   atol=TOL_PARTIALS_REL * np.abs(want).max())


def test_partials_of_shards_sum_to_single_device():
    x, q, nrm, w = partial_inputs()
    n = x.shape[0] // WORLD
    total = sum(gn_reduce_partials_reference(
        *(torch.as_tensor(a[r * n:(r + 1) * n]) for a in (x, q, nrm, w)),
        0.05) for r in range(WORLD))
    check_partials(total.numpy(), x, q, nrm, w)


def test_partials_all_reduced_over_four_ranks(tmp_path):
    x, q, nrm, w = partial_inputs()
    outs = worker.run_ranks("partials", tmp_path, {
        "x": x, "q": q, "n": nrm, "w": w, "huber_delta": 0.05}, WORLD)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["partials"], outs[0]["partials"])
    check_partials(outs[0]["partials"], x, q, nrm, w)
    np.testing.assert_allclose(
        outs[0]["sums"], fold_rows(torch.as_tensor(outs[0]["partials"]))
        .numpy())
