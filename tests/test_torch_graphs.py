"""The captured programs (tpuslam_torch/graphs.py), on the CPU.

A CUDA graph exists only on the card (tests/test_torch_cuda.py replays
each program there against its eager run).  Here:

  * the key changes with every static argument (config, intrinsics, sub,
    bucket, solver), with each tensor's shape, dtype and device, and with
    the lane, and equal arguments give equal keys;
  * a launch counted during a capture is recorded for the graph, not
    counted, and each replay adds it under the replaying stream, under the
    counter's lock;
  * on CPU tensors each program's entry point gives the bits of its plain
    eager call, and of the loop it replaced (scan_step by scan_step,
    _frozen_sub_chunk by sub-chunk);
  * with `SimGraphs` — graphs simulated on the CPU: a capture runs the
    body once with its state restored after, and a replay runs it again
    into the same static output buffers, so a caller that kept a buffer
    past the next replay sees it change — the machinery itself: inputs
    copied in, state carried in the buffers, outputs copied out, the
    warm-up's results returned by a key's first call and the capture at
    its second, a failing capture raising, and a SLAM run's checkpoint
    taken through graph-held state resuming to the same poses.

The map-tracking programs (the projective and grid refinements, the
frame cloud, the fusion, the promotion bundle and pyramid packing, map BA
and the ring refinement), on the 16-frame 120×160 loop of
tests/test_torch_map_slam.py:

  * each entry point's key, as the entry point computes it, changes with
    each of its static arguments (the map's capacity, the index's cell,
    `with_desc`, two meshes of one size) and not with tensor values;
  * on CPU tensors each gives the bits of its plain eager call;
  * under `SimGraphs` a whole map-tracking run (projective; grid with map
    BA, BA run twice so that it replays; the ring on a one-rank mesh
    without a group) gives the eager run's poses, refinement stats, map
    and BA output bit for bit, and stays within the reference's poses
    (`tpuslam.slam.SlamSystem`, JAX on the CPU) by POSE_TOL;
  * a replay after an insert or a rebuilt index aligns against the map
    as it is now (inputs copied in, never closed over);
  * a gloo mesh never captures the ring.

The reference's last compiled programs (the boundary scan, the aligners,
the grid index build, the verification and relocalization batches, the
sharded fusion and point-sharded ICP), on the same loop:

  * each key changes with each static argument and not with tensor
    values; under `SimGraphs` a key's first call, its capture and a replay
    give the eager bits, and a replay is held to the reference's jitted
    program (JAX on the CPU) with the tolerance of the function's own
    parity test;
  * the boundary scan over a whole loop is `scan_odometry_boundary`; the
    map aligners and the refinements share their graphs; the index build
    replayed after an insert is a fresh build; the verification batches
    pad with row 0; a gloo mesh never captures the fusion or the ICP;
  * a revisit turned by a yaw, verified from the identity through the
    graphed batches, takes the reference's gate decision.

The distributed programs (the edge-sharded pose graph, the landmark-
sharded map BA, the batched aligner), on the reference's own problems of
tests/test_torch_dist.py and two frame pairs of the loop: each key
changes with each static argument (a mesh of another group, the config,
the Huber widths, the bucket, landmarks and observations, K, the batch
size, the pyramid's levels) and not with tensor values; under `SimGraphs`
a key's first call, its capture and a replay give the eager bits on a
one-rank mesh without a group; a gloo mesh never captures them; a replay
is held to the reference's jitted program on one device with the
tolerance of the function's own parity test.
"""

import contextlib
import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.backend.loopclosure as rloop
import tpuslam.backend.relocalize as rreloc
import tpuslam.dist.map_fusion as rfusion
import tpuslam.dist.mesh as rmesh
import tpuslam.dist.sharded_icp as rsharded
import tpuslam.frontend as rfront
import tpuslam.icp as rticp
from tests.test_slam import loop_trajectory as map_loop_trajectory
from tests.test_torch_map_slam import CFG as MAP_REF_CFG
from tests.test_torch_map_slam import K as REF_K
from tests.test_torch_map_slam import POSE_TOL
from tests.test_torch_map_slam import run as run_map
from tpuslam.geom.cloud import PointCloud as RCloud
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch import graphs, mapping
from tpuslam_torch import slam as slam_mod
from tpuslam_torch.backend import (
    loopclosure,
    map_ba,
    posegraph,
    relocalize,
)
from tpuslam_torch.backend.verify import COVERAGE_COL, ROW_SIZE, passes_gates
from tpuslam_torch.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
from tpuslam_torch.dist import map_fusion, ring_map
from tpuslam_torch.dist.mesh import Mesh, make_mesh
from tpuslam_torch.dist.sharded_icp import make_aligned_spmd_fn
from tpuslam_torch.frontend import (
    FlatChunk,
    FlatFrozen,
    FrozenState,
    SuperChunkCarry,
    _frozen_sub_chunk,
    _kf_cloud_jit,
    _select,
    _track,
    depth_descriptor,
    initial_state,
    pack_pyramid,
    pack_pyramid_jit,
    preprocess,
    process_frame_jit,
    promote_bundle_jit,
    scan_chunk,
    scan_odometry,
    scan_odometry_boundary,
    scan_odometry_boundary_jit,
    scan_step,
    scan_superchunk_frozen,
)
from tpuslam_torch.geom.voxel import voxel_downsample
from tpuslam_torch.icp import (
    FlatICP,
    align_clouds_jit,
    align_frames_jit,
    align_map_to_frame,
    align_map_to_frame_jit,
    align_to_index,
    align_to_index_jit,
    flat_icp_scalars,
)
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels.correspond import (
    build_grid_index,
    build_grid_index_jit,
)
from tpuslam_torch.slam import SlamSystem
from tpuslam_torch.utils import checkpoint

torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
CFG = SLAMConfig(
    height=H, width=W,
    icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                  max_corr_dist=0.25, huber_delta=0.05),
    keyframe=KeyframeConfig(max_translation=0.08, max_rotation=0.12),
    posegraph=PoseGraphConfig(max_nodes=64, max_edges=256, gn_iters=15,
                              lc_min_gap=3, lc_max_dist=0.6,
                              lc_max_residual=0.05, lc_min_inliers=0.3),
    voxel=VoxelConfig(capacity=1 << 13, map_capacity=1 << 15),
)
FRAMES, CUT, CHUNK = 48, 24, 8


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(FRAMES, cycles=2, radius=0.35)
    return gt, np.stack([render_depth(gt[i], K, H, W, seed=i)
                         for i in range(FRAMES)]).astype(np.float32)


class SimGraphs:
    """Graphs simulated on CPU tensors (the module doc)."""

    def handles(self, dev):
        return True

    def lane(self, dev):
        return 0

    @contextlib.contextmanager
    def on_capture_stream(self, dev, lane):
        yield

    def capture(self, dev, lane, body, state_bufs):
        saved = [b.clone() for b in state_bufs]
        outs = body()                  # what a capture records
        for b, s in zip(state_bufs, saved):
            b.copy_(s)                 # ... and nothing ran
        return body, outs

    def replay(self, graph, outs):
        with _build.recording(), graphs._inside():   # no wrapper, no
            new = graph()                             # nested capture
        for o, n in zip(outs, new):
            o.copy_(n)
        return outs

    def keep_for(self, tensors, dev):
        pass

    def memory(self, dev):
        return 0

    def forget_pools(self):
        pass


@pytest.fixture
def sim(monkeypatch):
    graphs.clear()
    monkeypatch.setattr(graphs, "_backend", SimGraphs())
    yield
    graphs.clear()


def bits(tree):
    return [t.clone() for t in graphs.flatten(tree)[0]]


def same_bits(a, b):
    la, lb = graphs.flatten(a)[0], graphs.flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(torch.nan_to_num(x.float(), 7.0),
                        torch.nan_to_num(y.float(), 7.0))
        for x, y in zip(la, lb))


def key(static, state=(), args=(), lane=0):
    sl, ss = graphs.flatten(state)
    il, is_ = graphs.flatten(args)
    return graphs.key_of(lane, static, ss, sl, is_, il)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def test_key_changes_with_every_static_argument():
    d = torch.zeros(H, W)
    base = dict(K=K, cfg=CFG, sub=8, use_dense=True, lc_weight=2.0)
    k0 = key(base, args=(d,))
    assert key(dict(base), args=(torch.ones(H, W),)) == k0   # values: no
    changed = {
        "config": dict(base, cfg=CFG.replace(cv_damping=0.25)),
        "icp": dict(base, cfg=CFG.replace(icp=ICPConfig(fused_gn=True))),
        "K": dict(base, K=K._replace(fx=K.fx * 1.01)),
        "K scaled": dict(base, K=K.scaled(0.5)),
        "sub": dict(base, sub=4),
        "solver": dict(base, use_dense=False),
        "weight": dict(base, lc_weight=1.0),
        "-0.0": dict(base, lc_weight=-0.0),
    }
    keys = {name: key(st, args=(d,)) for name, st in changed.items()}
    assert all(k != k0 for k in keys.values())
    assert len(set(keys.values())) == len(keys)
    assert key(dict(base, lc_weight=0.0), args=(d,)) != keys["-0.0"]


def test_key_changes_with_shape_dtype_device_structure_and_lane():
    st = {"cfg": CFG}
    g = posegraph.GraphHost(CFG.posegraph, device="cpu")
    for _ in range(3):
        g.add_node(np.eye(4, dtype=np.float32))
    g32, g64 = g.graph(bucketed=True), None
    for _ in range(40):
        g.add_node(np.eye(4, dtype=np.float32))
    g64 = g.graph(bucketed=True)
    assert g32.poses.shape[0] == 32 and g64.poses.shape[0] == 64
    k32 = key(st, args=(g32,))
    assert key(st, args=(g.graph(bucketed=False),)) != k32
    assert key(st, args=(g64,)) != k32                      # bucket
    assert key(st, args=(g32,)) == k32
    d = torch.zeros(H, W)
    k = key(st, args=(d,))
    assert key(st, args=(torch.zeros(H // 2, W),)) != k      # shape
    assert key(st, args=(d.double(),)) != k                 # dtype
    assert key(st, args=(torch.zeros(H, W, device="meta"),)) != k  # device
    assert key(st, args=((d,),)) != k                       # structure
    assert key(st, args=(d,), lane=1) != k                  # stream
    assert key(st, state=(d,), args=()) != key(st, state=(), args=(d,))


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------


def test_capture_records_launches_and_replays_count_them():
    c = _build.LaunchCounter("toy")
    c.launched(11)
    with _build.recording() as rec:
        c.launched(11)
        c.launched(11)
    assert rec == {c: 2}
    assert c.launches == 1 and c.by_stream == {11: 1}      # not counted
    c.replayed(rec[c], 22)
    c.replayed(rec[c], 22)
    assert c.launches == 5 and c.by_stream == {11: 1, 22: 4}
    c.reset()
    assert c.launches == 0 and c.by_stream == {}


def test_replay_accounting_is_taken_under_the_lock():
    c = _build.LaunchCounter("toy")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda s=s: [
            c.replayed(3, s % 2) for _ in range(2000)]) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert c.launches == 16 * 2000 * 3
    assert c.by_stream == {0: 8 * 6000, 1: 8 * 6000}


def test_a_replay_counts_the_kernels_of_its_capture(sim):
    c = _build.LaunchCounter("toy")

    def body(state, x):
        c.launched(99)                 # as a kernel wrapper does
        c.launched(99)
        return state + x, state * 2

    prog = graphs.Program("toy", body)
    with prog.loop(torch.zeros(3)) as lp:
        for _ in range(4):
            lp.step(torch.ones(3))
    # the first step's warm-up launched 2 (on the capture stream, counted
    # under the lane), the second step's capture recorded 2, and each of
    # the 3 replays (steps 2-4) added them
    assert c.launches == 8 and c.by_stream == {0: 8}
    (e,) = prog.entries()
    assert e.launches == {c: 2} and e.replays == 3


# ---------------------------------------------------------------------------
# The machinery, simulated
# ---------------------------------------------------------------------------


def test_loop_carries_state_in_the_buffers_and_copies_it_out(sim):
    prog = graphs.Program("toy", lambda s, x: ((s[0] + x, s[1] * 2),
                                               s[0].sum()[None]))
    state = (torch.zeros(2), torch.ones(1))
    ys = torch.empty(5)
    with prog.loop(state) as lp:
        for i in range(5):
            ys[i:i + 1].copy_(lp.step(torch.full((2,), float(i))))
        end = lp.state()
    assert ys.tolist() == [0.0, 0.0, 2.0, 6.0, 12.0]
    assert end[0].tolist() == [10.0, 10.0] and end[1].tolist() == [32.0]
    assert state[0].tolist() == [0.0, 0.0]        # the caller's, untouched
    (e,) = prog.entries()
    assert end[0].data_ptr() != e.state_bufs[0].data_ptr()
    # a second loop from another state hits the graph and starts there
    with prog.loop((torch.full((2,), 5.0), torch.ones(1))) as lp:
        assert lp.step(torch.zeros(2)).tolist() == [10.0]
    assert len(prog.entries()) == 1 and e.replays == 5


def test_run_hands_out_copies(sim):
    prog = graphs.Program("toy", lambda s, x, y: ((), (x + y, x * y)))
    a = prog.run(torch.ones(2), torch.full((2,), 3.0))          # warm-up
    b = prog.run(torch.ones(2), torch.full((2,), 5.0))          # a replay
    c = prog.run(torch.full((2,), 2.0), torch.full((2,), 5.0))  # another
    assert [t.tolist() for t in a] == [[4.0, 4.0], [3.0, 3.0]]
    assert [t.tolist() for t in b] == [[6.0, 6.0], [5.0, 5.0]]
    assert [t.tolist() for t in c] == [[7.0, 7.0], [10.0, 10.0]]
    assert prog.entries()[0].replays == 2


def test_an_output_that_is_an_input_buffer_is_copied(sim):
    prog = graphs.Program("toy", lambda s, x: ((), x))
    a = prog.run(torch.ones(2))
    prog.run(torch.zeros(2))
    assert a.tolist() == [1.0, 1.0]


def test_a_capture_failure_raises(sim, monkeypatch):
    def fail(dev, lane, body, state_bufs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs._backend, "capture", fail)
    prog = graphs.Program("toy", lambda s, x: ((), x + 1))
    # the first call is the warm-up; the second captures, and raises, as
    # does every later call of the key
    assert prog.run(torch.ones(2)).tolist() == [2.0, 2.0]
    for _ in range(2):
        with pytest.raises(graphs.CaptureError, match="toy: capture failed"):
            prog.run(torch.ones(2))
    assert [e.graph for e in prog.entries()] == [None]
    # eager=True is the explicit eager path, and runs
    assert prog.run(torch.ones(2), eager=True).tolist() == [2.0, 2.0]


def test_a_state_whose_shape_changes_cannot_be_captured(sim):
    prog = graphs.Program("toy", lambda s, x: (torch.cat([s, x]), x))
    with pytest.raises(graphs.CaptureError, match="new state"):
        with prog.loop(torch.zeros(2)) as lp:
            lp.step(torch.ones(1))


def test_a_capture_on_another_thread_warms_that_thread_up(sim):
    """The warm-up on one thread, the capture on another: that thread
    runs a warm-up of its own first (its library handles), and the state
    carried into the capture is the one the caller gave."""
    calls = []
    prog = graphs.Program("toy", lambda s, x: (
        calls.append(threading.get_ident()) or (s + x, s.clone())))
    with prog.loop(torch.zeros(2)) as lp:
        assert lp.step(torch.ones(2)).tolist() == [0.0, 0.0]
    main = threading.get_ident()
    got = []

    def other():
        with prog.loop(torch.full((2,), 5.0)) as lp:
            got.append(lp.step(torch.ones(2)).tolist())
            got.append(lp.step(torch.ones(2)).tolist())

    t = threading.Thread(target=other)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert got == [[5.0, 5.0], [6.0, 6.0]]
    # the main thread's warm-up; the other's warm-up, the sim's capture
    # run and its two replays
    assert calls[0] == main and len(calls) == 5
    assert all(c != main for c in calls[1:])


def test_programs_called_by_a_program_run_inline(sim):
    inner = graphs.Program("inner", lambda s, x: ((), x * 3))
    outer = graphs.Program("outer", lambda s, x: ((), inner.run(x) + 1))
    assert outer.run(torch.ones(2)).tolist() == [4.0, 4.0]
    assert outer.run(torch.zeros(2)).tolist() == [1.0, 1.0]
    assert inner.entries() == [] and len(outer.entries()) == 1


# ---------------------------------------------------------------------------
# The six programs on the CPU
# ---------------------------------------------------------------------------


def test_scan_odometry_and_scan_chunk_match_the_scan_step_loop(loop):
    d = torch.as_tensor(loop[1][:10])
    st = initial_state(d[0], K, CFG)
    poses, promotes, inliers = scan_odometry(d, K, CFG)
    state = st
    for i in range(10):                    # the loop they replaced
        state, T_world_cam, out = scan_step(state, d[i], K, CFG)
        assert torch.equal(poses[i], T_world_cam)
        assert bool(promotes[i]) == bool(out.promote)
        assert torch.equal(inliers[i], out.icp.inlier_fraction)
    assert bool(promotes.any())
    new_state, ys = scan_chunk(d, K, st, CFG)
    assert same_bits(new_state, state)
    assert torch.equal(ys[:, FlatChunk.WORLD_T].reshape(-1, 4, 4), poses)
    for eager in (False, True):
        assert same_bits(scan_odometry(d, K, CFG, eager=eager),
                         (poses, promotes, inliers))


def test_scan_superchunk_frozen_matches_the_sub_chunk_loop(loop):
    d = torch.as_tensor(loop[1][:17])
    st = initial_state(d[0], K, CFG)
    carry = SuperChunkCarry(kf_packed=st.kf_packed, T_kf_cam=st.T_kf_cam,
                            last_delta=st.last_delta)
    for sub in (4, 8):
        got, ys = scan_superchunk_frozen(d[1:], K, carry, CFG, sub)
        kf, fs = carry.kf_packed, FrozenState(carry.T_kf_cam,
                                              carry.last_delta)
        rows = torch.empty_like(ys)
        for g0 in range(0, 16, sub):       # the loop it replaced
            fs, pyr = _frozen_sub_chunk(kf, d[1 + g0:1 + g0 + sub], K, fs,
                                        CFG, rows[g0:g0 + sub])
            any_p = torch.any(rows[g0:g0 + sub, FlatFrozen.PROMOTE] > 0.5)
            kf = _select(any_p, pack_pyramid(pyr, CFG.icp), kf)
            fs = fs._replace(T_kf_cam=_select(
                any_p, torch.eye(4), fs.T_kf_cam))
        assert torch.equal(ys, rows)
        assert same_bits(got, SuperChunkCarry(kf, fs.T_kf_cam,
                                              fs.last_delta))
        assert same_bits(scan_superchunk_frozen(d[1:], K, carry, CFG, sub,
                                                eager=True), (got, ys))


def test_process_frame_jit_matches_the_track(loop):
    d = torch.as_tensor(loop[1][:3])
    kf = pack_pyramid(preprocess(d[0], K, CFG), CFG.icp)
    eye = torch.eye(4)
    got = process_frame_jit(d[2], kf, K, eye, eye, CFG)
    pyr, out, delta = _track(kf, d[2], K, eye, eye, CFG)
    assert same_bits(got[0], pyr)
    assert torch.equal(got[1], out.T_kf_cam) and torch.equal(got[2], delta)
    assert same_bits(process_frame_jit(d[2], kf, K, eye, eye, CFG,
                                       eager=True), got)


def _pose_graph(loop):
    gt = loop[0]
    g = posegraph.GraphHost(CFG.posegraph, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(20):
        T = gt[k].copy()
        T[:3, 3] += rng.normal(scale=0.01, size=3)
        g.add_node(T.astype(np.float32))
        if k:
            g.add_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k])
    g.add_edge(2, 14, np.linalg.inv(gt[2]) @ gt[14], weight=2.0)
    return g.graph(bucketed=True)


def test_pose_graph_solvers_give_their_eager_bits(loop):
    g = _pose_graph(loop)
    pg = CFG.posegraph
    dense = posegraph.optimize_pose_graph(g, pg)
    assert same_bits(dense, posegraph._optimize_dense(
        (), g, cfg=pg, huber_delta=0.5)[1])
    assert same_bits(posegraph.optimize_pose_graph(g, pg, eager=True), dense)
    cg = posegraph.optimize_pose_graph_cg(g, pg, cg_iters=32)
    assert same_bits(cg, posegraph._optimize_cg(
        (), g, cfg=pg, huber_delta=0.5, cg_iters=32, cg_tol=1e-6)[1])
    assert same_bits(posegraph.optimize(g, pg, live_nodes=20), dense)
    assert float((dense[0][:20] - g.poses[:20]).abs().max()) > 1e-4


def test_fused_attempt_gives_its_eager_bits(loop):
    d = torch.as_tensor(loop[1])
    pairs = [(0, 24), (4, 28)]
    padded = pairs + pairs[:1] + pairs[:1]
    tables = [pack_pyramid(preprocess(d[i], K, CFG), CFG.icp)[1]
              for i, _ in padded]
    clouds = [promote_bundle_jit(d[j], K, CFG, False)[2] for _, j in padded]
    gt = loop[0]
    T_inits = torch.as_tensor(np.stack([
        (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)
        for i, j in padded]))
    g = _pose_graph(loop)
    ci = torch.tensor([0, 4, 0, 0], dtype=torch.int32)
    cj = torch.tensor([14, 16, 14, 14], dtype=torch.int32)
    args = (tables, [c.points for c in clouds], [c.normals for c in clouds],
            [c.mask for c in clouds], K.scaled(0.5), T_inits, len(pairs), g,
            ci, cj, H // 2, W // 2, CFG.icp, CFG.posegraph, True, 2.0)
    flat = loopclosure.fused_attempt_jit(*args)
    assert same_bits(loopclosure.fused_attempt_jit(*args, eager=True), flat)
    rows = flat[:4 * 21].reshape(4, 21)
    assert torch.equal(rows[2], rows[0]) and torch.equal(rows[3], rows[0])


# ---------------------------------------------------------------------------
# A SLAM run through simulated graphs
# ---------------------------------------------------------------------------


def _slam():
    return SlamSystem(K, CFG, enable_loop_closure=True,
                      chunk_mode="boundary", async_backend=True,
                      device="cpu")


def _run(slam, depths, lo, hi):
    ts = np.arange(FRAMES) / 30.0
    for i in range(lo, hi, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    return slam


def test_checkpoint_through_graph_held_state_resumes_to_the_same_poses(
        loop, sim, tmp_path):
    """Boundary chunks with the deferred backend, every program replayed
    from simulated graphs: the run equals the eager one bit for bit, and a
    checkpoint after 24 frames, loaded into a fresh system, continues to
    the same poses."""
    depths = loop[1]
    whole = _run(_slam(), depths, 0, FRAMES)
    path = str(tmp_path / "mid.npz")
    first = _run(_slam(), depths, 0, CUT)
    checkpoint.save_checkpoint(path, first, first.odo.frame_idx)
    resumed = _slam()
    assert checkpoint.load_checkpoint(path, resumed) == CUT
    _run(resumed, depths, CUT, FRAMES)
    replays = {e["program"]: e["replays"] for e in graphs.stats()}
    assert replays.get("scan_superchunk_frozen", 0) > 0
    assert replays.get("fused_attempt_jit", 0) + len(
        [e for e in graphs.stats() if e["program"] == "fused_attempt_jit"]
    ) > 0
    for s in (whole, resumed):
        s.finalize()
    graphs.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "_backend", graphs.CudaGraphs())
        eager = _run(_slam(), depths, 0, FRAMES)
        eager.finalize()
    _, p_whole = whole.trajectory()
    _, p_res = resumed.trajectory()
    _, p_eager = eager.trajectory()
    assert len(whole.closures) >= 1
    assert [(c.i, c.j) for c in whole.closures] == [
        (c.i, c.j) for c in eager.closures]
    np.testing.assert_array_equal(p_whole, p_eager)
    assert [r.index for r in resumed.odo.keyframes] == [
        r.index for r in whole.odo.keyframes]
    np.testing.assert_allclose(p_res, p_whole, atol=1e-5)


# ---------------------------------------------------------------------------
# The map-tracking programs
# ---------------------------------------------------------------------------

MAP_CFG = config_from_reference(MAP_REF_CFG)
MAP_FRAMES = 16
MAP_PROGRAMS = ("_refine_projective_jit", "_refine_grid_jit",
                "_kf_cloud_jit", "_fuse", "promote_bundle_jit",
                "pack_pyramid_jit", "optimize_map_ba", "ring_align")
GROUPS = (object(), object())     # two process groups, for the keys only


@pytest.fixture(scope="module")
def map_loop():
    """tests/test_torch_map_slam.py's 16-frame loop."""
    gt = map_loop_trajectory(30)[:MAP_FRAMES]
    return gt, np.stack([render_depth(gt[i], K, H, W, seed=i)
                         for i in range(MAP_FRAMES)]).astype(np.float32)


def _pose(T) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, dtype=np.float32))


@pytest.fixture(scope="module")
def map_inputs(map_loop):
    """Each map program's inputs: a map of three keyframes fused at their
    true poses, its grid index, frame 6's pyramid and cloud, a warm start
    1 cm off, and a map BA problem over the three keyframes."""
    gt, depths = map_loop
    d = torch.as_tensor(depths)
    cfg = MAP_CFG
    kfs = (0, 4, 8)
    clouds = [promote_bundle_jit(d[i], K, cfg, False)[2] for i in kfs]
    vmap = mapping.VoxelMap(cfg.voxel, device="cpu")
    for c, i in zip(clouds, kfs):
        vmap.insert(c, gt[i])
    pyr = preprocess(d[6], K, cfg)
    v = cfg.voxel
    T0 = gt[6].copy()
    T0[:3, 3] += 0.01
    ctrl = voxel_downsample(vmap.cloud, 2.0 * v.map_voxel_size, 4096,
                            v.origin, v.extent)
    host = posegraph.GraphHost(cfg.posegraph, device="cpu")
    for k, i in enumerate(kfs):
        host.add_node(gt[i].astype(np.float32))
        if k:
            host.add_edge(k - 1, k, np.linalg.inv(gt[kfs[k - 1]]) @ gt[i])
    prob = map_ba.build_map_ba_problem(
        _pose(np.stack([gt[i] for i in kfs])),
        torch.stack([c.points[:512] for c in clouds]),
        torch.stack([c.mask[:512] for c in clouds]), ctrl.points,
        ctrl.normals, ctrl.mask, max_dist=float(cfg.icp.max_corr_dist))
    return {"depth": d[6], "pyr": pyr, "map": vmap.cloud,
            "index": vmap.build_index(cell=float(cfg.icp.max_corr_dist)),
            "cloud": _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity,
                                   v.origin, v.extent),
            "new_cloud": clouds[1], "T0": _pose(T0), "T": _pose(gt[4]),
            "graph": host.graph(bucketed=True), "prob": prob}


class _Keyed(Exception):
    """The spy's stop: the entry point has computed its key."""


def entry_key(call):
    """The key `call` computes for its graph, taken before it runs."""
    seen = []
    key_of = graphs.key_of

    def spy(*a):
        seen.append(key_of(*a))
        raise _Keyed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "_backend", SimGraphs())
        mp.setattr(graphs, "key_of", spy)
        with pytest.raises(_Keyed):
            call()
    return seen[0]


def _half(cloud):
    """The first half of a cloud's rows: another capacity."""
    n = cloud.points.shape[0] // 2
    return type(cloud)(*(t[:n] for t in cloud))


def _map_program_calls(mi):
    """name → (call(**changes) with the program's arguments, {what: the
    changes that give another key}, changes of tensor values only)."""
    cfg, icp, v = MAP_CFG, MAP_CFG.icp, MAP_CFG.voxel
    icp2 = dataclasses.replace(icp, max_iters=icp.max_iters + 1)
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    g = mi["graph"]
    big = posegraph.GraphHost(cfg.posegraph, device="cpu")
    for _ in range(40):
        big.add_node(np.eye(4, dtype=np.float32))
    pg = cfg.posegraph
    vox = dict(voxel_size=v.voxel_size, capacity=v.capacity,
               origin=v.origin, extent=v.extent)
    fuse = dict(capacity=v.map_capacity, voxel_size=v.map_voxel_size,
                origin=v.origin, extent=v.extent)
    moved = mi["T0"].clone()
    moved[0, 3] += 0.1
    return {
        "_refine_projective_jit": (
            lambda map=mi["map"], K=K, icp=icp, T0=mi["T0"], eager=False:
            slam_mod._refine_projective_jit(map, mi["pyr"][0], K, T0, icp,
                                            eager=eager),
            {"capacity": dict(map=_half(mi["map"])),
             "K": dict(K=K._replace(fx=K.fx * 1.01)), "cfg": dict(icp=icp2)},
            dict(T0=moved)),
        "_refine_grid_jit": (
            lambda index=mi["index"], icp=icp, T0=mi["T0"], eager=False:
            slam_mod._refine_grid_jit(mi["cloud"], index, T0, icp,
                                      eager=eager),
            {"cell": dict(index=mi["index"]._replace(cell=0.3)),
             "capacity": dict(index=build_grid_index(
                 _half(mi["map"]), cell=float(icp.max_corr_dist))),
             "cfg": dict(icp=icp2)},
            dict(T0=moved)),
        "_kf_cloud_jit": (
            lambda frame=mi["pyr"][0], **kw: _kf_cloud_jit(
                frame, **dict(vox, **kw)),
            {"voxel_size": dict(voxel_size=0.03),
             "capacity": dict(capacity=1024), "origin": dict(origin=-10.0),
             "extent": dict(extent=20.0)},
            dict(frame=preprocess(torch.as_tensor(
                np.asarray(mi["depth"]) * 1.01), K, cfg)[0])),
        "_fuse": (
            lambda map=mi["map"], T=mi["T"], **kw: mapping.fuse_jit(
                map, mi["new_cloud"], T, **dict(fuse, **kw)),
            {"capacity": dict(map=_half(mi["map"]),
                              capacity=v.map_capacity // 2),
             "voxel_size": dict(voxel_size=0.03),
             "origin": dict(origin=-10.0), "extent": dict(extent=20.0)},
            dict(T=mi["T0"])),
        "promote_bundle_jit": (
            lambda depth=mi["depth"], K=K, cfg=cfg, with_desc=False,
            eager=False: promote_bundle_jit(depth, K, cfg, with_desc,
                                            eager=eager),
            {"with_desc": dict(with_desc=True),
             "K": dict(K=K._replace(cy=K.cy + 0.5)),
             "cfg": dict(cfg=cfg.replace(icp=icp2)),
             "shape": dict(depth=mi["depth"][:, :W // 2])},
            dict(depth=mi["depth"] * 1.01)),
        "pack_pyramid_jit": (
            lambda pyr=mi["pyr"], cfg=cfg, eager=False: pack_pyramid_jit(
                pyr, cfg, eager=eager),
            {"cfg": dict(cfg=cfg.replace(icp=dataclasses.replace(
                icp, packed_dtype="float32"))),
             "shape": dict(pyr=mi["pyr"][:2])},
            dict(pyr=preprocess(mi["depth"] * 1.01, K, cfg))),
        "optimize_map_ba": (
            lambda graph=g, pg=pg, huber=0.05, edge=0.5, eager=False:
            map_ba.optimize_map_ba(graph, mi["prob"], pg, huber_delta=huber,
                                   edge_huber_delta=edge, eager=eager),
            {"bucket": dict(graph=big.graph(bucketed=True)),
             "cfg": dict(pg=dataclasses.replace(pg, gn_iters=3)),
             "huber": dict(huber=0.1), "edge huber": dict(edge=0.25)},
            dict(graph=g._replace(poses=g.poses * 1.0 + 0.001))),
        "ring_align": (
            lambda mesh=mesh, icp=icp, backend="kernel", T0=mi["T0"],
            eager=False: ring_map.make_ring_align_fn(mesh, icp, backend)(
                mi["cloud"], mi["map"], T0, eager=eager),
            {"a mesh of a group": dict(mesh=Mesh(
                GROUPS[0], 0, 1, torch.device("cpu"))),
             "a mesh of another group of one size": dict(mesh=Mesh(
                 GROUPS[1], 0, 1, torch.device("cpu"))),
             "backend": dict(backend="ops"), "cfg": dict(icp=icp2)},
            dict(T0=moved, mesh=Mesh(None, 0, 1, torch.device("cpu")))),
    }


def test_map_program_calls_cover_every_map_program(map_inputs):
    assert tuple(_map_program_calls(map_inputs)) == MAP_PROGRAMS
    names = {p.name for p in graphs._programs}
    assert set(MAP_PROGRAMS) <= names


@pytest.mark.parametrize("program", MAP_PROGRAMS)
def test_map_program_key_changes_with_each_static_argument(map_inputs,
                                                           monkeypatch,
                                                           program):
    """A mesh's part of the key is its group's identity, rank, size and
    backend: two groups of one size differ; two meshes without a group
    (no collectives) share their graphs."""
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group: "nccl")
    call, changes, values = _map_program_calls(map_inputs)[program]
    k0 = entry_key(call)
    assert entry_key(lambda: call(**values)) == k0          # values: no
    keys = {what: entry_key(lambda kw=kw: call(**kw))
            for what, kw in changes.items()}
    assert all(k != k0 for k in keys.values()), keys
    assert len(set(keys.values())) == len(keys)


def _plain_map_calls(mi):
    """name → the program's plain eager computation, written out."""
    cfg, icp, v = MAP_CFG, MAP_CFG.icp, MAP_CFG.voxel
    d = mi["depth"]

    def bundle(with_desc):
        pyr = preprocess(d, K, cfg)
        return (pyr, pack_pyramid(pyr, icp), voxel_downsample(
            pyr[0].as_cloud(), v.voxel_size, v.capacity, v.origin, v.extent),
            depth_descriptor(pyr[-1].points, pyr[-1].mask)
            if with_desc else None)

    return {
        "_refine_projective_jit": lambda: flat_icp_scalars(
            align_map_to_frame(mi["map"], mi["pyr"][0], K, mi["T0"], icp)),
        "_refine_grid_jit": lambda: flat_icp_scalars(align_to_index(
            mi["cloud"], mi["index"], mi["T0"], icp)),
        "_kf_cloud_jit": lambda: voxel_downsample(
            mi["pyr"][0].as_cloud(), v.voxel_size, v.capacity, v.origin,
            v.extent),
        "_fuse": lambda: mapping._fuse(
            mi["map"], mi["new_cloud"], mi["T"], v.map_capacity,
            v.map_voxel_size, v.origin, v.extent),
        "promote_bundle_jit": lambda: bundle(False),
        "promote_bundle_jit with_desc": lambda: bundle(True),
        "pack_pyramid_jit": lambda: pack_pyramid(mi["pyr"], icp),
        "optimize_map_ba": lambda: map_ba._optimize_map_ba(
            (), mi["graph"], mi["prob"], cfg=cfg.posegraph, huber_delta=0.05,
            edge_huber_delta=0.5)[1],
        "ring_align": lambda: ring_map._ring_align(
            (), mi["cloud"], mi["map"], mi["T0"],
            mesh=Mesh(None, 0, 1, torch.device("cpu")), cfg=icp,
            backend="kernel")[1],
    }


@pytest.mark.parametrize("program", MAP_PROGRAMS[:5]
                         + ("promote_bundle_jit with_desc",)
                         + MAP_PROGRAMS[5:])
def test_map_program_gives_its_eager_bits_on_the_cpu(map_inputs, program):
    """On CPU tensors each entry point, and its `eager=True` call, give
    the bits of the computation written out op by op."""
    plain = _plain_map_calls(map_inputs)[program]()
    name, _, desc = program.partition(" ")
    base = _map_program_calls(map_inputs)[name][0]
    kw = {"with_desc": True} if desc else {}
    got = base(**kw)
    assert same_bits(got, plain)
    assert same_bits(base(eager=True, **kw), plain)
    if desc:
        assert got[3] is not None
    if name.startswith("_refine"):
        assert float(got[16]) > 0.5          # converged
    assert not any(e["captured"] for e in graphs.stats())


MAP_MODES = {"projective": {},
             "grid_map_ba": {"map_track_mode": "grid", "map_ba": True},
             "ring": {"sharded_map": True}}


def _map_run(depths, mode):
    """The 16-frame map-tracking run; with map BA, `finalize` (BA's
    first call, the key's warm-up) and then a second BA (its capture and
    replay).  Returns everything the run produced."""
    slam = SlamSystem(K, MAP_CFG, enable_loop_closure=False,
                      track_against_map=True, device="cpu",
                      **MAP_MODES[mode])
    for i in range(MAP_FRAMES):
        slam.process(depths[i], timestamp=i / 30.0)
    out = {"keyframes": [r.index for r in slam.odo.keyframes],
           "stats": list(slam.map_refine_stats),
           "poses": slam.trajectory()[1],
           "map": bits(slam.map.cloud_shards if mode == "ring"
                       else slam.map.cloud)}
    if MAP_MODES[mode].get("map_ba"):
        slam.finalize()
        first = (slam.map_ba_stats, slam.trajectory()[1])
        assert slam.refine_map_ba()
        out["map_ba"] = [first, (slam.map_ba_stats, slam.trajectory()[1])]
    return out


@pytest.mark.parametrize("mode", MAP_MODES)
def test_map_run_through_simulated_graphs_is_the_eager_run(map_loop, sim,
                                                           monkeypatch,
                                                           mode):
    """Every map program replayed from simulated graphs: the poses, the
    refinement stats, the map and map BA's output are the eager run's bit
    for bit; projective and ring are held to the reference's system on
    the same frames within POSE_TOL."""
    gt, depths = map_loop
    got = _map_run(depths, mode)
    replays = {}
    for e in graphs.stats():
        replays[e["program"]] = replays.get(e["program"], 0) + e["replays"]
    ran = {"projective": ("_refine_projective_jit", "_fuse"),
           "grid_map_ba": ("_refine_grid_jit", "_kf_cloud_jit", "_fuse",
                           "optimize_map_ba"),
           "ring": ("ring_align", "_kf_cloud_jit")}[mode]
    assert all(replays.get(p, 0) > 0 for p in ran), replays
    assert replays.get("pack_pyramid_jit", 0) > 0
    graphs.clear()
    monkeypatch.setattr(graphs, "_backend", graphs.CudaGraphs())
    eager = _map_run(depths, mode)
    assert got["keyframes"] == eager["keyframes"]
    assert len(got["keyframes"]) >= 4
    assert got["stats"] == eager["stats"]
    assert np.mean([s["ok"] for s in got["stats"]]) > 0.5
    np.testing.assert_array_equal(got["poses"], eager["poses"])
    assert same_bits(got["map"], eager["map"])
    if "map_ba" in got:
        for (s_got, p_got), (s_eager, p_eager) in zip(got["map_ba"],
                                                      eager["map_ba"]):
            assert s_got == s_eager and s_got["num_obs"] > 100
            np.testing.assert_array_equal(p_got, p_eager)
        return
    if mode == "ring":
        import tpuslam.dist.mesh as rmesh

        monkeypatch.setattr(rmesh, "make_mesh", lambda: rmesh.Mesh(
            np.asarray(rmesh.jax.devices()[:1]),
            axis_names=(rmesh.SHARD_AXIS,)))
    ref = RSlam(REF_K, MAP_REF_CFG, enable_loop_closure=False,
                track_against_map=True, sharded_map=mode == "ring")
    r_kf, _, r_ok, r_est = run_map(ref, depths)
    assert r_kf == got["keyframes"]
    assert r_ok == [s["ok"] for s in got["stats"]]
    np.testing.assert_allclose(got["poses"], r_est, atol=POSE_TOL)


@pytest.mark.parametrize("mode", ["projective", "grid"])
def test_a_replay_aligns_against_the_map_as_it_is_now(map_loop, sim, mode):
    """The refinement captured against a two-keyframe map, then a third
    keyframe fused in (the fusion's own replay) and, in grid mode, the
    index rebuilt: the next replay equals the eager refinement against the
    new map, and differs from the replay before the insert."""
    gt, depths = map_loop
    d = torch.as_tensor(depths)
    icp, v = MAP_CFG.icp, MAP_CFG.voxel
    clouds = [promote_bundle_jit(d[i], K, MAP_CFG, False)[2]
              for i in (0, 5, 10)]
    vmap = mapping.VoxelMap(v, device="cpu")
    for c, i in zip(clouds[:2], (0, 5)):
        vmap.insert(c, gt[i])
    pyr = preprocess(d[7], K, MAP_CFG)
    cloud = _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity, v.origin,
                          v.extent)
    T0 = _pose(gt[7])

    def refine(eager=False):
        if mode == "projective":
            return slam_mod._refine_projective_jit(vmap.cloud, pyr[0], K, T0,
                                                   icp, eager=eager)
        index = vmap.build_index(cell=float(icp.max_corr_dist))
        return slam_mod._refine_grid_jit(cloud, index, T0, icp, eager=eager)

    before = [refine() for _ in range(2)]     # the warm-up; the capture
    assert same_bits(before[1], before[0])
    assert same_bits(before[1], refine(eager=True))
    eager_map = mapping.fuse_jit(vmap.cloud, clouds[2], _pose(gt[10]),
                                 v.map_capacity, v.map_voxel_size, v.origin,
                                 v.extent, eager=True)
    vmap.insert(clouds[2], gt[10])            # the fusion's second replay
    assert same_bits(vmap.cloud, eager_map)
    after = refine()
    assert same_bits(after, refine(eager=True))
    assert not torch.equal(after, before[1])
    name = "_refine_projective_jit" if mode == "projective" else (
        "_refine_grid_jit")
    (entry,) = [e for e in graphs.stats() if e["program"] == name]
    assert entry["captured"] and entry["replays"] == 2
    (fuse,) = [e for e in graphs.stats() if e["program"] == "_fuse"]
    assert fuse["replays"] == 2


def test_a_gloo_mesh_never_captures_the_ring(map_inputs, sim, tmp_path):
    """On a gloo group the ring runs op by op whatever the tensors' device
    (a decision from the backend), so it never meets a capture; without a
    group or over NCCL it is captured."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cpu")
        assert mesh.backend == "gloo" and not ring_map.captures(mesh)
        call = ring_map.make_ring_align_fn(mesh, MAP_CFG.icp)
        mi = map_inputs
        outs = [call(mi["cloud"], mi["map"], mi["T0"]) for _ in range(3)]
        assert ring_map._RING_ALIGN.entries() == []
        assert all(same_bits(o, outs[0]) for o in outs[1:])
        assert same_bits(outs[0], call(mi["cloud"], mi["map"], mi["T0"],
                                       eager=True))
    finally:
        dist.destroy_process_group()
    assert ring_map.captures(Mesh(None, 0, 1, torch.device("cpu")))
    nccl = Mesh(None, 0, 1, torch.device("cpu"))
    object.__setattr__(nccl, "group", object())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.distributed, "get_backend", lambda group: "nccl")
        assert ring_map.captures(nccl)


# ---------------------------------------------------------------------------
# The last compiled programs: the boundary scan, the alignments, the grid
# index build, the verification batches, the sharded fusion and ICP
# ---------------------------------------------------------------------------

LAST_PROGRAMS = ("scan_odometry_boundary_jit", "align_frames_jit",
                 "align_clouds_jit", "build_grid_index", "_verify_pairs_jit",
                 "_verify_projective_pairs_jit", "_batch_verify_jit",
                 "_batch_verify_projective_jit", "fuse_sharded",
                 "align_frames_spmd")
VERIFY_LVL = 1
N_LIVE = 2
# tolerances to the reference, as each function's own parity test holds it
TOL_SCAN = 1e-4       # tests/test_torch_frontend.py boundary scan
TOL_ALIGN_T = 5e-5    # tests/test_torch_icp.py, tests/test_torch_grid.py
TOL_ROW_T = 1e-4      # tests/test_torch_backend.py fused attempt rows
TOL_SPMD_T = 1e-5     # tests/test_torch_dist.py TOL_ICP_T (iterations ±3)


@pytest.fixture(scope="module")
def last_inputs(map_loop, map_inputs):
    """map_inputs plus three keyframes' promotion bundles (frames 0, 4,
    8), four verification pairs of which N_LIVE are live (padding repeats
    pair 0), their initial guesses from the true poses, frame 5's
    pyramid, and a one-rank mesh without a group."""
    gt, depths = map_loop
    d = torch.as_tensor(depths)
    bundles = {i: promote_bundle_jit(d[i], K, MAP_CFG, False)
               for i in (0, 4, 8)}
    pairs = ((0, 4), (4, 8), (0, 4), (0, 4))
    return dict(map_inputs, d=d, gt=gt, bundles=bundles, pairs=pairs,
                T_inits=_pose(np.stack([np.linalg.inv(gt[i]) @ gt[j]
                                        for i, j in pairs])),
                pyr5=preprocess(d[5], K, MAP_CFG),
                mesh=Mesh(None, 0, 1, torch.device("cpu")))


def _last_program_calls(li):
    """name → (call(**changes) with the program's arguments, {what: the
    changes that give another key}, changes of tensor values only)."""
    cfg, icp, v = MAP_CFG, MAP_CFG.icp, MAP_CFG.voxel
    icp2 = dataclasses.replace(icp, max_iters=icp.max_iters + 1)
    b = li["bundles"]
    pairs = li["pairs"]
    tables = [b[i][1][VERIFY_LVL] for i, _ in pairs]
    clouds_i = [b[i][2] for i, _ in pairs]
    clouds_j = [b[j][2] for _, j in pairs]
    K_lvl = K.scaled(1.0 / 2 ** VERIFY_LVL)
    h, w = H >> VERIFY_LVL, W >> VERIFY_LVL
    eye = torch.eye(4)
    moved = li["T_inits"].clone()
    moved[:, 0, 3] += 0.01
    group = Mesh(GROUPS[0], 0, 1, torch.device("cpu"))

    def verify_projective(n_live=N_LIVE, B=4, K_lvl=K_lvl, icp=icp,
                          T_inits=li["T_inits"], eager=False):
        return loopclosure.verify_batch(
            tables[:B], [c.points for c in clouds_j[:B]],
            [c.normals for c in clouds_j[:B]],
            [c.mask for c in clouds_j[:B]], K_lvl, T_inits[:B], n_live, h,
            w, icp, eager=eager)

    def fuse(mesh=li["mesh"], vox=v, map=li["map"], T=li["T"],
             eager=False):
        fn = map_fusion.make_fuse_fn(mesh, vox, v.capacity)[0]
        return fn(map, b[8][2], T, eager=eager)

    return {
        "scan_odometry_boundary_jit": (
            lambda depths=li["d"], K=K, cfg=cfg, chunk=8, eager=False:
            scan_odometry_boundary_jit(depths, K, cfg, chunk, eager=eager),
            {"chunk": dict(chunk=4), "K": dict(K=K._replace(fx=K.fx * 1.01)),
             "cfg": dict(cfg=cfg.replace(icp=icp2)),
             "shape": dict(depths=li["d"][:, :, :W // 2])},
            dict(depths=li["d"] * 1.01)),
        "align_frames_jit": (
            lambda src=li["pyr5"], dst=li["pyr"], K=K, icp=icp, T0=eye,
            eager=False: align_frames_jit(src, dst, K, T0, icp, eager=eager),
            {"K": dict(K=K._replace(cy=K.cy + 0.5)), "cfg": dict(icp=icp2),
             "shape": dict(src=li["pyr5"][:2], dst=li["pyr"][:2])},
            dict(T0=li["T0"])),
        "align_clouds_jit": (
            lambda dst=b[4][2], icp=icp, use_grid=True, T0=li["T_inits"][0],
            eager=False: align_clouds_jit(b[0][2], dst, T0, icp, use_grid,
                                          eager=eager),
            {"use_grid": dict(use_grid=False), "cfg": dict(icp=icp2),
             "capacity": dict(dst=_half(b[4][2]))},
            dict(T0=moved[0])),
        "build_grid_index": (
            lambda dst=li["map"], cell=0.25, origin=None, eager=False:
            build_grid_index_jit(dst, cell, origin, eager=eager),
            {"cell": dict(cell=0.3), "rows": dict(dst=_half(li["map"])),
             "origin given": dict(origin=torch.zeros(3))},
            dict(dst=li["map"]._replace(points=li["map"].points * 1.01))),
        "_verify_pairs_jit": (
            lambda n_live=N_LIVE, B=4, icp=icp, T_inits=li["T_inits"],
            eager=False: loopclosure.verify_batch_grid(
                clouds_i[:B], clouds_j[:B], T_inits[:B], n_live, icp,
                eager=eager),
            {"live": dict(n_live=3), "B": dict(B=2), "cfg": dict(icp=icp2)},
            dict(T_inits=moved)),
        "_verify_projective_pairs_jit": (
            verify_projective,
            {"live": dict(n_live=3), "B": dict(B=2),
             "K": dict(K_lvl=K.scaled(0.25)), "cfg": dict(icp=icp2)},
            dict(T_inits=moved)),
        "_batch_verify_jit": (
            lambda B=4, icp=icp, T_inits=li["T_inits"], eager=False:
            relocalize._batch_verify_jit(li["cloud"], clouds_i[:B],
                                         T_inits[:B], icp, eager=eager),
            {"B": dict(B=2), "cfg": dict(icp=icp2)}, dict(T_inits=moved)),
        "_batch_verify_projective_jit": (
            lambda B=4, K_lvl=K_lvl, icp=icp, T_inits=li["T_inits"],
            eager=False: relocalize._batch_verify_projective_jit(
                li["cloud"], tables[:B], K_lvl, T_inits[:B], h, w, icp,
                eager=eager),
            {"B": dict(B=2), "K": dict(K_lvl=K.scaled(0.25)),
             "cfg": dict(icp=icp2)}, dict(T_inits=moved)),
        "fuse_sharded": (
            fuse,
            {"a mesh of a group": dict(mesh=group),
             "voxel cfg": dict(vox=dataclasses.replace(
                 v, map_voxel_size=v.map_voxel_size * 2)),
             "map capacity": dict(map=_half(li["map"]))},
            dict(T=li["T0"])),
        "align_frames_spmd": (
            lambda mesh=li["mesh"], icp=icp, K=K, T0=eye, eager=False:
            make_aligned_spmd_fn(mesh, icp)(li["pyr5"], li["pyr"], K, T0,
                                            eager=eager),
            {"a mesh of a group": dict(mesh=group), "cfg": dict(icp=icp2),
             "K": dict(K=K._replace(fx=K.fx * 1.01))},
            dict(T0=li["T0"])),
    }


def test_last_program_calls_cover_every_program(last_inputs):
    assert tuple(_last_program_calls(last_inputs)) == LAST_PROGRAMS
    assert set(LAST_PROGRAMS) <= {p.name for p in graphs._programs}


@pytest.mark.parametrize("program", LAST_PROGRAMS)
def test_last_program_key_changes_with_each_static_argument(
        last_inputs, monkeypatch, program):
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group: "nccl")
    call, changes, values = _last_program_calls(last_inputs)[program]
    k0 = entry_key(call)
    assert entry_key(lambda: call(**values)) == k0          # values: no
    keys = {what: entry_key(lambda kw=kw: call(**kw))
            for what, kw in changes.items()}
    assert all(k != k0 for k in keys.values()), keys
    assert len(set(keys.values())) == len(keys)


@pytest.mark.parametrize("program", LAST_PROGRAMS)
def test_last_program_replays_give_its_eager_bits(last_inputs, sim,
                                                  program):
    """The first call (the warm-up), the second (the capture and a
    replay) and a third (a replay), each bit-equal to the eager run."""
    call = _last_program_calls(last_inputs)[program][0]
    ref = bits(call(eager=True))
    got = [bits(call()) for _ in range(3)]
    assert all(same_bits(g, ref) for g in got)
    (entry,) = [e for e in graphs.stats() if e["program"] == program]
    # the boundary scan replays once a chunk: its first call warms up on
    # chunk 0 and captures on chunk 1
    assert entry["captured"] and entry["replays"] == (
        5 if program == "scan_odometry_boundary_jit" else 2)


def test_boundary_scan_over_the_loop_is_the_eager_scan(loop, sim):
    """#1 over the 48-frame loop, six chunks, each a replay after the
    first two: poses, flags and inlier fractions are the bits of
    `scan_odometry_boundary`, with promotions."""
    d = torch.as_tensor(loop[1])
    got = scan_odometry_boundary_jit(d, K, CFG, 8)
    graphs.clear()
    want = scan_odometry_boundary(d, K, CFG, 8)
    assert same_bits(got, want)
    assert int(want[1].sum()) >= 2


@pytest.mark.parametrize("name", ["align_to_index_jit",
                                  "align_map_to_frame_jit"])
def test_the_map_alignments_share_the_refinements_graphs(last_inputs, sim,
                                                         name):
    """icp's jitted map alignments and the SLAM system's refinements are
    one program: a key captured through one replays through the other."""
    li, icp = last_inputs, MAP_CFG.icp
    if name == "align_to_index_jit":
        def align():
            return align_to_index_jit(li["cloud"], li["index"], li["T0"],
                                      icp)

        def refine():
            return slam_mod._refine_grid_jit(li["cloud"], li["index"],
                                             li["T0"], icp)
        program = "_refine_grid_jit"
    else:
        def align():
            return align_map_to_frame_jit(li["map"], li["pyr"][0], K,
                                          li["T0"], icp)

        def refine():
            return slam_mod._refine_projective_jit(li["map"], li["pyr"][0],
                                                   K, li["T0"], icp)
        program = "_refine_projective_jit"
    res, flat = align()
    assert same_bits(flat, flat_icp_scalars(res))
    again = align()                       # the capture
    assert same_bits(again, (res, flat))
    assert same_bits(refine(), flat)      # a replay of that graph
    (entry,) = [e for e in graphs.stats() if e["program"] == program]
    assert entry["captured"] and entry["replays"] == 2


def test_index_build_replay_after_an_insert_is_a_fresh_build(map_loop,
                                                             sim):
    """The index build captured on a two-keyframe map, a third keyframe
    fused in: the next replay equals a fresh eager build of the new map
    (the cloud copied in, the index copied out), table and all."""
    gt, depths = map_loop
    d = torch.as_tensor(depths)
    cfg, v = MAP_CFG, MAP_CFG.voxel
    cell = float(cfg.icp.max_corr_dist)
    clouds = [promote_bundle_jit(d[i], K, cfg, False)[2] for i in (0, 5, 10)]
    vmap = mapping.VoxelMap(v, device="cpu")
    for c, i in zip(clouds[:2], (0, 5)):
        vmap.insert(c, gt[i])
    before = [vmap.build_index(cell) for _ in range(2)]
    assert same_bits(before[1], before[0])
    vmap.insert(clouds[2], gt[10])
    after = vmap.build_index(cell)
    fresh = build_grid_index(vmap.cloud, cell)
    assert same_bits(after, fresh) and after.cell == fresh.cell
    assert not torch.equal(after.keys, before[1].keys)
    (entry,) = [e for e in graphs.stats()
                if e["program"] == "build_grid_index"]
    assert entry["captured"] and entry["replays"] == 2


@pytest.mark.parametrize("program", ["_verify_pairs_jit",
                                     "_verify_projective_pairs_jit"])
def test_verification_batches_pad_with_row_zero(last_inputs, sim, program):
    """`verify_batch`'s rule in both batches, replayed: rows past the
    N_LIVE live candidates are row 0 (the padding repeats candidate 0),
    and the live rows are each candidate's own verification."""
    call = _last_program_calls(last_inputs)[program][0]
    for _ in range(2):
        call()
    rows = call()
    assert rows.shape == (4, ROW_SIZE)
    assert all(torch.equal(rows[b], rows[0]) for b in range(N_LIVE, 4))
    assert not torch.equal(rows[1], rows[0])
    assert bool((rows[:N_LIVE, FlatICP.CONVERGED] > 0.5).all())
    one = call(n_live=1, B=1, eager=True)
    assert torch.equal(one[0], rows[0])


@pytest.mark.parametrize("program", ["fuse_sharded", "align_frames_spmd"])
def test_a_gloo_mesh_never_captures_the_fusion_or_the_sharded_icp(
        last_inputs, sim, tmp_path, program):
    """On a gloo group #7 and #8 run op by op whatever the tensors'
    device (`mesh.captures`): no key is ever made, and every call gives
    the eager bits."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cpu")
        assert mesh.backend == "gloo" and not ring_map.captures(mesh)
        call = _last_program_calls(last_inputs)[program][0]
        outs = [bits(call(mesh=mesh)) for _ in range(3)]
        assert not [e for e in graphs.stats() if e["program"] == program]
        assert all(same_bits(o, outs[0]) for o in outs[1:])
        assert same_bits(outs[0], call(mesh=mesh, eager=True))
    finally:
        dist.destroy_process_group()


# -- held to the reference (JAX on the CPU), replayed through SimGraphs ----


def _r(t) -> "jnp.ndarray":
    return jnp.asarray(np.asarray(t))


def _r_cloud(c):
    return RCloud(*(_r(t) for t in c))


def _r_stack(clouds):
    return RCloud(*(jnp.stack([_r(getattr(c, f)) for c in clouds])
                    for f in ("points", "normals", "mask")))


def _r_pyr(pyr):
    return tuple(rticp.Frame(*(_r(t) for t in f)) for f in pyr)


def check_rows(got, want, tol_t):
    """Verification rows: converged and the gates equal, T within tol_t,
    inlier fraction 1e-3, RMS 1e-3 relative, coverage 1e-4 (the fused
    attempt's rows, tests/test_torch_backend.py)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, FlatICP.CONVERGED],
                                  want[:, FlatICP.CONVERGED])
    pg = MAP_CFG.posegraph
    assert [passes_gates(r, pg) for r in got] == [
        passes_gates(r, pg) for r in want]
    np.testing.assert_allclose(got[:, FlatICP.T], want[:, FlatICP.T],
                               atol=tol_t)
    np.testing.assert_allclose(got[:, FlatICP.INLIER_FRACTION],
                               want[:, FlatICP.INLIER_FRACTION], atol=1e-3)
    np.testing.assert_allclose(got[:, FlatICP.RMS], want[:, FlatICP.RMS],
                               rtol=1e-3)
    np.testing.assert_allclose(got[:, COVERAGE_COL], want[:, COVERAGE_COL],
                               atol=1e-4)


def check_alignment(got, want, tol_t, iters_tol=0):
    assert abs(int(got.iters) - int(want.iters)) <= iters_tol
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T),
                               atol=tol_t)
    np.testing.assert_allclose(float(got.inlier_fraction),
                               float(want.inlier_fraction), atol=1e-3)


REFERENCE_PROGRAMS = tuple(p for p in LAST_PROGRAMS
                           if p != "build_grid_index")


@pytest.mark.parametrize("program", REFERENCE_PROGRAMS)
def test_last_program_replay_matches_reference(last_inputs, sim, program,
                                               monkeypatch):
    """Each program's third call (a replay) against the reference's
    jitted program on the same inputs, with the tolerance its own parity
    test states; the sharded two on a one-rank mesh (the reference on a
    one-device mesh)."""
    li = last_inputs
    call = _last_program_calls(li)[program][0]
    for _ in range(2):
        call()
    got = call()
    ricp_cfg, b, pairs = MAP_REF_CFG.icp, li["bundles"], li["pairs"]
    T_inits = _r(li["T_inits"])
    K_lvl = REF_K.scaled(1.0 / 2 ** VERIFY_LVL)
    h, w = H >> VERIFY_LVL, W >> VERIFY_LVL
    if program == "scan_odometry_boundary_jit":
        rp, rpr, ri = rfront.scan_odometry_boundary_jit(
            _r(li["d"]), REF_K, MAP_REF_CFG, 8)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(rpr))
        assert int(got[1].sum()) >= 2
        np.testing.assert_allclose(got[0].numpy(), np.asarray(rp),
                                   atol=TOL_SCAN)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ri),
                                   atol=TOL_SCAN)
    elif program == "align_frames_jit":
        want = rticp.align_frames_jit(_r_pyr(li["pyr5"]), _r_pyr(li["pyr"]),
                                      REF_K, jnp.eye(4), ricp_cfg)
        check_alignment(got, want, TOL_ALIGN_T)
    elif program == "align_clouds_jit":
        want = rticp.align_clouds_jit(_r_cloud(b[0][2]), _r_cloud(b[4][2]),
                                      T_inits[0], ricp_cfg, True)
        check_alignment(got, want, TOL_ALIGN_T)
    elif program == "_verify_pairs_jit":
        want = rloop._verify_pairs_jit(
            _r_stack([b[i][2] for i, _ in pairs]),
            _r_stack([b[j][2] for _, j in pairs]), T_inits, ricp_cfg)
        check_rows(got, want, TOL_ALIGN_T)
    elif program == "_verify_projective_pairs_jit":
        want = rloop._verify_projective_pairs_jit(
            jnp.stack([_r(b[i][1][VERIFY_LVL]) for i, _ in pairs]),
            _r_stack([b[j][2] for _, j in pairs]), K_lvl, T_inits, h, w,
            ricp_cfg)
        check_rows(got, want, TOL_ROW_T)
    elif program == "_batch_verify_jit":
        want = rreloc._batch_verify_jit(
            _r_cloud(li["cloud"]), _r_stack([b[i][2] for i, _ in pairs]),
            T_inits, ricp_cfg)
        check_rows(got, want, TOL_ALIGN_T)
    elif program == "_batch_verify_projective_jit":
        want = rreloc._batch_verify_projective_jit(
            _r_cloud(li["cloud"]),
            jnp.stack([_r(b[i][1][VERIFY_LVL]) for i, _ in pairs]), K_lvl,
            T_inits, h, w, ricp_cfg)
        check_rows(got, want, TOL_ROW_T)
    elif program == "fuse_sharded":
        fuse = rfusion.make_fuse_fn(rmesh.make_mesh(1), MAP_REF_CFG.voxel,
                                    MAP_CFG.voxel.capacity)[0]
        shard, stats = fuse(_r_cloud(li["map"]), _r_cloud(b[8][2]),
                            _r(li["T"]))
        np.testing.assert_array_equal(got[0].mask.numpy(),
                                      np.asarray(shard.mask))
        np.testing.assert_allclose(got[0].points.numpy(),
                                   np.asarray(shard.points), atol=1e-5)
        np.testing.assert_allclose(got[0].normals.numpy(),
                                   np.asarray(shard.normals), atol=1e-4)
        assert int(got[1].dropped) == int(stats.dropped) == 0
        assert int(got[1].routed) == int(stats.routed) > 0
    else:
        fn = rsharded.make_aligned_spmd_fn(rmesh.make_mesh(1), ricp_cfg)
        want = fn(_r_pyr(li["pyr5"]), _r_pyr(li["pyr"]), REF_K, jnp.eye(4))
        check_alignment(got, want, TOL_SPMD_T, iters_tol=3)


# -- a revisit with a yaw offset, verified from the identity --------------

REVISIT_YAWS = (0.05, 0.1, 0.15, 0.3)


def _yawed(T: np.ndarray, yaw: float) -> np.ndarray:
    """T with the camera turned by `yaw` about its own y axis (image
    down: a yaw of the view)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.eye(4)
    R[0, 0], R[0, 2], R[2, 0], R[2, 2] = c, s, -s, c
    return T @ R


@pytest.mark.parametrize("path", ["projective", "grid"])
@pytest.mark.parametrize("yaw", REVISIT_YAWS)
def test_yawed_revisit_through_graphed_verification_matches_reference(
        map_loop, sim, yaw, path):
    """The descriptor candidate's case: keyframe 4 revisited from its own
    position turned by `yaw`, verified from the identity (as
    `propose_attempt` seeds a descriptor pair) through the graphed batch
    (B = 2, one live), replayed, against the reference's jitted batch.
    Both packages take the same gate decision; where they close the loop
    the row agrees to the batch's tolerance (a rejected row never reaches
    the graph, and the path of an ICP that does not converge is not held
    to float32 agreement).  The gap to the true relative pose is printed.
    The smallest yaw closes in both."""
    gt, depths = map_loop
    cfg = MAP_CFG
    T_i = gt[4]
    T_j = _yawed(T_i, yaw)
    d_j = render_depth(T_j, K, H, W, seed=99).astype(np.float32)
    bi = promote_bundle_jit(torch.as_tensor(depths[4]), K, cfg, False)
    bj = promote_bundle_jit(torch.as_tensor(d_j), K, cfg, False)
    T_inits = torch.eye(4).expand(2, 4, 4).contiguous()
    K_lvl = K.scaled(1.0 / 2 ** VERIFY_LVL)
    h, w = H >> VERIFY_LVL, W >> VERIFY_LVL
    cj = bj[2]
    if path == "projective":
        def call():
            return loopclosure.verify_batch(
                [bi[1][VERIFY_LVL]] * 2, [cj.points] * 2, [cj.normals] * 2,
                [cj.mask] * 2, K_lvl, T_inits, 1, h, w, cfg.icp)
        want = rloop._verify_projective_pairs_jit(
            jnp.stack([_r(bi[1][VERIFY_LVL])] * 2), _r_stack([cj] * 2),
            REF_K.scaled(1.0 / 2 ** VERIFY_LVL), _r(T_inits), h, w,
            MAP_REF_CFG.icp)
        tol = TOL_ROW_T
    else:
        def call():
            return loopclosure.verify_batch_grid([bi[2]] * 2, [cj] * 2,
                                                 T_inits, 1, cfg.icp)
        want = rloop._verify_pairs_jit(_r_stack([bi[2]] * 2),
                                       _r_stack([cj] * 2), _r(T_inits),
                                       MAP_REF_CFG.icp)
        tol = TOL_ALIGN_T
    for _ in range(2):
        call()
    got = call().numpy()
    (entry,) = [e for e in graphs.stats() if e["replays"] == 2]
    assert entry["captured"]
    closes = passes_gates(got[0], cfg.posegraph)
    assert closes == passes_gates(np.asarray(want)[0], MAP_REF_CFG.posegraph)
    if closes:
        check_rows(got, want, tol)
    T_true = np.linalg.inv(T_i) @ T_j
    E = np.linalg.inv(got[0][FlatICP.T].reshape(4, 4)) @ T_true
    gap_t = float(np.linalg.norm(E[:3, 3]))
    gap_r = float(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    print(f"yaw {yaw} {path}: closes {closes} in both, gap {gap_t:.3e} m, "
          f"{gap_r:.3e} rad")
    if yaw == REVISIT_YAWS[0]:
        assert closes


# ---------------------------------------------------------------------------
# The distributed programs: the edge-sharded pose graph, the landmark-
# sharded map BA and the batched aligner
# ---------------------------------------------------------------------------

DIST_PROGRAMS = ("optimize_pose_graph_spmd", "optimize_map_ba_spmd",
                 "batched_align_frames")
# tolerances to the reference, as each function's own parity test holds it
TOL_DIST_PG = 5e-4      # tests/test_torch_dist.py TOL_PG
TOL_DIST_BA = 5e-5      # tests/test_torch_map_ba.py (tests/test_map_ba.py)
TOL_DIST_BATCH = 2e-4   # tests/test_torch_batch_eval.py TOL_T


@pytest.fixture(scope="module")
def dist_inputs(last_inputs):
    """The reference's own problems of tests/test_torch_dist.py (the noisy
    10-node ring with a loop edge; tests/test_map_ba.py's SLAM-like map BA
    problem), as the reference's trees and the port's, and a batch of two
    frame pairs (frame 5 against frame 6, from the identity and from 1 cm
    off)."""
    from tests.test_torch_dist import ring_graph, slam_cfg
    from tests.test_map_ba import _make_slam_like
    from tpuslam_torch.icp import Frame
    from tpuslam_torch.interop import (
        map_ba_problem_from_reference,
        pose_graph_from_reference,
    )

    r_graph, r_pg_cfg = ring_graph()
    _gt, _init, r_prob, r_bgraph, r_ba_cfg, _m = _make_slam_like(
        np.random.default_rng(1))
    li = last_inputs
    moved = torch.eye(4)
    moved[0, 3] = 0.01
    T0s = torch.stack([torch.eye(4), moved])

    def stack(pyr):
        return tuple(Frame(*(torch.stack([t, t]) for t in f)) for f in pyr)

    return dict(
        mesh=li["mesh"], r_graph=r_graph, r_pg_cfg=r_pg_cfg,
        graph=pose_graph_from_reference(r_graph, "cpu"),
        pg_cfg=slam_cfg(posegraph=r_pg_cfg).posegraph,
        r_bgraph=r_bgraph, r_prob=r_prob, r_ba_cfg=r_ba_cfg,
        bgraph=pose_graph_from_reference(r_bgraph, "cpu"),
        prob=map_ba_problem_from_reference(r_prob, "cpu"),
        ba_cfg=slam_cfg(posegraph=r_ba_cfg).posegraph,
        src=stack(li["pyr5"]), dst=stack(li["pyr"]), T0s=T0s)


def first_members(pyr, n: int):
    """The first `n` members of a batched pyramid."""
    return tuple(type(f)(*(t[:n] for t in f)) for f in pyr)


def _dist_program_calls(di):
    """name → (call(**changes) with the program's arguments, {what: the
    changes that give another key}, changes of tensor values only)."""
    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.dist.batch_eval import make_batched_aligner

    group = Mesh(GROUPS[0], 0, 1, torch.device("cpu"))
    icp = MAP_CFG.icp
    icp2 = dataclasses.replace(icp, max_iters=icp.max_iters + 1)
    g, pg = di["graph"], di["pg_cfg"]
    prob, ba = di["prob"], di["ba_cfg"]
    # another bucket: the graph's storage doubled with unused slots
    g2 = posegraph.PoseGraph(
        torch.cat([g.poses, torch.eye(4).expand_as(g.poses)]),
        torch.cat([g.node_mask, torch.zeros_like(g.node_mask)]),
        *(torch.cat([t, torch.zeros_like(t)]) for t in g[2:]))
    noisy = g._replace(poses=g.poses.clone())
    noisy.poses[1:, 0, 3] += 0.01
    # more landmarks (the map twice: every observation still indexes it)
    wide = prob._replace(**{f: torch.cat([getattr(prob, f)] * 2) for f in (
        "map_points", "map_normals", "map_mask")})
    half = prob._replace(**{f: getattr(prob, f)[:prob.obs_w.shape[0] // 2]
                            for f in ("obs_pose", "obs_map", "obs_p",
                                      "obs_w")})
    moved = di["T0s"].clone()
    moved[:, 1, 3] += 0.01
    return {
        "optimize_pose_graph_spmd": (
            lambda mesh=di["mesh"], graph=g, cfg=pg, huber=0.5,
            eager=False: optimize_pose_graph_spmd(graph, cfg, mesh, huber,
                                                  eager=eager),
            {"a mesh of a group": dict(mesh=group),
             "cfg": dict(cfg=dataclasses.replace(pg, gn_iters=3)),
             "huber": dict(huber=0.4), "bucket": dict(graph=g2)},
            dict(graph=noisy)),
        "optimize_map_ba_spmd": (
            lambda mesh=di["mesh"], graph=di["bgraph"], prob=prob, cfg=ba,
            huber=0.05, edge_huber=0.5, eager=False:
            map_ba.optimize_map_ba_spmd(graph, prob, cfg, mesh, huber,
                                        edge_huber, eager=eager),
            {"a mesh of a group": dict(mesh=group),
             "cfg": dict(cfg=dataclasses.replace(ba, gn_iters=3)),
             "huber": dict(huber=0.04), "edge huber": dict(edge_huber=0.4),
             "landmarks": dict(prob=wide), "observations": dict(prob=half)},
            dict(prob=prob._replace(obs_p=prob.obs_p * 1.01))),
        "batched_align_frames": (
            lambda mesh=di["mesh"], icp=icp, K=K, src=di["src"],
            dst=di["dst"], T0s=di["T0s"], eager=False:
            make_batched_aligner(mesh, icp)(src, dst, K, T0s, eager=eager),
            {"a mesh of a group": dict(mesh=group), "cfg": dict(icp=icp2),
             "K": dict(K=K._replace(fx=K.fx * 1.01)),
             "batch": dict(src=first_members(di["src"], 1),
                           dst=first_members(di["dst"], 1),
                           T0s=di["T0s"][:1]),
             "levels": dict(src=di["src"][:2], dst=di["dst"][:2])},
            dict(T0s=moved)),
    }


def test_dist_program_calls_cover_every_program(dist_inputs):
    assert tuple(_dist_program_calls(dist_inputs)) == DIST_PROGRAMS
    assert set(DIST_PROGRAMS) <= {p.name for p in graphs._programs}
    from tpuslam_torch.dist import mesh as mesh_mod

    assert set(DIST_PROGRAMS) <= {p.name for p in
                                  mesh_mod._collective_programs}


@pytest.mark.parametrize("program", DIST_PROGRAMS)
def test_dist_program_key_changes_with_each_static_argument(
        dist_inputs, monkeypatch, program):
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group: "nccl")
    call, changes, values = _dist_program_calls(dist_inputs)[program]
    k0 = entry_key(call)
    assert entry_key(lambda: call(**values)) == k0          # values: no
    keys = {what: entry_key(lambda kw=kw: call(**kw))
            for what, kw in changes.items()}
    assert all(k != k0 for k in keys.values()), keys
    assert len(set(keys.values())) == len(keys)


@pytest.mark.parametrize("program", DIST_PROGRAMS)
def test_dist_program_replays_give_its_eager_bits(dist_inputs, sim,
                                                  program):
    """The first call (the warm-up), the second (the capture and a
    replay) and a third (a replay), each bit-equal to the eager run, on a
    one-rank mesh without a group."""
    call = _dist_program_calls(dist_inputs)[program][0]
    ref = bits(call(eager=True))
    got = [bits(call()) for _ in range(3)]
    assert all(same_bits(g, ref) for g in got)
    (entry,) = [e for e in graphs.stats() if e["program"] == program]
    assert entry["captured"] and entry["replays"] == 2


@pytest.mark.parametrize("program", DIST_PROGRAMS)
def test_a_gloo_mesh_never_captures_the_distributed_programs(
        dist_inputs, sim, tmp_path, program):
    """On a gloo group each runs op by op whatever the tensors' device
    (`mesh.captures`): no key is ever made, and every call gives the
    eager bits."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cpu")
        assert mesh.backend == "gloo" and not ring_map.captures(mesh)
        call = _dist_program_calls(dist_inputs)[program][0]
        outs = [bits(call(mesh=mesh)) for _ in range(3)]
        assert not [e for e in graphs.stats() if e["program"] == program]
        assert all(same_bits(o, outs[0]) for o in outs[1:])
        assert same_bits(outs[0], call(mesh=mesh, eager=True))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("program", DIST_PROGRAMS)
def test_dist_program_replay_matches_reference(dist_inputs, sim, program):
    """Each program's third call (a replay) on a one-rank mesh against the
    reference's jitted program on a one-device mesh, with the tolerance
    of the function's own parity test."""
    from tpuslam.backend import map_ba as rba
    from tpuslam.backend.distba import optimize_pose_graph_spmd as r_pg
    from tpuslam.dist import batch_eval as rbatch

    di = dist_inputs
    call = _dist_program_calls(di)[program][0]
    for _ in range(2):
        call()
    got = call()
    rmesh1 = rmesh.make_mesh(1)
    if program == "optimize_pose_graph_spmd":
        want, want_cost = r_pg(di["r_graph"], di["r_pg_cfg"], rmesh1)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=TOL_DIST_PG)
        np.testing.assert_allclose(float(got[1]), float(want_cost),
                                   rtol=1e-3)
    elif program == "optimize_map_ba_spmd":
        rp, rm, _rc = rba.optimize_map_ba_spmd(
            di["r_bgraph"], di["r_prob"], di["r_ba_cfg"], rmesh1)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(rp),
                                   atol=TOL_DIST_BA)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(rm),
                                   atol=TOL_DIST_BA)
    else:
        want = rbatch.make_batched_aligner(rmesh1, MAP_REF_CFG.icp)(
            _r_pyr(di["src"]), _r_pyr(di["dst"]), REF_K, _r(di["T0s"]))
        assert got.T.shape == (2, 4, 4)
        np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T),
                                   atol=TOL_DIST_BATCH)
        np.testing.assert_array_equal(got.iters.numpy(),
                                      np.asarray(want.iters))
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(want.converged))
