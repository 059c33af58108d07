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
"""

import contextlib
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_slam import loop_trajectory as map_loop_trajectory
from tests.test_torch_map_slam import CFG as MAP_REF_CFG
from tests.test_torch_map_slam import K as REF_K
from tests.test_torch_map_slam import POSE_TOL
from tests.test_torch_map_slam import run as run_map
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch import graphs, mapping
from tpuslam_torch import slam as slam_mod
from tpuslam_torch.backend import loopclosure, map_ba, posegraph
from tpuslam_torch.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
from tpuslam_torch.dist import ring_map
from tpuslam_torch.dist.mesh import Mesh, make_mesh
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
    scan_step,
    scan_superchunk_frozen,
)
from tpuslam_torch.geom.voxel import voxel_downsample
from tpuslam_torch.icp import align_map_to_frame, align_to_index
from tpuslam_torch.icp import flat_icp_scalars
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels.correspond import build_grid_index
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
