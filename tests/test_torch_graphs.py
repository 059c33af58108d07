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
"""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from tpuslam_torch import graphs
from tpuslam_torch.backend import loopclosure, posegraph
from tpuslam_torch.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
from tpuslam_torch.frontend import (
    FlatChunk,
    FlatFrozen,
    FrozenState,
    SuperChunkCarry,
    _frozen_sub_chunk,
    _select,
    _track,
    initial_state,
    pack_pyramid,
    preprocess,
    process_frame_jit,
    promote_bundle_jit,
    scan_chunk,
    scan_odometry,
    scan_step,
    scan_superchunk_frozen,
)
from tpuslam_torch.kernels import _build
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
