"""The port's tracer (tpuslam_torch/utils/profiling.py).

On the CPU: the off path hands out one shared object and records
nothing; nested spans get their parents and self times; counters reset
and read back; a span shares torch.profiler's clock; a replay under
`SimGraphs` (graphs simulated on the CPU) is a `graphs.replay` span with
its warm-up and capture counted; a small SLAM session shows one
`slam.bootstrap` and one `slam.finalize` a session and `odo.process`
once a bootstrap frame; busy time is the union of the leaves' device
intervals.  On the card (`-m cuda`): over 2 s the anchors place a
third one within 50 µs of its reading, a replay's device interval is no
shorter than CUDA events give for the same graph, and a Program's second
call counts one capture.  The file imports nothing of JAX at its top, so
its `cuda` case runs on a machine without it:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest \
        -o addopts=""
"""

import statistics
import threading
import time

import numpy as np
import pytest
import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import (
    ICPConfig,
    Intrinsics,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
    VoxelConfig,
)
from tpuslam_torch.data.synthetic import loop_trajectory, render_depth
from tpuslam_torch.slam import SlamSystem
from tpuslam_torch.utils import profiling

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


@pytest.fixture
def tracer():
    """Start the tracer; stop it after the test if the test did not."""
    profiling.start()
    yield
    if profiling._tracer is not None:
        profiling.stop()


def test_the_off_path_records_nothing():
    assert profiling._tracer is None
    spans = [profiling.span("a"), profiling.span("b", device=True, n=3),
             profiling.span("c", since=5)]
    assert all(s is profiling.OFF for s in spans)
    with profiling.span("a") as sp:
        sp.edge_in()
        sp.edge_out()
    profiling.count("a")
    assert profiling.now() == 0
    profiling.start()
    tr = profiling.stop()
    assert tr.spans == [] and tr.counters == {} and tr.drift_ns is None
    with pytest.raises(RuntimeError):
        profiling.stop()


def test_nesting_gives_parents_and_self_times(tracer):
    with profiling.span("outer"):
        time.sleep(0.004)
        with profiling.span("mid", n=7):
            time.sleep(0.006)
            with profiling.span("inner"):
                time.sleep(0.002)
        t = profiling.now()
        time.sleep(0.003)
        with profiling.span("late", since=t):
            pass

    def other():
        with profiling.span("other"):
            time.sleep(0.001)

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    tr = profiling.stop()
    by = {s.name: s for s in tr.spans}
    assert [s.name for s in tr.spans] == ["inner", "mid", "late", "outer",
                                         "other"]
    assert by["outer"].parent == -1 and by["other"].parent == -1
    assert by["mid"].parent == by["outer"].id
    assert by["inner"].parent == by["mid"].id
    assert by["late"].parent == by["outer"].id
    assert by["other"].thread != by["outer"].thread
    assert by["mid"].n == 7 and by["inner"].n == 0
    assert by["late"].end_ns - by["late"].start_ns >= 3e6
    for s in tr.spans:
        assert tr.start_ns <= s.start_ns <= s.end_ns <= tr.stop_ns
        assert s.device_start_ns is None and not s.eager
    wall = {n: s.end_ns - s.start_ns for n, s in by.items()}
    assert tr.self_ns(by["inner"]) == wall["inner"]
    assert tr.self_ns(by["mid"]) == wall["mid"] - wall["inner"]
    assert tr.self_ns(by["outer"]) == (wall["outer"] - wall["mid"]
                                       - wall["late"])
    assert tr.self_ns(by["outer"]) >= 4e6
    assert tr.children(by["outer"]) == [by["mid"], by["late"]]
    assert tr.device_leaves() == [] and tr.busy_ns(0, 2 ** 62) == 0


def test_busy_is_the_union_of_the_leaves_device_intervals():
    def edged(name, sid, parent, d0, d1, eager=False):
        return profiling.Span(name, 0, 1, sid, parent, 0, d0, d1, eager, 0)

    tr = profiling.Trace(0, 100, [
        edged("inner", 2, 1, 10.0, 20.0),
        edged("outer", 1, -1, 5.0, 40.0, eager=True),  # holds an edged span
        edged("a", 3, -1, 15.0, 30.0),
        edged("b", 4, -1, 50.0, 60.0, eager=True),
        edged("host", 5, 4, None, None),
    ], {})
    assert [s.name for s in tr.device_leaves()] == ["inner", "a", "b"]
    assert tr.busy == [[10.0, 30.0], [50.0, 60.0]]
    assert tr.busy_ns(0, 100) == 30.0
    assert tr.busy_ns(25, 55) == 10.0 and tr.busy_ns(30, 50) == 0.0
    assert profiling.union([(3, 4), (1, 2), (2, 3), (5, 5)]) == [[1, 4]]


def test_device_times_fall_on_the_line_through_the_anchors():
    line = profiling.through([(0.0, 1000.0), (10e6, 1000.0 + 10e6 + 80),
                              (30e6, 1000.0 + 30e6 + 40)])
    assert line(0.0) == 1000.0 and line(30e6) == 1000.0 + 30e6 + 40
    assert line(5e6) == 1000.0 + 5e6 + 40           # halfway to the bend
    assert line(20e6) == 1000.0 + 20e6 + 60
    assert line(40e6) == 1000.0 + 40e6 + 20         # past the last anchor
    assert profiling.through([(0.0, 7.0)])(3.0) == 10.0
    # an anchor stamped 300 ns late takes its neighbours' offset
    pts = [(0.0, 100.0), (50.0, 150.0), (100.0, 200.0 - 300.0),
           (300.0, 400.0)]
    assert profiling.upper_envelope(pts, reach=60.0) == [
        (0.0, 100.0), (50.0, 150.0), (100.0, 200.0), (300.0, 400.0)]


def test_counters_reset_and_read_back(tracer):
    profiling.count("graphs.capture")
    profiling.count("graphs.capture", 3)
    profiling.count("x")
    assert profiling.stop().counters == {"graphs.capture": 4, "x": 1}
    profiling.count("x")                # off: not counted
    profiling.start()
    assert profiling.stop().counters == {}


def test_a_span_shares_the_profilers_clock(tracer):
    """Each span's start lies within 100 µs of the start of the
    record_function it opens, under a warm CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with torch.profiler.record_function("warm"):
                torch.ones(4)
        for i in range(20):
            with profiling.span(f"clock.{i}"):
                torch.ones(4)
    tr = profiling.stop()
    starts = {ev.name(): ev.start_ns()
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("clock.")}
    assert len(starts) == 20
    gaps = [abs(starts[s.name] - s.start_ns) for s in tr.spans]
    assert max(gaps) <= 100_000, gaps
    assert statistics.median(gaps) <= 20_000, gaps


def _double(_state, x):
    return (), x * 2.0 + 1.0


def test_a_replay_is_a_span_and_builds_are_counted(monkeypatch, tracer):
    from tests.test_torch_graphs import SimGraphs

    graphs.clear()
    monkeypatch.setattr(graphs, "_backend", SimGraphs())
    prog = graphs.Program("tracing_double", _double)
    x = torch.arange(6.0)
    for _ in range(4):                  # warm-up, capture, two replays
        assert torch.equal(prog.run(x), x * 2.0 + 1.0)
    tr = profiling.stop()
    graphs.clear()
    assert tr.counters == {"graphs.warm_up": 1, "graphs.capture": 1}
    reps = tr.named("graphs.replay")
    (cap,) = tr.named("graphs.capture")
    (warm,) = tr.named("graphs.warm_up")
    assert len(reps) == 3 and warm.parent == -1
    assert cap.parent == reps[0].id
    assert all(r.start_ns < r.end_ns and r.device_start_ns is None
               for r in reps)


def test_a_slam_session_has_one_bootstrap_and_one_finalize(tracer):
    frames, sessions = 16, 2
    gt = loop_trajectory(frames, cycles=1, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(frames)]).astype(np.float32)
    for _ in range(sessions):
        slam = SlamSystem(K, CFG, chunk_mode="boundary", chunk_sub=4,
                          device="cpu")
        for c0 in range(0, frames, 8):
            slam.process_chunk(depths[c0:c0 + 8],
                               np.arange(c0, c0 + 8) / 30.0)
        slam.finalize()
    tr = profiling.stop()
    by = {s.id: s for s in tr.spans}
    boots = tr.named("slam.bootstrap")
    assert len(boots) == len(tr.named("slam.finalize")) == sessions
    procs = tr.named("odo.process")
    assert len(procs) == 4 * sessions
    # each bootstrap frame is a `SlamSystem.process` call
    assert all(by[p.parent].name == "slam.process" for p in procs)
    assert all(by[by[p.parent].parent].name == "slam.bootstrap"
               for p in procs)
    assert [by[p.parent].name for p in tr.named("odo.preprocess")] == [
        "odo.process"] * sessions
    assert all(by[s.parent].name == "slam.finalize"
               for s in tr.named("slam.final_solve"))
    # the boundary scan covers each chunk's frames but the bootstrap's
    assert sum(s.n for s in tr.named("slam.scan")) == sessions * (frames - 4)
    assert len(tr.named("slam.readback")) == len(tr.named("slam.scan"))


@pytest.mark.cuda
def test_device_edges_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (device edges are CUDA events)")
    dev = torch.device("cuda:0")
    graphs.clear()
    a = torch.randn(1024, 1024, device=dev)

    def work(_state, x):
        for _ in range(8):
            x = torch.tanh(x @ a) * 0.5
        return (), x

    prog = graphs.Program("tracing_matmuls", work)
    x = torch.randn(1024, 1024, device=dev)
    prog.run(x)                         # warm-up
    profiling.start()
    prog.run(x)                         # capture, then a replay
    for _ in range(20):
        prog.run(x)
    mid = None
    mid_ev = torch.cuda.Event(enable_timing=True)
    mid_ev.record()                     # made before it is timed
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:  # the anchors 2 s apart
        prog.run(x)
        if mid is None and time.perf_counter() > t_end - 1.0:
            torch.cuda.synchronize()    # a third anchor between them
            mid = (time.time_ns(), mid_ev)
            mid_ev.record()
        time.sleep(0.05)
    tr = profiling.stop()
    assert tr.counters == {"graphs.capture": 1}
    # the two clocks drift apart by a few ppm (51 µs over these 2 s on one
    # H100 host): events are placed through the anchors between them
    assert tr.drift_ns is not None and len(tr.anchors) > 2
    assert abs(tr.place(mid[1]) - mid[0]) <= 50_000, tr.drift_ns
    # the same graph timed by CUDA events over back-to-back replays
    (entry,) = prog.entries()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        entry.graph.replay()
    e1.record()
    e1.synchronize()
    per_replay = e0.elapsed_time(e1) * 1e6 / 20
    reps = tr.named("graphs.replay")
    assert len(reps) > 40
    spans = [r.device_end_ns - r.device_start_ns for r in reps]
    assert statistics.median(spans) >= 0.99 * per_replay, (
        statistics.median(spans), per_replay)
    assert len(tr.device_leaves()) == len(reps)
    for r in reps:      # the device runs a replay after its launch began
        assert r.device_start_ns >= r.start_ns - 20_000
    graphs.clear()
