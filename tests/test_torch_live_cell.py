"""The benchmark's per-frame cell, `slam-loop-live-vga`
(`slambench/entries/slam_process.py`: every frame through
`SlamSystem.process`), and the spans and counters of the per-frame path
that its per-layer metrics read.  On the CPU at the small size of
`slambench/tests/small.py`, the port on its plain twins; each benchmark
run in a fresh interpreter."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench.core import spec  # noqa: E402
from slambench.core.trace import Slice  # noqa: E402
from slambench.inputs.scene import render_pool  # noqa: E402
from slambench.tests.small import run_small, small_cell  # noqa: E402
from slambench.tests.test_slambench_faults import UNCHANGED_STEP  # noqa: E402

torch.set_num_threads(1)

CELL = "slam-loop-live-vga"
FRAMES = 8                  # a session's frames in the benchmark runs
METRICS = ("frame_track_device_us_per_frame", "frame_host_us_per_frame",
           "frame_promote_us_per_promotion", "frame_attempt_ms_per_attempt")
HOST_METRICS = {"frame_host_us_per_frame", "frame_attempt_ms_per_attempt"}

MOVED_POSE = """
# every frame's pose moved by a millimetre where `process` makes it
import numpy as np
from tpuslam_torch import slam
orig = slam.SlamSystem.process
def moved(self, depth, timestamp=0.0):
    out = orig(self, depth, timestamp).copy()
    kf, T = self.odo.frame_refs[-1]
    T = np.array(T, dtype=np.float64)
    T[0, 3] += 1e-3
    self.odo.frame_refs[-1] = (kf, T)
    out[0, 3] += 1e-3
    return out
slam.SlamSystem.process = moved
"""


def _run(**kw) -> dict:
    rc, line, err, tops = run_small(CELL, frames=FRAMES, **kw)
    assert rc == 0, err[-3000:]
    assert not tops & {"jax", "jaxlib", "flax", "tpuslam"}, tops
    return line, err


@pytest.fixture(scope="module")
def traced_run():
    """One sound traced run, read by the two tests below."""
    return _run(traced=True)


def test_a_sound_run_is_correct(traced_run):
    line, err = traced_run
    assert line["correct"] is True, err[-3000:]
    assert set(line["compared"]) == {"pose_gap_tracked", "pose_gap_final",
                                     "keyframe_mismatch", "closure_mismatch"}
    for name, c in line["compared"].items():
        assert isinstance(c["value"], float), (name, c)
        assert c["value"] <= c["limit"], (name, c)


@pytest.mark.parametrize("fault", [UNCHANGED_STEP, MOVED_POSE],
                         ids=["unchanged_step", "moved_pose"])
def test_a_broken_per_frame_path_is_not_correct(fault):
    line, err = _run(prelude=fault)
    assert line["correct"] is False, err[-3000:]
    assert any(c["value"] == "no reading" or c["value"] > c["limit"]
               for c in line["compared"].values())


def test_a_traced_run_reads_the_host_spans(traced_run):
    line, err = traced_run
    m = line["metrics"]
    # the CPU has no device trace: the two device readers find nothing
    assert HOST_METRICS == set(m) & set(METRICS), (m, err[-3000:])
    assert m["frame_host_us_per_frame"]["value"] > 0
    assert m["frame_host_us_per_frame"]["unit"] == "us/frame"
    assert m["frame_attempt_ms_per_attempt"]["value"] > 0
    assert m["frame_attempt_ms_per_attempt"]["unit"] == "ms/attempt"


def _small_system(**kw):
    from tpuslam_torch.config import Intrinsics, SLAMConfig
    from tpuslam_torch.slam import SlamSystem

    _b, _c, config, traffic = small_cell(CELL, frames=24)
    traffic["pool"] = 1
    sensor = config["sensor"]
    pool = render_pool(traffic, sensor["height"], sensor["width"], 11,
                       torch.device("cpu"))
    cfg = SLAMConfig.from_json(json.dumps(config["slam_config"]))
    system = SlamSystem(Intrinsics(*pool["K"]), cfg.validate(),
                        device="cpu", **kw)
    return system, pool["depth"][0], pool["timestamps"]


def _traced(fn) -> object:
    from tpuslam_torch.utils import profiling

    profiling.start()
    try:
        fn()
    finally:
        tr = profiling.stop()
    return tr


def test_the_per_frame_path_opens_its_spans_and_counters():
    _b, _c, config, _t = small_cell(CELL)
    system, depth, ts = _small_system(
        **{k: v for k, v in config["system"].items() if k != "chunk"})
    tr = _traced(lambda: [system.process(depth[f], float(ts[f]))
                          for f in range(depth.shape[0])])
    frames = depth.shape[0]
    kfs = len(system.odo.keyframes)
    assert kfs >= 3 and system.closures
    assert len(tr.named("slam.process")) == frames
    assert all(s.n == 1 for s in tr.named("slam.process"))
    # every frame but the first is tracked and read back
    assert len(tr.named("odo.readback")) == frames - 1
    # every promotion after the first frame's keyframe
    assert len(tr.named("odo.promote")) == kfs - 1
    assert tr.counters["odo.promotions"] == kfs - 1
    attempts = tr.named("slam.frame_attempt")
    # one synchronous attempt a new keyframe, the first frame's included
    assert len(attempts) == tr.counters["slam.frame_attempts"] == kfs
    by_id = {s.id: s for s in tr.spans}
    for s in tr.named("odo.readback", "odo.promote", "slam.frame_attempt"):
        top = s
        while top.parent != -1:
            top = by_id[top.parent]
        assert top.name == "slam.process"
    # the chunk path's names stay the chunk path's
    assert not tr.named("slam.attempt", "slam.readback",
                        "slam.promote_bundle")


def test_the_boundary_path_opens_them_only_in_its_bootstrap():
    from tpuslam_torch import slam

    system, depth, ts = _small_system(chunk_mode="boundary", chunk_sub=4)
    committed = []
    orig = slam.SlamSystem._commit_chunk_end

    def counted(self):
        new_kf = orig(self)
        committed.append(new_kf)
        return new_kf

    slam.SlamSystem._commit_chunk_end = counted
    try:
        tr = _traced(lambda: [system.process_chunk(depth[c0:c0 + 8],
                                                   ts[c0:c0 + 8])
                              for c0 in range(0, depth.shape[0], 8)])
    finally:
        slam.SlamSystem._commit_chunk_end = orig
    by_id = {s.id: s for s in tr.spans}

    def in_bootstrap(s):
        while s.parent != -1:
            s = by_id[s.parent]
            if s.name == "slam.bootstrap":
                return True
        return False

    assert tr.named("slam.bootstrap")
    for s in tr.named("slam.frame_attempt", "odo.promote", "slam.process"):
        assert in_bootstrap(s), s
    # one `slam.attempt` a boundary call that committed a keyframe
    assert committed.count(True) >= 1
    assert len(tr.named("slam.attempt")) == committed.count(True)
    assert tr.counters.get("slam.frame_attempts", 0) == len(
        tr.named("slam.frame_attempt"))


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_nothing_without_its_spans(name):
    read = spec.module("metrics", name).read
    assert read(SimpleNamespace(slice=None)) is None
    assert read(SimpleNamespace(slice=Slice(wall_s=1.0))) is None
    chunk_spans = Slice(wall_s=1.0, spans=[
        ("bench.process_chunk", 0.0, 0.5, 1), ("slam.scan", 0.1, 0.2, 1),
        ("slam.readback", 0.2, 0.3, 1), ("slam.attempt", 0.3, 0.4, 1)],
        ops=[("k", 0.15, 0.25)], busy=[(0.15, 0.25)], records=[{}])
    assert read(SimpleNamespace(slice=chunk_spans)) is None


def test_the_readers_on_a_made_slice():
    """Two frames: frame 0 tracked and promoted with an attempt, frame 1
    tracked; device operations placed in each span."""
    spans = [
        ("slam.process", 0.0, 1.0, 1), ("odo.process", 0.0, 0.5, 1),
        ("odo.readback", 0.2, 0.3, 1), ("odo.promote", 0.3, 0.5, 1),
        ("slam.frame_attempt", 0.6, 0.9, 1),
        ("slam.process", 1.0, 1.5, 1), ("odo.process", 1.0, 1.4, 1),
        ("odo.readback", 1.2, 1.3, 1)]
    ops = [("track", 0.05, 0.15), ("copy", 0.25, 0.26),
           ("pack", 0.35, 0.40), ("cloud", 0.45, 0.55),
           ("verify", 0.65, 0.75),
           ("track", 1.05, 1.15), ("copy", 1.25, 1.27)]
    sl = Slice(wall_s=2.0, spans=spans, ops=ops)
    ctx = SimpleNamespace(slice=sl)

    def read(name):
        return spec.module("metrics", name).read(ctx)

    assert read("frame_track_device_us_per_frame") == pytest.approx(
        1e6 * (0.11 + 0.12) / 2)
    assert read("frame_promote_us_per_promotion") == pytest.approx(
        1e6 * (0.05 + 0.10))
    assert read("frame_attempt_ms_per_attempt") == pytest.approx(300.0)
    # 1.0 s + 0.5 s of wall less 0.1 + 0.2 + 0.3 and 0.1 of children
    assert read("frame_host_us_per_frame") == pytest.approx(
        1e6 * (0.4 + 0.4) / 2)
