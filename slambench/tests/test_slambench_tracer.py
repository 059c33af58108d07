"""The port's tracer in a run, on the CPU at the small size: a traced run
through `slambench/tools/trace_window.py` reports the tracer's host
numbers and no device number (the CPU has no events), and an untraced
run keeps the tracer off and its result line's keys."""

import json

from slambench.tests.small import run_small

TRACED = "from slambench.tools import trace_window\ntrace_window.install()"
# an untraced run that turned the tracer on would say so
WATCH = """
import sys
from tpuslam_torch.utils import profiling
_start = profiling.start
def _watched(*a, **k):
    print("TRACER STARTED", file=sys.stderr)
    return _start(*a, **k)
profiling.start = _watched
"""
DEVICE = ("device_idle_pct", "scan_idle_us_per_frame", "replay_host_us")


def _trace_line(err: str) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith("[trace] {")]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0][len("[trace] "):])


def test_a_traced_slam_run_reads_the_tracer():
    rc, res, err, _ = run_small("slam-loop-vga", traced=True,
                                prelude=TRACED)
    assert rc == 0, err[-3000:]
    m = res["metrics"]
    assert m["finalize_ms_per_session"]["value"] > 0
    assert m["finalize_ms_per_session"]["unit"] == "ms/session"
    assert m["graph_builds_in_window"]["value"] == 0
    assert not set(DEVICE) & set(m)
    # the slice's readers are still there, beside the tracer's numbers
    assert "slam_host_ms_per_chunk" in m
    checks = _trace_line(err)
    assert checks["drift_us"] is None and checks["eager_share_of_busy"] == {}
    assert set(checks["tracer_ms_per_chunk"]) == {
        "slam_host_ms_per_chunk", "attempt_ms_per_chunk",
        "promote_ms_per_chunk"}
    assert abs(checks["scan_start_gap_us"]) < 1e4


def test_a_traced_odometry_run_has_no_finalize():
    rc, res, err, _ = run_small("odom-orbit-vga", traced=True,
                                prelude=TRACED)
    assert rc == 0, err[-3000:]
    m = res["metrics"]
    assert m["graph_builds_in_window"]["value"] == 0
    assert "finalize_ms_per_session" not in m
    assert not set(DEVICE) & set(m)
    assert "tracer_ms_per_chunk" not in _trace_line(err)


def test_an_untraced_run_keeps_the_tracer_off_and_its_keys():
    rc, res, err, _ = run_small("slam-loop-vga", prelude=WATCH)
    assert rc == 0, err[-3000:]
    assert "TRACER STARTED" not in err and "[trace]" not in err
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "compared"}
    # the CPU has no device memory to report: no `peak_mem_mib`
    assert set(res["metrics"]) == {"fps", "pose_latency_p95_ms", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
