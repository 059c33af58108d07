"""A cell's `--trace 1` run with the port's tracer on over the whole timed
window (`tpuslam_torch/utils/profiling.py`): the run `slambench/run.py`
makes, and besides its metrics five numbers of the port's layers read
from the tracer outside the profiled slice, where nothing stretches the
host.

    python3 slambench/tools/trace_window.py --workload <cell> --seed <n> \
        --seconds <s>

The tracer starts before the window and stops after it; the slice's
bounds on the tracer's clock are the profiler's start and stop.  The last
line of standard output is the run's result line with the five numbers
added to its `metrics`; standard error ends with a `[trace]` JSON line:
the median gap between the tracer's scan spans and the profiler's ranges
of the same name in the slice, the device clock's drift over the window,
the anchors' bend from a straight line and the place a third anchor (at
the profiler's start) gets against its own reading, the event-timed
replays against the profiler's busy time inside them,
each eager leaf's share of the busy time, the fps outside the slice, and
the SLAM host spans a chunk outside the slice beside the slice's readers.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

SCANS = ("slam.scan", "odo.scan")
REPLAY = "graphs.replay"
HOST_CHILDREN = ("slam.scan", "slam.readback", "slam.drain",
                 "slam.promote_bundle", "slam.attempt")
UNITS = {"device_idle_pct": "%", "scan_idle_us_per_frame": "us/frame",
         "replay_host_us": "us/replay", "graph_builds_in_window": "builds",
         "finalize_ms_per_session": "ms/session"}


# -- the five readers: `prog.trace` (profiling.Trace), `prog.slice_ns` ------


def parts(prog) -> list:
    """The window outside the slice and the profiler's start and stop."""
    tr = prog.trace
    if prog.slice_ns is None:
        return [(tr.start_ns, tr.stop_ns)]
    return [(tr.start_ns, prog.slice_ns[0]), (prog.slice_ns[1], tr.stop_ns)]


def outside(prog, names) -> list:
    ps = parts(prog)
    return [s for s in prog.trace.named(*names)
            if any(lo <= s.start_ns and s.end_ns <= hi for lo, hi in ps)]


def device_idle_pct(prog):
    """100 × (1 − the leaves' device busy time / the window's), outside
    the slice; None without device edges."""
    tr = prog.trace
    if not tr.busy:
        return None
    ps = parts(prog)
    wall = sum(hi - lo for lo, hi in ps)
    return 100.0 * (1.0 - sum(tr.busy_ns(lo, hi) for lo, hi in ps) / wall)


def scan_idle_us_per_frame(prog):
    """Device idle from each scan span's host start to the device end of
    its last replay, over the frames the scans covered."""
    tr = prog.trace
    last: dict = {}
    for r in tr.named(REPLAY):
        if r.device_end_ns is not None:
            last[r.parent] = max(last.get(r.parent, 0.0), r.device_end_ns)
    idle = frames = 0
    for s in outside(prog, SCANS):
        if s.id in last:
            end = last[s.id]
            idle += (end - s.start_ns) - tr.busy_ns(s.start_ns, end)
            frames += s.n
    return 1e-3 * idle / frames if frames else None


def replay_host_us(prog):
    """Host wall of a `graphs.replay` span."""
    rs = outside(prog, (REPLAY,))
    return (1e-3 * sum(s.end_ns - s.start_ns for s in rs) / len(rs)
            if rs else None)


def graph_builds_in_window(prog):
    """Warm-ups and captures of captured programs in the window."""
    c = prog.trace.counters
    return c.get("graphs.warm_up", 0) + c.get("graphs.capture", 0)


def finalize_ms_per_session(prog):
    """Host wall of `SlamSystem.finalize` a session."""
    fs = outside(prog, ("slam.finalize",))
    return (1e-6 * sum(s.end_ns - s.start_ns for s in fs) / len(fs)
            if fs else None)


READERS = (device_idle_pct, scan_idle_us_per_frame, replay_host_us,
           graph_builds_in_window, finalize_ms_per_session)


# -- the checks of the tracer against the profiled slice --------------------


def _slice_start_ns(prof) -> int:
    from slambench.core.trace import SLICE_SPAN

    import torch

    cpu = torch.autograd.DeviceType.CPU
    return min(ev.start_ns() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == cpu and ev.name() == SLICE_SPAN)


def _late(pts: list):
    """How late the card stamped each anchor against the envelope the
    tracer places events by: [median, largest] in µs."""
    from tpuslam_torch.utils.profiling import upper_envelope

    late = sorted(e - t for (_d, t), (_d2, e) in zip(pts,
                                                     upper_envelope(pts)))
    return [1e-3 * statistics.median(late), 1e-3 * late[-1]] if late else None


def checks(prog, prof, win: dict, sessions: list) -> dict:
    from slambench.core.trace import reduce_profile
    from tpuslam_torch.utils.profiling import covered, union

    tr = prog.trace
    mid = getattr(prog, "mid", None)
    out = {"drift_us": None if tr.drift_ns is None else 1e-3 * tr.drift_ns,
           "bend_us": None if tr.bend_ns is None else 1e-3 * tr.bend_ns,
           "anchors": len(tr.anchors),
           "anchor_late_us": _late(tr.anchors),
           "mid_anchor_us": (None if mid is None or tr.place is None
                             else 1e-3 * (tr.place(mid[1]) - mid[0])),
           "edged_spans": sum(s.device_end_ns is not None
                              for s in tr.spans)}
    ps = parts(prog)
    busy = sum(tr.busy_ns(lo, hi) for lo, hi in ps)
    shares: dict = {}
    for s in tr.device_leaves():
        if s.eager:
            shares.setdefault(s.name, []).append(
                (s.device_start_ns, s.device_end_ns))
    out["eager_share_of_busy"] = {
        n: sum(covered(union(iv), lo, hi) for lo, hi in ps) / busy
        for n, iv in shares.items()} if busy else {}
    out["fps_outside_slice"] = (
        (win["frames"] - win["slice_frames"])
        / max(win["seconds"] - win["slice_s"] - win["profiler_s"], 1e-9))
    # the SLAM host spans a chunk outside the slice
    slice_chunks = [c for r in sessions if r.get("in_slice")
                    for c in r["chunks"]]
    n_out = win["handovers"] - len(slice_chunks)
    dt_out = sum(win["latencies"]) - sum(c[2] for c in slice_chunks)
    kids = outside(prog, HOST_CHILDREN)
    if n_out > 0 and kids:
        def ms(names):
            return 1e-6 * sum(s.end_ns - s.start_ns for s in kids
                              if s.name in names) / n_out
        out["tracer_ms_per_chunk"] = {
            "slam_host_ms_per_chunk": 1e3 * dt_out / n_out
            - ms(HOST_CHILDREN),
            "attempt_ms_per_chunk": ms(("slam.attempt", "slam.drain")),
            "promote_ms_per_chunk": ms(("slam.promote_bundle",))}
    if prof is None:
        return out
    sl = reduce_profile(prof)
    t0 = _slice_start_ns(prof)

    def rel(ns):
        return (ns - t0) * 1e-9

    inside = [s for s in tr.spans if prog.slice_ns[0] <= s.start_ns
              and s.end_ns <= prog.slice_ns[1]]
    mine = sorted(s.start_ns for s in inside if s.name in SCANS)
    theirs = sorted(s[1] for s in sl.spans if s[0] in SCANS)
    if mine and len(mine) == len(theirs):
        out["scan_start_gap_us"] = statistics.median(
            1e6 * (b - rel(a)) for a, b in zip(mine, theirs))
    reps = [s for s in inside
            if s.name == REPLAY and s.device_end_ns is not None]
    if reps:
        ev = sum(s.device_end_ns - s.device_start_ns for s in reps) * 1e-9
        seen = sum(covered(sl.busy, rel(s.device_start_ns),
                           rel(s.device_end_ns)) for s in reps)
        out["replays_event_s"], out["replays_profiler_busy_s"] = ev, seen
        # how much of the profiler's device time the leaves enclose
        inner = sum(covered(sl.busy, rel(lo), rel(hi)) for lo, hi in tr.busy
                    if hi >= prog.slice_ns[0] and lo <= prog.slice_ns[1])
        out["slice_busy_s"] = {
            "profiler": sl.busy_s, "profiler_inside_leaves": inner,
            "leaves": 1e-9 * tr.busy_ns(t0, t0 + sl.wall_s * 1e9)}
    return out


# -- the run -----------------------------------------------------------------


def install() -> dict:
    """Wrap the harness's window and metric collection: the tracer on over
    the window, the profiler's start and stop noted on its clock, the five
    numbers added to the traced run's metrics.  Returns the state the
    wrappers fill."""
    import torch

    from slambench.core import harness
    from tpuslam_torch.utils import profiling

    state: dict = {}
    window, collect = harness._window, harness.collect_metrics

    class Noted(torch.profiler.profile):
        def start(self):
            state["lo"] = time.time_ns()
            if "mid" in state:
                # the harness has just synchronised: a third anchor in the
                # window's middle, against the tracer's placing of it
                state["mid"][1].record()
                state["mid"] = (state["lo"], state["mid"][1])
            super().start()

        def stop(self):
            super().stop()
            state["hi"] = time.time_ns()

    def traced_window(entry, pool, seconds, traced, sync, cuda):
        plain = torch.profiler.profile
        torch.profiler.profile = Noted
        if cuda:            # made (by a first record) before the window
            state["mid"] = (0, torch.cuda.Event(enable_timing=True))
            state["mid"][1].record()
        profiling.start()
        try:
            win, sessions, prof = window(entry, pool, seconds, traced, sync,
                                         cuda)
        finally:
            trace = profiling.stop()
            torch.profiler.profile = plain
        prog = SimpleNamespace(trace=trace, slice_ns=(
            (state["lo"], state["hi"]) if prof is not None else None),
            mid=state.get("mid"))
        state["program"] = prog
        state["checks"] = checks(prog, prof, win, sessions)
        return win, sessions, prof

    def collect_metrics(bench, cell, traced, ctx, *a, **k):
        out = collect(bench, cell, traced, ctx, *a, **k)
        ctx.program = state["program"]
        for read in READERS:
            v = read(ctx.program)
            if v is not None:
                out[read.__name__] = {"value": float(v),
                                      "unit": UNITS[read.__name__]}
        state["checks"]["slice_readers"] = {
            k: out[k]["value"] for k in ("slam_host_ms_per_chunk",
                                         "attempt_ms_per_chunk",
                                         "promote_ms_per_chunk") if k in out}
        harness.log("[trace] " + json.dumps(state["checks"]))
        return out

    harness._window, harness.collect_metrics = traced_window, collect_metrics
    return state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    from slambench.core import harness

    install()
    return harness.run(a.workload, a.seed, a.seconds, True, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
