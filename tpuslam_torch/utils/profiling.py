"""The port's tracer, its torch.profiler trace and device memory — port of
`tpuslam/utils/profiling.py`.

Spans.  `span(name)` marks a stage of the pipeline (`slam.scan`,
`graphs.replay`, `odo.process`, …):

    with profiling.span("slam.scan", n=frames):
        ...

With the tracer off and no profiler running it does nothing: it returns
`OFF`, one shared object, and records nothing.  Between `start()` and
`stop()` it records the span's name, host start and end, parent span and
thread, in memory, in nanoseconds of `time.time_ns()`: the clock
torch.profiler stamps its events with, so a span and a profiled range of
the same name can be compared.  While a torch.profiler runs it also opens
`torch.profiler.record_function(name)`, so a profile and `trace()`'s
Chrome export show it.

Device edges.  A span opened with `device=True` (or one that calls
`edge_in()` and `edge_out()` around the device work it issues) records
a timing CUDA event on the current stream at each edge, taken from a pool
`start()` makes.  `stop()` places them on the host's clock by anchors,
events recorded at a known `time.time_ns()` on a stream with nothing
queued, so that the card stamps them at once: one right after a
`torch.cuda.synchronize()` at `start()` and one at `stop()`, and between
them an edge whose stream was idle (after a readback) while no profiler
ran, at most one every `ANCHOR_GAP_NS`.  An anchor can
only be stamped late, so each takes the largest offset of those within
`ENVELOPE_NS` (`upper_envelope`), and an event falls on the straight line
between the two anchors around it (the card's clock and the host's drift
apart by a few ppm, and not at a steady rate).  Edges go
around device work that does not wait on the host (a graph's replay, a
readback) or around an eager block, whose interval then also holds the
gaps between its launches: such a span is marked `eager`.  The device's
busy time is the union of the device intervals of the leaf edged spans
(`Trace.busy_ns`).

Counters.  `count(name, n)` adds to a counter the tracer keeps from
`start()` to `stop()` (kernel launches are counted by
`kernels/_build.LaunchCounter`, not here).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Callable, NamedTuple, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns

EVENTS = 1 << 15            # timing events made at `start()`
ANCHOR_GAP_NS = 10_000_000  # the least time between two anchors
ENVELOPE_NS = 200_000_000   # the reach of `upper_envelope`


class _Off:
    """The span of an untraced, unprofiled run: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def edge_in(self) -> None:
        pass

    def edge_out(self) -> None:
        pass


OFF = _Off()


class Span(NamedTuple):
    """A closed span.  Times in ns of `time.time_ns()`; the device edges
    are None where the span recorded none."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int                 # the enclosing span's id, -1 at the top
    thread: int
    device_start_ns: Optional[float]
    device_end_ns: Optional[float]
    eager: bool
    n: int                      # work the span covers (frames), or 0


def union(intervals) -> list:
    """Merge (start, end) intervals into disjoint [start, end] in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        elif e > s:
            out.append([s, e])
    return out


def covered(merged, lo: float, hi: float) -> float:
    """The length of [lo, hi] that `union`'s intervals cover."""
    i = bisect.bisect_left(merged, lo, key=lambda iv: iv[1])
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        total += min(merged[i][1], hi) - max(merged[i][0], lo)
        i += 1
    return total


@dataclass
class Trace:
    """What `stop()` returns: the spans in the order they closed, the
    counters, the traced interval, and on the card: the device clock's
    drift against the host's over it (the end anchor placed by the start
    anchor's elapsed time, less its own reading), the anchors' largest
    distance from the straight line between the first and the last
    (`bend_ns`), the anchors [(device ns after the first, host ns)], and
    `place`, which puts a CUDA event recorded while the tracer was on onto
    the host's clock as the spans' edges are placed."""

    start_ns: int
    stop_ns: int
    spans: list
    counters: dict
    drift_ns: Optional[float] = None
    bend_ns: Optional[float] = None
    anchors: list = field(default_factory=list, repr=False)
    place: Optional[Callable] = field(default=None, repr=False)

    def named(self, *names: str) -> list:
        return [s for s in self.spans if s.name in names]

    def children(self, span: Span) -> list:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> float:
        """Host wall less what the span's children cover."""
        kids = union((c.start_ns, c.end_ns) for c in self.children(span))
        return (span.end_ns - span.start_ns
                - covered(kids, span.start_ns, span.end_ns))

    def device_leaves(self) -> list:
        """The edged spans that enclose no other edged span."""
        edged = [s for s in self.spans if s.device_end_ns is not None]
        by_id = {s.id: s for s in self.spans}
        inner = set()
        for s in edged:
            p = by_id.get(s.parent)
            while p is not None and p.id not in inner:
                inner.add(p.id)
                p = by_id.get(p.parent)
        return [s for s in edged if s.id not in inner]

    @cached_property
    def busy(self) -> list:
        """The union of the leaves' device intervals, [start, end] in
        order."""
        return union((s.device_start_ns, s.device_end_ns)
                      for s in self.device_leaves())

    def busy_ns(self, lo: float, hi: float) -> float:
        """Device busy time in [lo, hi]."""
        return covered(self.busy, lo, hi)


class _Tracer:
    def __init__(self) -> None:
        self.records: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.local = threading.local()
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.pool: list = []
        self.anchors: list = []     # (time_ns, event) at idle edges
        self.last_anchor = 0
        self.anchor = None
        if self.cuda:
            self.pool = [torch.cuda.Event(enable_timing=True)
                         for _ in range(EVENTS)]
            for ev in self.pool:        # made now, not inside the window
                ev.record()
            self.anchor = _anchor()
        self.start_ns = _now()

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def event(self):
        ev = (self.pool.pop() if self.pool
              else torch.cuda.Event(enable_timing=True))
        # an anchor where the card stamps the event at once: nothing
        # queued, no profiler (CUPTI) between; the stream is asked (~9 µs
        # on the H100 host) only once an anchor is due
        if (_now() - self.last_anchor >= ANCHOR_GAP_NS and not _profiling()
                and torch.cuda.current_stream().query()):
            self.last_anchor = _now()
            self.anchors.append((self.last_anchor, ev))
        ev.record()
        return ev

    def finish(self) -> Trace:
        stop_ns = _now()
        drift = bend = place = None
        pts: list = []
        if self.anchor is not None:
            t0, ev0 = self.anchor
            t1, ev1 = _anchor()
            ev1.synchronize()
            d1 = ev0.elapsed_time(ev1) * 1e6
            pts = [(0.0, t0)]
            for t, ev in self.anchors:
                d = ev0.elapsed_time(ev) * 1e6
                if pts[-1][0] + ANCHOR_GAP_NS <= d <= d1 - ANCHOR_GAP_NS:
                    pts.append((d, t))
            pts.append((d1, t1))
            drift = t0 + d1 - t1
            bend = max(abs(t - t0 - d * (t1 - t0) / d1) if d1 > 0 else 0.0
                       for d, t in pts)
            line = through(upper_envelope(pts))

            def place(ev):
                return line(ev0.elapsed_time(ev) * 1e6)
        spans = []
        for (name, h0, h1, sid, parent, thread, e0, e1, eager,
             n) in self.records:
            edges = (place(e0), place(e1)) if (
                place is not None and e1 is not None) else (None, None)
            spans.append(Span(name, h0, h1, sid, parent, thread, *edges,
                              eager, n))
        return Trace(self.start_ns, stop_ns, spans, dict(self.counters),
                     drift, bend, pts, place)


def upper_envelope(pts: list, reach: float = ENVELOPE_NS) -> list:
    """The anchors `pts` [(device ns, host ns)] with each one's offset
    (host less device) raised to the largest within `reach` of device
    time: a thread switch or the profiler can only make the card stamp an
    anchor late, never early."""
    out, lo = [], 0
    for d, _t in pts:
        while pts[lo][0] < d - reach:
            lo += 1
        hi, best = lo, -float("inf")
        while hi < len(pts) and pts[hi][0] <= d + reach:
            best = max(best, pts[hi][1] - pts[hi][0])
            hi += 1
        out.append((d, d + best))
    return out


def through(pts: list) -> Callable:
    """The host time of a device time on the broken line through the
    anchors `pts`, [(device ns after the first, host ns)] in order."""
    ds = [d for d, _ in pts]

    def at(d: float) -> float:
        i = min(max(bisect.bisect_right(ds, d), 1), len(ds) - 1)
        (da, ta), (db, tb) = pts[i - 1], pts[i]
        return ta + (d - da) * ((tb - ta) / (db - da) if db > da else 1.0)
    return at


def _anchor() -> tuple:
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    t = _now()
    ev.record()
    return t, ev


class _Span:
    __slots__ = ("name", "device", "eager", "n", "t0", "tr", "id",
                 "parent", "ev0", "ev1", "rf")

    def __init__(self, name, device, eager, n, since, tr) -> None:
        self.name = name
        self.device = device
        self.eager = eager
        self.n = n
        self.t0 = since
        self.tr = tr
        self.ev0 = self.ev1 = self.rf = None

    def __enter__(self):
        # the profiler's range opens first and closes last: the span's
        # host interval lies inside it, a few µs from each edge
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        tr = self.tr
        if tr is not None:
            stack = tr.stack()
            self.parent = stack[-1] if stack else -1
            self.id = next(tr.ids)
            stack.append(self.id)
            if not self.t0:
                self.t0 = _now()
        if self.device:
            self.edge_in()
        return self

    def __exit__(self, *exc):
        if self.device:
            self.edge_out()
        tr = self.tr
        if tr is not None:
            t1 = _now()
            tr.stack().pop()
            tr.records.append((self.name, self.t0, t1, self.id, self.parent,
                               threading.get_ident(), self.ev0, self.ev1,
                               self.eager, self.n))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return None

    def edge_in(self) -> None:
        """Record the device edge before the span's device work."""
        if self.tr is not None and self.tr.cuda:
            self.ev0 = self.tr.event()

    def edge_out(self) -> None:
        """Record the device edge after it."""
        if self.ev0 is not None:
            self.ev1 = self.tr.event()


_tracer: Optional[_Tracer] = None


def span(name: str, device: bool = False, eager: bool = False, n: int = 0,
         since: int = 0):
    """A context manager around one stage (the module doc).  `device`:
    record device edges at entry and exit (the caller's work is on the
    card); `eager`: those edges hold op-by-op launches; `n`: the work it
    covers (frames); `since`: a start taken earlier by `now()`."""
    tr = _tracer
    if tr is None and not _profiling():
        return OFF
    return _Span(name, device, eager, n, since, tr)


def now() -> int:
    """`time.time_ns()` while the tracer is on, else 0: a span's `since`
    for a span whose name is known only after its work began."""
    return _now() if _tracer is not None else 0


def count(name: str, n: int = 1) -> None:
    """Add `n` to the tracer's counter `name` (nothing while it is off)."""
    tr = _tracer
    if tr is not None:
        with tr.lock:
            tr.counters[name] = tr.counters.get(name, 0) + n


def start() -> None:
    """Turn the tracer on with fresh spans and counters; on the card, make
    the pool of timing events and record the start anchor."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("the tracer is already on")
    _tracer = _Tracer()


def stop() -> Trace:
    """Turn the tracer off; return what it recorded."""
    global _tracer
    tr, _tracer = _tracer, None
    if tr is None:
        raise RuntimeError("the tracer is not on")
    return tr.finish()


@contextlib.contextmanager
def trace(out_dir: str):
    """Capture a torch.profiler trace of the enclosed work into
    `out_dir/trace.json`; the spans show as named ranges around the
    kernels they issue.

        with profiling.trace("traces/run"):
            run_odometry(...)

    Yields the path the trace will be written to (on exit)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(out_dir, "trace.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def device_memory_stats() -> dict:
    """Per-GPU allocator stats (device memory watermark), keyed like the
    reference's by device name; empty without a GPU."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
