"""Reduction of a torch.profiler slice to what the per-layer readers need:
the host spans (record_function ranges, the program's and the
benchmark's), the device's operations, the union of device busy
intervals, and the device's idle gaps labelled by what the host was
doing.  (The profiler links few of the kernels that CUDA graphs replay
to the host call that launched them, so nothing here relies on those
links: a reader attributes device work by time.)

Everything is reduced in the process from the profiler's raw events; no
trace file is written.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

_DEVICE_KINDS = ("kernel", "memcpy", "memset")


@dataclass
class Slice:
    """A traced slice.  Times in seconds from the slice's start."""

    wall_s: float = 0.0
    spans: list = field(default_factory=list)   # (name, start, end, thread)
    ops: list = field(default_factory=list)     # (name, start, end)
    busy: list = field(default_factory=list)    # merged (start, end)
    records: list = field(default_factory=list)  # the slice's sessions

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def spans_named(self, *names: str) -> list:
        return [s for s in self.spans if s[0] in names]

    def device_s_between(self, lo: float, hi: float) -> float:
        """Device seconds of the operations that started in [lo, hi)."""
        starts = [o[1] for o in self.ops]
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
        return sum(o[2] - o[1] for o in self.ops[i:j])

    def device_s_of(self, kernels) -> tuple:
        """(seconds, count) of the device operations of these kernels
        (`kernel_name` of the trace's name)."""
        t, n = 0.0, 0
        kernels = set(kernels)
        for name, s, e in self.ops:
            if kernel_name(name) in kernels:
                t += e - s
                n += 1
        return t, n

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            key = kernel_name(name) or "(unnamed device operation)"
            by[key] = by.get(key, 0.0) + (e - s)
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time between the slice's start, its busy intervals
        and its end, summed by the innermost host span open at each gap's
        midpoint ("host outside any span" where none is)."""
        edges = [(0.0, 0.0)] + self.busy + [(self.wall_s, self.wall_s)]
        gaps = sorted((0.5 * (e0 + s1), s1 - e0)
                      for (_, e0), (s1, _) in zip(edges, edges[1:])
                      if s1 > e0)
        # sweep: the spans open at each midpoint, innermost = shortest
        marks = sorted([(s, 0, i) for i, (_, s, _e, _t) in
                        enumerate(self.spans)]
                       + [(e, 2, i) for i, (_, _s, e, _t) in
                          enumerate(self.spans)]
                       + [(m, 1, j) for j, (m, _) in enumerate(gaps)])
        open_: set = set()
        by: dict = {}
        for _, kind, i in marks:
            if kind == 0:
                open_.add(i)
            elif kind == 2:
                open_.discard(i)
            else:
                if open_:
                    inner = min(open_, key=lambda o: self.spans[o][2]
                                - self.spans[o][1])
                    key = self.spans[inner][0]
                else:
                    key = "host outside any span"
                by[key] = by.get(key, 0.0) + gaps[i][1]
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]


def kernel_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list: "void (anonymous namespace)::
    correspond_kernel(float const*, …)" is "correspond_kernel"."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:120]
    return name[:120]


def _kind(ev) -> str:
    try:
        return str(ev.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


SLICE_SPAN = "bench.slice"


def reduce_profile(prof) -> Slice:
    """The slice of a stopped torch.profiler.profile: the range of its
    `SLICE_SPAN` span, which the caller opens after a device
    synchronisation and closes after another."""
    import torch

    events = prof.profiler.kineto_results.events()
    cpu_dev = torch.autograd.DeviceType.CPU
    marks = [ev for ev in events if ev.device_type() == cpu_dev
             and ev.name() == SLICE_SPAN]
    if not marks:
        raise RuntimeError(f"no {SLICE_SPAN} span in the profile")
    t0_ns = marks[0].start_ns()
    wall_s = (marks[0].end_ns() - t0_ns) * 1e-9
    out = Slice(wall_s=wall_s)
    for ev in events:
        kind = _kind(ev)
        if ev.device_type() == cpu_dev:
            if ev.is_user_annotation():
                out.spans.append((ev.name(), (ev.start_ns() - t0_ns) * 1e-9,
                                  (ev.end_ns() - t0_ns) * 1e-9,
                                  ev.start_thread_id()))
            continue
        if ev.is_user_annotation() or "annotation" in kind:
            continue
        if kind and not any(k in kind for k in _DEVICE_KINDS):
            continue
        s = (ev.start_ns() - t0_ns) * 1e-9
        out.ops.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
    out.ops.sort(key=lambda o: o[1])
    for _name, s, e in out.ops:
        s, e = max(s, 0.0), min(e, wall_s)
        if e <= s:
            continue
        if out.busy and s <= out.busy[-1][1]:
            out.busy[-1] = (out.busy[-1][0], max(out.busy[-1][1], e))
        else:
            out.busy.append((s, e))
    return out
