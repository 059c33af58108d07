"""One run of one cell: set-up, the timed window, the traced slice, the
check against the plain reference, and the result line.

Set-up renders the cell's session pool on the card from the seed and
warms every program the window will replay; a wait for the card's faster
state of graph replays follows, reported apart from `setup_s`.  The window then hands the
pool's sessions to the port in the seeded order, as fast as it takes
them (a closed loop), until `--seconds` have passed and one session has
finished; a session running then is dropped after its current
hand-over.  With
`--trace 1` the window's launch counters are read, and torch.profiler
records two whole sessions from the window's middle (the slice).  Once
the window has closed and the peak memory is read, the program's state
is freed and the reference runs sampled sessions again for `correct`.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

import numpy as np

from slambench.core import spec
from slambench.core.trace import SLICE_SPAN, reduce_profile

BANNED = ("jax", "jaxlib", "flax", "tpuslam")
SLICE_SESSIONS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def kernel_counters() -> dict:
    from tpuslam_torch.kernels import (correspond, gn_epilogue, gn_fused,
                                       gn_partials, gn_step, ring_nn)

    return {c.name: c for c in (
        correspond.counter, correspond.grid_counter, correspond.table_counter,
        gn_partials.counter, gn_epilogue.counter, gn_step.counter,
        gn_fused.counter, ring_nn.counter)}


# A CUDA graph of PROBE_NODES dependent one-block kernels, timed by CUDA
# events.  On the H100 machines a process's graph replays run in one of two
# states (PERF.md, "The two speeds of the card"): ~1.43 µs a kernel node
# (2.84-2.95 ms for the probe), and from a random moment on, for good,
# ~1.07 µs (2.13-2.24 ms).  The port's replayed work runs ~20% faster in the
# second.  `FAST_PROBE_MS` splits the two by device kind; a kind without an
# entry is not waited for.  The wait is the machine's, not the port's set-up:
# it is reported apart (`graph_state_s`) and left out of `setup_s`.
PROBE_NODES = 2000
FAST_PROBE_MS = {"NVIDIA H100 80GB HBM3": 2.55}
# The faster state came 17-81 s after a process's start in every run so far;
# a run still slower after WAIT_S of waiting measures the slower one.
WAIT_S = 90.0


class GraphProbe:
    def __init__(self, dev) -> None:
        import torch

        self.x = torch.zeros(256, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.x.add_(1.0)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(PROBE_NODES):
                self.x.add_(1.0)

    def ms(self) -> float:
        import torch

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)


def wait_for_fast_graphs(entry, pool: dict, probe: GraphProbe,
                         limit: float) -> tuple:
    """Go on warming with the cell's own sessions until the probe reads the
    faster state, for at most `WAIT_S`: the window then measures the state
    the card keeps.  Returns (seconds waited, the last probe in ms)."""
    t0 = time.perf_counter()
    order = [int(s) for s in pool["order"]]
    k = 0
    ms = probe.ms()
    while ms > limit and time.perf_counter() - t0 < WAIT_S:
        for _ev in entry.session(order[k % len(order)]):
            pass
        k += 1
        ms = probe.ms()
    return time.perf_counter() - t0, ms


def graph_entries() -> tuple:
    from tpuslam_torch import graphs

    st = graphs.stats()
    return len(st), sum(1 for e in st if e["captured"])


def _window(entry, pool: dict, seconds: float, traced: bool, sync,
            cuda: bool):
    """Hand sessions over until the deadline.  Returns the window's
    numbers, the finished sessions' records and, traced, the profiler."""
    order = [int(s) for s in pool["order"]]
    frames, lat, sessions = 0, [], []
    prof = None
    slice_left = SLICE_SESSIONS if traced else 0
    slice_t = slice_frames = prof_cost = 0.0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    stop = False
    while not stop:
        s = order[k % len(order)]
        in_slice = False
        if slice_left and prof is None:
            done = time.perf_counter() - t_start
            per = done / max(len(sessions), 1)
            if sessions and done >= 0.5 * (seconds - SLICE_SESSIONS * per):
                import torch
                from torch.profiler import ProfilerActivity, profile

                sync()
                t_prof = time.perf_counter()
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof.start()
                slice_rf = torch.profiler.record_function(SLICE_SPAN)
                slice_rf.__enter__()
                slice_t0 = time.perf_counter()
        if prof is not None and slice_left:
            in_slice = True
        for kind, *rest in entry.session(s):
            if kind == "chunk":
                frames += rest[0]
                lat.append(rest[1])
                if in_slice:
                    slice_frames += rest[0]
            else:
                rec = rest[0]
                rec["in_slice"] = in_slice
                sessions.append(rec)
            # the window closes at the deadline once a session has
            # finished (the check needs one), never inside the slice
            if (not in_slice and sessions
                    and time.perf_counter() >= deadline):
                stop = True
                break
        if in_slice:
            slice_left -= 1
            if slice_left == 0:
                sync()
                slice_rf.__exit__(None, None, None)
                slice_t = time.perf_counter() - slice_t0
                prof.stop()
                # the profiler's start and stop, outside the slice
                prof_cost = time.perf_counter() - t_prof - slice_t
                if time.perf_counter() >= deadline:
                    stop = True
        k += 1
    t_end = time.perf_counter()
    return {"seconds": t_end - t_start, "frames": frames, "latencies": lat,
            "handovers": len(lat), "slice_s": slice_t,
            "slice_frames": slice_frames, "profiler_s": prof_cost}, \
        sessions, prof


def run(workload_name: str, seed: int, seconds: float, traced: bool,
        t_process: float) -> int:
    """One run on the card (run.py's command line)."""
    bench = spec.benchmark()
    cell = spec.workload(bench, workload_name)
    t = time.perf_counter()
    import torch

    phases = {"torch_import_s": time.perf_counter() - t}
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        log(f"slambench: {workload_name} needs {cell['chips']} CUDA "
            f"device(s); found {torch.cuda.device_count()}")
        return 2
    return execute(bench, cell, spec.config_of(bench, cell["config"]),
                   spec.traffic(cell["traffic"]), seed, seconds, traced,
                   torch.device("cuda", 0), t_process, phases)


def execute(bench: dict, cell: dict, config: dict, traffic: dict, seed: int,
            seconds: float, traced: bool, dev, t_process: float,
            phases: dict | None = None) -> int:
    """Set-up, window, check and result line on `dev` (the card; the CPU
    tests pass the CPU, where the port runs its plain twins)."""
    import torch

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    phases = dict(phases or {})
    t = time.perf_counter()
    import tpuslam_torch  # noqa: F401  (sets the port's numeric policy)
    from tpuslam_torch.kernels import _build

    phases["imports_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    phases["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        _build.library()
    phases["kernel_library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from slambench.inputs.scene import render_pool

    sensor = config["sensor"]
    pool = render_pool(traffic, int(sensor["height"]), int(sensor["width"]),
                       seed, dev)
    sync()
    pool_bytes = pool["depth"].numel() * pool["depth"].element_size()
    phases["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    entry = spec.module("entries", config["entry"]).Entry(config, pool, dev)
    entry.warm()
    sync()
    phases["warm_s"] = time.perf_counter() - t
    keys_warm = graph_entries()
    probe, state, waited = None, "", 0.0
    if cuda and kind in FAST_PROBE_MS:
        t = time.perf_counter()
        probe = GraphProbe(dev)
        waited, ms = wait_for_fast_graphs(entry, pool, probe,
                                          FAST_PROBE_MS[kind])
        waited = time.perf_counter() - t
        state = (f"; graph probe {ms:.3f} ms "
                 f"({'faster' if ms <= FAST_PROBE_MS[kind] else 'slower'}"
                 f" state, limit {FAST_PROBE_MS[kind]})")

    keys_before = graph_entries()
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    # the port's set-up: everything from the process's start to the
    # window but the probe and the wait for the card's faster state, so
    # long as the wait built nothing of the port's (a program first met
    # or captured there was set-up, and its wait counts)
    if keys_before != keys_warm:
        waited = 0.0
    setup_s = time.perf_counter() - t_process - waited
    log("[setup] " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f" setup_s {setup_s:.3f}; apart from it graph_state_s "
        f"{waited:.3f}{state}; graph keys after warm-up {keys_warm[0]} "
        f"(captured {keys_warm[1]}), after the wait {keys_before[0]} "
        f"(captured {keys_before[1]})")

    win, sessions, prof = _window(entry, pool, seconds, traced, sync, cuda)
    launches = {n: c.launches + c.plain_calls for n, c in counters.items()}
    keys_after = graph_entries()
    if probe is not None:
        log(f"[probe] after the window: graph probe {probe.ms():.3f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = banned_modules()
    if found:
        log(f"slambench: loaded modules it must not: {found}")
        return 3
    log(f"[window] {win['seconds']:.4f} s, {win['frames']} frames, "
        f"{win['handovers']} hand-overs, {len(sessions)} sessions "
        f"finished; graph keys {keys_before[0]} -> {keys_after[0]}, "
        f"captured {keys_before[1]} -> {keys_after[1]}")
    lat_ms = np.asarray(win["latencies"]) * 1e3
    log(f"[latency] hand-overs {lat_ms.size}, median "
        f"{np.median(lat_ms):.4f} ms, p95 {np.percentile(lat_ms, 95):.4f} "
        f"ms, max {lat_ms.max():.4f} ms")

    # the program's state goes before the reference runs on the card
    slice_records = [r for r in sessions if r.get("in_slice")]
    fps = win["frames"] / win["seconds"]
    ctx = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, window=win, fps=fps,
        setup_s=setup_s, peak_bytes=peak, pool_bytes=pool_bytes,
        launches=launches, sessions=sessions, slice=None, work=None,
        device_kind=kind, peaks=spec.peaks(kind))
    if prof is not None:
        ctx.slice = reduce_profile(prof)
        ctx.slice.records = slice_records
        del prof
        outside = ((win["frames"] - win["slice_frames"])
                   / max(win["seconds"] - win["slice_s"]
                         - win["profiler_s"], 1e-9))
        inside = win["slice_frames"] / max(win["slice_s"], 1e-9)
        log(f"[trace] fps outside the slice {outside:.4f}, inside it "
            f"{inside:.4f} (the profiler on): it costs "
            f"{100 * (1 - inside / outside):.2f}% of the rate; its start "
            f"and stop {win['profiler_s']:.3f} s of the window")
        log(f"[trace] {len(ctx.slice.ops)} device operations, "
            f"{len(ctx.slice.spans)} spans, device busy "
            f"{ctx.slice.busy_s:.4f} of {ctx.slice.wall_s:.4f} s")

    from tpuslam_torch import graphs

    graphs.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, compared = check(entry, sessions, slice_records, seed, ctx)

    out_metrics = collect_metrics(bench, cell["name"], traced, ctx)
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": 1,
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win["handovers"],
              "failed": 0, "metrics": out_metrics, "device": device}
    if ctx.slice is not None:
        device["busy_s"] = ctx.slice.busy_s
        device["window_s"] = ctx.slice.wall_s
        result["breakdown"] = {"device_ops": ctx.slice.top_ops(10),
                               "idle_gaps": ctx.slice.idle_gaps(10)}
    result["compared"] = compared
    found = banned_modules()
    if found:
        log(f"slambench: loaded modules it must not: {found}")
        return 3
    for name, c in compared.items():
        log(f"[compared] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def collect_metrics(bench: dict, cell: str, traced: bool, ctx,
                    here=spec.HERE) -> dict:
    """Every metric of the cell that its reader finds something for:
    `end_to_end/<name>.py` untraced, `metrics/<name>.py` traced."""
    out = {}
    for m in spec.metrics_for(bench, cell, traced):
        kind_dir = "metrics" if traced else "end_to_end"
        value = spec.module(kind_dir, m["name"], here).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check(entry, sessions: list, slice_records: list, seed: int,
          ctx) -> tuple:
    """Run the reference over a seeded sample of the finished sessions
    (and, traced, the slice's sessions, whose work the roofline readers
    count); return (correct, {name: {value, limit}})."""
    from slambench.reference.plain import Work

    mod = sys.modules[type(entry).__module__]
    limits = mod.LIMITS
    rng = np.random.default_rng([seed, 1])
    by_pool: dict = {}
    for rec in sessions:
        by_pool.setdefault(rec["pool"], rec)
    pools = sorted(by_pool)
    n = min(mod.CHECK_SESSIONS, len(pools))
    sample = [pools[i] for i in rng.choice(len(pools), n, replace=False)]
    worst = {k: 0.0 for k in limits}
    errors = []
    refs = {}
    t = time.perf_counter()
    for s in sample:
        try:
            refs[s] = entry.reference(s)
        except Exception as e:      # noqa: BLE001 — reported, not hidden
            errors.append(f"session {s}: {type(e).__name__}: {e}")
            continue
        for k, v in entry.compare(by_pool[s], refs[s]).items():
            worst[k] = max(worst[k], v)
    ctx.check_s = time.perf_counter() - t
    if slice_records:
        ctx.work = Work()
        for rec in slice_records:
            entry.reference(rec["pool"], ctx.work)
    log(f"[check] sessions {sample} of {len(sessions)} finished, reference "
        f"{ctx.check_s:.3f} s" + (f"; errors {errors}" if errors else ""))
    if not sample or errors:
        worst = {k: float("inf") for k in limits}
    compared = {k: {"value": worst[k] if np.isfinite(worst[k])
                    else "no reading", "limit": limits[k]} for k in limits}
    correct = all(worst[k] <= limits[k] for k in limits)
    return correct, compared
