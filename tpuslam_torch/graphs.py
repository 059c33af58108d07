"""Captured programs — the port's counterpart of `jax.jit`: CUDA graphs.

The reference runs its main path as compiled programs: `scan_odometry`'s
frame step inside one `lax.scan`, `process_frame_jit`, the two SLAM chunk
scans, the pose-graph solves and the fused loop-closure attempt.  Run op
by op from Python, each pays the host's dispatch for every op (~600 a
tracked frame, ~11,700 a 32-node pose-graph solve) while the card idles.
A `Program` captures such a function into a CUDA graph once and replays
it: one launch from the host for all of its kernels.  The kernels stay
the port's own; nothing is generated.

Key.  One graph per key, as `jit` compiles one program per static
signature: the program's static arguments (configs, intrinsics, sizes,
flags — every Python value that reaches a kernel as a C float or bounds a
loop, compared by `repr`, so 0.0 and -0.0 differ; an object with a
`graph_key()` method, such as a mesh, by what that returns), the
structure of the tensor arguments with each one's shape, dtype and
device, and the calling stream (its "lane").

Capture.  A key's first call runs the function eagerly on the lane's
capture stream — the warm-up, whose results are the call's, and during
which cuBLAS and cuSOLVER make their handles and workspaces.  Its second
call captures the graph into the lane's memory pool and replays it, and
every later call replays it: a key met once (a pose-graph bucket the run
passes through) never pays for a capture, which costs ~2.6× the eager
run.  Graphs of one lane share the pool: they replay one after another on
one stream, and each replay's outputs are copied out before the next
replay is issued (`Loop`'s lock).

Buffers.  Inputs are copied into static buffers before a replay and
outputs are copied out after it, so no caller ever holds a buffer that a
later replay overwrites.  A `Loop` carries state between replays inside
the graph: the graph itself copies the function's new state into the
state buffers, and `Loop.state()` hands out a copy.

Scratch.  The kernels' persistent scratch (the GN ticket and rows, the
ring_nn tickets and partials) is keyed by the graph under warm-up or
capture (`_build.scratch_key`), so two graphs replayed at once on two
streams never share a ticket.

Launch counts.  A replay launches the captured kernels without calling
their wrappers, so each graph records its kernels' launches during its
capture (`_build.LaunchCounter`), and every replay adds them to the
counters under the replaying stream.  The warm-up's launches count under
the calling stream too.

CPU tensors run the function eagerly (the path the CPU tests hold to the
reference); `eager=True` runs it eagerly on the card, for a comparison of
the two paths.  A function that fails to capture raises `CaptureError`:
nothing falls back to eager at run time.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import Callable

import torch

from tpuslam_torch.kernels import _build


class CaptureError(RuntimeError):
    """A program could not be captured into a CUDA graph."""


# ---------------------------------------------------------------------------
# Argument trees: tuples, lists and NamedTuples of tensors; any other leaf is
# a static value and part of the key.
# ---------------------------------------------------------------------------

_LEAF = "tensor"


def _flatten(tree, leaves: list):
    """Append `tree`'s tensors to `leaves`; return its structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    return ("value", repr(tree), tree)


def _unflatten(spec, it):
    if spec == _LEAF:
        return next(it)
    if spec[0] == "value":
        return spec[2]
    kind, children = spec
    items = [_unflatten(c, it) for c in children]
    if hasattr(kind, "_fields"):           # a NamedTuple
        return kind(*items)
    return kind(items)


def _spec_key(spec):
    """The structure without the static values' objects (their repr
    stands for them)."""
    if spec == _LEAF:
        return spec
    if spec[0] == "value":
        return ("value", spec[1])
    return (spec[0], tuple(_spec_key(c) for c in spec[1]))


def flatten(tree) -> tuple[list, object]:
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def unflatten(spec, leaves) -> object:
    return _unflatten(spec, iter(leaves))


def _sig(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def static_key(v) -> object:
    """A static argument's part of a key: `v.graph_key()` where `v` has
    one (an object whose `repr` does not say which one it is), else its
    `repr`."""
    graph_key = getattr(v, "graph_key", None)
    return graph_key() if callable(graph_key) else repr(v)


def key_of(lane, static: dict, state_spec, state_leaves, in_spec,
           in_leaves) -> tuple:
    """A graph's key: the lane, the static arguments (`static_key`), and
    the state's and inputs' structure with each tensor's shape, dtype and
    device."""
    return (lane, tuple(sorted((k, static_key(v))
                               for k, v in static.items())),
            _spec_key(state_spec), _sig(state_leaves), _spec_key(in_spec),
            _sig(in_leaves))


def _device(leaves):
    """The device of the first tensor, or None."""
    return leaves[0].device if leaves else None


# ---------------------------------------------------------------------------
# The card's side: lanes, capture streams, pools, graphs.
# ---------------------------------------------------------------------------


class CudaGraphs:
    """Streams, pools and graphs on the card.  A lane is the calling
    stream; each lane has a capture stream and a memory pool of its own,
    made at its first capture.  The capture streams come from PyTorch's
    high-priority pool, which nothing else of the port draws on; a graph
    replays at the priority of the stream it is launched into."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: dict = {}
        self._pools: dict = {}

    def handles(self, dev: torch.device) -> bool:
        return dev.type == "cuda"

    def lane(self, dev: torch.device) -> int:
        return torch.cuda.current_stream(dev).cuda_stream

    @contextlib.contextmanager
    def on_capture_stream(self, dev: torch.device, lane: int):
        """Run the block on the lane's capture stream, ordered after the
        work the lane has issued, and order the lane after it."""
        key = (dev.index, lane)
        with self._lock:
            if key not in self._streams:
                self._streams[key] = torch.cuda.Stream(dev, priority=-1)
                self._pools[key] = torch.cuda.graph_pool_handle()
            cap = self._streams[key]
        calling = torch.cuda.current_stream(dev)
        cap.wait_stream(calling)
        try:
            with torch.cuda.stream(cap):
                yield
        finally:
            calling.wait_stream(cap)

    def capture(self, dev: torch.device, lane: int, body: Callable,
                state_bufs: list):
        """Capture `body()` on the current (capture) stream into the
        lane's pool; return (graph, body's output tensors).  A failed
        capture leaves the lane a fresh pool: the allocator cannot take
        the old one back into a capture once the failed graph is gone."""
        key = (dev.index, lane)
        g = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: it could free pinned
        # host memory or another stream's tensors on this thread, whose
        # event queries the capture refuses (it is then invalidated)
        collecting = gc.isenabled()
        gc.disable()
        try:
            g.capture_begin(pool=self._pools[key],
                            capture_error_mode="thread_local")
            try:
                outs = body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    g.capture_end()
                with self._lock:
                    self._pools[key] = torch.cuda.graph_pool_handle()
                raise
            g.capture_end()
        finally:
            if collecting:
                gc.enable()
        return g, outs

    def forget_pools(self) -> None:
        """New pools for later captures (every graph is gone)."""
        with self._lock:
            for key in self._pools:
                self._pools[key] = torch.cuda.graph_pool_handle()

    def replay(self, graph, outs: list) -> list:
        graph.replay()
        return outs

    def keep_for(self, tensors, dev: torch.device) -> None:
        """Tensors the warm-up made on the capture stream, handed to the
        lane: the allocator must not reuse their blocks before the lane's
        work on them is done."""
        stream = torch.cuda.current_stream(dev)
        for t in tensors:
            t.record_stream(stream)

    def memory(self, dev: torch.device) -> int:
        return torch.cuda.memory_reserved(dev)


_backend = CudaGraphs()
_lane_locks: dict = {}
_registry_lock = threading.Lock()
_entry_ids = itertools.count(1)
_programs: list = []
_tls = threading.local()     # depth of program bodies running on the thread


def _lane_lock(dev: torch.device, lane: int) -> threading.RLock:
    with _registry_lock:
        return _lane_locks.setdefault((dev.type, dev.index, lane),
                                      threading.RLock())


@contextlib.contextmanager
def _inside():
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def _nested() -> bool:
    """A program body is running on this thread (its warm-up or capture):
    programs it calls run inline, as part of it."""
    return getattr(_tls, "depth", 0) > 0


class _Entry:
    """One key's graph: its static buffers, the body its capture records
    and what the capture recorded (`graph` is None until the key's second
    call; `error` is a failed capture's)."""

    def __init__(self, program: "Program") -> None:
        self.id = next(_entry_ids)
        self.program = program
        self.graph = None
        self.body = None
        self.error = None
        self.warm_threads: set = set()     # threads that ran its warm-up
        self.state_bufs: list = []
        self.input_bufs: list = []
        self.input_sig: tuple = ()
        self.outs: list = []
        self.state_spec = self.out_spec = None
        self.launches: dict = {}           # LaunchCounter → launches
        self.warm_s = self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def info(self) -> dict:
        return {"program": self.program.name, "id": self.id,
                "captured": self.graph is not None,
                "warm_up_s": self.warm_s, "capture_s": self.capture_s,
                "pool_mib": self.pool_bytes / 2 ** 20,
                "replays": self.replays,
                "kernel_launches": {c.name: n for c, n in
                                    self.launches.items()}}


def _copy_in(bufs, leaves) -> None:
    for b, t in zip(bufs, leaves):
        b.copy_(t)


def _clone(leaves) -> list:
    return [t.clone() for t in leaves]


class Program:
    """A function captured once per key and replayed.

    `fn(state, *args, **static)` returns `(new_state, outputs)`: `state`
    and `args` are trees of tensors (tuples, lists, NamedTuples; other
    leaves are static), `static` the keyword arguments that are part of
    the key.  Call a stateless program with `run`, a stateful one through
    `loop`."""

    def __init__(self, name: str, fn: Callable) -> None:
        self.name = name
        self.fn = fn
        self._entries: dict = {}
        with _registry_lock:
            _programs.append(self)

    def run(self, *args, eager: bool = False, **static):
        """`fn((), *args, **static)`'s outputs: replayed on the card,
        eager on the CPU or with `eager=True`."""
        with self.loop((), eager=eager, **static) as lp:
            return lp.step(*args, copy=True)

    def loop(self, state, eager: bool = False, **static) -> "Loop":
        return Loop(self, state, eager, static)

    def entries(self) -> list:
        return list(self._entries.values())

    # -- warm-up and capture --------------------------------------------------

    def _first(self, key, dev, lane, state_leaves, state_spec, in_leaves,
               in_spec, static):
        """A key's first call: its entry's static buffers, and the warm-up
        (the function, eagerly, on the lane's capture stream).  Returns
        (entry, the warm-up's outputs)."""
        be = _backend
        e = _Entry(self)
        e.state_spec = state_spec
        t0 = time.perf_counter()
        e.state_bufs = [t.contiguous().clone() for t in state_leaves]
        e.input_bufs = [t.contiguous().clone() for t in in_leaves]
        e.input_sig = _sig(e.input_bufs)

        def body():
            new_state, out = self.fn(unflatten(state_spec, e.state_bufs),
                                     *unflatten(in_spec, e.input_bufs),
                                     **static)
            new_leaves, _ = flatten(new_state)
            if _sig(new_leaves) != _sig(e.state_bufs):
                raise CaptureError(
                    f"{self.name}: the new state's tensors "
                    f"{_sig(new_leaves)} differ from the state's "
                    f"{_sig(e.state_bufs)}")
            _copy_in(e.state_bufs, new_leaves)
            out_leaves, e.out_spec = flatten(out)
            return out_leaves

        e.body = body
        e.warm_threads.add(threading.get_ident())
        with be.on_capture_stream(dev, lane), _inside(), \
                _build.scratch_scope(("graph", e.id), lane):
            warm = body()
        # the call keeps the warm-up's outputs; one that is a static
        # buffer would change under a later replay
        static_ptrs = {t.data_ptr() for t in e.state_bufs + e.input_bufs}
        warm = [t.clone() if t.data_ptr() in static_ptrs else t
                for t in warm]
        be.keep_for(warm, dev)
        e.warm_s = time.perf_counter() - t0
        self._entries[key] = e
        return e, warm

    def _capture(self, e: _Entry, dev, lane) -> None:
        """A key's second call: capture its graph (which the call then
        replays).  A failure raises, now and at every later call."""
        if e.error is not None:
            raise CaptureError(e.error)
        be = _backend
        t0 = time.perf_counter()
        with be.on_capture_stream(dev, lane), _inside(), \
                _build.scratch_scope(("graph", e.id), lane):
            if threading.get_ident() not in e.warm_threads:
                # cuBLAS and cuSOLVER handles are the calling thread's:
                # this one's are made by a warm-up of its own, which
                # leaves the state as it found it
                saved = _clone(e.state_bufs)
                e.body()
                _copy_in(e.state_bufs, saved)
                e.warm_threads.add(threading.get_ident())
            mem0 = be.memory(dev)
            with _build.recording() as rec:
                try:
                    e.graph, e.outs = be.capture(dev, lane, e.body,
                                                 e.state_bufs)
                except CaptureError as err:
                    e.error = str(err)
                    raise
                except Exception as err:   # noqa: BLE001 — re-raised
                    e.error = (f"{self.name}: capture failed: "
                               f"{type(err).__name__}: {err}")
                    raise CaptureError(e.error) from err
            e.pool_bytes = be.memory(dev) - mem0
        e.launches = dict(rec)
        e.capture_s = time.perf_counter() - t0

    def _replay(self, e: _Entry, dev, lane) -> list:
        outs = _backend.replay(e.graph, e.outs)
        e.replays += 1
        for counter, n in e.launches.items():
            counter.replayed(n, lane)
        return outs

    def _drop(self) -> None:
        for e in self._entries.values():
            _build.drop_scratch(("graph", e.id))
        self._entries.clear()

    def drop(self) -> None:
        """Drop this program's graphs (after the card has finished their
        work); the lanes' pools keep their memory for later captures."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._drop()


class Loop:
    """Replays of one program with its state carried in the graph's
    buffers.  Holds the lane's lock from the first step to `close`, so no
    other thread replays a graph of the lane in between.  On the CPU or
    with `eager` the steps call the function."""

    def __init__(self, program: Program, state, eager: bool,
                 static: dict) -> None:
        self.program = program
        self.static = static
        self._eager = eager
        self._state = state
        self._entry = None
        self._lock = None
        self._dev = self._lane = None

    def __enter__(self) -> "Loop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._lock is not None:
            self._lock.release()
            self._lock = None

    def step(self, *args, copy: bool = False):
        """One step on `args`; returns its outputs.  Replayed outputs are
        the graph's buffers, valid until the next replay of the lane,
        unless `copy`."""
        p = self.program
        state_leaves, state_spec = flatten(self._state)
        in_leaves, in_spec = flatten(args)
        dev = _device(state_leaves + in_leaves)
        if (self._eager or dev is None or not _backend.handles(dev)
                or _nested()):
            with _inside():          # programs it calls run eagerly too
                self._state, out = p.fn(self._state, *args, **self.static)
            return out
        if self._entry is None:
            lane = _backend.lane(dev)
            self._dev, self._lane = dev, lane
            self._lock = _lane_lock(dev, lane)
            self._lock.acquire()
            key = key_of(lane, self.static, state_spec, state_leaves,
                         in_spec, in_leaves)
            e = p._entries.get(key)
            if e is None:
                e, warm = p._first(key, dev, lane, state_leaves, state_spec,
                                   in_leaves, in_spec, self.static)
                self._entry = e
                return unflatten(e.out_spec, warm)
            self._entry = e
            _copy_in(e.state_bufs, state_leaves)
        e = self._entry
        if _sig(in_leaves) != e.input_sig:
            raise ValueError(f"{p.name}: a loop's inputs keep their shapes: "
                             f"{_sig(in_leaves)} against {e.input_sig}")
        _copy_in(e.input_bufs, in_leaves)
        if e.graph is None:
            p._capture(e, self._dev, self._lane)
        outs = p._replay(e, self._dev, self._lane)
        return unflatten(e.out_spec, _clone(outs) if copy else outs)

    def state(self):
        """The carried state: a copy of the graph's buffers."""
        if self._entry is None:
            return self._state
        e = self._entry
        return unflatten(e.state_spec, _clone(e.state_bufs))


def stats() -> list:
    """Every key's graph: program, whether it is captured, warm-up and
    capture seconds, pool MiB the capture added, replays and hand-kernel
    launches a replay."""
    with _registry_lock:
        programs = list(_programs)
    return [e.info() for p in programs for e in p.entries()]


def clear() -> None:
    """Drop every captured graph (after the card has finished its work)."""
    with _registry_lock:
        programs = list(_programs)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for p in programs:
        p._drop()
    _backend.forget_pools()
