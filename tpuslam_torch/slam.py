"""Full SLAM orchestration — port of `tpuslam/slam.py`: odometry + keyframe
pose graph + loop closure + relocalization.

Host-driven control loop; everything compute-heavy runs on the device.
The production shape is `process_chunk` in boundary mode: each chunk is
tracked against a frozen keyframe with promotion on the device at
sub-chunk boundaries (`frontend.scan_superchunk_frozen`), the host reads
the chunk back once, mirrors the bookkeeping, promotes keyframes from the
device-resident depth and dispatches ONE fused propose → verify →
pose-graph attempt (`backend.loopclosure.fused_attempt_jit`).  With
`async_backend=True` the attempt's readback rides the next chunk's
readback (the deferred backend), so a chunk costs one host sync.  On the
card the scans, the per-frame track, the promotions, the attempt, the
pose-graph solves and the map path (each refinement, the fusion, map BA)
replay CUDA graphs (tpuslam_torch/graphs.py), one launch each from the
host.

With `track_against_map` every keyframe is fused into a world voxel map
(mapping.VoxelMap, or dist/map_fusion.ShardedVoxelMap over the ranks of
the default process group with `sharded_map`) and each frame's tracked
pose is refined against that map, one frame at a time: by reverse
projective association (icp.align_map_to_frame), with
`map_track_mode="grid"` by the grid probe against a sorted index of the
map (icp.align_to_index, the index rebuilt lazily after each insert) or,
sharded, by the ring ICP (dist/ring_map.py, whose hops are the ring_nn
kernel).  With `map_ba` `finalize` ends with a Schur-complement map BA
over all keyframes (`refine_map_ba`, backend/map_ba.py).

With `PoseGraphConfig.lc_descriptor` each promotion also computes the
keyframe's depth descriptor and starts its copy to the host, and the
attempt adds pose-free descriptor candidates.  When the candidates'
keyframes carry no uniform verification tables (restored from a file of
another `verify_level`, or from one that predates the tables) the attempt
verifies by the grid-hash probe instead (`_chain_attempt_fallback`), with
the same gates, solve and readback layout.

With `async_backend=True` in the inline chunk mode (per-frame `process`
and inline `process_chunk`) the loop-closure attempts run on a worker
thread, the reference's design: each promotion queues one attempt, the
worker snapshots the keyframes and the graph under the system's lock,
verifies and solves outside it, and commits under it; `finalize` joins the
worker and re-raises its error.  On a GPU the workers run on a CUDA stream
of their own (one a device for the process), so their kernels overlap
tracking's on the main stream; the kernels' scratch is kept per stream
(kernels/gn_step.py, ring_nn.py), and a CUDA graph bakes in scratch of its
own; the workers' graphs are keyed by their stream, the main thread's by
the main stream, so each is captured once a process.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch.backend.loopclosure import (
    extend_with_candidates,
    fused_attempt_jit,
    gate_rows,
    propose_attempt,
    verify_batch_grid,
)
from tpuslam_torch.backend.map_ba import build_map_ba_problem, optimize_map_ba
from tpuslam_torch.backend.posegraph import GraphHost, optimize, resolve_solver
from tpuslam_torch.backend.relocalize import relocalize
from tpuslam_torch.backend.verify import ROW_SIZE
from tpuslam_torch.config import ICPConfig, Intrinsics, SLAMConfig
from tpuslam_torch.dist.map_fusion import ShardedVoxelMap
from tpuslam_torch.dist.mesh import make_mesh
from tpuslam_torch.dist.ring_map import make_ring_align_fn
from tpuslam_torch.frontend import (
    FlatChunk,
    FlatFrozen,
    Odometry,
    ScanState,
    SuperChunkCarry,
    fuse_readbacks_jit,
    preprocess,
    promote_bundle_jit,
    scan_chunk,
    scan_superchunk_frozen,
)
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.voxel import voxel_downsample
from tpuslam_torch.icp import (
    FlatICP,
    Frame,
    align_map_to_frame_jit,
    align_to_index_jit,
)
from tpuslam_torch.kernels.correspond import GridIndex
from tpuslam_torch.mapping import VoxelMap
from tpuslam_torch.transfer import upload
from tpuslam_torch.utils import profiling

# Information weight of verified loop-closure / relocalization edges
# relative to odometry edges (1.0).  The fused attempt's candidate weights,
# accepted-closure edges and reloc edges must agree, or the device-side
# solve diverges from later host re-solves.
LC_EDGE_WEIGHT = 2.0

# How long `finalize` waits for the backend worker to drain its queue, and
# `wait_backend_idle` for its attempts to commit (the reference's join
# limit); past it they raise rather than hang.
WORKER_JOIN_S = 120.0


def _refine_projective_jit(map_cloud: PointCloud, frame: Frame,
                           K: Intrinsics, T0: torch.Tensor, cfg: ICPConfig,
                           eager: bool = False) -> torch.Tensor:
    """The projective map refinement's flat scalars (icp.FlatICP): the
    graph of `icp.align_map_to_frame_jit`, unless `eager`."""
    return align_map_to_frame_jit(map_cloud, frame, K, T0, cfg,
                                  eager=eager)[1]


def _refine_grid_jit(cloud: PointCloud, index: GridIndex, T0: torch.Tensor,
                     cfg: ICPConfig, eager: bool = False) -> torch.Tensor:
    """The grid map refinement's flat scalars: the graph of
    `icp.align_to_index_jit`, unless `eager`."""
    return align_to_index_jit(cloud, index, T0, cfg, eager=eager)[1]


class PendingAttempt(NamedTuple):
    """A dispatched-but-unread fused loop-closure attempt (the deferred
    backend: rows + poses stay on the device until the next chunk)."""

    live: list                  # (i, j, T_init) candidate triples
    attempted: set              # all attempted pairs
    packed: torch.Tensor        # device handle: flat rows ++ poses
    rows_shape: tuple
    poses_shape: tuple
    live_nodes: int             # graph live count at dispatch
    # the keyframe records whose tensors the attempt's kernels read, held
    # until its readback has synchronised the stream they run on: the
    # main thread may drop a record's cloud meanwhile (sparsification), and
    # the caching allocator must not hand that block out while a kernel of
    # another stream still reads it
    keep: tuple = ()

    @property
    def size(self) -> int:
        return math.prod(self.rows_shape) + math.prod(self.poses_shape)


_STOP = object()     # the backend worker's last queue item
_worker_streams: dict = {}
_worker_streams_lock = threading.Lock()


def _worker_stream(device: torch.device) -> torch.cuda.Stream:
    """The backend workers' stream on `device`, one for every system of
    the process: the attempts' CUDA graphs are keyed by the stream that
    calls them (tpuslam_torch/graphs.py), so a later system's worker
    replays the graphs an earlier one captured.  Two workers at once
    queue on it, and their graph replays take the stream's lock."""
    with _worker_streams_lock:
        if device not in _worker_streams:
            _worker_streams[device] = torch.cuda.Stream(device=device)
        return _worker_streams[device]


class SlamSystem:
    """Odometry frontend + pose-graph backend with loop closure.

    `device` is where tracking, the map and the backend run (the card by
    default); depth handed over as a host array is copied there.
    """

    def __init__(self, K: Intrinsics, cfg: SLAMConfig,
                 enable_loop_closure: bool = True,
                 enable_map: bool = False,
                 track_against_map: bool = False,
                 async_backend: bool = False,
                 map_ba: bool = False,
                 map_track_mode: str = "projective",
                 sharded_map: bool = False,
                 enable_relocalization: bool = True,
                 reloc_after: int = 2,
                 chunk_mode: str = "inline",
                 chunk_sub: int = 8,
                 device="cuda"):
        if map_track_mode not in ("projective", "grid"):
            raise ValueError(f"map_track_mode must be 'projective' or 'grid',"
                             f" got {map_track_mode!r}")
        if chunk_mode not in ("inline", "boundary"):
            raise ValueError(f"chunk_mode must be 'inline' or 'boundary', "
                             f"got {chunk_mode!r}")
        if chunk_sub < 1:
            raise ValueError("chunk_sub must be ≥ 1")
        self.cfg = cfg
        self.odo = Odometry(K, cfg, keep_keyframe_clouds=True, device=device)
        self.device = self.odo.device
        self.graph = GraphHost(cfg.posegraph, device=self.device)
        self.enable_loop_closure = enable_loop_closure
        self.map_ba = map_ba
        self.map_ba_stats: Optional[dict] = None
        enable_map = enable_map or track_against_map or map_ba
        self.sharded_map = sharded_map
        if enable_map and sharded_map:
            # the map is sharded over the default process group's ranks:
            # all-to-all fusion, ring refinement — never whole on a device
            self._map_mesh = make_mesh(self.device)
            self.map = ShardedVoxelMap(cfg.voxel, self._map_mesh,
                                       new_capacity=cfg.voxel.capacity)
        elif enable_map:
            self.map = VoxelMap(cfg.voxel, device=self.device)
        else:
            self.map = None
        self.track_against_map = track_against_map
        # "projective": reverse projective association against the current
        # frame's table; "grid": the grid probe against a sorted map index
        self.map_track_mode = map_track_mode
        self._map_index = None
        self.map_refine_stats: list[dict] = []
        self._known_edges: set[tuple[int, int]] = set()
        # pairs that FAILED verification: skipped until the next graph
        # optimization (keyframe clouds are immutable, so only a moved
        # initial guess can change a pair's verdict)
        self._failed_pairs: set[tuple[int, int]] = set()
        self._num_graph_nodes = 0
        self.closures: list = []
        # relocalization after `reloc_after` consecutive lost frames, with
        # exponential backoff on failed attempts
        self.enable_relocalization = enable_relocalization
        self.reloc_after = reloc_after
        self._reloc_backoff = reloc_after
        self._lost_streak = 0
        self._pending_reloc_edges: dict[int, tuple[int, np.ndarray]] = {}
        self.relocalizations: list = []
        # "inline": per-frame promotion through the chunk (frontend
        # .scan_chunk); "boundary": frozen-keyframe sub-chunks promoting
        # their LAST frame (frontend.scan_superchunk_frozen)
        self.chunk_mode = chunk_mode
        # sub-chunk size = the boundary mode's keyframe-cadence floor
        self.chunk_sub = int(chunk_sub)
        # deferred backend (boundary mode + async_backend): the attempt's
        # readback rides the next chunk's scan readback
        self.async_backend = async_backend
        self._pending_attempt: Optional[PendingAttempt] = None
        # worker-thread backend (inline chunk mode + async_backend): the
        # attempts run on a worker thread overlapped with tracking, and
        # their corrections commit under the lock.  In boundary mode async
        # means the deferred drain above and no worker is started.
        self._lock = threading.Lock()
        self._backend_queue: queue.Queue = queue.Queue()
        self._backend_thread: Optional[threading.Thread] = None
        self._backend_error: Optional[BaseException] = None
        # attempts queued and not yet committed (`wait_backend_idle`)
        self._backend_idle = threading.Condition()
        self._backend_queued = 0
        self._worker_stream = None
        if async_backend and chunk_mode == "inline":
            if self.device.type == "cuda":
                # the worker's attempts go to a stream of their own on the
                # system's device, beside tracking on the main stream; if
                # it cannot be made this raises (no attempt falls back to
                # the main stream or to the CPU twins)
                self._worker_stream = _worker_stream(self.device)
            self._backend_thread = threading.Thread(
                target=self._backend_worker, name="tpuslam-backend",
                daemon=True)
            self._backend_thread.start()

    def _backend_worker(self) -> None:
        """The worker thread: one attempt a queued item until `_STOP`.  An
        item is the stream that queued it (None on the CPU).  An error is
        kept for `finalize` and the worker goes on."""
        ctx = contextlib.ExitStack()
        if self._worker_stream is not None:
            # the current device and stream are the calling thread's own:
            # set both for this thread, or its kernels would go to device
            # 0's default stream
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self._worker_stream))
        with ctx:
            while True:
                item = self._backend_queue.get()
                if item is _STOP:
                    return
                try:
                    if self.enable_loop_closure:
                        self._attempt_loop_closure(after=item)
                except BaseException as e:      # raised by finalize
                    self._backend_error = e
                finally:
                    with self._backend_idle:
                        self._backend_queued -= 1
                        self._backend_idle.notify_all()

    def _queue_attempt(self) -> None:
        """Queue one attempt for the worker.  On a GPU the item carries the
        queuing thread's stream, which wrote the keyframes' tables."""
        with self._backend_idle:
            self._backend_queued += 1
        self._backend_queue.put(torch.cuda.current_stream(self.device)
                                if self._worker_stream is not None else None)

    def wait_backend_idle(self, timeout: float = WORKER_JOIN_S) -> None:
        """Wait until every queued attempt is committed (no-op without the
        worker); raise the worker's error, or TimeoutError past
        `timeout` seconds."""
        if self._backend_thread is not None:
            with self._backend_idle:
                if not self._backend_idle.wait_for(
                        lambda: self._backend_queued == 0, timeout):
                    raise TimeoutError(
                        f"backend worker: {self._backend_queued} attempt(s) "
                        f"not committed after {timeout} s")
        if self._backend_error is not None:
            raise self._backend_error

    def finalize(self) -> None:
        """Drain the deferred backend, join the worker (re-raising its
        error) and run a final global optimization."""
        with profiling.span("slam.finalize"):
            self._drain_pending()
            if self._backend_thread is not None:
                self._backend_queue.put(_STOP)
                self._backend_thread.join(timeout=WORKER_JOIN_S)
                if self._backend_thread.is_alive():
                    raise TimeoutError(f"backend worker still running after "
                                       f"{WORKER_JOIN_S} s")
                self._backend_thread = None
                if self._backend_error is not None:
                    raise self._backend_error
            if self.enable_loop_closure:
                self._attempt_loop_closure()
            if self.graph.num_edges > 0:
                with profiling.span("slam.final_solve"):
                    self._optimize()
            if self.map_ba:
                self.refine_map_ba()

    def _sync_graph_with_keyframes(self) -> bool:
        """Add any newly promoted keyframes as nodes + odometry edges."""
        added = False
        while self._num_graph_nodes < len(self.odo.keyframes):
            k = self._num_graph_nodes
            rec = self.odo.keyframes[k]
            self.graph.add_node(rec.T_world_kf)
            if k in self._pending_reloc_edges:
                # keyframe born from relocalization: link it to its anchor
                # with the verified pose, not an odometry edge across the
                # loss gap
                anchor, T_ij = self._pending_reloc_edges.pop(k)
                self.graph.add_edge(anchor, k, T_ij, weight=LC_EDGE_WEIGHT)
                self._known_edges.add((anchor, k))
                self.odo.protect(anchor, k)
                self._bound_protected()
            elif k > 0:
                prev = self.odo.keyframes[k - 1]
                T_ij = np.linalg.inv(prev.T_world_kf.astype(np.float64)) @ (
                    rec.T_world_kf.astype(np.float64))
                self.graph.add_edge(k - 1, k, T_ij, weight=1.0)
                self._known_edges.add((k - 1, k))
            self._num_graph_nodes += 1
            added = True
            if self.map is not None and rec.cloud is not None:
                self.map.insert(rec.cloud, rec.T_world_kf)
                self._map_index = None     # stale: rebuilt lazily
        return added

    def _refine_against_map(self) -> None:
        """Frame-to-map refinement: re-align the current frame's estimate
        against the accumulated voxel map and, when the result passes the
        gates, push it into the frontend's keyframe-relative state.  The
        result is read back as one flat scalar vector (one host sync)."""
        odo = self.odo
        kf_id, T_rel = odo.frame_refs[-1]
        rec = odo.keyframes[kf_id]
        if odo.last_pyr is None or self.map.num_insertions < 2:
            return
        T0 = upload(rec.T_world_kf.astype(np.float32)
                    @ T_rel.astype(np.float32), self.device)
        if self.sharded_map:
            cloud = odo._kf_cloud(odo.last_pyr)   # current frame, camera
            _res, flat = make_ring_align_fn(self._map_mesh, self.cfg.icp)(
                cloud, self.map.cloud_shards, T0)
        elif self.map_track_mode == "projective":
            flat = _refine_projective_jit(self.map.cloud, odo.last_pyr[0],
                                          odo.K, T0, self.cfg.icp)
        else:
            if self._map_index is None:
                self._map_index = self.map.build_index(
                    cell=float(self.cfg.icp.max_corr_dist))
            cloud = odo._kf_cloud(odo.last_pyr)   # current frame, camera
            flat = _refine_grid_jit(cloud, self._map_index, T0,
                                    self.cfg.icp)
        s = flat.cpu().numpy()                    # the one host sync
        T_est = s[FlatICP.T].reshape(4, 4)
        ok = (bool(s[FlatICP.CONVERGED] > 0.5)
              and float(s[FlatICP.INLIER_FRACTION]) > 0.3
              and float(s[FlatICP.NUM_INLIERS])
              >= float(self.cfg.map_refine_min_inliers)
              and bool(np.all(np.isfinite(T_est))))
        self.map_refine_stats.append(
            {"ok": ok, "rms": float(s[FlatICP.RMS]),
             "inliers": float(s[FlatICP.INLIER_FRACTION])})
        if not ok:
            return
        T_world_cam = T_est.astype(np.float64)
        T_rel_new = np.linalg.inv(rec.T_world_kf.astype(np.float64)
                                  ) @ T_world_cam
        odo.frame_refs[-1] = (kf_id, T_rel_new)
        odo.T_kf_cam = upload(T_rel_new.astype(np.float32), self.device)
        odo.trajectory[-1] = T_world_cam

    def _dispatch_closure_attempt(
            self, max_candidates: int = 4,
            after=None) -> Optional[PendingAttempt]:
        """Propose → verify → optimize on the device, WITHOUT reading back.

        Candidate edges enter the solve with weight LC_EDGE_WEIGHT·accept
        (the device-side gate), so verification rows and optimized poses
        come back in one readback; the host then mirrors the gate decisions
        from the same float32 values and applies the poses when a closure
        was accepted.  Returns None when nothing was verifiable (a dry pass
        costs no device work: proposal is host-side numpy).

        The snapshot is taken under the lock (the worker runs this beside
        tracking); `after` is then the stream that wrote the keyframes'
        tables (the worker's queued item).
        """
        with self._lock:
            n = self._num_graph_nodes
            graph = self.graph.snapshot()
            keyframes = list(self.odo.keyframes[:n])
            known = set(self._known_edges) | set(self._failed_pairs)
            if after is not None:
                # every table, cloud and descriptor of these keyframes was
                # issued on `after` before its thread released the lock:
                # the worker's stream waits for an event recorded there
                # now (an event taken when the item was queued would miss
                # keyframes promoted since)
                torch.cuda.current_stream(self.device).wait_stream(after)
        kf_poses = [graph._poses[k].astype(np.float64) for k in range(n)]
        live_nodes = graph.num_nodes
        live, padded, attempted, v0 = propose_attempt(
            keyframes, kf_poses, self.cfg.icp, self.cfg.posegraph,
            exclude_pairs=known, K=self.odo.K, max_candidates=max_candidates)
        if not live:
            with self._lock:
                self._failed_pairs.update(attempted)
            return None
        g = graph.graph(bucketed=True)
        b = len(padded)
        dev = self.device
        cand_i = upload(np.asarray([i for i, _, _ in live] + [0] * (b - len(
            live)), dtype=np.int32), dev)
        cand_j = upload(np.asarray([j for _, j, _ in live] + [0] * (b - len(
            live)), dtype=np.int32), dev)
        T_inits = upload(np.stack([T for _, _, T in padded]), dev)
        if v0 is None:
            packed = self._chain_attempt_fallback(
                keyframes, padded, live, T_inits, g, cand_i, cand_j,
                live_nodes)
        else:
            use_dense = resolve_solver(self.cfg.posegraph, live_nodes,
                                       capacity=g.poses.shape[0]) == "dense"
            packed = fused_attempt_jit(
                [keyframes[i].verify.packed for i, _, _ in padded],
                [keyframes[j].cloud.points for _, j, _ in padded],
                [keyframes[j].cloud.normals for _, j, _ in padded],
                [keyframes[j].cloud.mask for _, j, _ in padded],
                self.odo.K.scaled(1.0 / (2 ** v0.level)), T_inits,
                len(live), g, cand_i, cand_j, v0.height, v0.width,
                self.cfg.icp, self.cfg.posegraph, use_dense, LC_EDGE_WEIGHT)
        return PendingAttempt(
            live=live, attempted=attempted, packed=packed,
            rows_shape=(b, ROW_SIZE), poses_shape=tuple(g.poses.shape),
            live_nodes=live_nodes, keep=tuple(keyframes))

    def _chain_attempt_fallback(self, keyframes, padded, live, T_inits, g,
                                cand_i, cand_j,
                                live_nodes: int) -> torch.Tensor:
        """The attempt for keyframes without uniform verification tables:
        grid-hash verification of the candidates (cloud j onto cloud i),
        the gate-weighted candidate edges and the pose-graph solve, on the
        device and packed as `fused_attempt_jit` packs them (rows ++
        poses), so the drain reads it unchanged."""
        rows = verify_batch_grid([keyframes[i].cloud for i, _, _ in padded],
                                 [keyframes[j].cloud for _, j, _ in padded],
                                 T_inits, len(live), self.cfg.icp)
        g_ext = extend_with_candidates(g, rows, len(live), cand_i, cand_j,
                                       self.cfg.posegraph, LC_EDGE_WEIGHT)
        poses_opt, _cost = optimize(g_ext, self.cfg.posegraph,
                                    live_nodes=live_nodes)
        return torch.cat([rows.reshape(-1).to(torch.float32),
                          poses_opt.reshape(-1).to(torch.float32)])

    def _drain_closure_attempt(self, p: PendingAttempt,
                               flat: Optional[np.ndarray] = None) -> bool:
        """Read back (unless `flat` came fused with another readback), gate
        and commit one dispatched attempt (the commit under the lock)."""
        if flat is None:
            # the ONE sync; on the worker it waits for the worker's stream
            # only, and nothing of the attempt crosses to the main thread
            # but these host values
            flat = p.packed.cpu().numpy()
        rows_size = math.prod(p.rows_shape)
        s = flat[:rows_size].reshape(p.rows_shape)
        poses = flat[rows_size:].reshape(p.poses_shape)
        closures = gate_rows(p.live, s, self.cfg.posegraph)
        with self._lock:
            accepted = {(c.i, c.j) for c in closures}
            self._failed_pairs.update(p.attempted - accepted)
            added = False
            for c in closures:
                if (c.i, c.j) in self._known_edges:
                    continue
                self.graph.add_edge(c.i, c.j, c.T_ij, weight=LC_EDGE_WEIGHT)
                self._known_edges.add((c.i, c.j))
                # closure anchors keep their clouds through sparsification
                self.odo.protect(c.i, c.j)
                self._bound_protected()
                self.closures.append(c)
                added = True
            if added:
                if self.graph.num_nodes == p.live_nodes:
                    # apply the fused optimization (accepted edges at
                    # weight 2, rejected 0) and re-anchor the frontend as
                    # _optimize does
                    self._apply_poses(poses.astype(np.float32))
                else:
                    # the graph grew while the attempt was in flight: its
                    # poses are stale, re-solve on the current graph
                    self._optimize()
        return bool(closures)

    def _attempt_loop_closure(self, after=None) -> bool:
        """One fused attempt, dispatched and drained at once (one sync)."""
        p = self._dispatch_closure_attempt(after=after)
        if p is None:
            return False
        return self._drain_closure_attempt(p)

    def _drain_pending(self) -> None:
        """Drain the deferred backend's outstanding attempt, if any (before
        any path that must see a sync-equivalent graph state: per-frame
        stepping, inline chunks, finalize)."""
        p, self._pending_attempt = self._pending_attempt, None
        if p is not None:
            self._drain_closure_attempt(p)

    def _bound_protected(self) -> None:
        """Cap the sparsification-protected anchor set, evicting the least
        recently re-confirmed anchors."""
        cap = max(4, int(self.cfg.keyframe.max_keyframes) // 2)
        prot = self.odo.protected_kf_ids
        if len(prot) > cap:
            keep = sorted(prot, key=prot.__getitem__)[-cap:]
            self.odo.protected_kf_ids = {k: prot[k] for k in keep}

    def _apply_poses(self, poses: np.ndarray) -> None:
        """Commit optimized keyframe poses: graph, keyframe records and the
        live tracking origin (under the lock, or with no worker running)."""
        self.graph.set_poses(poses)
        # optimization moved the initial guesses: failed pairs may verify
        self._failed_pairs.clear()
        self.odo.T_world_kf = poses[self._num_graph_nodes - 1]
        for idx in range(self._num_graph_nodes):
            rec = self.odo.keyframes[idx]
            self.odo.keyframes[idx] = rec._replace(T_world_kf=poses[idx])

    def _optimize(self) -> None:
        graph = self.graph.graph(bucketed=True)
        poses, _cost = optimize(graph, self.cfg.posegraph,
                                live_nodes=self.graph.num_nodes)
        self._apply_poses(poses.cpu().numpy().astype(np.float32))

    def refine_map_ba(self, max_control: int = 4096,
                      points_per_kf: int = 512) -> bool:
        """Global Schur-complement map BA over all keyframes.

        Re-voxelizes the live map into ≤ `max_control` control points,
        associates a subsample of every retained keyframe cloud with them
        and refines keyframe poses and control-point offsets jointly
        (backend/map_ba.py).  The poses are written back into the graph,
        the keyframe records and the tracking origin; the dense map stays
        the running fusion.  Returns whether BA ran and was finite.

        A deferred loop-closure attempt still pending is drained first: the
        reference leaves it pending, and the next chunk would then apply
        its pre-BA poses over BA's.
        """
        self._drain_pending()
        n = self._num_graph_nodes
        if self.map is None or n < 2 or self.map.num_insertions < 2:
            return False
        map_cloud = (self.map.gather() if self.sharded_map
                     else self.map.cloud)
        v = self.cfg.voxel
        ctrl = voxel_downsample(map_cloud, 2.0 * v.map_voxel_size,
                                max_control, origin=v.origin,
                                extent=v.extent)
        # keyframes whose clouds were sparsified away contribute no map
        # observations; the graph's edges still constrain their poses
        kf_points, kf_mask, kf_poses, kf_ids = [], [], [], []
        for kid, rec in enumerate(self.odo.keyframes[:n]):
            if rec.cloud is None:
                continue
            stride = max(1, rec.cloud.points.shape[0] // points_per_kf)
            kf_points.append(rec.cloud.points[::stride][:points_per_kf])
            kf_mask.append(rec.cloud.mask[::stride][:points_per_kf])
            kf_poses.append(rec.T_world_kf.astype(np.float32))
            kf_ids.append(kid)
        if len(kf_ids) < 2:
            return False
        dev = self.device
        prob = build_map_ba_problem(
            upload(np.stack(kf_poses), dev), torch.stack(kf_points),
            torch.stack(kf_mask), ctrl.points, ctrl.normals, ctrl.mask,
            max_dist=float(self.cfg.icp.max_corr_dist),
            kf_ids=upload(np.asarray(kf_ids, dtype=np.int32), dev))
        poses, _map_pts, cost = optimize_map_ba(
            self.graph.graph(bucketed=True), prob, self.cfg.posegraph,
            huber_delta=self.cfg.icp.huber_delta)
        # one readback: the poses, the cost and the two counts
        flat = torch.cat([poses.reshape(-1).to(torch.float32), torch.stack([
            cost.to(torch.float32), prob.obs_w.sum().to(torch.float32),
            ctrl.mask.sum().to(torch.float32)])]).cpu().numpy()
        poses = flat[:-3].reshape(poses.shape)
        if not np.all(np.isfinite(poses)):
            return False
        self.map_ba_stats = {"cost": float(flat[-3]),
                             "num_obs": int(flat[-2]),
                             "num_control": int(flat[-1])}
        # BA moved every initial guess: failed closure pairs may verify
        with self._lock:
            self._apply_poses(poses)
        return True

    def _attempt_relocalization(self) -> Optional[bool]:
        """Re-anchor the current (lost) frame on a stored keyframe.

        True on success (the frame becomes a keyframe at the verified pose,
        joining the graph by a reloc edge to its anchor), False on a failed
        attempt (counts toward the backoff), None when the frame has too
        few valid points to verify anything."""
        odo = self.odo
        if odo.last_pyr is None or not odo.keyframes:
            return None
        frame_cloud = odo._kf_cloud(odo.last_pyr)
        if int(frame_cloud.count()) < 100:
            return None
        kf_id, T_rel = odo.frame_refs[-1]
        T_last = odo.keyframes[kf_id].T_world_kf.astype(np.float64) @ T_rel
        r = relocalize(frame_cloud, odo.keyframes, T_last, self.cfg.icp,
                       self.cfg.posegraph, K=odo.K)
        if r is None:
            return False
        anchor = odo.keyframes[r.kf_id]
        T_world_cam = anchor.T_world_kf.astype(np.float64) @ r.T_kf_cam
        odo.T_world_kf = T_world_cam.astype(np.float32)
        odo.T_kf_cam = torch.eye(4, device=self.device)
        odo.last_delta = torch.eye(4, device=self.device)
        odo._promote(odo.last_pyr, odo.timestamps[-1])
        # _promote stamps index=frame_idx, which already advanced past the
        # frame being relocalized
        odo.keyframes[-1] = odo.keyframes[-1]._replace(index=odo.frame_idx - 1)
        new_id = len(odo.keyframes) - 1
        odo.frame_refs[-1] = (new_id, np.eye(4))
        odo.trajectory[-1] = T_world_cam
        odo.stats[-1]["relocalized"] = True
        self._pending_reloc_edges[new_id] = (r.kf_id, np.asarray(r.T_kf_cam))
        self.relocalizations.append(r)
        return True

    def _commit_chunk_end(self) -> bool:
        """Bookkeeping shared by the chunk paths once a chunk is committed:
        no loss streak, and the graph catches up with the new keyframes."""
        self.odo.last_pyr = None      # per-frame pyramids are not retained
        self._lost_streak = 0
        self._reloc_backoff = self.reloc_after
        return self._sync_graph_with_keyframes()

    def _process_chunk_boundary(self, depths: torch.Tensor,
                                timestamps) -> np.ndarray:
        """Boundary-promotion chunk processing (frontend
        .scan_superchunk_frozen).

        World poses are composed on the host in float64 from the readback's
        relative poses, so the scan output does not depend on pose
        corrections: the deferred backend can apply the PREVIOUS attempt's
        corrections right before this walk and stay identical to the
        synchronous order, while its readback rides this scan's.
        """
        odo = self.odo
        n = depths.shape[0]
        # the keyframe cadence stays at `sub` whatever the call's length
        sub = (self.chunk_sub
               if n >= self.chunk_sub and n % self.chunk_sub == 0 else n)
        carry = SuperChunkCarry(kf_packed=odo.kf_packed,
                                T_kf_cam=odo.T_kf_cam,
                                last_delta=odo.last_delta)
        with profiling.span("slam.scan", n=n):
            new_carry, ys = scan_superchunk_frozen(depths, odo.K, carry,
                                                   self.cfg, sub)
        pending, self._pending_attempt = self._pending_attempt, None
        readback = profiling.span("slam.readback", device=depths.is_cuda,
                                  eager=True)
        if pending is not None:
            # one readback covers BOTH the deferred attempt and this scan
            with readback:
                combined = fuse_readbacks_jit(pending.packed,
                                              ys).cpu().numpy()
            s = combined[pending.size:].reshape(n, FlatFrozen.SIZE)
            with profiling.span("slam.drain"):
                self._drain_closure_attempt(pending, combined[:pending.size])
        else:
            with readback:
                s = ys.cpu().numpy()       # the ONE host sync of the chunk
        if np.any(s[:, FlatFrozen.LOST] > 0.5):
            # tracking failed mid-chunk: nothing was committed — replay the
            # chunk per frame so loss accounting and relocalization engage
            return np.stack([self.process(depths[i], float(timestamps[i]))
                             for i in range(n)])
        out = []
        with_desc = bool(self.cfg.posegraph.lc_descriptor)
        base_T = odo.T_world_kf.astype(np.float64)
        for g0 in range(0, n, sub):
            rels = [s[g0 + i][FlatFrozen.REL_T].reshape(4, 4)
                    .astype(np.float64) for i in range(sub)]
            flags = s[g0:g0 + sub, FlatFrozen.PROMOTE] > 0.5
            # promote-LAST, mirroring the device-side select
            p = sub - 1 if flags.any() else -1
            kf_id = len(odo.keyframes) - 1
            ref_base = len(odo.frame_refs)
            for i in range(sub):
                row = s[g0 + i]
                T_world_cam = base_T @ rels[i]
                odo.frame_refs.append((kf_id, rels[i]))
                odo.stats.append({
                    "iters": int(row[FlatFrozen.ITERS]),
                    "rms": float(row[FlatFrozen.RMS]),
                    "inliers": float(row[FlatFrozen.INLIER_FRACTION]),
                    "promoted": i == p,
                    "lost": False,
                })
                odo.trajectory.append(T_world_cam)
                odo.timestamps.append(float(timestamps[g0 + i]))
                odo.frame_idx += 1
                out.append(T_world_cam)
            if p >= 0:
                # the sub-chunk's LAST frame is the new keyframe; its
                # pyramid, tables, cloud and descriptor derive from the
                # device-resident depth without a sync
                odo.T_world_kf = (base_T @ rels[p]).astype(np.float32)
                with profiling.span("slam.promote_bundle"):
                    pyr, packed, cloud, desc = promote_bundle_jit(
                        depths[g0 + p], odo.K, self.cfg, with_desc)
                odo._promote_from_bundle(pyr, packed, cloud, desc,
                                         float(timestamps[g0 + p]))
                odo.keyframes[-1] = odo.keyframes[-1]._replace(
                    index=odo.frame_idx - sub + p)
                odo.frame_refs[ref_base + p] = (len(odo.keyframes) - 1,
                                                np.eye(4))
                base_T = base_T @ rels[p]
        # the carry's tables and poses ARE the device-side truth — the last
        # promote_bundle packed the same frame the device packed
        odo.kf_packed = new_carry.kf_packed
        odo.T_kf_cam = new_carry.T_kf_cam
        odo.last_delta = new_carry.last_delta
        new_kf = self._commit_chunk_end()
        if new_kf and self.enable_loop_closure:
            # ONE coalesced attempt per call at the 4-candidate budget
            with profiling.span("slam.attempt"):
                att = self._dispatch_closure_attempt()
            if att is not None:
                if self.async_backend:
                    self._pending_attempt = att   # deferred to next chunk
                else:
                    with profiling.span("slam.drain"):
                        self._drain_closure_attempt(att)
        return np.stack(out)

    def process_chunk(self, depths, timestamps=None) -> np.ndarray:
        """Process a chunk of frames with one readback.

        Steps per frame instead (same semantics) while no keyframe is
        seeded — in boundary mode only the first sub-chunk, then the rest
        of the call is scanned — when a frame of the chunk reports
        tracking loss (the chunk then commits nothing and replays), and
        throughout with `track_against_map` (map refinement is per frame).

        Returns (C, 4, 4) world←cam poses as tracked; `trajectory()`
        re-anchors on optimized keyframe poses.
        """
        depths = self.odo.as_depth(depths)
        n = depths.shape[0]
        if timestamps is None:
            timestamps = [0.0] * n
        odo = self.odo
        if self.track_against_map or odo.kf_pyr is None:
            sub = self.chunk_sub
            if (self.chunk_mode == "boundary" and not self.track_against_map
                    and n > sub and n % sub == 0):
                # bootstrap exactly ONE sub-chunk per frame (seeding the
                # keyframe), then scan the tail, so keyframe decisions do
                # not depend on the call's length
                with profiling.span("slam.bootstrap"):
                    head = np.stack([self.process(depths[i],
                                                  float(timestamps[i]))
                                     for i in range(sub)])
                tail = self._process_chunk_boundary(depths[sub:],
                                                    timestamps[sub:])
                return np.concatenate([head, tail])
            return np.stack([self.process(depths[i], float(timestamps[i]))
                             for i in range(n)])
        if self.chunk_mode == "boundary":
            return self._process_chunk_boundary(depths, timestamps)
        self._drain_pending()
        state = ScanState(
            kf_packed=odo.kf_packed,
            T_world_kf=upload(odo.T_world_kf.astype(np.float32), self.device),
            T_kf_cam=odo.T_kf_cam, last_delta=odo.last_delta)
        new_state, ys = scan_chunk(depths, odo.K, state, self.cfg)
        s = ys.cpu().numpy()               # the ONE host sync of the chunk
        if np.any(s[:, FlatChunk.LOST] > 0.5):
            return np.stack([self.process(depths[i], float(timestamps[i]))
                             for i in range(n)])
        out = []
        with self._lock:
            for i in range(n):
                row = s[i]
                T_world_cam = row[FlatChunk.WORLD_T].reshape(4, 4).astype(
                    np.float64)
                promoted = bool(row[FlatChunk.PROMOTE] > 0.5)
                if promoted:
                    odo.T_world_kf = T_world_cam.astype(np.float32)
                    odo._promote(preprocess(depths[i], odo.K, self.cfg),
                                 float(timestamps[i]))
                    odo.frame_refs.append((len(odo.keyframes) - 1,
                                           np.eye(4)))
                else:
                    odo.frame_refs.append((
                        len(odo.keyframes) - 1,
                        row[FlatChunk.REL_T].reshape(4, 4).astype(
                            np.float64)))
                odo.stats.append({
                    "iters": int(row[FlatChunk.ITERS]),
                    "rms": float(row[FlatChunk.RMS]),
                    "inliers": float(row[FlatChunk.INLIER_FRACTION]),
                    "promoted": promoted,
                    "lost": False,
                })
                odo.trajectory.append(T_world_cam)
                odo.timestamps.append(float(timestamps[i]))
                odo.frame_idx += 1
                out.append(T_world_cam)
            # commit the device-side carry AFTER the walk
            odo.kf_packed = new_state.kf_packed
            odo.T_kf_cam = new_state.T_kf_cam
            odo.last_delta = new_state.last_delta
            kf_before = self._num_graph_nodes
            new_kf = self._commit_chunk_end()
            num_new = self._num_graph_nodes - kf_before
        if new_kf and self._backend_thread is not None:
            # one queued attempt per promotion, not one per chunk: the
            # per-frame path's opportunities (the reference measured a
            # single item a chunk dropping closures 38 → 34/23 on its
            # 120-frame loop)
            for _ in range(num_new):
                self._queue_attempt()
        elif new_kf and self.enable_loop_closure:
            # one attempt per promotion, as the per-frame path gets,
            # stopping when dry
            for _ in range(num_new):
                if not self._attempt_loop_closure():
                    break
        return np.stack(out)

    def process(self, depth, timestamp: float = 0.0) -> np.ndarray:
        """Track one frame (per-frame path); returns its world←cam pose."""
        with profiling.span("slam.process", n=1):
            self._drain_pending()
            with self._lock:
                self.odo.process(depth, timestamp)
                if self.odo.stats[-1].get("lost"):
                    self._lost_streak += 1
                    if (self.enable_relocalization
                            and self._lost_streak >= self._reloc_backoff):
                        r = self._attempt_relocalization()
                        if r is True:
                            self._lost_streak = 0
                            self._reloc_backoff = self.reloc_after
                        elif r is False:
                            # genuine miss: back off
                            self._lost_streak = 0
                            self._reloc_backoff = min(
                                2 * self._reloc_backoff, 64)
                        # r is None: no usable data — keep the streak
                else:
                    self._lost_streak = 0
                    self._reloc_backoff = self.reloc_after
                new_kf = self._sync_graph_with_keyframes()
            if new_kf and self._backend_thread is not None:
                self._queue_attempt()
            elif new_kf and self.enable_loop_closure:
                # synchronous: dispatch and drain inside this frame
                profiling.count("slam.frame_attempts")
                with profiling.span("slam.frame_attempt"):
                    self._attempt_loop_closure()
            if self.track_against_map:
                with self._lock:
                    self._refine_against_map()
            kf_id, T_rel = self.odo.frame_refs[-1]
            T_world_kf = self.odo.keyframes[kf_id].T_world_kf
            return T_world_kf.astype(np.float64) @ T_rel

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (F,), poses (F, 4, 4)) with every frame re-anchored
        on the current (optimized) keyframe poses."""
        poses = np.zeros((len(self.odo.frame_refs), 4, 4))
        for f, (kf_id, T_rel) in enumerate(self.odo.frame_refs):
            poses[f] = (self.odo.keyframes[kf_id].T_world_kf
                        .astype(np.float64) @ T_rel)
        return np.asarray(self.odo.timestamps), poses
