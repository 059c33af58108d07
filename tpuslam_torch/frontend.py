"""Frame-to-keyframe odometry — port of `tpuslam/frontend.py`.

Three loops over one tracking step (`track_step_packed`):

  * `scan_odometry` / `scan_odometry_boundary_jit` — a whole sequence with
    every piece of state on the input's device: the keyframe is kept as its
    packed gather tables, per-frame outputs go into preallocated tensors
    that the caller reads back once.  Nothing inside a frame waits for the
    GPU.
  * `scan_chunk` / `scan_superchunk_frozen` — the chunked streaming scans
    of `SlamSystem.process_chunk` (inline and boundary promotion): one
    (C, SIZE) float32 matrix per chunk for the host to read back once.
  * `Odometry` — the host-driven per-frame loop: one `process_frame_jit`
    call and one readback per frame; promotion bookkeeping (keyframe
    records, their voxel clouds, verification tables and depth
    descriptors, cloud budget) on the host.

Where the reference takes a `lax.cond` to re-pack the keyframe only on
promotion, the port packs unconditionally and selects with `torch.where`
on the device, so no flag is read on the host inside a chunk.  Names ending
in `_jit` are the reference's.  The reference's compiled programs are CUDA
graphs here (tpuslam_torch/graphs.py), replayed on the card: the frame step
of `scan_odometry` and `scan_chunk` (one replay a frame, the scan's state
carried in the graph), `process_frame_jit` (one replay a frame), the
sub-chunk of `scan_superchunk_frozen` (one replay a sub-chunk), the chunk
of `scan_odometry_boundary_jit` (one replay a chunk, the keyframe's world
pose carried with the sub-chunk's carry), and a promotion's
`promote_bundle_jit`, `pack_pyramid_jit` and `_kf_cloud_jit`.
On the CPU, or with `eager=True`, they run op by op.

Keyframe criterion: relative motion (translation/rotation) beyond
threshold OR inlier fraction below threshold; a frame whose inlier fraction
falls below `lost_inlier_fraction` (or whose pose is non-finite) keeps its
warm-start pose and never promotes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch import graphs
from tpuslam_torch.config import Intrinsics, SLAMConfig
from tpuslam_torch.geom import se3
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.voxel import voxel_downsample
from tpuslam_torch.icp import (
    Frame,
    ICPResult,
    align_frames,
    align_frames_packed,
    pack_pyramid,
)
from tpuslam_torch.kernels.preprocess import preprocess
from tpuslam_torch.kernels.warm_start import warm_start
from tpuslam_torch.transfer import resolve_device, upload
from tpuslam_torch.utils import profiling


class TrackResult(NamedTuple):
    T_kf_cam: torch.Tensor     # (4, 4) camera pose in keyframe frame
    icp: ICPResult
    promote: torch.Tensor      # () bool — should current frame become keyframe
    lost: torch.Tensor         # () bool — tracking failure


def _promote_flags(res: ICPResult, T0: torch.Tensor,
                   cfg: SLAMConfig) -> TrackResult:
    T = res.T
    lost = ((res.inlier_fraction < cfg.keyframe.lost_inlier_fraction)
            | ~torch.all(torch.isfinite(T)))
    T = torch.where(lost, T0, T)
    promote = (
        (se3.translation_norm(T) > cfg.keyframe.max_translation)
        | (se3.rotation_angle(T) > cfg.keyframe.max_rotation)
        | (res.inlier_fraction < cfg.keyframe.min_inlier_fraction)
    ) & ~lost
    return TrackResult(T_kf_cam=T, icp=res, promote=promote, lost=lost)


def track_step_packed(kf_packed: tuple, cur_pyr, K: Intrinsics,
                      T0: torch.Tensor, cfg: SLAMConfig) -> TrackResult:
    """Track the current pyramid against a pre-packed keyframe and decide
    promotion (flags stay on the device)."""
    res = align_frames_packed(cur_pyr, kf_packed, K, T0, cfg.icp)
    return _promote_flags(res, T0, cfg)


def track_step(kf_pyr, cur_pyr, K: Intrinsics, T0: torch.Tensor,
               cfg: SLAMConfig) -> TrackResult:
    """Track the current pyramid against a keyframe pyramid (packed per
    call) and decide promotion."""
    res = align_frames(cur_pyr, kf_pyr, K, T0, cfg.icp)
    return _promote_flags(res, T0, cfg)


def _track(kf_packed: tuple, depth: torch.Tensor, K: Intrinsics,
           T_kf_cam: torch.Tensor, last_delta: torch.Tensor,
           cfg: SLAMConfig):
    """Warm start + preprocess + track one frame: (pyr, TrackResult, the
    inter-frame motion for the next warm start)."""
    pyr = preprocess(depth, K, cfg)
    T0 = warm_start(T_kf_cam, last_delta, cfg.cv_damping)
    out = track_step_packed(kf_packed, pyr, K, T0, cfg)
    return pyr, out, se3.relative(T_kf_cam, out.T_kf_cam)


def _track_stats(out: TrackResult) -> torch.Tensor:
    """(5,) float32 [promote, lost, iters, rms, inlier_fraction]."""
    return torch.stack([
        out.promote.to(torch.float32),
        out.lost.to(torch.float32),
        out.icp.iters.to(torch.float32),
        out.icp.rms.to(torch.float32),
        out.icp.inlier_fraction.to(torch.float32),
    ])


def _select(flag: torch.Tensor, new, old):
    """`torch.where(flag, new, old)` over a pose or a tuple of tables."""
    if isinstance(new, tuple):
        return tuple(torch.where(flag, n, o) for n, o in zip(new, old))
    return torch.where(flag, new, old)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device)


class FlatTrack:
    """Index map of `process_frame_jit`'s flat scalar vector (the per-frame
    readback of the host-driven loop; not icp.FlatICP's layout)."""

    T = slice(0, 16)          # T_kf_cam, row-major
    PROMOTE = 16
    LOST = 17
    ITERS = 18
    RMS = 19
    INLIER_FRACTION = 20
    SIZE = 21


def _process_frame(_state, depth, kf_packed, T_kf_cam, last_delta, *,
                   K: Intrinsics, cfg: SLAMConfig):
    pyr, out, delta = _track(kf_packed, depth, K, T_kf_cam, last_delta, cfg)
    flat = torch.cat([out.T_kf_cam.reshape(16).to(torch.float32),
                      _track_stats(out)])
    return (), (pyr, out.T_kf_cam, delta, flat)


_PROCESS_FRAME = graphs.Program("process_frame_jit", _process_frame)


def process_frame_jit(depth: torch.Tensor, kf_packed: tuple, K: Intrinsics,
                      T_kf_cam: torch.Tensor, last_delta: torch.Tensor,
                      cfg: SLAMConfig, eager: bool = False):
    """Warm start + preprocess + track for the host-driven loop; a CUDA
    graph on the card (one replay, keyed by K, cfg and the shapes) unless
    `eager`.

    Returns (pyr, T_kf_cam, delta, flat): the chained state stays on the
    device and every scalar the host needs is in one (FlatTrack.SIZE,)
    float32 vector, so the loop reads back once per frame.
    """
    return _PROCESS_FRAME.run(depth, kf_packed, T_kf_cam, last_delta,
                              eager=eager, K=K, cfg=cfg)


def _pack_pyramid(_state, pyr, *, cfg: SLAMConfig):
    return (), pack_pyramid(pyr, cfg.icp)


_PACK_PYRAMID = graphs.Program("pack_pyramid_jit", _pack_pyramid)


def pack_pyramid_jit(pyr, cfg: SLAMConfig, eager: bool = False) -> tuple:
    """`icp.pack_pyramid` of a keyframe's pyramid; a CUDA graph on the
    card (keyed by cfg and the shapes) unless `eager`."""
    return _PACK_PYRAMID.run(pyr, eager=eager, cfg=cfg)


def _kf_cloud(_state, frame: Frame, *, voxel_size: float, capacity: int,
              origin: float, extent: float):
    return (), voxel_downsample(frame.as_cloud(), voxel_size, capacity,
                                origin, extent)


_KF_CLOUD = graphs.Program("_kf_cloud_jit", _kf_cloud)


def _kf_cloud_jit(frame: Frame, voxel_size: float, capacity: int,
                  origin: float, extent: float,
                  eager: bool = False) -> PointCloud:
    """A frame's voxel-downsampled cloud (the keyframe cloud, and the
    frame cloud the grid and ring refinements align); a CUDA graph on the
    card (keyed by the voxel grid and the shapes) unless `eager`."""
    return _KF_CLOUD.run(frame, eager=eager, voxel_size=voxel_size,
                         capacity=capacity, origin=origin, extent=extent)


def _promote_bundle(_state, depth, *, K: Intrinsics, cfg: SLAMConfig,
                    with_desc: bool):
    pyr = preprocess(depth, K, cfg)
    packed = pack_pyramid(pyr, cfg.icp)
    cloud = voxel_downsample(pyr[0].as_cloud(), cfg.voxel.voxel_size,
                             cfg.voxel.capacity, cfg.voxel.origin,
                             cfg.voxel.extent)
    desc = (depth_descriptor(pyr[-1].points, pyr[-1].mask)
            if with_desc else None)
    return (), (pyr, packed, cloud, desc)


_PROMOTE_BUNDLE = graphs.Program("promote_bundle_jit", _promote_bundle)


def promote_bundle_jit(depth: torch.Tensor, K: Intrinsics, cfg: SLAMConfig,
                       with_desc: bool, eager: bool = False):
    """Everything a keyframe promotion derives from its depth frame: the
    pyramid, its packed gather tables, the voxel-downsampled cloud and,
    with `with_desc`, the depth descriptor (on the device).  A CUDA graph
    on the card (keyed by K, cfg, `with_desc` and the shape) unless
    `eager`."""
    return _PROMOTE_BUNDLE.run(depth, eager=eager, K=K, cfg=cfg,
                               with_desc=with_desc)


def prefetch_to_device(frames, lookahead: int = 2, device="cuda"):
    """Re-yield a TumFrame stream with each depth array already copied to
    `device`, `lookahead` frames ahead of the consumer.

    The copies go through `transfer.upload`: the host array is copied into
    pinned memory and sent without waiting for the device, so a frame's
    transfer overlaps the previous frame's tracking, and the loader may
    reuse its array at once.  The dtype is kept (uint16 counts stay uint16:
    `preprocess` divides them on the device).
    """
    from collections import deque

    dev = resolve_device(device)
    pending: deque = deque()
    for f in frames:
        pending.append(f._replace(depth=upload(f.depth, dev)))
        if len(pending) >= max(1, lookahead):
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class VerifyTable(NamedTuple):
    """Packed row-gather table a keyframe retains for projective backend
    verification (loop closure / relocalization) — a byproduct of its own
    tracking tables, kept at KeyframeConfig.verify_level."""

    packed: torch.Tensor        # (h·w, 8) table (pack_organized_target)
    height: int                 # level image dims
    width: int
    level: int                  # pyramid level (scales the intrinsics)


DESC_GRID = (6, 8)              # (gh, gw) blocks of the coarsest level


def depth_descriptor(points: torch.Tensor, mask: torch.Tensor,
                     gh: int = DESC_GRID[0],
                     gw: int = DESC_GRID[1]) -> torch.Tensor:
    """Pose-free appearance descriptor of a keyframe: the mean depth and
    the valid fraction of each block of a gh×gw grid over the coarsest
    pyramid level, (2·gh·gw,) float32 (trailing rows and columns that do
    not fill a block are left out).

    Proximity proposal cannot nominate a revisit whose drift exceeds
    `lc_max_dist`; similar descriptors nominate it with no pose term
    (backend/loopclosure.py `propose_descriptor_candidates`).
    """
    z = points[..., 2]
    h, w = z.shape
    hc, wc = (h // gh) * gh, (w // gw) * gw
    zb = torch.where(mask, z, 0.0)[:hc, :wc].reshape(
        gh, hc // gh, gw, wc // gw)
    mb = mask[:hc, :wc].reshape(gh, hc // gh, gw, wc // gw).to(z.dtype)
    cnt = mb.sum(dim=(1, 3))
    mean_z = zb.sum(dim=(1, 3)) / torch.clamp(cnt, min=1.0)
    frac = cnt / float((hc // gh) * (wc // gw))
    return torch.cat([mean_z.reshape(-1),
                      frac.reshape(-1)]).to(torch.float32)


class _InFlight(np.ndarray):
    """A descriptor's pinned host buffer whose copy from the device may
    still run: `ready` is the CUDA event recorded after the copy."""

    ready = None


def descriptor_to_host(desc: torch.Tensor) -> np.ndarray:
    """Start the copy of a descriptor to host memory without waiting.

    A CUDA tensor is copied into pinned memory, non-blocking, and a CUDA
    event is recorded after the copy; the array returned carries it as
    `ready` until `host_descriptor` has waited on it.  A CPU tensor is
    copied at once.
    """
    if desc.device.type != "cuda":
        return desc.detach().clone().numpy()
    buf = torch.empty(desc.shape, dtype=desc.dtype, pin_memory=True)
    buf.copy_(desc, non_blocking=True)
    out = buf.numpy().view(_InFlight)   # the view keeps `buf` alive
    out.ready = torch.cuda.Event()
    out.ready.record()
    return out


def host_descriptor(desc) -> Optional[np.ndarray]:
    """A keyframe's descriptor as a float32 numpy array.  The first read
    of one still in flight waits on its copy's event (that copy and the
    work queued before it), never on later work of the stream."""
    if desc is None:
        return None
    if getattr(desc, "ready", None) is not None:
        desc.ready.synchronize()
        desc.ready = None
    return np.asarray(desc, dtype=np.float32)


class KeyframeRecord(NamedTuple):
    """Host-side record of a promoted keyframe (for the backend)."""

    index: int                  # frame index in the sequence
    timestamp: float
    T_world_kf: np.ndarray      # (4, 4)
    cloud: Optional[PointCloud]  # voxel-downsampled cloud, KF camera frame
    # retained verification table; dropped together with `cloud` by
    # sparsification
    verify: Optional[VerifyTable] = None
    # pose-free descriptor (depth_descriptor) in host memory, kept only
    # with PoseGraphConfig.lc_descriptor and only alongside the cloud; read
    # it through `host_descriptor`
    desc: Optional[np.ndarray] = None


class Odometry:
    """Host-driven frame-to-keyframe visual odometry.

    `device` is where tracking runs; depth given as a host array is copied
    there, depth given as a tensor must already be on it.
    """

    def __init__(self, K: Intrinsics, cfg: SLAMConfig,
                 keep_keyframe_clouds: bool = True, device="cuda"):
        self.K = K
        self.cfg = cfg
        # the concrete device, so that as_depth compares like with like
        self.device = resolve_device(device)
        self.keep_keyframe_clouds = keep_keyframe_clouds
        self.T_world_kf = np.eye(4, dtype=np.float32)
        self.T_kf_cam = torch.eye(4, device=self.device)
        self.last_delta = torch.eye(4, device=self.device)
        self.kf_pyr = None
        self.kf_packed = None             # row-gather tables, built per promote
        self.frame_idx = 0
        self.trajectory: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.keyframes: list[KeyframeRecord] = []
        self.stats: list[dict] = []
        # per-frame (keyframe id, T_kf_cam) so the backend can re-anchor the
        # full trajectory after pose-graph optimization
        self.frame_refs: list[tuple[int, np.ndarray]] = []
        self.last_pyr = None  # most recent preprocessed frame
        # keyframe ids whose clouds must survive sparsification (loop-closure
        # and relocalization anchors), mapped to a recency sequence so the
        # bound evicts the least recently re-confirmed anchor
        self.protected_kf_ids: dict[int, int] = {}
        self._protect_seq = 0

    def as_depth(self, depth) -> torch.Tensor:
        """Depth as a tensor on the odometry's device."""
        if isinstance(depth, torch.Tensor):
            if depth.device != self.device:
                raise ValueError(f"depth is on {depth.device}, odometry runs "
                                 f"on {self.device}")
            return depth
        return torch.as_tensor(np.asarray(depth), device=self.device)

    def protect(self, *ids: int) -> None:
        """Mark keyframes as sparsification-protected, refreshing recency."""
        for k in ids:
            self._protect_seq += 1
            self.protected_kf_ids[k] = self._protect_seq

    def _kf_cloud(self, pyr) -> PointCloud:
        v = self.cfg.voxel
        return _kf_cloud_jit(pyr[0], v.voxel_size, v.capacity, v.origin,
                             v.extent)

    def _promote(self, pyr, timestamp: float) -> None:
        packed = pack_pyramid_jit(pyr, self.cfg)
        cloud = desc = None
        if self.keep_keyframe_clouds:
            cloud = self._kf_cloud(pyr)
            if self.cfg.posegraph.lc_descriptor:
                desc = depth_descriptor(pyr[-1].points, pyr[-1].mask)
        self._promote_from_bundle(pyr, packed, cloud, desc, timestamp)

    def _promote_from_bundle(self, pyr, packed, cloud, desc,
                             timestamp: float) -> None:
        """Promotion bookkeeping from pre-computed derived state (the
        boundary chunk path computes it with `promote_bundle_jit`).  A
        descriptor, given on the device, starts its copy to the host here
        (`descriptor_to_host`): the record never holds a device tensor."""
        self.kf_pyr = pyr
        self.kf_packed = packed
        verify = None
        if self.keep_keyframe_clouds:
            # retain the tracking table at verify_level for the backend's
            # projective verification — already computed, memory only
            lvl = min(int(self.cfg.keyframe.verify_level), len(pyr) - 1)
            h, w, _ = pyr[lvl].points.shape
            verify = VerifyTable(packed=packed[lvl], height=h, width=w,
                                 level=lvl)
            if desc is not None:
                desc = descriptor_to_host(desc)
        else:
            cloud = None
            desc = None
        self.keyframes.append(KeyframeRecord(
            index=self.frame_idx, timestamp=timestamp,
            T_world_kf=self.T_world_kf.copy(), cloud=cloud, verify=verify,
            desc=desc))
        if self.keep_keyframe_clouds:
            self._enforce_cloud_budget()

    def _enforce_cloud_budget(self) -> None:
        """Keyframe sparsification: past `cfg.keyframe.max_keyframes`
        retained clouds, drop the cloud of the most spatially redundant
        keyframe (smallest distance to another retained one).  Protected:
        the newest `sparsify_protect_recent`, id 0, and `protected_kf_ids`.
        Poses always stay."""
        budget = int(self.cfg.keyframe.max_keyframes)
        recent = int(self.cfg.keyframe.sparsify_protect_recent)
        retained = [k for k, r in enumerate(self.keyframes)
                    if r.cloud is not None]
        if len(retained) <= budget:
            return
        protected = set(self.protected_kf_ids)
        protected.add(0)
        if recent > 0:           # -0 would slice the WHOLE list (protect all)
            protected.update(retained[-recent:])
        pos = np.stack([self.keyframes[k].T_world_kf[:3, 3].astype(np.float64)
                        for k in retained])
        while len(retained) > budget:
            d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            nearest = d.min(axis=1)
            drop_at = None
            for idx in np.argsort(nearest):
                if retained[int(idx)] not in protected:
                    drop_at = int(idx)
                    break
            if drop_at is None:
                return  # everything protected — bounded by the protections
            k = retained[drop_at]
            self.keyframes[k] = self.keyframes[k]._replace(
                cloud=None, verify=None, desc=None)
            retained.pop(drop_at)
            pos = np.delete(pos, drop_at, axis=0)

    def process(self, depth, timestamp: float = 0.0) -> np.ndarray:
        """Feed one depth frame (H, W) metres; returns world←cam pose (4, 4)."""
        with profiling.span("odo.process"):
            depth = self.as_depth(depth)
            if self.kf_pyr is None:
                with profiling.span("odo.preprocess", device=depth.is_cuda,
                                    eager=True):
                    pyr = preprocess(depth, self.K, self.cfg)
                self.last_pyr = pyr
                self._promote(pyr, timestamp)
                T_world_cam = self.T_world_kf
                self.stats.append({"iters": 0, "rms": 0.0, "inliers": 1.0,
                                   "promoted": True})
                self.frame_refs.append((len(self.keyframes) - 1, np.eye(4)))
            else:
                pyr, T_new, delta, flat = process_frame_jit(
                    depth, self.kf_packed, self.K, self.T_kf_cam,
                    self.last_delta, self.cfg)
                self.last_pyr = pyr
                with profiling.span("odo.readback", device=depth.is_cuda,
                                    eager=True):
                    s = flat.cpu().numpy()   # the ONE host sync of the frame
                T_rel = s[FlatTrack.T].reshape(4, 4)
                promoted = s[FlatTrack.PROMOTE] > 0.5
                self.last_delta = delta  # device-resident; never read back
                self.T_kf_cam = T_new
                T_world_cam = (self.T_world_kf @ T_rel).astype(np.float32)
                if promoted:
                    self.T_world_kf = T_world_cam
                    self.T_kf_cam = torch.eye(4, device=self.device)
                    profiling.count("odo.promotions")
                    with profiling.span("odo.promote"):
                        self._promote(pyr, timestamp)
                    self.frame_refs.append((len(self.keyframes) - 1,
                                            np.eye(4)))
                else:
                    self.frame_refs.append((len(self.keyframes) - 1, T_rel))
                self.stats.append({
                    "iters": int(s[FlatTrack.ITERS]),
                    "rms": float(s[FlatTrack.RMS]),
                    "inliers": float(s[FlatTrack.INLIER_FRACTION]),
                    "promoted": bool(promoted),
                    "lost": bool(s[FlatTrack.LOST] > 0.5),
                })
            self.trajectory.append(np.asarray(T_world_cam, dtype=np.float64))
            self.timestamps.append(timestamp)
            self.frame_idx += 1
            return self.trajectory[-1]


class ScanState(NamedTuple):
    kf_packed: tuple            # keyframe row-gather tables (per level)
    T_world_kf: torch.Tensor
    T_kf_cam: torch.Tensor
    last_delta: torch.Tensor


def initial_state(depth0: torch.Tensor, K: Intrinsics,
                  cfg: SLAMConfig) -> ScanState:
    """The scan's start: frame 0 is the keyframe, every pose the identity."""
    eye = torch.eye(4, dtype=torch.float32, device=depth0.device)
    kf = pack_pyramid(preprocess(depth0, K, cfg), cfg.icp)
    return ScanState(kf_packed=kf, T_world_kf=eye, T_kf_cam=eye,
                     last_delta=eye)


def scan_step(state: ScanState, depth: torch.Tensor, K: Intrinsics,
              cfg: SLAMConfig):
    """Track one frame with per-frame promotion; returns (new_state,
    T_world_cam, TrackResult), all on the device.  The frame's tables are
    packed every frame and selected by the promote flag on the device."""
    pyr, out, delta = _track(state.kf_packed, depth, K, state.T_kf_cam,
                             state.last_delta, cfg)
    T_world_cam = state.T_world_kf @ out.T_kf_cam
    promote = out.promote
    new_state = ScanState(
        kf_packed=_select(promote, pack_pyramid(pyr, cfg.icp),
                          state.kf_packed),
        T_world_kf=_select(promote, T_world_cam, state.T_world_kf),
        T_kf_cam=_select(promote, _eye(T_world_cam), out.T_kf_cam),
        last_delta=delta,
    )
    return new_state, T_world_cam, out


def _scan_step_row(state: ScanState, depth: torch.Tensor, *, K: Intrinsics,
                   cfg: SLAMConfig):
    """`scan_step` with its outputs packed as one FlatChunk row."""
    new_state, T_world_cam, out = scan_step(state, depth, K, cfg)
    return new_state, torch.cat([T_world_cam.reshape(16).to(torch.float32),
                                 out.T_kf_cam.reshape(16).to(torch.float32),
                                 _track_stats(out)])


# the reference's scan body: one graph a (K, cfg, frame size), one replay a
# frame, the ScanState carried in the graph's buffers
_SCAN_STEP = graphs.Program("scan_step", _scan_step_row)


def scan_odometry(depths: torch.Tensor, K: Intrinsics, cfg: SLAMConfig,
                  state: ScanState | None = None, eager: bool = False):
    """Full-sequence frame-to-keyframe odometry.

    Args:
      depths: (F, H, W) depth frames on the device the scan runs on.
      state: where to start (interop.scan_state_from_numpy); by default
        frame 0 is the keyframe and every frame, frame 0 included, is
        tracked, as in the reference.
      eager: on the card, run the frame step op by op instead of replaying
        its graph.
    Returns:
      poses (F, 4, 4) world←cam, promote flags (F,), inlier fractions (F,),
      on the device, filled without any host synchronisation.
    """
    F = depths.shape[0]
    if state is None:
        state = initial_state(depths[0], K, cfg)
    _, ys = scan_chunk(depths, K, state, cfg, eager)
    return (ys[:, FlatChunk.WORLD_T].reshape(F, 4, 4).contiguous(),
            ys[:, FlatChunk.PROMOTE] > 0.5,
            ys[:, FlatChunk.INLIER_FRACTION].contiguous())


class FlatChunk:
    """Per-frame column layout of `scan_chunk`'s (C, SIZE) readback matrix.
    Index through these names, never literals (FlatTrack/FlatICP differ)."""

    WORLD_T = slice(0, 16)     # T_world_cam, row-major
    REL_T = slice(16, 32)      # T_kf_cam (pre-promotion, vs the frame's kf)
    PROMOTE = 32
    LOST = 33
    ITERS = 34
    RMS = 35
    INLIER_FRACTION = 36
    SIZE = 37


def scan_chunk(depths: torch.Tensor, K: Intrinsics, state: ScanState,
               cfg: SLAMConfig, eager: bool = False):
    """Track a chunk of frames with per-frame promotion (the inline chunk
    mode): keyframe state stays on the device; returns (new_state, ys) with
    ys the (C, FlatChunk.SIZE) matrix the host reads back once.  On the
    card each frame replays the frame step's graph (the one `scan_odometry`
    replays), unless `eager`."""
    ys = torch.empty((depths.shape[0], FlatChunk.SIZE), dtype=torch.float32,
                     device=depths.device)
    with _SCAN_STEP.loop(state, eager=eager, K=K, cfg=cfg) as lp:
        for i in range(depths.shape[0]):
            ys[i].copy_(lp.step(depths[i]))
        return lp.state(), ys


class FrozenState(NamedTuple):
    """Carry of the frozen-keyframe chunk scan — poses only, no tables."""

    T_kf_cam: torch.Tensor      # (4, 4) pose vs the FROZEN keyframe
    last_delta: torch.Tensor    # (4, 4) last inter-frame motion


class FlatFrozen:
    """Per-frame column layout of `scan_superchunk_frozen`'s (N, SIZE)
    readback.  No world pose: the host composes world = T_world_kf · REL_T
    in float64, which keeps the scan output independent of pose
    corrections (what makes the deferred backend deterministic)."""

    REL_T = slice(0, 16)       # T_kf_cam vs the frozen keyframe, row-major
    PROMOTE = 16
    LOST = 17
    ITERS = 18
    RMS = 19
    INLIER_FRACTION = 20
    SIZE = 21


class SuperChunkCarry(NamedTuple):
    """Device-resident carry of `scan_superchunk_frozen` across calls."""

    kf_packed: tuple            # packed tables of the CURRENT keyframe
    T_kf_cam: torch.Tensor      # (4, 4) pose vs that keyframe
    last_delta: torch.Tensor    # (4, 4) last inter-frame motion


def _frozen_sub_chunk(kf_packed: tuple, depths: torch.Tensor, K: Intrinsics,
                      st: FrozenState, cfg: SLAMConfig, rows: torch.Tensor):
    """Track `depths` against a frozen keyframe; each frame's FlatFrozen row
    goes into `rows`.  Returns (end state, the last frame's pyramid)."""
    pyr = None
    for i in range(depths.shape[0]):
        pyr, out, delta = _track(kf_packed, depths[i], K, st.T_kf_cam,
                                 st.last_delta, cfg)
        rows[i] = torch.cat([out.T_kf_cam.reshape(16).to(torch.float32),
                             _track_stats(out)])
        st = FrozenState(T_kf_cam=out.T_kf_cam, last_delta=delta)
    return st, pyr


def _sub_chunk(carry: SuperChunkCarry, depths: torch.Tensor, *,
               K: Intrinsics, cfg: SLAMConfig):
    """One sub-chunk against the frozen keyframe and the promotion select
    at its boundary: (new carry, (sub, FlatFrozen.SIZE) rows)."""
    rows = torch.empty((depths.shape[0], FlatFrozen.SIZE),
                       dtype=torch.float32, device=depths.device)
    st, pyr = _frozen_sub_chunk(
        carry.kf_packed, depths, K,
        FrozenState(T_kf_cam=carry.T_kf_cam, last_delta=carry.last_delta),
        cfg, rows)
    any_p = torch.any(rows[:, FlatFrozen.PROMOTE] > 0.5)
    return SuperChunkCarry(
        kf_packed=_select(any_p, pack_pyramid(pyr, cfg.icp),
                          carry.kf_packed),
        T_kf_cam=_select(any_p, _eye(st.T_kf_cam), st.T_kf_cam),
        last_delta=st.last_delta), rows


# one graph a (K, cfg, sub, frame size): a whole sub-chunk a replay
_SUB_CHUNK = graphs.Program("scan_superchunk_frozen", _sub_chunk)


def scan_superchunk_frozen(depths: torch.Tensor, K: Intrinsics,
                           carry: SuperChunkCarry, cfg: SLAMConfig,
                           sub: int, eager: bool = False):
    """G sub-chunks of `sub` frames with promotion on the device at
    sub-chunk boundaries; the host reads back once per call.  On the card
    each sub-chunk is one replay of a CUDA graph (the carry kept in the
    graph between them), unless `eager`.

    Every emitted pose is relative to the sub-chunk's entry keyframe.  When
    any frame of a sub-chunk flags promotion, its LAST frame becomes the
    keyframe and the carry resets to the exact identity (re-anchoring on a
    mid-chunk frame leaves ~1e-7 of inversion noise that the nearest-pixel
    association amplifies, see the reference).  The last frame's pyramid is
    the one its tracking just built, so the promotion only packs it; the
    select is a `torch.where` on the device.

    Returns (new_carry, ys) with ys of shape (G·sub, FlatFrozen.SIZE).
    """
    n = depths.shape[0]
    if n % sub:
        raise ValueError(f"superchunk length {n} not divisible by {sub}")
    ys = torch.empty((n, FlatFrozen.SIZE), dtype=torch.float32,
                     device=depths.device)
    with _SUB_CHUNK.loop(carry, eager=eager, K=K, cfg=cfg) as lp:
        for g0 in range(0, n, sub):
            ys[g0:g0 + sub].copy_(lp.step(depths[g0:g0 + sub]))
        return lp.state(), ys


def fuse_readbacks_jit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concatenate two device results into one flat float32 vector, so the
    host reads both back in one transfer (the deferred backend's attempt
    rides the next chunk's scan readback)."""
    return torch.cat([a.reshape(-1).to(torch.float32),
                      b.reshape(-1).to(torch.float32)])


class BoundaryState(NamedTuple):
    """Carry of `scan_odometry_boundary_jit` between chunks: the frozen
    keyframe's tables and poses, and the world pose of that keyframe."""

    carry: SuperChunkCarry
    T_world_kf: torch.Tensor    # (4, 4)


def _boundary_chunk(state: BoundaryState, depths: torch.Tensor, *,
                    K: Intrinsics, cfg: SLAMConfig):
    """One chunk of the boundary scan: the sub-chunk against the frozen
    keyframe (`_sub_chunk`), its world poses, and the keyframe's world pose
    moved to the chunk's LAST frame where any frame flags promotion (a
    `torch.where` on the device).  Returns (new state, (rows, world))."""
    carry, rows = _sub_chunk(state.carry, depths, K=K, cfg=cfg)
    world = state.T_world_kf @ rows[:, FlatFrozen.REL_T].reshape(-1, 4, 4)
    any_p = torch.any(rows[:, FlatFrozen.PROMOTE] > 0.5)
    return BoundaryState(carry=carry, T_world_kf=_select(
        any_p, world[-1], state.T_world_kf)), (rows, world)


# the reference's scan_odometry_boundary_jit: one graph a (K, cfg, chunk,
# frame size), one replay a chunk, the BoundaryState carried in the graph
_BOUNDARY_CHUNK = graphs.Program("scan_odometry_boundary_jit",
                                 _boundary_chunk)


def scan_odometry_boundary_jit(depths: torch.Tensor, K: Intrinsics,
                               cfg: SLAMConfig, chunk: int = 8,
                               eager: bool = False):
    """Full-sequence odometry with BOUNDARY keyframe promotion: each chunk
    tracks against a frozen keyframe, and when any frame of the chunk flags
    promotion the chunk's LAST frame becomes the keyframe, its world pose
    the last frame's tracked pose.  On the card each chunk is one replay of
    a CUDA graph, the carry and the keyframe's world pose kept in the graph
    between them, with no host synchronisation, unless `eager`.

    Args:
      depths: (F, H, W) depth on the device, F divisible by `chunk`.
    Returns:
      poses (F, 4, 4) world←cam, promote flags (F,), inlier fractions (F,).
    """
    F = depths.shape[0]
    if F % chunk:
        raise ValueError(f"frames ({F}) must be divisible by chunk ({chunk})")
    with profiling.span("odo.scan", n=F):
        with profiling.span("odo.initial_state", device=depths.is_cuda,
                            eager=True):
            st = initial_state(depths[0], K, cfg)
        state = BoundaryState(
            carry=SuperChunkCarry(kf_packed=st.kf_packed,
                                  T_kf_cam=st.T_kf_cam,
                                  last_delta=st.last_delta),
            T_world_kf=st.T_world_kf)
        ys = torch.empty((F, FlatFrozen.SIZE), dtype=torch.float32,
                         device=depths.device)
        poses = torch.empty((F, 4, 4), dtype=torch.float32,
                            device=depths.device)
        with _BOUNDARY_CHUNK.loop(state, eager=eager, K=K, cfg=cfg) as lp:
            for c0 in range(0, F, chunk):
                rows, world = lp.step(depths[c0:c0 + chunk])
                ys[c0:c0 + chunk].copy_(rows)
                poses[c0:c0 + chunk].copy_(world)
        return (poses, ys[:, FlatFrozen.PROMOTE] > 0.5,
                ys[:, FlatFrozen.INLIER_FRACTION])


def scan_odometry_boundary(depths: torch.Tensor, K: Intrinsics,
                           cfg: SLAMConfig, chunk: int = 8):
    """`scan_odometry_boundary_jit` op by op (the reference's unjitted
    scan)."""
    return scan_odometry_boundary_jit(depths, K, cfg, chunk, eager=True)
