"""Config / flag system (verbatim copy of `tpuslam/config.py`).

The dataclasses import nothing of JAX, so the port carries the same tree
field for field; `tests/test_torch_config.py` holds the two copies equal.

Reference status: argv + hard-coded constants in a C++ prototype (SURVEY.md §5
"Config / flag system"; reference mount empty — provenance [PK]).  Here: one
frozen-dataclass config tree.  Everything that changes *shapes or loop bounds*
(capacities, pyramid levels, iteration caps) is a static Python int so the
configs can be closed over / passed as static jit arguments; runtime scalars
(tolerances, Huber delta) stay floats and are baked as compile-time constants
when closed over.

Camera intrinsics are a NamedTuple pytree so they can be traced (they vary per
dataset, not per frame).
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple


class Intrinsics(NamedTuple):
    """Pinhole camera intrinsics. A pytree (traced under jit).

    TUM Freiburg defaults are provided by the classmethods; the reference
    consumes TUM RGB-D sequences (SURVEY.md §2a R1: fx≈525, cx≈319.5 for fr1).
    """

    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def tum_fr1(cls) -> "Intrinsics":
        return cls(517.3, 516.5, 318.6, 255.3)

    @classmethod
    def tum_fr2(cls) -> "Intrinsics":
        return cls(520.9, 521.0, 325.1, 249.7)

    @classmethod
    def tum_fr3(cls) -> "Intrinsics":
        return cls(535.4, 539.2, 320.1, 247.6)

    @classmethod
    def tum_default(cls) -> "Intrinsics":
        """ROS default used by TUM tools when sequence is unknown."""
        return cls(525.0, 525.0, 319.5, 239.5)

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics after downsampling the image by `factor` (e.g. 0.5).

        Follows the convention that pixel (u, v) maps to ((u+0.5)*f - 0.5)
        continuous coordinates; for factor = 1/2**k this is the standard
        pyramid intrinsics update.
        """
        return Intrinsics(
            self.fx * factor,
            self.fy * factor,
            (self.cx + 0.5) * factor - 0.5,
            (self.cy + 0.5) * factor - 0.5,
        )


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP solver parameters (SURVEY.md §2a R7)."""

    max_iters: int = 30                  # per pyramid level
    # Early-exit when the twist step ||δ|| falls below this (0.1 mm / 0.1
    # mrad — the f32 noise floor; tighter just burns iterations).
    tol_delta: float = 1e-4
    # Optional per-pyramid-level override, index 0 = FINEST.  Coarse levels
    # only need to land inside the next-finer level's convergence basin, so
    # a looser coarse tol is safe — but measure before using: at 640×480
    # defaults (1e-4, 1e-3, 2e-3) was throughput-neutral (coarse levels
    # already early-exit) and (1e-4, 2e-3, 5e-3) was 6% SLOWER end to end
    # (sloppier warm starts push iterations onto the expensive finest
    # level).  Synthetic-loop ATE unchanged in both cases.
    tol_delta_per_level: tuple | None = None
    huber_delta: float = 0.05            # m — robust weight knee
    max_corr_dist: float = 0.25          # m — reject correspondences beyond
    normal_dot_min: float = 0.5          # reject if normals disagree (cosine)
    damping: float = 1e-6                # Levenberg multiplicative diag damping
    # Absolute damping, scaled by trace(H)/6: pins near-unobservable DoF
    # (e.g. roll against a dominant plane) instead of letting GN launch huge
    # steps along them.  Trust-region clamps bound any single update.
    damping_abs: float = 1e-4
    max_rot_step: float = 0.3            # rad per GN step
    max_trans_step: float = 0.3          # m per GN step
    pyramid_levels: int = 3              # coarse-to-fine image pyramid
    iters_per_level: tuple = (12, 8, 8)  # index 0 = FINEST level
    depth_min: float = 0.1               # m — valid depth range
    depth_max: float = 5.0
    # GN steps solved per correspondence gather.  The projective row gather
    # dominates the iteration (measured 1.1 of 1.3 ms at 640x480); between
    # gathers the association barely changes, so re-solving the same
    # linearization with re-transformed points (classic inner/outer ICP)
    # buys extra convergence nearly free.  `iters_per_level` still counts GN
    # steps, so the step budget is unchanged — only the gather count drops.
    # 2 measured 0.58 ms/GN-step vs 1.31 at 1 (640×480 finest level), with
    # the converged pose within 6e-5 of re-associating every step.  3 is
    # cheaper per step (0.44) but loses at the frame level: the early-exit
    # can only fire between gathers, so near convergence the extra forced
    # inner solves are pure waste (measured 206 vs 219 fps).
    inner_steps: int = 2
    # Optional per-level override of `inner_steps`, index 0 = FINEST (same
    # convention as iters_per_level).  Coarse levels are latency-bound (the
    # small gathers cost a near-constant ~85 µs regardless of point count)
    # and never early-exit mid-gather-group, so packing MORE GN solves per
    # gather there is nearly free while the finest level stays at 2 (its
    # early-exit granularity matters — see inner_steps note above).
    inner_steps_per_level: tuple | None = None
    # Storage dtype of the packed projective-association table.  The TPU
    # gather engine moves 16-byte rows ~2.3x faster than 32-byte rows, and
    # float16's 10-bit mantissa keeps the converged pose within 6e-5 of the
    # float32 table (bfloat16's 8 bits cost 8e-4 — not worth it).  All math
    # stays float32; only the gathered target rows are stored quantized.
    packed_dtype: str = "float16"
    # SOURCE-point decimation at the FINEST pyramid level: keep 1/k of the
    # source pixels (1 = all, 2 = every other ROW — contiguous row slices
    # keep the gather's spatial locality; a checkerboard was measured 35%
    # slower — 4 = use the next-coarser pyramid frame as the source, i.e. a
    # stride-2 grid without the relayout-bound (H, W, 3) strided slice).
    # 4 is +11% fps over 2 at 640×480 (438 vs 394) with synthetic-orbit ATE
    # still at the noise floor (0.046 vs 0.031 mm), but degrades sharply at
    # LOW resolutions (7.4 mm vs 0.14 mm on the 120×160 loop — too few
    # residuals) — opt in for VGA+, never for small frames.
    # The association gather is ~85% of an iteration and is O(source
    # points), so k=2 nearly halves the finest-level cost; the TARGET table
    # stays full resolution, so association precision is unchanged — only
    # the (massively overdetermined) residual set shrinks.  The 6-DoF GN
    # system remains conditioned with >100k correspondences at 640×480/k=2.
    # Default 2: measured 246 vs 216 fps at 640×480 full tracking with the
    # synthetic-loop ATE unchanged at the noise floor (1.3e-4 vs 1.0e-4 m).
    finest_subsample: int = 2
    # Optional per-level source decimation override, index 0 = FINEST (same
    # convention as iters_per_level); each entry ∈ {1, 2, 4} as in
    # finest_subsample.  The middle pyramid level runs several gather-groups
    # per frame at FULL source density by default — decimating it trades
    # residual count (hugely overdetermined) for gather rows exactly like
    # the finest level does.  None → (finest_subsample, 1, 1, ...).
    level_subsample: tuple | None = None
    # Fully-fused projective GN step (kernels/gn_fused.py): transform,
    # projection/normal gates, Huber and the JJᵀ reduction in ONE Pallas
    # VMEM pass per GN solve.  The kernel itself is 14× faster than the
    # unfused reduce (8.7 µs vs 0.12 ms at 153k points, measured round 4)
    # — but OFF by default: its per-component plane prep costs ~0.5 ms of
    # lane-deinterleave relayouts per iteration AND evicts the f16 packed
    # table from VMEM, where XLA's allocator pins it on the legacy path
    # (a VMEM-resident table gathers at 0.29 ms vs 1.70 ms from HBM —
    # BASELINE.md round-4 roofline).  Net: 1.28 vs 0.34 ms/GN-step.  Keep
    # False unless the target generation grows VMEM or Mosaic gains f16
    # refs + cheap lane deinterleave; the kernel + oracle stay tested as
    # the design is environment-bound, not wrong.  Projective-packed
    # targets only — grid-hash and brute-force always use the legacy
    # chain.
    fused_gn: bool = False


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Voxel-grid downsample + map parameters (SURVEY.md §2a R4, R10)."""

    voxel_size: float = 0.02             # m (downsample)
    map_voxel_size: float = 0.02         # m (global map)
    capacity: int = 1 << 14              # max points kept by a downsample
    map_capacity: int = 1 << 17          # max points in the live voxel map
    origin: float = -20.0                # m — world AABB min corner (all axes)
    extent: float = 40.0                 # m — world AABB edge length


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe promotion thresholds (SURVEY.md §2a R9)."""

    max_translation: float = 0.15        # m relative to current keyframe
    max_rotation: float = 0.30           # rad
    min_inlier_fraction: float = 0.40    # re-anchor when overlap drops
    # Tracking is declared LOST (pose rejected, relocalization armed) when
    # the inlier fraction falls below this.  Lower it for sparse-depth
    # sequences where even healthy frames match few pixels.
    lost_inlier_fraction: float = 0.10
    # Keyframe-cloud retention budget.  Keyframe POSES are cheap (16 floats
    # — the pose graph grows without bound, see PoseGraphConfig) but each
    # stored CLOUD is ~0.5 MB, so past this budget the most spatially
    # redundant stored cloud is dropped (greedy min-nearest-neighbor-
    # distance sparsification; loop-closure/reloc anchor keyframes and the
    # most recent `sparsify_protect_recent` are never dropped).  Memory is
    # thus bounded on arbitrarily long sequences while loop closure keeps a
    # spatially diverse cloud cover.
    max_keyframes: int = 256
    sparsify_protect_recent: int = 8     # newest keyframes never sparsified
    # Pyramid level of the packed row-gather table each keyframe retains
    # for PROJECTIVE loop-closure/relocalization verification (0 = finest).
    # The table is a byproduct of tracking (pack_pyramid at promotion) —
    # retaining level 1 costs h·w/4 · 16 B (~1.2 MB at VGA) and makes a
    # verification ~400× lighter on gather traffic than the grid-hash
    # probe (see BASELINE.md roofline: the gather is issue-rate-bound).
    verify_level: int = 1


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Pose-graph backend parameters (SURVEY.md §2a R11, R12)."""

    # INITIAL graph capacities — GraphHost doubles its storage when full
    # (amortized growth; each doubling costs one solver recompile), so
    # trajectories are unbounded.  These only set the starting padding.
    max_nodes: int = 256
    max_edges: int = 1024
    gn_iters: int = 20
    damping: float = 1e-4
    # GN inner solver: "dense" Cholesky on the (6N, 6N) system (fastest for
    # N ≤ a few hundred), "cg" — matrix-free block-Jacobi-preconditioned
    # conjugate gradient over the edge blocks (O(E)/iteration, no (6N)²
    # materialization; use for long trajectories), or "auto" — dense up to
    # `dense_max_nodes` of graph capacity, CG beyond.
    solver: str = "auto"
    dense_max_nodes: int = 256
    cg_iters: int = 128
    cg_tol: float = 1e-6
    rot_weight: float = 100.0            # information weight on rotation part
    trans_weight: float = 100.0
    # loop closure proposal
    lc_max_dist: float = 0.7             # m — candidate proximity radius
    lc_min_gap: int = 20                 # keyframe-index separation
    lc_max_residual: float = 0.05        # m — accept closure if ICP rms below
    lc_min_inliers: float = 0.5
    # Observability gate: smallest eigenvalue of the per-inlier normal
    # coverage matrix (Σw·nnᵀ)/Σw must exceed this, else the alignment can
    # slide along dominant planes with near-zero point-to-plane residual and
    # the "closure" just re-encodes drift.
    lc_min_normal_coverage: float = 0.03
    # Pose-FREE loop-closure candidates from per-keyframe depth descriptors
    # (frontend.depth_descriptor): proximity proposal alone is drift-
    # bounded — a revisit whose accumulated drift exceeds lc_max_dist is
    # never proposed.  Descriptor pairs enter the SAME gated verification
    # batch with an IDENTITY initial guess (a descriptor match implies a
    # similar viewpoint, which is the projective-ICP convergence basin).
    # Off by default: zero cost when disabled.
    lc_descriptor: bool = False
    # Max relative block-depth difference for a descriptor candidate
    # (propose_descriptor_candidates: weighted |Δz|/(z₁+z₂) over mutually
    # valid blocks ∈ [0, ~2]); 0.10 ≈ "same structure within 10%".
    lc_desc_max_dist: float = 0.10
    lc_desc_candidates: int = 2          # per verification pass


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Top-level system config."""

    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    voxel: VoxelConfig = dataclasses.field(default_factory=VoxelConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    posegraph: PoseGraphConfig = dataclasses.field(default_factory=PoseGraphConfig)
    height: int = 480
    width: int = 640
    depth_scale: float = 5000.0          # TUM 16-bit PNG scale (SURVEY §2a R1)
    # Constant-velocity warm-start damping γ ∈ [0,1]: T0 extrapolates only
    # γ·(last inter-frame twist).  Full extrapolation (γ=1) is UNSTABLE with
    # nearest-pixel association: its sub-pixel deadband lets ICP confirm the
    # extrapolated pose instead of correcting it, and the velocity estimate
    # then amplifies its own error exponentially (diagnosed on the synthetic
    # loop: γ=1 diverges to metres, γ≤0.5 tracks exactly).
    cv_damping: float = 0.5
    use_pallas: bool = True              # Pallas kernels vs pure-jnp oracle
    # Minimum ABSOLUTE matched-point count for a frame-to-map refinement to
    # be accepted (on top of the 0.3 inlier-fraction gate).  Scale it with
    # frame resolution / map density: 300 suits VGA frames with the default
    # map capacity; small frames or sparse maps need less or refinement
    # silently never fires.
    map_refine_min_inliers: int = 300
    dtype: str = "float32"

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "SLAMConfig":
        """Raise ValueError with a clear message for config mistakes that
        would otherwise surface as cryptic trace-time shape errors deep in
        jit (static-shape discipline: capacities and level tuples ARE the
        compiled program).  Returns self for chaining."""
        icp = self.icp
        errs = []
        if icp.pyramid_levels < 1:
            errs.append("icp.pyramid_levels must be ≥ 1")
        if len(icp.iters_per_level) < icp.pyramid_levels:
            errs.append(
                f"icp.iters_per_level has {len(icp.iters_per_level)} entries "
                f"for {icp.pyramid_levels} pyramid levels (index 0 = finest)")
        for name in ("tol_delta_per_level", "inner_steps_per_level",
                     "level_subsample"):
            v = getattr(icp, name)
            if v is not None and len(v) > icp.pyramid_levels:
                errs.append(f"icp.{name} has more entries than pyramid levels")
        if icp.finest_subsample not in (1, 2, 4):
            errs.append("icp.finest_subsample must be 1, 2 or 4")
        if icp.level_subsample is not None and any(
                f not in (1, 2, 4) for f in icp.level_subsample):
            errs.append("icp.level_subsample entries must be 1, 2 or 4")
        if self.posegraph.solver not in ("auto", "dense", "cg"):
            errs.append("posegraph.solver must be 'auto', 'dense' or 'cg'")
        for name, v in (("voxel.capacity", self.voxel.capacity),
                        ("voxel.map_capacity", self.voxel.map_capacity),
                        ("posegraph.max_nodes", self.posegraph.max_nodes),
                        ("posegraph.max_edges", self.posegraph.max_edges),
                        ("keyframe.max_keyframes",
                         self.keyframe.max_keyframes)):
            if v < 1:
                errs.append(f"{name} must be ≥ 1")
        if self.keyframe.sparsify_protect_recent < 1:
            errs.append("keyframe.sparsify_protect_recent must be ≥ 1 (the "
                        "active tracking keyframe must keep its cloud)")
        if (self.height >> (icp.pyramid_levels - 1)) < 8 or (
                self.width >> (icp.pyramid_levels - 1)) < 8:
            errs.append(
                f"{icp.pyramid_levels} pyramid levels on a {self.height}×"
                f"{self.width} frame leaves the coarsest level under 8 px")
        if self.depth_scale <= 0:
            errs.append("depth_scale must be > 0")
        if not 0.0 <= self.cv_damping <= 0.5:
            errs.append("cv_damping must be in [0, 0.5] — full constant-"
                        "velocity extrapolation feedback-diverges with "
                        "nearest-pixel association (see field comment)")
        if errs:
            raise ValueError("invalid SLAMConfig:\n  - " + "\n  - ".join(errs))
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SLAMConfig":
        raw = json.loads(text)
        sub = {
            "icp": ICPConfig,
            "voxel": VoxelConfig,
            "keyframe": KeyframeConfig,
            "posegraph": PoseGraphConfig,
        }
        top_fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in raw.items():
            if k not in top_fields:
                # same cross-version tolerance as nested fields below
                import sys
                print(f"config: ignoring unknown field {k}", file=sys.stderr)
                continue
            if k in sub and isinstance(v, dict):
                # JSON has no tuples; per-level knobs must be hashable
                # (configs are static jit args).  Unknown keys are dropped
                # with a warning so configs written by other versions load.
                fields = {f.name for f in dataclasses.fields(sub[k])}
                v2 = {}
                for k2, raw_v in v.items():
                    if k2 not in fields:
                        import sys
                        print(f"config: ignoring unknown field {k}.{k2}",
                              file=sys.stderr)
                        continue
                    v2[k2] = tuple(raw_v) if isinstance(raw_v, list) else raw_v
                kw[k] = sub[k](**v2)
            else:
                kw[k] = v
        return cls(**kw)
