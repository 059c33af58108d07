"""tpuslam_torch — the PyTorch / CUDA port of tpuslam for one NVIDIA H100.

A second package beside `tpuslam/` (the JAX reference, which it never
imports).  Module paths mirror the reference's so each counterpart is easy
to find.  It covers frame-to-keyframe odometry (`frontend.scan_odometry`,
`frontend.Odometry`) and the SLAM system (`slam.SlamSystem`: boundary
chunks, deferred loop closure, pose graph, relocalization, frame-to-map
tracking), driven by its command line (`python -m tpuslam_torch.cli`) over
TUM sequences on disk (`data/tum.py`), with checkpoints either package
reads (`utils/checkpoint.py`).  The
association gather, the GN reduction, the GN epilogue and the fused GN
step are hand-written CUDA kernels (`csrc/*.cu`, built at first use by
`kernels/_build.py`).  On CPU tensors every kernel wrapper runs its plain
PyTorch twin instead.
"""

__version__ = "0.1.0"

import torch as _torch

# Numeric policy of the reference (tpuslam/__init__.py forces fp32
# "highest"): SE(3) products and the GN normal equations are metric to the
# millimetre, so TF32 is off for matmuls and convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from tpuslam_torch.config import (  # noqa: E402,F401
    Intrinsics,
    ICPConfig,
    VoxelConfig,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
)
