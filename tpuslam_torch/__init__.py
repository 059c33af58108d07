"""tpuslam_torch — the PyTorch / CUDA port of tpuslam for one NVIDIA H100.

A second package beside `tpuslam/` (the JAX reference, which it never
imports).  Module paths mirror the reference's so each counterpart is easy
to find.  The first slice is frame-to-keyframe odometry over a full
sequence (`frontend.scan_odometry`), with the association gather, the GN
reduction and the GN epilogue as hand-written CUDA kernels
(`csrc/*.cu`, built at first use by `kernels/_build.py`).  On CPU tensors
every kernel wrapper runs its plain PyTorch twin instead.
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
