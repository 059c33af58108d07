"""Tracing and device memory — port of `tpuslam/utils/profiling.py`.

`trace` records a `torch.profiler` trace of the host and, where the device
is a GPU, of its kernels, and exports it as a Chrome trace (viewable in
Perfetto or chrome://tracing).  The pipeline's host stages are named
ranges (`scope`, as `slam.py`'s spans), which the trace shows around the
kernels they issue.
"""

from __future__ import annotations

import contextlib
import os

import torch

# named range in a torch.profiler trace (the reference's jax.named_scope)
scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(out_dir: str):
    """Capture a trace of the enclosed work into `out_dir/trace.json`.

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
