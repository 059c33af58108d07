"""Host → device copies that do not wait for the device.

A plain CPU→CUDA copy from pageable memory synchronises with the device's
queue before it returns, which would cost the host loop a full drain each
time it hands the device a small array (a pose, a graph snapshot, the
candidates of a loop-closure attempt).  Staging the array in pinned memory
makes the copy asynchronous on the current stream; PyTorch's caching host
allocator keeps the pinned buffer alive until the copy has run.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The concrete device an entry point runs on ("cuda" becomes
    "cuda:<current>").  Raises when a CUDA device is asked for and there is
    none: the entry points default to the card, and a run that silently
    fell back to the CPU twins would measure the wrong thing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device here (pass device='cpu' "
                f"to run on the plain PyTorch twins)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(array, device) -> torch.Tensor:
    """A copy of a host array (numpy or nested lists) on `device`.

    The copy is the caller's own: later changes to `array` do not reach it.
    """
    t = torch.from_numpy(np.array(array, copy=True, order="C"))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
