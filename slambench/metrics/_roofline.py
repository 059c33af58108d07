"""A roofline stage's share: its least time at the calls' shapes (counted
from the plain reference's record of what the slice's sessions needed)
over the device time of the stage's kernels in the slice."""

from slambench.core import spec


def share(ctx, stage: str):
    if ctx.slice is None or ctx.work is None or ctx.peaks is None:
        return None
    dev_s, n = ctx.slice.device_s_of(spec.kernels_of(stage))
    if n == 0 or dev_s <= 0:
        return None
    least = spec.module("rooflines", stage).least_seconds(ctx.work,
                                                          ctx.peaks)
    return 100.0 * least / dev_s
