"""Device time by host interval, for readers that ask it of many
intervals of one slice."""

import bisect
import itertools


def between(sl):
    """`sl.device_s_between` (the device seconds of the operations that
    started in [lo, hi)), with the slice's starts and durations summed
    once."""
    starts = [o[1] for o in sl.ops]
    total = [0.0] + list(itertools.accumulate(o[2] - o[1] for o in sl.ops))

    def at(lo: float, hi: float) -> float:
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
        return total[j] - total[i] if j > i else 0.0
    return at
