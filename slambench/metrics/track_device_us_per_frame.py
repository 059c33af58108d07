"""Device time of the boundary scan a frame, from the slice.  Each scan
call (`slam.scan` around the SLAM cells' `scan_superchunk_frozen`, or the
benchmark's `bench.scan` around `scan_odometry_boundary_jit`) is followed
by the readback that waits for it (`slam.readback` / `bench.readback`),
and the card is idle when the call starts (the chunk before ended in a
readback): the device operations that start between the call's start and
its readback's end are the scan's.  Over the frames those calls tracked.
"""

PAIRS = (("slam.scan", "slam.readback"), ("bench.scan", "bench.readback"))


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.records:
        return None
    for scan, readback in PAIRS:
        calls = sorted(sl.spans_named(scan), key=lambda x: x[1])
        if calls:
            break
    else:
        return None
    ends = sorted(x[2] for x in sl.spans_named(readback))
    dev = 0.0
    for _n, s, e, _t in calls:
        after = [t for t in ends if t >= e]
        dev += sl.device_s_between(s, after[0] if after else e)
    frames = sum(c[1] for r in sl.records for c in r["chunks"])
    if not frames or dev <= 0:
        return None
    return 1e6 * dev / frames
