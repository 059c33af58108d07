"""Device time of a per-frame promotion (`Odometry._promote`:
`pack_pyramid_jit`'s tables and `_kf_cloud_jit`'s voxel cloud), from the
slice.  The card is idle when `odo.promote` starts (the frame's readback
came just before); the device operations that start from its start until
the host opens the next span that issues device work (`slam.frame_attempt`,
`slam.process` or `odo.process`) are the promotion's.  Work of the
promotion that the card starts only after the host has moved on is
counted with what follows, so this is a lower bound where the card
lags.  Over the slice's promotions."""

from slambench.metrics import _device

NEXT = ("slam.frame_attempt", "slam.process", "odo.process")


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    promos = sl.spans_named("odo.promote")
    if not promos:
        return None
    starts = sorted(x[1] for x in sl.spans_named(*NEXT))
    device_s = _device.between(sl)
    dev = 0.0
    for _n, s, e, _t in promos:
        after = [t for t in starts if t >= e]
        dev += device_s(s, after[0] if after else sl.wall_s)
    if dev <= 0:
        return None
    return 1e6 * dev / len(promos)
