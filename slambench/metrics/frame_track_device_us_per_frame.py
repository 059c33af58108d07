"""Device time of the per-frame tracking a tracked frame, from the slice:
`frontend.process_frame_jit` (preprocessing, the warm start, the ICP
loop) as `SlamSystem.process` runs it.  Each tracked frame's `odo.process`
span holds one `odo.readback`, the sync that waits for the frame's work;
the card is idle when `odo.process` starts (the frame before ended in a
readback or an attempt's drain), so the device operations that start
between its start and its readback's end are the frame's tracking.  A
promotion of the frame before that the card still runs when the next
`odo.process` starts would count here; the host's walk between frames
outlasts it."""

from slambench.metrics import _device


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    ends = sorted(x[2] for x in sl.spans_named("odo.readback"))
    if not ends:
        return None
    device_s = _device.between(sl)
    dev, frames = 0.0, 0
    for _n, s, e, _t in sl.spans_named("odo.process"):
        inside = [t for t in ends if s <= t <= e]
        if inside:
            dev += device_s(s, inside[0])
            frames += 1
    if not frames or dev <= 0:
        return None
    return 1e6 * dev / frames
