"""Host self time of `SlamSystem.process` a frame: each `slam.process`
span's wall less what `odo.readback`, `odo.promote` and
`slam.frame_attempt` cover; the frame's replay dispatch, the host walk,
its records and the graph sync, over all frames of the slice."""

from slambench.metrics import _spans

CHILDREN = ("odo.readback", "odo.promote", "slam.frame_attempt")


def read(ctx):
    if ctx.slice is None:
        return None
    frames = ctx.slice.spans_named("slam.process")
    if not frames:
        return None
    kids = ctx.slice.spans_named(*CHILDREN)
    self_s = sum((e - s) - _spans.covered(s, e, kids)
                 for _n, s, e, _t in frames)
    return 1e6 * self_s / len(frames)
