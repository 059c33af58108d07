"""Host self time of `SlamSystem.process_chunk` a chunk: each call's wall
less what its child spans (`slam.scan`, `slam.readback`, `slam.drain`,
`slam.promote_bundle`, `slam.attempt`) cover; the host walk, keyframe
records and graph sync, and the per-frame bootstrap of a session's first
chunk."""

from slambench.metrics import _spans


def read(ctx):
    if ctx.slice is None:
        return None
    chunks = ctx.slice.spans_named("bench.process_chunk")
    if not chunks:
        return None
    kids = ctx.slice.spans_named(*_spans.CHILDREN)
    self_s = sum((e - s) - _spans.covered(s, e, kids)
                 for _n, s, e, _t in chunks)
    return 1e3 * self_s / len(chunks)
