"""Host wall of the loop-closure attempt a chunk: the time inside
`slam.attempt` (proposal and the fused verify + pose-graph program's
dispatch) and `slam.drain` (its readback, gates and commit), over all
chunks of the slice."""

from slambench.metrics import _spans


def read(ctx):
    if ctx.slice is None:
        return None
    chunks = ctx.slice.spans_named("bench.process_chunk")
    if not chunks:
        return None
    spent = _spans.wall_s(ctx.slice.spans_named("slam.attempt", "slam.drain"))
    return 1e3 * spent / len(chunks)
