"""Host wall of a loop-closure attempt on the per-frame path: the time
inside `slam.frame_attempt` (proposal, the fused verify + pose-graph
program's dispatch, its readback, gates and commit, one sync), over the
attempts of the slice, those that found no candidate included."""

from slambench.metrics import _spans


def read(ctx):
    if ctx.slice is None:
        return None
    attempts = ctx.slice.spans_named("slam.frame_attempt")
    if not attempts:
        return None
    return 1e3 * _spans.wall_s(attempts) / len(attempts)
