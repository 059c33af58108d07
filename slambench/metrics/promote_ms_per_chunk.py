"""Host wall of keyframe promotion a chunk: the time inside
`slam.promote_bundle` (`frontend.promote_bundle_jit`: the pyramid, packed
tables and voxel cloud of a new keyframe), over all chunks of the
slice."""

from slambench.metrics import _spans


def read(ctx):
    if ctx.slice is None:
        return None
    chunks = ctx.slice.spans_named("bench.process_chunk")
    promos = ctx.slice.spans_named("slam.promote_bundle")
    if not chunks or not promos:
        return None
    return 1e3 * _spans.wall_s(promos) / len(chunks)
