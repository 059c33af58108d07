"""peak_mem_mib: the CUDA allocator's peak over the warm-up and the
window, less the benchmark's own input pool: what the port holds (graph
pools, pyramids, keyframe tables, the pose graph).  None off the card."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return (ctx.peak_bytes - ctx.pool_bytes) / 2 ** 20
