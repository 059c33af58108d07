"""Hand-kernel launches of the ICP loop a frame: the port's
`LaunchCounter`s of `correspond`, `gn_step` and `gn_fused` (graph replays
counted by what each graph recorded) over the whole window, over the
window's frames.  Verification solves count too."""

KERNELS = ("correspond", "gn_step", "gn_fused")


def read(ctx):
    frames = ctx.window["frames"]
    n = sum(ctx.launches.get(k, 0) for k in KERNELS)
    if not frames or not n:
        return None
    return n / frames
