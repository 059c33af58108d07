"""fps: frames whose poses reached the host in the window, over the
window's seconds (session construction and `finalize` inside)."""


def read(ctx):
    return ctx.window["frames"] / ctx.window["seconds"]
