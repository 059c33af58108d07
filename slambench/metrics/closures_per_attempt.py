"""Useful outcomes over attempts of the loop-closure layer: the closures
the slice's sessions accepted (`SlamSystem.closures`) over the
`slam.attempt` spans they opened."""


def read(ctx):
    if ctx.slice is None or not ctx.slice.records:
        return None
    attempts = len(ctx.slice.spans_named("slam.attempt"))
    if attempts == 0:
        return None
    return sum(len(r["closures"]) for r in ctx.slice.records) / attempts
