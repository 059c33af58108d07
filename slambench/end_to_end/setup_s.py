"""setup_s: from the process's start to the window's first hand-over:
imports, the CUDA context, the kernels' library, rendering the session
pool and warming every program the window replays.  The harness's wait
for the card's faster state of graph replays is left out (it is the
machine's, and is logged apart as `graph_state_s`) unless the port met or
captured a program during it."""


def read(ctx):
    return ctx.setup_s
