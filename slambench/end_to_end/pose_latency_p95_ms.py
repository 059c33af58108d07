"""pose_latency_p95_ms: the 95th percentile, over every hand-over in the
window, of the time from handing a chunk to the port to its poses on the
host."""

import numpy as np


def read(ctx):
    lat = ctx.window["latencies"]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
