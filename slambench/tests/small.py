"""A cell cut to a size the CPU runs in seconds: 120×160 frames, the
keyframe and closure gates of the port's 48-frame CPU tests, short
sessions and a pool of two.  On the CPU the port runs its plain twins."""

import copy

from slambench.core import spec


def small_cell(name: str, frames: int = 24) -> tuple:
    """(bench, cell, config, traffic) of `name` at the small size."""
    bench = spec.benchmark()
    cell = spec.workload(bench, name)
    config = copy.deepcopy(spec.config_of(bench, cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["sensor"].update(height=120, width=160)
    tree = config["slam_config"]
    tree.update(height=120, width=160)
    tree["keyframe"].update(max_translation=0.08, max_rotation=0.12)
    tree["posegraph"].update(max_nodes=64, max_edges=256, lc_min_gap=3,
                             lc_max_dist=0.6, lc_min_inliers=0.3)
    tree["voxel"].update(capacity=1 << 13)
    traffic.update(frames=frames, pool=2)
    if traffic["trajectory"] == "loop":
        traffic["params"]["cycles"] = 1
    return bench, cell, config, traffic


RUN = r"""
import sys, time
T0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from slambench.core import harness
from slambench.tests.small import small_cell
{prelude}
bench, cell, config, traffic = small_cell({cell!r}, frames={frames})
rc = harness.execute(bench, cell, config, traffic, {seed}, {seconds}, {traced},
                     torch.device("cpu"), T0)
print("TOPS", ",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


def run_small(cell: str, frames: int = 16, seed: int = 7,
              seconds: float = 2.5, traced: bool = False,
              prelude: str = "") -> tuple:
    """One run of a small cell on the CPU in a fresh interpreter, with
    `prelude` run first (a fault planted under the timed path): (exit
    code, the result line, standard error, the loaded top-level
    modules)."""
    import json
    import subprocess
    import sys

    code = RUN.format(root=str(spec.ROOT), cell=cell, frames=frames,
                      seed=seed, seconds=seconds, traced=traced,
                      prelude=prelude)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=spec.ROOT)
    lines = p.stdout.strip().splitlines()
    tops = set(lines[-1].split("TOPS ")[1].split(",")) if lines and \
        lines[-1].startswith("TOPS ") else set()
    results = [ln for ln in lines if ln.startswith("{")]
    return (p.returncode, json.loads(results[-1]) if results else None,
            p.stderr, tops)
