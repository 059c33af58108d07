"""The readings that the limits of `correct` are set from, for one cell
on many seeds in one process: on each seed the cell's pool is rendered,
the check's sample of sessions is drawn as a run draws it, each sampled
session goes through the port three times (its programs' warm-up,
capture, replay: the third is what a timed window produces), and is run
again by the plain reference in float32 and, as the control, with TF32
matmuls (the nearest precision below the configuration's float32).

    python3 slambench/tools/readings.py --workload slam-loop-vga \
        --seeds 101 102 103 [--out readings.jsonl]

Prints one JSON line a seed: the program's numbers and the control's,
each against the float32 reference, beside the entry's limits.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))


def sample(seed: int, pool: int, n: int) -> list:
    import numpy as np

    rng = np.random.default_rng([seed, 1])
    return sorted(int(i) for i in rng.choice(pool, min(n, pool),
                                             replace=False))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    import tpuslam_torch  # noqa: F401
    from slambench.core import spec
    from slambench.inputs.scene import render_pool

    bench = spec.benchmark()
    cell = spec.workload(bench, a.workload)
    config = spec.config_of(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    mod = spec.module("entries", config["entry"])
    out = open(a.out, "a") if a.out else None
    for seed in a.seeds:
        t0 = time.perf_counter()
        pool = render_pool(traffic, config["sensor"]["height"],
                           config["sensor"]["width"], seed, dev)
        entry = mod.Entry(config, pool, dev)
        line = {"workload": a.workload, "seed": seed, "limits": mod.LIMITS,
                "program": {}, "control": {}}
        for s in sample(seed, pool["depth"].shape[0], mod.CHECK_SESSIONS):
            for _ in range(3):
                rec = [ev[1] for ev in entry.session(s) if ev[0] == "done"][0]
            torch.backends.cuda.matmul.allow_tf32 = False
            ref = entry.reference(s)
            line["program"][s] = entry.compare(rec, ref)
            if not a.no_control:
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ctl = entry.reference(s)
                    line["control"][s] = entry.compare(ctl, ref)
                except Exception as e:   # noqa: BLE001 — a failed control
                    line["control"][s] = f"{type(e).__name__}: {e}"
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
