"""The control of `correct` on the card: the plain reference computed
with TF32 matmuls (the nearest precision below the configurations'
float32) in the port's place fails the entry's limits, while the port's
replayed path passes them.  At the cells' 640×480 widths on short
sessions; `slambench/tools/readings.py` reads the same at full length on
many seeds.  Skips without a card:

    python -m pytest slambench/tests/test_slambench_control.py -m cuda
"""

import pytest
import torch

from slambench.core import spec
from slambench.inputs.scene import render_pool

FRAMES = 24


def _short(cell_name: str) -> tuple:
    bench = spec.benchmark()
    cell = spec.workload(bench, cell_name)
    config = spec.config_of(bench, cell["config"])
    traffic = dict(spec.traffic(cell["traffic"]))
    if traffic["trajectory"] == "loop":     # the cell's motion a frame
        traffic["params"] = dict(traffic["params"], cycles=(
            traffic["params"]["cycles"] * FRAMES / traffic["frames"]))
    traffic.update(frames=FRAMES, pool=1)
    return config, traffic


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["slam-loop-vga", "odom-orbit-vga"])
def test_the_tf32_control_fails_and_the_port_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import tpuslam_torch  # noqa: F401  (the port's numeric policy)

    config, traffic = _short(cell)
    dev = torch.device("cuda", 0)
    pool = render_pool(traffic, config["sensor"]["height"],
                       config["sensor"]["width"], 2 ** 31 + 5, dev)
    mod = spec.module("entries", config["entry"])
    entry = mod.Entry(config, pool, dev)
    for _ in range(3):              # warm-up, capture, replay
        rec = [ev[1] for ev in entry.session(0) if ev[0] == "done"][0]
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = entry.reference(0)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ctl = entry.reference(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    sound = entry.compare(rec, ref)
    control = entry.compare(ctl, ref)
    assert all(sound[k] <= mod.LIMITS[k] for k in mod.LIMITS), sound
    assert any(control[k] > mod.LIMITS[k] for k in mod.LIMITS), control
