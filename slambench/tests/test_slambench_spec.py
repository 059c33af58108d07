"""The benchmark's data is found by name, a new metric is a new file,
the result line has the contract's shape, and the roofline counts are
the stated ones."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from slambench.core import harness, spec
from slambench.tests.small import run_small

torch.set_num_threads(1)
BENCH = spec.benchmark()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_is_found_by_name(cfg):
    data = spec.config_of(BENCH, cfg["name"])
    assert data["name"] == cfg["name"]
    assert cfg["file"].startswith("slambench/configs/")
    assert set(cfg["reduced"]) <= set(data["reduced"])
    assert (spec.HERE / "entries" / f"{data['entry']}.py").is_file()
    assert data["slam_config"]["height"] == data["sensor"]["height"]
    assert data["slam_config"]["width"] == data["sensor"]["width"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_mix_is_found_by_name(cell):
    mix = spec.traffic(cell["traffic"])
    assert mix["name"] == cell["traffic"]
    assert mix["trajectory"] in ("loop", "orbit")
    assert cell["chips"] == 1


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_file_has_a_reader(m):
    assert callable(spec.module("metrics", m["name"]).read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_each_end_to_end_metric_has_a_reader(m):
    assert callable(spec.module("end_to_end", m["name"]).read)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(BENCH, cell["name"],
                                                   False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(BENCH, cell["name"], True)


def test_a_metric_added_as_a_file_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "frames_per_session", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "SLAM host loop",
        "moves": "fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "slambench" / "metrics" / "frames_per_session.py").write_text(
        "def read(ctx):\n"
        "    return ctx.window['frames'] / max(len(ctx.sessions), 1)\n")
    loaded = spec.benchmark(root)
    ctx = SimpleNamespace(window={"frames": 480, "seconds": 1.0},
                          sessions=[{}, {}], slice=None, work=None,
                          launches={}, peaks=None)
    got = harness.collect_metrics(loaded, "odom-orbit-vga", True, ctx,
                                  here=root / "slambench")
    assert got["frames_per_session"] == {"value": 240.0, "unit": "frames"}
    assert "frames_per_session" not in harness.collect_metrics(
        BENCH, "odom-orbit-vga", True, ctx)


def test_the_last_line_has_the_contract_shape():
    rc, line, err, _ = run_small("odom-orbit-vga", seed=2 ** 31 + 12345)
    assert rc == 0, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0, err[-3000:]
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    assert {"fps", "setup_s"} <= set(line["metrics"])
    for name, c in line["compared"].items():
        assert set(c) == {"value", "limit"}
        assert f"[compared] {name} " in err
    assert err.rstrip().splitlines()[-1].startswith("[compared]")


def test_roofline_counts_at_known_shapes():
    assoc = spec.module("rooflines", "association")
    gn = spec.module("rooflines", "gn_solve")
    # level 0 of a 640x480 frame, every other row: 153,600 rows
    assert assoc.call(153600, 100000) == (5 * 153600 + 64 * 100000 + 64,
                                          50 * 100000)
    assert gn.call(153600, 90000) == (4 * 153600 + 36 * 90000 + 512,
                                      100 * 90000 + 600)
    peaks = spec.peaks("NVIDIA H100 80GB HBM3")
    work = SimpleNamespace(assoc=[(153600, 100000)] * 2, gn=[(19200, 0)])
    b, _ = assoc.call(153600, 100000)
    assert assoc.least_seconds(work, peaks) == pytest.approx(
        2 * b / 3.35e12)
    assert gn.least_seconds(work, peaks) == pytest.approx(
        (4 * 19200 + 512) / 3.35e12)
    assert spec.kernels_of("association") == ["correspond_kernel"]
    assert spec.kernels_of("gn_solve") == ["gn_step_kernel"]
    assert spec.peaks("some other card") is None
