"""The benchmark's data, found by name: `BENCHMARK.json` at the root of
the checkout, `configs/<config>.json`, `traffic/<mix>.json`,
`entries/<entry>.py`, `metrics/<metric>.py`, `end_to_end/<metric>.py`,
`rooflines/<stage>.py` with its kernels in `rooflines/<stage>.kernels/`
and the table of peaks, `rooflines/peaks.json`.  A later cell, mix,
configuration or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent        # slambench/
ROOT = HERE.parent                                    # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config_of(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def module(kind: str, name: str, here: Path = HERE):
    """`slambench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metric entries: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    if not traced:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in e2e]


def kernels_of(stage: str, here: Path = HERE) -> list:
    """Kernel names (prefixes of the device trace's names) that do a
    roofline stage's work: one file a kernel."""
    d = here / "rooflines" / f"{stage}.kernels"
    return sorted(p.name for p in d.iterdir() if p.is_file())


def peaks(kind: str, here: Path = HERE):
    """The published peaks of a device kind, or None when the table has
    none for it."""
    return load_json(here / "rooflines" / "peaks.json").get(kind)
