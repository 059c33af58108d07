"""What a run loads and what the reference imports."""

import ast
from pathlib import Path

from slambench.core import spec
from slambench.tests.small import run_small

HERE = spec.HERE
BANNED_TOP = {"jax", "jaxlib", "flax", "tpuslam"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax_and_no_jax_package():
    for cell in ("slam-loop-vga", "odom-orbit-vga"):
        rc, line, err, tops = run_small(cell, seed=4242, traced=True)
        assert rc == 0, err[-3000:]
        assert line["correct"] is True
        assert "tpuslam_torch" in tops and "slambench" in tops
        assert not tops & BANNED_TOP, tops & BANNED_TOP


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & (BANNED_TOP | {"tpuslam_torch", "slambench"})
        assert not bad, (f.name, bad)


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in sorted(HERE.rglob("*.py")):
        assert not _imports(f) & BANNED_TOP, f
