"""The port's `bench_scale` and `bench_pathology` (tpuslam_torch/bench/
harness.py) against the reference's (tpuslam/bench/harness.py) at cut
sizes, on CPU; `bench_slam`'s keys against the reference's (read from its
source: running its five JAX variants would compile each) and `run_bench`'s
nested `slam` and `loader`; `run_bench`'s top-level keys against the
reference's on the same call (a superset, `fps_reps` rounded to 0.1, the
reference's default of 120 frames); its boundary variant and headline
(its keys read from the reference's source, its boundary poses against
the reference's scan on the same depths, the headline by the reference's
own selection statement, executed).

  * bench_scale: 64 frames of the five-lap loop at 120×160 (the recorded
    run: 2,000 at 320×240), chunks of 16 (32), BASELINE config 5 as is:
    every frame promotes at this speed, the graph doubles from 32 nodes,
    the cloud budget of 48 binds;
  * bench_pathology: 40 frames at 120×160 (60 at 640×480).

Keyframes, closures, lost frames and the graph's nodes and capacity must
be equal, and the ATEs within 1e-4 m of each other.
"""

import ast
import inspect
import math
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.frontend as rf
from tpuslam.bench import harness as ref
from tpuslam.config import Intrinsics as RIntrinsics
from tpuslam.config import SLAMConfig as RSLAMConfig
from tpuslam.eval.ate import ate_rmse
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch import frontend as pf
from tpuslam_torch import icp as picp
from tpuslam_torch.bench import harness as port

torch.set_num_threads(1)

ATE_TOL = 1e-4


def test_bench_scale_matches_reference():
    kw = dict(frames=64, height=120, width=160, chunk=16)
    r = ref.bench_scale(**kw)
    p = port.bench_scale(**kw, device="cpu")
    for k in ("frames", "graph_nodes", "node_capacity", "keyframes",
              "retained_clouds", "loop_closures", "lost_frames"):
        assert p[k] == r[k], k
    assert p["node_capacity"] > 32 and p["retained_clouds"] == 48
    assert p["loop_closures"] >= 2 and p["lost_frames"] == 0
    assert abs(p["ate_rmse_m"] - r["ate_rmse_m"]) < ATE_TOL
    assert p["ate_rmse_m"] < 0.02 and p["poses_finite"]


def test_bench_pathology_matches_reference(monkeypatch):
    keyframes = []
    finalize = RSlam.finalize

    def counting(self):
        finalize(self)
        keyframes.append(len(self.odo.keyframes))

    monkeypatch.setattr(RSlam, "finalize", counting)
    r = ref.bench_pathology(frames=40, height=120, width=160)
    p = port.bench_pathology(frames=40, height=120, width=160, device="cpu")
    assert p["keyframes"] == keyframes[-1]
    for k in ("frames", "loop_closures", "lost_frames"):
        assert p[k] == r[k], k
    assert p["lost_frames"] == 0
    assert abs(p["ate_rmse_m"] - r["ate_rmse_m"]) < ATE_TOL
    assert p["ate_rmse_m"] < 0.04


def test_bench_loader_reports_decoder():
    p = port.bench_loader(height=48, width=64, frames=6)
    assert p["decode_fps"] > 0 and p["cached_fps"] > 0
    assert p["decoder"].split(" ")[0] in ("native", "cv2", "numpy")
    assert p["native"] == p["decoder"].startswith("native")


def reference_bench_slam_keys() -> set:
    """The keys of the dict `tpuslam.bench.harness.bench_slam` returns."""
    tree = ast.parse(inspect.getsource(ref.bench_slam).lstrip())
    returns = [n for n in ast.walk(tree) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict)]
    return {k.value for k in returns[-1].value.keys}


SLAM_KEYS = {
    "slam_fps", "slam_fps_async", "async_gain", "slam_fps_chunked",
    "slam_fps_chunked_async", "slam_fps_chunked_inline", "slam_fps_reps",
    "upload_fps_equiv", "chunk", "slam_ate_rmse_m", "slam_chunked_ate_rmse_m",
    "slam_chunked_async_ate_rmse_m", "slam_chunked_inline_ate_rmse_m",
    "loop_closures", "loop_closures_chunked", "loop_closures_chunked_async",
    "loop_closures_chunked_inline", "keyframes", "keyframes_chunked",
    "frames"}
REPS = {"sync": 3, "async": 3, "chunked": 5, "chunked_async": 5,
        "chunked_inline": 3}


def check_bench_slam(r: dict, frames: int) -> None:
    assert set(r) == SLAM_KEYS | {"device"} and r["device"] == "cpu"
    assert {k: len(v) for k, v in r["slam_fps_reps"].items()} == REPS
    assert r["frames"] == frames and r["chunk"] == 8
    for k in SLAM_KEYS - {"slam_fps_reps", "chunk", "frames"}:
        assert math.isfinite(r[k]) and r[k] >= 0, k
    assert r["keyframes"] >= 1 and r["keyframes_chunked"] >= 1
    assert r["async_gain"] == pytest.approx(
        r["slam_fps_async"] / r["slam_fps"])


def test_bench_slam_has_the_reference_keys():
    assert reference_bench_slam_keys() == SLAM_KEYS
    check_bench_slam(port.bench_slam(frames=16, height=48, width=64,
                                     device="cpu"), 16)


def test_run_bench_nests_loader_and_slam():
    kw = dict(frames=3, height=48, width=64, device="cpu", warmup=0, reps=1)
    r = port.run_bench(**kw, slam_frames=8, loader_frames=4)
    check_bench_slam(r["slam"], 8)
    assert {"decode_fps", "cached_fps", "native", "decoder"} <= set(
        r["loader"])
    bare = port.run_bench(**kw, slam_frames=None, loader_frames=None)
    assert "slam" not in bare and "loader" not in bare


# ---- run_bench: the boundary variant and the headline ---------------------

BOUNDARY_KEYS = {"fps_per_chip_boundary", "ms_per_frame_boundary",
                 "fps_reps_boundary", "ate_rmse_m_boundary",
                 "headline_variant", "fps_headline"}
TOL_BOUNDARY = 1e-4   # tests/test_torch_frontend.py's boundary scan


def _reference_run_bench_tree():
    return ast.parse(textwrap.dedent(inspect.getsource(ref.run_bench)))


def reference_run_bench_keys() -> set:
    """The keys `tpuslam.bench.harness.run_bench` stores in its result."""
    return {n.slice.value for n in ast.walk(_reference_run_bench_tree())
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "result"
            and isinstance(n.slice, ast.Constant)}


def reference_headline_rule():
    """The reference's selection statement (the `if` that sets
    `headline_variant`), as a function of its names."""
    (stmt,) = [n for n in ast.walk(_reference_run_bench_tree())
               if isinstance(n, ast.If) and "headline_variant" in
               ast.unparse(n.body[0])]
    src = ("def rule(m, m_b, wall, frames, wall_b, fb, result):\n"
           + textwrap.indent(ast.unparse(stmt), "    ")
           + "\n    return result['headline_variant']\n")
    names: dict = {}
    exec(compile(src, "tpuslam/bench/harness.py", "exec"), names)
    return names["rule"]


@pytest.mark.parametrize("ate,ate_b", [(5e-5, 5e-5), (5e-5, 2e-3),
                                       (2e-3, 5e-5), (2e-3, 2e-3)])
@pytest.mark.parametrize("boundary_faster", [True, False])
def test_headline_variant_is_the_reference_rule(ate, ate_b,
                                                boundary_faster):
    """`harness.headline_variant` against the reference's own statement,
    executed, fed both ATEs and both times a frame."""
    spf, spf_b = (2e-3, 1e-3) if boundary_faster else (1e-3, 2e-3)
    want = reference_headline_rule()(
        {"rmse": ate}, {"rmse": ate_b}, spf * 16, 16, spf_b * 8, 8,
        {"fps_per_chip": 1.0, "fps_per_chip_boundary": 2.0})
    assert port.headline_variant(ate, spf, ate_b, spf_b) == want


def test_run_bench_keys_are_a_superset_of_the_references():
    """`run_bench` at 16 frames 120×160, the port's and the reference's
    on the same call (one device, no SLAM pass): every top-level key the
    reference returns, `fps_reps` rounded to 0.1 as the reference rounds
    them, and the reference's default of 120 frames."""
    kw = dict(frames=16, height=120, width=160, warmup=0, slam_frames=None)
    want = ref.run_bench(devices=1, **kw)
    got = port.run_bench(device="cpu", reps=1, **kw)
    assert set(want) <= set(got), set(want) - set(got)
    for key in ("fps_reps", "fps_reps_boundary"):
        assert got[key] == [round(v, 1) for v in got[key]], key
    assert got["ms_per_frame"] == pytest.approx(1e3 / got["fps_per_chip"])
    assert got["compile_plus_first_run_s"] > 0
    for fn in (ref.run_bench, port.run_bench):
        assert inspect.signature(fn).parameters["frames"].default == 120


def test_run_bench_boundary_variant_matches_reference(monkeypatch):
    """16 frames of the orbit at 120×160: `run_bench` returns every key
    the reference's returns for the boundary variant and the headline;
    its boundary poses (the last timed call, a replay of each chunk's
    graph off the card's path) match `tpuslam.frontend.
    scan_odometry_boundary` on the same depths; its ATE is theirs; its
    headline follows the reference's rule on the two ATEs and times; the
    ICP iteration latency is timed through `align_frames_jit`."""
    assert BOUNDARY_KEYS <= reference_run_bench_keys()
    seen = []
    scan = pf.scan_odometry_boundary_jit

    def spy(*a, **kw):
        seen.append(scan(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(pf, "scan_odometry_boundary_jit", spy)
    aligns = []
    align = picp.align_frames_jit
    monkeypatch.setattr(picp, "align_frames_jit",
                        lambda *a, **kw: aligns.append(1) or align(*a, **kw))
    seq = port._render_sequence(16, 120, 160)
    r = port.run_bench(frames=16, height=120, width=160, device="cpu",
                       warmup=0, reps=1, sequence=seq, slam_frames=None,
                       loader_frames=None)
    assert BOUNDARY_KEYS <= set(r) and len(seen) == 2
    # icp_iter_latency_ms: one call for the count, two (the key's warm-up
    # and capture), five timed
    assert len(aligns) == 8 and r["icp_iter_count"] == 50
    K, gt, depths = seq
    rp, rpr, ri = rf.scan_odometry_boundary(
        jnp.asarray(depths), RIntrinsics(*K),
        RSLAMConfig().replace(height=120, width=160), 8)
    pp, ppr, pi = seen[-1]
    np.testing.assert_array_equal(ppr.numpy(), np.asarray(rpr))
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp),
                               atol=TOL_BOUNDARY)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ri),
                               atol=TOL_BOUNDARY)
    ts = np.arange(16, dtype=np.float64)
    r_ate = ate_rmse(ts, np.asarray(rp, np.float64), ts, gt)["rmse"]
    assert abs(r["ate_rmse_m_boundary"] - r_ate) <= 1e-5
    assert r["ate_rmse_m_boundary"] < 1e-3
    assert r["ms_per_frame_boundary"] == pytest.approx(
        1e3 / r["fps_per_chip_boundary"])
    assert len(r["fps_reps_boundary"]) == 1
    want = reference_headline_rule()(
        {"rmse": r["ate_rmse_m"]}, {"rmse": r["ate_rmse_m_boundary"]},
        16 / r["fps_per_chip"], 16, 16 / r["fps_per_chip_boundary"], 16,
        {"fps_per_chip": r["fps_per_chip"],
         "fps_per_chip_boundary": r["fps_per_chip_boundary"]})
    assert r["headline_variant"] == want
    assert r["fps_headline"] == (r["fps_per_chip_boundary"]
                                 if want == "boundary" else r["fps_per_chip"])
