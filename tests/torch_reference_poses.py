"""Write the reference's full-width results for the port to be held to.

    JAX_PLATFORMS=cpu python tests/torch_reference_poses.py [OUT.npz]

Runs the JAX package (`tpuslam`) on the CPU and writes
`tpuslam_torch/bench/data/reference_vga.npz` (or OUT.npz), which the port
reads with numpy alone:

  * `orbit_*`: the 240-frame 640×480 orbit of `bench.py`
    (`tpuslam.bench.harness._render_sequence`, the defaults at that size):
    the poses, promotion flags and inlier fractions of the classic scan
    (`scan_odometry_jit`) and of the boundary scan
    (`scan_odometry_boundary_jit`, chunks of 8);
  * `loop_<variant>_*`: the 120-frame 640×480 two-lap loop of
    `tpuslam.bench.harness.bench_slam`, its config (lc_min_gap 8) and two
    of its passes, `per_frame` (`SlamSystem.process` a frame, backend
    synchronous) and `chunked` (boundary chunks of 8, `chunk_sub=4`,
    synchronous): each pass's per-frame poses (`trajectory()`), its
    keyframes' frame indices, its closure pairs (i, j) and its ATE
    (`max_difference=0.005`, as bench_slam takes it);
  * metadata: frames, sizes, both configs as `SLAMConfig.to_json`, the
    git blob hash of every `tpuslam` file the run imported, and the
    seconds each part took.

Not a test module and not part of the test run: tests/
test_torch_reference_file.py holds the port's CPU scans to the file, and
chip_smoke.py holds the card's full-width runs to it.  Rerun it when a
default of `tpuslam.config` or the synthetic scene changes (that test
fails on a stale file).
"""

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUT = ROOT / "tpuslam_torch" / "bench" / "data" / "reference_vga.npz"
HEIGHT, WIDTH = 480, 640
ORBIT_FRAMES = 240          # bench.py's default
LOOP_FRAMES = 120           # bench_slam's default
LOOP_CYCLES = 2
CHUNK = 8                   # the boundary scan's and bench_slam's chunk
CHUNK_SUB = 4               # bench_slam's promotion sub-chunk
ATE_MAX_DIFFERENCE = 0.005  # bench_slam's association window


def orbit_config():
    """`run_bench`'s config: the defaults at 640×480."""
    from tpuslam.config import SLAMConfig

    return SLAMConfig().replace(height=HEIGHT, width=WIDTH)


def loop_config():
    """`bench_slam`'s config: the defaults at 640×480, lc_min_gap 8."""
    import dataclasses

    from tpuslam.config import SLAMConfig

    cfg = SLAMConfig()
    return cfg.replace(height=HEIGHT, width=WIDTH, posegraph=dataclasses
                       .replace(cfg.posegraph, lc_min_gap=8))


def blob_hash(path: Path) -> str:
    """git's blob hash of a file (`git hash-object`)."""
    data = path.read_bytes()
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def reference_blobs() -> dict:
    """{path in the repo: blob hash} of every imported `tpuslam` file."""
    pkg = ROOT / "tpuslam"
    out = {}
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and Path(f).resolve().is_relative_to(pkg):
            p = Path(f).resolve()
            out[str(p.relative_to(ROOT))] = blob_hash(p)
    return dict(sorted(out.items()))


def orbit(out: dict) -> None:
    import jax.numpy as jnp

    from tpuslam.bench.harness import _render_sequence
    from tpuslam.frontend import scan_odometry_boundary_jit, scan_odometry_jit

    K, _gt, depths = _render_sequence(ORBIT_FRAMES, HEIGHT, WIDTH)
    d = jnp.asarray(depths)
    cfg = orbit_config()
    for name, run in (("classic", lambda: scan_odometry_jit(d, K, cfg)),
                      ("boundary", lambda: scan_odometry_boundary_jit(
                          d, K, cfg, CHUNK))):
        poses, promote, inliers = (np.asarray(a) for a in run())
        out[f"orbit_{name}_poses"] = poses
        out[f"orbit_{name}_promote"] = promote
        out[f"orbit_{name}_inliers"] = inliers


def loop(out: dict) -> None:
    """bench_slam's per-frame and chunked synchronous passes, each as its
    `one_pass` / `one_pass_chunked` runs it."""
    import jax.numpy as jnp

    from tpuslam.config import Intrinsics
    from tpuslam.data.synthetic import loop_trajectory, render_depth
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.slam import SlamSystem

    F = LOOP_FRAMES
    K = Intrinsics(525.0 * WIDTH / 640.0, 525.0 * HEIGHT / 480.0,
                   WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5)
    gt = loop_trajectory(F, cycles=LOOP_CYCLES, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, HEIGHT, WIDTH, seed=i)
                       for i in range(F)]).astype(np.float32)
    dev = jnp.asarray(depths)
    ts = np.arange(F) / 30.0
    cfg = loop_config()

    def per_frame():
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=False)
        for i in range(F):
            slam.process(dev[i], timestamp=ts[i])
        slam.finalize()
        return slam

    def chunked():
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=False, chunk_mode="boundary",
                          chunk_sub=CHUNK_SUB)
        for i in range(0, F - F % CHUNK, CHUNK):
            slam.process_chunk(dev[i:i + CHUNK], ts[i:i + CHUNK])
        for i in range(F - F % CHUNK, F):
            slam.process(dev[i], timestamp=ts[i])
        slam.finalize()
        return slam

    for name, run in (("per_frame", per_frame), ("chunked", chunked)):
        t0 = time.perf_counter()
        slam = run()
        t_est, est = slam.trajectory()
        out[f"loop_{name}_poses"] = np.asarray(est, np.float64)
        out[f"loop_{name}_keyframes"] = np.asarray(
            [kf.index for kf in slam.odo.keyframes], np.int64)
        out[f"loop_{name}_closures"] = np.asarray(
            [(c.i, c.j) for c in slam.closures], np.int64).reshape(-1, 2)
        out[f"loop_{name}_ate_rmse_m"] = np.float64(ate_rmse(
            t_est, est, ts, gt, max_difference=ATE_MAX_DIFFERENCE)["rmse"])
        out[f"loop_{name}_seconds"] = np.float64(time.perf_counter() - t0)


def main(argv) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    path = Path(argv[1]) if len(argv) > 1 else OUT
    out: dict = {}
    t0 = time.perf_counter()
    orbit(out)
    out["orbit_seconds"] = np.float64(time.perf_counter() - t0)
    t1 = time.perf_counter()
    loop(out)
    out["loop_seconds"] = np.float64(time.perf_counter() - t1)
    out.update(
        height=np.int64(HEIGHT), width=np.int64(WIDTH),
        orbit_frames=np.int64(ORBIT_FRAMES), loop_frames=np.int64(LOOP_FRAMES),
        loop_cycles=np.int64(LOOP_CYCLES), chunk=np.int64(CHUNK),
        chunk_sub=np.int64(CHUNK_SUB),
        ate_max_difference=np.float64(ATE_MAX_DIFFERENCE),
        orbit_config=np.asarray(orbit_config().to_json()),
        loop_config=np.asarray(loop_config().to_json()),
        reference_blobs=np.asarray(json.dumps(reference_blobs())),
        jax_version=np.asarray(jax.__version__))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(json.dumps({"out": str(path), "bytes": path.stat().st_size,
                      "orbit_s": float(out["orbit_seconds"]),
                      "loop_s": float(out["loop_seconds"]),
                      **{f"loop_{n}": {
                          "keyframes": int(out[f"loop_{n}_keyframes"].size),
                          "closures": int(out[f"loop_{n}_closures"].shape[0]),
                          "ate_rmse_m": float(out[f"loop_{n}_ate_rmse_m"])}
                         for n in ("per_frame", "chunked")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
