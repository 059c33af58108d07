"""The port's worker-thread backend (tpuslam_torch/slam.py, `async_backend`
in the inline chunk mode) on the CPU, against the JAX reference.

  * per-frame `process` with the worker against the reference's
    synchronous run on tests/test_async_backend.py's 30-frame loop: ATE
    below max(2 × the reference's, 0.02 m) (that test's bound), every pose
    finite;
  * inline chunks of 8 with the worker against the reference's inline
    synchronous run on tests/test_chunked_slam.py's 48-frame two-lap loop:
    the same keyframe indices, closures ≥ max(1, reference // 2), ATE
    below 0.02 m (tests/test_chunked_slam.py:99-122's gates);
  * an error on the worker re-raised by `finalize`, and `finalize` twice;
  * `save_checkpoint` with attempts queued: the file holds the state once
    the worker went idle (every queued attempt committed), and a system
    resumed from it reproduces that state within 1e-5
    (tests/test_fault_recovery.py's bound);
  * the kernels' launch counters, which the worker and the main thread
    both increment, lose no count under a short switch interval.

No test waits on the thread without a limit: `finalize` and
`wait_backend_idle` raise after `slam.WORKER_JOIN_S` seconds.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_chunked_slam import CFG as CHUNK_CFG
from tests.test_slam import CFG as LOOP_CFG
from tests.test_slam import H, K, W, loop_trajectory
from tpuslam.data.synthetic import loop_trajectory as two_lap_trajectory
from tpuslam.data.synthetic import render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch import slam as pslam
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.interop import config_from_reference
from tpuslam_torch.kernels._build import LaunchCounter
from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

PK = PIntrinsics(*K)
FRAMES_LOOP = 30           # tests/test_async_backend.py
FRAMES_TWO_LAP = 48        # tests/test_chunked_slam.py
CHUNK = 8
ASYNC_ATE_FLOOR_M = 0.02   # tests/test_async_backend.py:34
CHUNKED_ATE_M = 0.02       # tests/test_chunked_slam.py:120
TOL_RESUME = 1e-5          # tests/test_fault_recovery.py:86


@pytest.fixture(scope="module")
def loop():
    gt = loop_trajectory(FRAMES_LOOP)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES_LOOP)]).astype(np.float32)
    return gt, depths


@pytest.fixture(scope="module")
def two_lap():
    gt = two_lap_trajectory(FRAMES_TWO_LAP, cycles=2, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(FRAMES_TWO_LAP)]).astype(np.float32)
    return gt, depths


def ate(slam, gt) -> float:
    ts, est = slam.trajectory()
    return ate_rmse(ts, est, np.arange(len(gt)) / 30.0, gt,
                    max_difference=0.005)["rmse"]


def per_frame(slam, depths, lo=0, hi=None):
    for i in range(lo, len(depths) if hi is None else hi):
        slam.process(depths[i], timestamp=i / 30.0)
    return slam


def chunks(slam, depths, lo=0, hi=None):
    hi = len(depths) if hi is None else hi
    ts = np.arange(len(depths)) / 30.0
    for i in range(lo, hi, CHUNK):
        slam.process_chunk(depths[i:i + CHUNK], ts[i:i + CHUNK])
    return slam


def worker_system(cfg):
    slam = pslam.SlamSystem(PK, config_from_reference(cfg),
                            enable_loop_closure=True, async_backend=True,
                            chunk_mode="inline", device="cpu")
    assert slam._backend_thread is not None and slam._worker_stream is None
    return slam


def test_per_frame_worker_matches_reference_sync(loop):
    gt, depths = loop
    ref = per_frame(RSlam(K, LOOP_CFG, enable_loop_closure=True), depths)
    ref.finalize()
    slam = per_frame(worker_system(LOOP_CFG), depths)
    thread = slam._backend_thread
    slam.finalize()
    assert slam._backend_thread is None and not thread.is_alive()
    _, est = slam.trajectory()
    assert np.all(np.isfinite(est))
    a_ref, a_port = ate(ref, gt), ate(slam, gt)
    assert a_port < max(2 * a_ref, ASYNC_ATE_FLOOR_M), (a_port, a_ref)


def test_inline_chunks_worker_matches_reference_inline_sync(two_lap):
    gt, depths = two_lap
    ref = chunks(RSlam(K, CHUNK_CFG, enable_loop_closure=True), depths)
    ref.finalize()
    slam = chunks(worker_system(CHUNK_CFG), depths)
    slam.finalize()
    assert ([r.index for r in slam.odo.keyframes]
            == [r.index for r in ref.odo.keyframes])
    assert len(slam.closures) >= max(1, len(ref.closures) // 2), (
        len(slam.closures), len(ref.closures))
    assert ate(slam, gt) < CHUNKED_ATE_M


def test_worker_error_is_raised_by_finalize(two_lap):
    _, depths = two_lap
    slam = worker_system(CHUNK_CFG)
    calls = []

    def failing(after=None):
        calls.append(after)
        raise RuntimeError("attempt failed on the worker")

    slam._attempt_loop_closure = failing
    chunks(slam, depths, 0, 16)
    with pytest.raises(RuntimeError, match="attempt failed on the worker"):
        slam.finalize()
    assert calls and all(a is None for a in calls)   # the CPU: no stream
    assert slam._backend_thread is None


def test_finalize_twice(loop):
    gt, depths = loop
    slam = per_frame(worker_system(LOOP_CFG), depths)
    slam.finalize()
    _, once = slam.trajectory()
    closures = len(slam.closures)
    slam.finalize()                  # no worker left: attempt + optimize
    _, twice = slam.trajectory()
    assert slam._backend_thread is None and len(slam.closures) >= closures
    assert np.all(np.isfinite(twice))
    assert ate(slam, gt) < ASYNC_ATE_FLOOR_M
    # the second pass re-solves the same graph (plus any closure its one
    # attempt adds): the poses stay within a millimetre
    np.testing.assert_allclose(twice, once, atol=1e-3)


def test_checkpoint_waits_for_queued_attempts(two_lap, tmp_path):
    gt, depths = two_lap
    slam = worker_system(CHUNK_CFG)
    attempt = slam._attempt_loop_closure
    gate = threading.Event()

    def held(after=None):            # attempts queue up behind the gate
        gate.wait(60)
        return attempt(after=after)

    slam._attempt_loop_closure = held
    chunks(slam, depths, 0, 40)
    assert slam._backend_queued > 1  # attempts are queued at the save
    opener = threading.Timer(0.5, gate.set)
    opener.start()                   # while save_checkpoint waits
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, slam, slam.odo.frame_idx)
    opener.join(10)
    assert slam._backend_queued == 0  # every queued attempt committed
    # the file holds the state after the worker went idle
    _, est_idle = slam.trajectory()
    with np.load(path) as z:
        assert int(z["graph_num_edges"]) == slam.graph.num_edges
        np.testing.assert_array_equal(
            z["graph_poses"], slam.graph._poses[:slam.graph.num_nodes])
        np.testing.assert_array_equal(
            z["kf_poses"], np.stack([r.T_world_kf
                                     for r in slam.odo.keyframes]))
    # resumed into a fresh system, synchronous: the same state within
    # 1e-5, and it goes on to close the loop
    res = pslam.SlamSystem(PK, config_from_reference(CHUNK_CFG),
                           enable_loop_closure=True, device="cpu")
    assert load_checkpoint(path, res) == 40
    _, est_res = res.trajectory()
    np.testing.assert_allclose(est_res, est_idle, atol=TOL_RESUME)
    assert res.graph.num_edges == slam.graph.num_edges
    chunks(res, depths, 40)
    res.finalize()
    assert ate(res, gt) < CHUNKED_ATE_M
    slam.finalize()


def test_launch_counter_loses_no_count_across_threads():
    counter = LaunchCounter()
    threads_n, each = 16, 2000

    def work(k):
        for _ in range(each):
            counter.launched(k % 2)
            counter.plain()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == counter.plain_calls == threads_n * each
    assert counter.by_stream == {0: threads_n * each // 2,
                                 1: threads_n * each // 2}
    counter.reset()
    assert (counter.launches, counter.plain_calls, counter.by_stream) == (
        0, 0, {})
