"""The port's multi-process runs (the reference's tests/test_multihost.py,
tests/test_multihost_recovery.py and the hard exit of
tests/test_fault_recovery.py), each process a child that imports
tpuslam_torch and no JAX:

- two processes over a `tcp://` rendezvous (gloo): an all_reduce, the
  distributed pose graph against the single-device one (5e-4), the
  owner-routed map fusion against one VoxelMap (the same voxel count, no
  drop) and the ring ICP across the two processes (recovers the pose);
- a died host mid-BA: process 1 `os._exit`s after the phase-1 snapshot,
  the survivor is ended, both restart from the snapshot and finish within
  1e-5 of an uninterrupted run;
- a SLAM process that `os._exit`s after `utils.checkpoint.save_checkpoint`
  and resumes to the uninterrupted trajectory (1e-5);
- `python -m tpuslam_torch.cli bench --devices 2` in two processes
  (`--coordinator`, `--device cpu`): both exit 0 with the sharded ICP's
  keys; `--devices 2` without a process group exits 2.

Every child runs under a time limit; a survivor blocked on a dead peer is
killed.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 150

_COLLECTIVES = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

init, pid = sys.argv[1], int(sys.argv[2])
initialize_distributed(init, world_size=2, rank=pid, backend="gloo")
mesh = make_mesh("cpu")
assert (mesh.size, mesh.rank) == (2, pid)

# --- collective smoke: an all-reduce across the two processes ---
out = mesh.all_reduce(torch.full((4,), float(pid + 1)))
print("PSUM", out.tolist(), flush=True)

# --- distributed pose graph across processes ---
from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
from tpuslam_torch.backend.posegraph import GraphHost, optimize_pose_graph
from tpuslam_torch.config import PoseGraphConfig

cfg = PoseGraphConfig(max_nodes=8, max_edges=16, gn_iters=5)
g = GraphHost(cfg, device="cpu")
rng = np.random.default_rng(0)
prev = np.eye(4, dtype=np.float32)
g.add_node(prev)
for k in range(1, 6):
    step = np.eye(4, dtype=np.float32)
    step[:3, 3] = rng.normal(scale=0.05, size=3)
    cur = prev @ step
    g.add_node(cur)
    g.add_edge(k - 1, k, step)
    prev = cur
graph = g.graph()
poses_ref, _ = optimize_pose_graph(graph, cfg)
poses_spmd, cost = optimize_pose_graph_spmd(graph, cfg, mesh)
print("DISTBA_ERR", float((poses_spmd - poses_ref).abs().max()), flush=True)

# --- all-to-all owner-routed map fusion across the two processes ---
from tpuslam_torch.config import VoxelConfig
from tpuslam_torch.dist.map_fusion import ShardedVoxelMap
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.mapping import VoxelMap

vcfg = VoxelConfig(map_voxel_size=0.05, map_capacity=1 << 10, origin=-2.0,
                   extent=4.0)
rng2 = np.random.default_rng(7)
pts = rng2.uniform(-1.5, 1.5, size=(512, 3)).astype(np.float32)
nrm = rng2.normal(size=(512, 3)).astype(np.float32)
nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
cloud = PointCloud(points=torch.as_tensor(pts), normals=torch.as_tensor(nrm),
                   mask=torch.ones((512,), dtype=torch.bool))
svm = ShardedVoxelMap(vcfg, mesh, new_capacity=512)
stats = svm.insert(cloud, np.eye(4, dtype=np.float32))
ref = VoxelMap(vcfg, device="cpu")
ref.insert(cloud, np.eye(4, dtype=np.float32))
print("FUSION", int(stats.dropped), svm.size(), ref.size(), flush=True)

# --- ring-sharded frame-to-map ICP across the two processes ---
from tpuslam_torch.config import ICPConfig
from tpuslam_torch.dist.ring_map import align_to_map_ring
from tpuslam_torch.geom import se3

icp_cfg = ICPConfig(pyramid_levels=1, iters_per_level=(30,),
                    max_corr_dist=0.25)
T_true = se3.exp(torch.tensor([0.01, -0.008, 0.012, 0.01, -0.006, 0.008]))
moved = PointCloud(points=se3.transform_points(T_true, cloud.points),
                   normals=se3.rotate_vectors(T_true, cloud.normals),
                   mask=cloud.mask)
res = align_to_map_ring(moved, svm.cloud_shards, torch.eye(4), icp_cfg, mesh)
err = float((res.T @ T_true - torch.eye(4)).abs().max())
print("RING_ERR", err, flush=True)
print("JAX", "jax" in sys.modules, flush=True)
"""

_RECOVERY = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
from tpuslam_torch.backend.posegraph import GraphHost
from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

init, pid, ckpt, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
crash_phase = int(sys.argv[5])
initialize_distributed(init, world_size=2, rank=pid, backend="gloo",
                       timeout_s=60)
mesh = make_mesh("cpu")
cfg = PoseGraphConfig(max_nodes=16, max_edges=32, gn_iters=4)

# a deterministic noisy 10-node loop, the same on both processes
rng = np.random.default_rng(3)
g = GraphHost(cfg, device="cpu")
true_step = np.eye(4, dtype=np.float32); true_step[0, 3] = 0.1
prev = np.eye(4, dtype=np.float32)
g.add_node(prev)
for k in range(1, 10):
    noisy = prev @ true_step
    noisy[:3, 3] += rng.normal(scale=0.02, size=3).astype(np.float32)
    g.add_node(noisy)
    g.add_edge(k - 1, k, true_step)
    prev = noisy
loop = np.eye(4, dtype=np.float32); loop[0, 3] = 0.9
g.add_edge(0, 9, loop, weight=2.0)

PHASES = 3
start_phase = 0
if os.path.exists(ckpt):
    z = np.load(ckpt)
    start_phase = int(z["phase"])
    g.set_poses(z["poses"].astype(np.float32))
    print(f"RESUMED phase={start_phase}", flush=True)

for phase in range(start_phase, PHASES):
    if phase == crash_phase and pid == 1:
        os._exit(42)        # a died host: no cleanup, mid-BA
    poses, cost = optimize_pose_graph_spmd(g.graph(), cfg, mesh)
    g.set_poses(poses.numpy().astype(np.float32))
    if pid == 0:            # snapshot after every completed phase
        tmp = ckpt + ".tmp.npz"
        np.savez(tmp, phase=phase + 1, poses=g._poses[: g.num_nodes])
        os.replace(tmp, ckpt)
    print(f"PHASE {phase} cost {float(cost):.6e}", flush=True)

if pid == 0:
    np.save(out_path, g._poses[: g.num_nodes])
print("DONE", flush=True)
"""

_SLAM = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpuslam_torch.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth
from tpuslam_torch.slam import SlamSystem
from tpuslam_torch.utils.checkpoint import load_checkpoint, save_checkpoint

ckpt, out_path, crash_at = sys.argv[1], sys.argv[2], int(sys.argv[3])
K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
CFG = SLAMConfig(height=H, width=W,
                 icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                               max_corr_dist=0.25, huber_delta=0.05),
                 keyframe=KeyframeConfig(max_translation=0.10,
                                         max_rotation=0.15))
poses = orbit_trajectory(10)
depths = np.stack([render_depth(poses[i], K, H, W, seed=i)
                   for i in range(10)])
slam = SlamSystem(K, CFG, enable_loop_closure=False, device="cpu")
start = 0
if os.path.exists(ckpt):
    start = load_checkpoint(ckpt, slam)
for i in range(start, 10):
    slam.process(depths[i], timestamp=i / 30.0)
    save_checkpoint(ckpt, slam, slam.odo.frame_idx)
    if crash_at >= 0 and slam.odo.frame_idx == crash_at:
        os._exit(42)   # a hard crash: no cleanup, no flush
ts, traj = slam.trajectory()
np.save(out_path, traj)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def launch(script: Path, args_per_proc):
    return [subprocess.Popen([sys.executable, str(script), *map(str, args)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             cwd=REPO, env=child_env(), text=True)
            for args in args_per_proc]


def finish_all(procs, timeout=TIMEOUT_S):
    """(returncode, stdout, stderr) of each; a time-out kills them all."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def value(out: str, tag: str) -> list:
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][0]
    return line.split()[1:]


def test_two_process_collectives_distba_fusion_ring(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_COLLECTIVES)
    init = f"tcp://127.0.0.1:{free_port()}"
    outs = finish_all(launch(child, [(init, 0), (init, 1)]))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert "PSUM [3.0, 3.0, 3.0, 3.0]" in out, out
        assert float(value(out, "DISTBA_ERR")[0]) < 5e-4, out
        dropped, got, want = (int(v) for v in value(out, "FUSION"))
        assert dropped == 0 and got == want, out
        assert float(value(out, "RING_ERR")[0]) < 5e-3, out
        assert value(out, "JAX") == ["False"]


def run_recovery(child, ckpt, out, crash_phase):
    init = f"tcp://127.0.0.1:{free_port()}"
    return launch(child, [(init, pid, ckpt, out, crash_phase)
                          for pid in range(2)])


def test_died_host_mid_ba_recovers_from_snapshot(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_RECOVERY)

    # an uninterrupted 2-process run
    ck_ref, out_ref = tmp_path / "ref.npz", tmp_path / "ref_poses.npy"
    for rc, out, err in finish_all(run_recovery(child, ck_ref, out_ref, -1)):
        assert rc == 0, err[-3000:]
        assert "PHASE 2" in out

    # process 1 dies mid-BA, after the phase-1 snapshot
    ck, out_crash = tmp_path / "crash.npz", tmp_path / "crash_poses.npy"
    procs = run_recovery(child, ck, out_crash, 2)
    try:
        assert procs[1].wait(timeout=TIMEOUT_S) == 42
        # the survivor errors out of (or blocks in) a collective with the
        # dead peer; a job layer would end it: a grace period, then kill
        try:
            procs[0].wait(timeout=10)
        except subprocess.TimeoutExpired:
            procs[0].kill()
    finally:
        finish_all(procs)
    assert not out_crash.exists()
    assert int(np.load(ck)["phase"]) >= 1

    # both restart, reload the snapshot and finish
    for rc, out, err in finish_all(run_recovery(child, ck, out_crash, -1)):
        assert rc == 0, err[-3000:]
        assert "RESUMED" in out and "DONE" in out
    ref, rec = np.load(out_ref), np.load(out_crash)
    assert rec.shape == ref.shape
    np.testing.assert_allclose(rec, ref, atol=1e-5)


def run_slam(tmp_path, name, crash_at):
    runner = tmp_path / "runner.py"
    runner.write_text(_SLAM)
    ckpt, out = tmp_path / f"{name}.npz", tmp_path / f"{name}.npy"
    (rc, _out, err), = finish_all(launch(runner, [(ckpt, out, crash_at)]))
    return rc, err, ckpt, out


def test_hard_exit_after_save_resumes_to_uninterrupted(tmp_path):
    rc, err, _, out_ref = run_slam(tmp_path, "ref", -1)
    assert rc == 0, err[-2000:]
    rc, err, ckpt, out_crash = run_slam(tmp_path, "crash", 5)
    assert rc == 42, err[-2000:]
    assert ckpt.exists() and not out_crash.exists()
    rc, err, _, _ = run_slam(tmp_path, "crash", -1)
    assert rc == 0, err[-2000:]
    ref, rec = np.load(out_ref), np.load(out_crash)
    assert rec.shape == ref.shape == (10, 4, 4)
    np.testing.assert_allclose(rec, ref, atol=1e-5)


def cli_bench(extra):
    return [sys.executable, "-m", "tpuslam_torch.cli", "bench", "--frames",
            "3", "--height", "48", "--width", "64", "--device", "cpu",
            *extra]


def test_cli_bench_devices_over_two_processes():
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        cli_bench(["--devices", "2", "--coordinator", coord,
                   "--num-processes", "2", "--process-id", str(pid)]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=child_env(), text=True) for pid in range(2)]
    for rc, out, err in finish_all(procs):
        assert rc == 0, err[-3000:]
        r = json.loads(out.strip().splitlines()[-1])
        assert r["n_devices"] == 2
        for k in ("spmd_align_ms", "single_align_ms", "scaling_efficiency"):
            assert np.isfinite(r[k]) and r[k] > 0, k
    # without a group of that size: a ValueError, exit 2
    p = subprocess.run(cli_bench(["--devices", "2"]), capture_output=True,
                       text=True, cwd=REPO, env=child_env(),
                       timeout=TIMEOUT_S)
    assert p.returncode == 2 and "devices=2" in p.stderr, p.stderr[-2000:]
