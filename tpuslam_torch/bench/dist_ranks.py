"""The distributed stages on one rank of a process group, on arrays from a
file — the program each rank of a multi-rank check runs:

    python -m tpuslam_torch.bench.dist_ranks RANK WORLD INIT_METHOD IN.npz \\
        OUT.npz [--device cuda:0] [--backend gloo] [--timeout-s 300]

Joins the group (`INIT_METHOD` is `tcp://host:port` or `file://path`),
runs every stage whose inputs IN.npz holds (`pack_inputs` writes them) and
writes this rank's results to OUT.npz:

  * `icp`     — `dist/sharded_icp.align_frames_spmd` of a pyramid pair;
  * `pg`      — `backend/distba.optimize_pose_graph_spmd`;
  * `ba`      — `backend/map_ba.optimize_map_ba_spmd` (and `dropped`);
  * `batch`   — `dist/batch_eval.make_batched_aligner` over a batch of
                pyramid pairs (this rank's block by `shard_batch`);
  * `bench`   — `bench/harness.run_bench(…, devices=WORLD)`.

Each stage's wall time (host clock, fenced on a GPU) and each kernel's
launches and plain-twin calls during it go to OUT.npz beside its results.
Several ranks may share one GPU over gloo, which takes CUDA tensors in
its collectives; NCCL needs one GPU a rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

STAGES = ("icp", "pg", "ba", "batch", "bench")


def put(arrays: dict, prefix: str, tup) -> None:
    """The fields of a NamedTuple of tensors into `arrays` as numpy."""
    for name, t in zip(tup._fields, tup):
        arrays[f"{prefix}_{name}"] = t.detach().cpu().numpy()


def get(z, prefix: str, cls, device):
    """A NamedTuple `cls` from `put`'s arrays, on `device`."""
    return cls(*(torch.as_tensor(z[f"{prefix}_{name}"], device=device)
                 for name in cls._fields))


def put_pyramid(arrays: dict, prefix: str, pyr) -> None:
    for li, frame in enumerate(pyr):
        put(arrays, f"{prefix}{li}", frame)


def get_pyramid(z, prefix: str, device) -> tuple:
    from tpuslam_torch.icp import Frame

    levels = sum(1 for k in z.files if k.startswith(prefix)
                 and k.endswith("_points"))
    return tuple(get(z, f"{prefix}{li}", Frame, device)
                 for li in range(levels))


def pack_inputs(path, *, icp=None, pg=None, ba=None, batch=None,
                bench=None) -> None:
    """Write the stages' inputs to `path` (npz).

    icp:   (src_pyr, dst_pyr, K, T0, SLAMConfig) — its `.icp` is used;
    pg:    (PoseGraph, SLAMConfig, huber_delta) — its `.posegraph`;
    ba:    (PoseGraph, MapBAProblem, SLAMConfig, huber_delta,
            edge_huber_delta);
    batch: (src_pyrs, dst_pyrs, K, T0s, SLAMConfig): every tensor with a
           leading batch dimension, a multiple of the world size;
    bench: a `bench.harness._render_sequence` output (K, ground-truth
           poses, depths) for `run_bench`.
    """
    a: dict = {}
    if icp is not None:
        src, dst, K, T0, cfg = icp
        put_pyramid(a, "icp_src", src)
        put_pyramid(a, "icp_dst", dst)
        a.update(icp_K=np.asarray(K, np.float64), icp_T0=T0.cpu().numpy(),
                 icp_cfg=cfg.to_json())
    if pg is not None:
        graph, cfg, huber = pg
        put(a, "pg", graph)
        a.update(pg_cfg=cfg.to_json(), pg_huber=huber)
    if ba is not None:
        graph, prob, cfg, huber, edge_huber = ba
        put(a, "bag", graph)
        put(a, "bap", prob)
        a.update(ba_cfg=cfg.to_json(), ba_huber=huber,
                 ba_edge_huber=edge_huber)
    if batch is not None:
        src, dst, K, T0s, cfg = batch
        put_pyramid(a, "batch_src", src)
        put_pyramid(a, "batch_dst", dst)
        a.update(batch_K=np.asarray(K, np.float64),
                 batch_T0s=T0s.cpu().numpy(), batch_cfg=cfg.to_json())
    if bench is not None:
        K, poses, depths = bench
        a.update(bench_K=np.asarray(K, np.float64), bench_poses=poses,
                 bench_depths=depths)
    np.savez(path, **a)


def _config(z, key):
    from tpuslam_torch.config import SLAMConfig

    return SLAMConfig.from_json(str(z[key]))


def _intrinsics(z, key):
    from tpuslam_torch.config import Intrinsics

    return Intrinsics(*(float(v) for v in z[key]))


def _icp(z, mesh, dev) -> dict:
    from tpuslam_torch.dist.sharded_icp import align_frames_spmd

    res = align_frames_spmd(get_pyramid(z, "icp_src", dev),
                            get_pyramid(z, "icp_dst", dev),
                            _intrinsics(z, "icp_K"),
                            torch.as_tensor(z["icp_T0"], device=dev),
                            _config(z, "icp_cfg").icp, mesh)
    out: dict = {}
    put(out, "icp", res)
    return out


def _pg(z, mesh, dev) -> dict:
    from tpuslam_torch.backend.distba import optimize_pose_graph_spmd
    from tpuslam_torch.backend.posegraph import PoseGraph

    poses, cost = optimize_pose_graph_spmd(
        get(z, "pg", PoseGraph, dev), _config(z, "pg_cfg").posegraph, mesh,
        huber_delta=float(z["pg_huber"]))
    return {"pg_poses": poses.cpu().numpy(), "pg_cost": cost.cpu().numpy()}


def _ba(z, mesh, dev) -> dict:
    from tpuslam_torch.backend.map_ba import (
        MapBAProblem,
        optimize_map_ba_spmd,
        partition_observations,
    )
    from tpuslam_torch.backend.posegraph import PoseGraph

    prob = get(z, "bap", MapBAProblem, dev)
    poses, map_pts, cost = optimize_map_ba_spmd(
        get(z, "bag", PoseGraph, dev), prob,
        _config(z, "ba_cfg").posegraph, mesh,
        huber_delta=float(z["ba_huber"]),
        edge_huber_delta=float(z["ba_edge_huber"]))
    dropped = partition_observations(prob, mesh.size)[2]
    return {"ba_poses": poses.cpu().numpy(), "ba_map": map_pts.cpu().numpy(),
            "ba_cost": cost.cpu().numpy(), "ba_dropped": np.asarray(dropped)}


def _batch(z, mesh, dev) -> dict:
    from tpuslam_torch.dist.batch_eval import make_batched_aligner, shard_batch

    fn = make_batched_aligner(mesh, _config(z, "batch_cfg").icp)
    res = fn(shard_batch(get_pyramid(z, "batch_src", "cpu"), mesh),
             shard_batch(get_pyramid(z, "batch_dst", "cpu"), mesh),
             _intrinsics(z, "batch_K"),
             shard_batch(torch.as_tensor(z["batch_T0s"]), mesh))
    out: dict = {}
    put(out, "batch", res)
    return out


def _bench(z, mesh, dev) -> dict:
    from tpuslam_torch.bench.harness import run_bench

    depths = z["bench_depths"]
    frames, height, width = depths.shape
    r = run_bench(frames, height, width, device=str(dev),
                  sequence=(_intrinsics(z, "bench_K"), z["bench_poses"],
                            depths), devices=mesh.size, slam_frames=None,
                  loader_frames=None)
    return {"bench_json": np.asarray(json.dumps(r))}


_RUN = {"icp": _icp, "pg": _pg, "ba": _ba, "batch": _batch, "bench": _bench}
_INPUT = {"icp": "icp_cfg", "pg": "pg_cfg", "ba": "ba_cfg",
          "batch": "batch_cfg", "bench": "bench_depths"}


def run_stages(z, mesh) -> dict:
    """Every stage whose inputs `z` holds, on `mesh`; results, and per
    stage `<stage>_ms`, `<stage>_launches` and `<stage>_plain` (counts in
    the order of `kernels`)."""
    from tpuslam_torch.bench.harness import kernel_counters

    counters = kernel_counters()
    dev = mesh.device
    out: dict = {"kernels": np.asarray(list(counters))}
    for stage in STAGES:
        if _INPUT[stage] not in z.files:
            continue
        for c in counters.values():
            c.reset()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out.update(_RUN[stage](z, mesh, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[f"{stage}_ms"] = np.asarray((time.perf_counter() - t0) * 1e3)
        out[f"{stage}_launches"] = np.asarray(
            [c.launches for c in counters.values()])
        out[f"{stage}_plain"] = np.asarray(
            [c.plain_calls for c in counters.values()])
    return out


def spawn(commands, log_dir, timeout_s: float, env=None) -> None:
    """Run one process a rank (`commands[r]`, its output in
    `log_dir/rank<r>.log`) and wait for all of them.  A rank that exits
    non-zero, or the time limit, ends the others (a survivor may be
    blocked in a collective with a dead peer); then RuntimeError with the
    logs' tails.  No process outlives the call."""
    log_dir = Path(log_dir)
    logs = [open(log_dir / f"rank{r}.log", "w") for r in range(len(commands))]
    procs = []
    try:
        for cmd, log in zip(commands, logs):
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes) or len(procs) < len(commands):
        tails = "\n".join(
            f"--- rank {r} (exit {c}) ---\n"
            + (log_dir / f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes))
        raise RuntimeError(f"ranks failed or timed out after {timeout_s} s: "
                           f"exit codes {codes}\n{tails}")


def run(world: int, inputs, work_dir, device: str, backend: str = "gloo",
        timeout_s: float = 600.0) -> list:
    """`world` processes of this program on `inputs` (a `file://`
    rendezvous in `work_dir`), each on `device`; their outputs by rank."""
    work_dir = Path(work_dir)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    spawn([[sys.executable, "-m", "tpuslam_torch.bench.dist_ranks", str(r),
            str(world), f"file://{work_dir / 'rendezvous'}", str(inputs),
            str(work_dir / f"rank{r}.npz"), "--device", device,
            "--backend", backend, "--timeout-s", str(timeout_s)]
           for r in range(world)], work_dir, timeout_s, env=env)
    return [dict(np.load(work_dir / f"rank{r}.npz")) for r in range(world)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dist_ranks")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init_method")
    ap.add_argument("inputs")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--timeout-s", type=float, default=300.0)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpuslam_torch.dist.mesh import initialize_distributed, make_mesh

    initialize_distributed(args.init_method, world_size=args.world,
                           rank=args.rank, backend=args.backend,
                           timeout_s=args.timeout_s)
    try:
        mesh = make_mesh(args.device)
        out = run_stages(np.load(args.inputs), mesh)
        out["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(args.output, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
