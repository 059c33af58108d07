"""One rank of a gloo process group for the port's multi-rank tests
(tests/test_torch_ring.py, tests/test_torch_dist.py, ...).

    python tests/torch_dist_worker.py CASE RANK WORLD INIT_FILE IN.npz OUT_DIR

Joins the group through `file://INIT_FILE`, runs CASE on the arrays of
IN.npz with the port (tpuslam_torch only: this process imports no JAX) and
writes OUT_DIR/rank<RANK>.npz.  Not a test module: the tests start WORLD
of these processes (`run_ranks`) and compare what they write with the
reference.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuslam_torch.config import ICPConfig, VoxelConfig  # noqa: E402
from tpuslam_torch.dist.mesh import (  # noqa: E402
    initialize_distributed,
    make_mesh,
)
from tpuslam_torch.geom.cloud import PointCloud  # noqa: E402


def cloud(z, prefix: str) -> PointCloud:
    return PointCloud(points=torch.as_tensor(z[f"{prefix}_points"]),
                      normals=torch.as_tensor(z[f"{prefix}_normals"]),
                      mask=torch.as_tensor(z[f"{prefix}_mask"]))


def ring_case(z, mesh) -> dict:
    """Ring ICP of the frame against this rank's map shard, per backend."""
    from tpuslam_torch.dist.ring_map import make_ring_align_fn

    cfg = ICPConfig(max_iters=int(z["max_iters"]),
                    max_corr_dist=float(z["max_corr_dist"]),
                    huber_delta=float(z["huber_delta"]))
    frame = cloud(z, "frame")
    rows = z["map_points"].shape[0] // mesh.size
    lo = mesh.rank * rows
    out = {}
    for name in ("map", "tiny"):
        full = cloud(z, name)
        shard = PointCloud(*(a[lo:lo + rows] for a in full))
        for backend in ("ops", "kernel"):
            res, flat = make_ring_align_fn(mesh, cfg, backend)(
                frame, shard, torch.as_tensor(z["T0"]))
            key = f"{name}_{backend}"
            out[f"{key}_T"] = res.T.numpy()
            out[f"{key}_iters"] = res.iters.numpy()
            out[f"{key}_num_inliers"] = res.num_inliers.numpy()
            out[f"{key}_flat"] = flat.numpy()
    return out


def ring_hops_case(z, mesh) -> dict:
    """The ring correspondence of this rank's slice of the frame points over
    the map shards passed round the ring: the RingState after the D hops."""
    from tpuslam_torch.dist.ring_map import _ring_hops
    from tpuslam_torch.kernels.gn_epilogue import init_carry
    from tpuslam_torch.kernels.ring_nn import ring_correspond_hop, ring_state

    n = z["points"].shape[0] // mesh.size
    m = z["rows"].shape[0] // mesh.size
    pts = torch.as_tensor(z["points"][mesh.rank * n:(mesh.rank + 1) * n])
    mask = torch.as_tensor(z["mask"][mesh.rank * n:(mesh.rank + 1) * n])
    shard = torch.as_tensor(z["rows"][mesh.rank * m:(mesh.rank + 1) * m])
    state = ring_state(n, "cpu")
    carry = init_carry(torch.as_tensor(z["T"]), 12)
    spare = [torch.empty_like(shard), torch.empty_like(shard)]
    _ring_hops(mesh, shard, spare, lambda s, held: ring_correspond_hop(
        pts, mask, held, state, carry, s == 0, s == mesh.size - 1,
        float(z["max_dist"])))
    return {name: t.numpy() for name, t in zip(state._fields, state)}


def fusion_case(z, mesh) -> dict:
    """Insert the clouds into a ShardedVoxelMap; return this rank's shard."""
    from tpuslam_torch.dist.map_fusion import ShardedVoxelMap

    cfg = VoxelConfig(voxel_size=0.05, map_voxel_size=0.05,
                      capacity=1 << 12, map_capacity=1 << 13, origin=-2.0,
                      extent=4.0)
    svm = ShardedVoxelMap(cfg, mesh, new_capacity=int(z["new_capacity"]))
    T = z["T"]
    dropped = []
    for i in range(int(z["num_clouds"])):
        stats = svm.insert(cloud(z, f"c{i}"), T)
        dropped.append(int(stats.dropped))
    full = svm.gather()
    return {"points": svm.cloud_shards.points.numpy(),
            "normals": svm.cloud_shards.normals.numpy(),
            "mask": svm.cloud_shards.mask.numpy(),
            "dropped": np.asarray(dropped), "size": np.asarray(svm.size()),
            "gathered_mask": full.mask.numpy()}


def stages_case(z, mesh) -> dict:
    """The distributed stages of tpuslam_torch/bench/dist_ranks.py (the
    program the GPU check runs on each rank) on this rank."""
    from tpuslam_torch.bench.dist_ranks import run_stages

    return run_stages(z, mesh)


def partials_case(z, mesh) -> dict:
    """This rank's block of the points reduced to GN partials, all-reduced
    (the reference's psum of the sharded gn_reduce), and its fold."""
    from tpuslam_torch.kernels.gn_epilogue import fold_rows
    from tpuslam_torch.kernels.gn_partials import gn_reduce_partials

    n = z["x"].shape[0] // mesh.size
    block = slice(mesh.rank * n, (mesh.rank + 1) * n)
    partials = mesh.all_reduce(gn_reduce_partials(
        *(torch.as_tensor(z[k][block]) for k in ("x", "q", "n", "w")),
        float(z["huber_delta"])))
    return {"partials": partials.numpy(), "sums": fold_rows(partials).numpy()}


CASES = {"ring": ring_case, "ring_hops": ring_hops_case,
         "fusion": fusion_case, "stages": stages_case,
         "partials": partials_case}


def run_ranks(case, tmp_path, arrays, world: int, timeout_s: float = 240):
    """Start `world` worker processes on `arrays` (a `file://` rendezvous
    under `tmp_path`); their outputs by rank.  A failing rank or the time
    limit ends the others and fails the call."""
    from tpuslam_torch.bench.dist_ranks import spawn

    inp = Path(tmp_path) / "in.npz"
    np.savez(inp, **arrays)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    spawn([[sys.executable, str(Path(__file__).resolve()), case, str(r),
            str(world), str(Path(tmp_path) / "rendezvous"), str(inp),
            str(tmp_path)] for r in range(world)], tmp_path, timeout_s,
          env=env)
    outs = [dict(np.load(Path(tmp_path) / f"rank{r}.npz"))
            for r in range(world)]
    assert not any(bool(o["jax_imported"]) for o in outs)
    return outs


def main(argv) -> int:
    case, rank, world, init_file, inp, out_dir = argv
    torch.set_num_threads(1)
    initialize_distributed(f"file://{init_file}", world_size=int(world),
                           rank=int(rank), backend="gloo", timeout_s=120)
    mesh = make_mesh("cpu")
    z = np.load(inp)
    out = CASES[case](z, mesh)
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
