"""The port's ring map-exchange NN (kernels/ring_nn.py), ring ICP
(dist/ring_map.py) and sharded voxel-map fusion (dist/map_fusion.py)
against the reference.

- The hop's plain twin against the reference's Pallas `ring_nn` (interpret
  mode, inside `shard_map` on a one-device mesh): scores to 1e-6 relative
  (the two expand |x − q|² in other orders, a few float32 ulps), the
  winning row equal except where the two rows' scores are within 1 ulp.
- The ring ICP's hop twin (`ring_correspond_hop_reference`: the query
  transform, first-hop start, merge, last-hop gates) against the
  reference's `_ring_best_correspond_pallas` (interpret mode): q, n and w
  equal but for near-tie winners and points on the distance gate, which
  the reference's XLA transform (1 ulp from the twin's ordered one) can
  move; an all-invalid shard and a NaN query; four hops equal one.
- `_mix32` / `voxel_owner` bit for bit against numpy uint32 arithmetic and
  the reference.
- Four gloo ranks, each a process of tests/torch_dist_worker.py that
  imports no JAX, started with a `file://` rendezvous under tmp_path: the
  ring ICP with both backends against the reference's `align_to_map_ring`
  on a 4-device mesh (poses within 1e-4), at the identity and at an
  offset warm start; the ring correspondence's hops over the real
  transport against one hop over the whole map (scores bit for bit) and
  against the reference's on a 4-device mesh; and `ShardedVoxelMap` against
  the reference's on a 4-device mesh, shard for shard (points 1e-5,
  normals 1e-4: the port sums voxels in float64, the reference in
  float32).
- The ring ICP's reduction moves the frame points by the carry's pose
  itself: bit-equal to the reference-shaped reduction at the x the hops
  associate at, and a one-rank ring ICP calls no se3 product (pose within
  1e-4 of the reference's on a one-device mesh).
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import tpuslam.dist.map_fusion as rfusion
from tests.test_icp_synthetic import make_clouds
from tpuslam.config import ICPConfig as RICPConfig
from tpuslam.config import VoxelConfig as RVoxelConfig
from tpuslam.dist.mesh import make_mesh as r_make_mesh
from tpuslam.dist.ring_map import _ring_best_correspond_pallas
from tpuslam.dist.ring_map import align_to_map_ring as r_align_ring
from tpuslam.geom import se3 as rse3
from tpuslam.geom.cloud import PointCloud as RCloud
from tpuslam.kernels.pallas_ring import pack_query_columns, ring_nn
from tpuslam_torch.config import VoxelConfig
from tpuslam_torch.dist import map_fusion, ring_map
from tpuslam_torch.dist.mesh import make_mesh, pad_to_multiple, shard_cloud
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.kernels import gn_partials
from tpuslam_torch.kernels import ring_nn as pring

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
SCORE_RTOL = 1e-6
POSE_TOL = 1e-4
VCFG = dict(voxel_size=0.05, map_voxel_size=0.05, capacity=1 << 12,
            map_capacity=1 << 13, origin=-2.0, extent=4.0)


def random_problem(rng, n=512, m=2048, invalid=0.5):
    """Queries offset from the origin (|x|² ≈ 4, so no score is near 0)
    near a cloud of map rows of which about `invalid` are masked out."""
    q = rng.uniform(-1.0, 1.0, size=(m, 3)).astype(np.float32) + 1.0
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = rng.uniform(size=m) > invalid
    x = (q[rng.integers(0, m, n)]
         + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    return x, q, nrm, valid


def indexed_rows(q, nrm, valid):
    """Packed rows with the row index in the pad column, so a winning row
    names its index."""
    rows = pring.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                 torch.as_tensor(valid))
    rows[:, 7] = torch.arange(q.shape[0], dtype=torch.float32)
    return rows


def twin_hop(x, rows, block_m=512):
    best = pring.init_best(x.shape[0], "cpu")
    pring.ring_nn_hop_reference(torch.as_tensor(x), rows, *best,
                                block_m=block_m)
    return best


def reference_ring_nn(x, rows):
    mesh = r_make_mesh(1)
    shard_cols = jnp.asarray(rows.numpy().T)
    fn = shard_map(
        partial(ring_nn, n_dev=1, axis_name="shard", block_m=512,
                interpret=True),
        mesh=mesh, in_specs=(P(None, "shard"), P(None, "shard")),
        out_specs=(P("shard", None), P("shard", None)), check_vma=False)
    row, score = jax.jit(fn)(pack_query_columns(jnp.asarray(x)), shard_cols)
    return np.asarray(row), np.asarray(score)[:, 0]


def scores_of(x, rows_np, idx):
    """The twin's arithmetic for query i against row idx[i] (numpy f32)."""
    q = rows_np[idx]
    qq = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
    cst = qq + (np.float32(1.0) - q[:, 6]) * np.float32(1e30)
    x2 = np.float32(2.0) * x
    g = x2[:, 0] * q[:, 0] + x2[:, 1] * q[:, 1] + x2[:, 2] * q[:, 2]
    return cst - g


def test_ring_nn_twin_matches_reference_kernel():
    rng = np.random.default_rng(0)
    x, q, nrm, valid = random_problem(rng)
    rows = indexed_rows(q, nrm, valid)
    score, row = (t.numpy() for t in twin_hop(x, rows))
    r_row, r_score = reference_ring_nn(x, rows)
    np.testing.assert_allclose(score, r_score, rtol=SCORE_RTOL)
    idx, r_idx = row[:, 7].astype(int), r_row[:, 7].astype(int)
    assert np.all(row[:, 6] == 1.0) and np.all(r_row[:, 6] == 1.0)
    differ = idx != r_idx
    # where the winners differ, the reference's row scores within 1 ulp of
    # the twin's best under the twin's own arithmetic
    alt = scores_of(x[differ], rows.numpy(), r_idx[differ])
    assert np.all(np.abs(alt - score[differ])
                  <= np.spacing(np.abs(score[differ]))), (
        np.flatnonzero(differ), alt, score[differ])
    np.testing.assert_array_equal(row[~differ], r_row[~differ])
    assert differ.mean() < 0.01


def test_ring_nn_twin_merge_rules():
    """Ties go to the first row within a hop and to the earlier hop across
    hops; four hops over four shards equal one hop over the whole map; the
    chunking of the twin changes nothing; a non-finite query keeps +inf and
    a zero row; an all-invalid shard gives ~1e30 and a row with valid 0."""
    rng = np.random.default_rng(1)
    x, q, nrm, valid = random_problem(rng, n=256, m=1024)
    x[3] = np.nan
    q[700] = q[100]                               # exact duplicate row
    valid[700] = valid[100] = True
    x[5] = q[100]
    rows = indexed_rows(q, nrm, valid)
    whole = twin_hop(x, rows)
    assert int(whole[1][5, 7]) == 100
    for block in (64, 100, 1024):
        chunked = twin_hop(x, rows, block_m=block)
        assert torch.equal(chunked[0], whole[0])
        assert torch.equal(chunked[1], whole[1])
    hops = pring.init_best(x.shape[0], "cpu")
    for s in range(4):
        pring.ring_nn_hop_reference(torch.as_tensor(x),
                                    rows[s * 256:(s + 1) * 256], *hops)
    assert torch.equal(hops[0], whole[0]) and torch.equal(hops[1], whole[1])
    assert whole[0][3] == float("inf") and torch.all(whole[1][3] == 0)
    dead = rows.clone()
    dead[:, 6] = 0.0
    s_dead, r_dead = twin_hop(x, dead)
    fin = torch.isfinite(torch.as_tensor(x)).all(dim=1)
    assert torch.all(s_dead[fin] > 9e29) and torch.all(r_dead[:, 6] == 0)


# Rows where the twin and the reference may differ: a near-tie winner or a
# point on the max_dist gate, moved by the transform's last-ulp rounding.
RING_MISMATCH_SHARE = 0.01
POSE = [0.01, -0.02, 0.015, 0.03, -0.01, 0.02]
RADIUS = 0.2


def reference_ring_correspond(x, mask, rows, max_dist, n_dev=1):
    """`_ring_best_correspond_pallas` on an n_dev-device mesh (interpret
    mode): q, n, w for queries x (already at the pose)."""
    mesh = r_make_mesh(n_dev)
    fn = shard_map(
        lambda xs, ms, cols: _ring_best_correspond_pallas(
            xs, ms, cols, max_dist, "shard", n_dev, True),
        mesh=mesh, in_specs=(P("shard", None), P("shard"), P(None, "shard")),
        out_specs=(P("shard", None), P("shard", None), P("shard")),
        check_vma=False)
    q, n, w = jax.jit(fn)(jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(rows.numpy().T))
    return np.asarray(q), np.asarray(n), np.asarray(w)


def twin_ring(points, mask, parts, T, max_dist=RADIUS):
    state = pring.ring_state(points.shape[0], "cpu")
    for s, part in enumerate(parts):
        pring.ring_correspond_hop_reference(
            torch.as_tensor(points), torch.as_tensor(mask), part, state,
            torch.as_tensor(T), s == 0, s == len(parts) - 1, max_dist)
    return state


def ring_inputs(rng, n=512, m=2048, invalid=0.5):
    """Frame points (in the frame's camera) whose pose puts them near the
    map rows, with no-normal rows, a NaN point and masked points."""
    x, q, nrm, valid = random_problem(rng, n, m, invalid)
    nrm[::9] = 0.0
    T = np.array(rse3.exp(jnp.asarray(POSE)))
    p = ((x - T[:3, 3]) @ T[:3, :3]).astype(np.float32)   # T⁻¹ x
    p[7] = np.nan
    mask = rng.uniform(size=n) > 0.1
    return p, mask, q, nrm, valid, T


@pytest.mark.parametrize("case", ["half_valid", "all_invalid"])
def test_ring_correspond_twin_matches_reference(case):
    """First-hop start, merge and last-hop gates of the twin against the
    reference's whole ring correspondence; a NaN query and an all-invalid
    shard give no match."""
    rng = np.random.default_rng(4)
    p, mask, q, nrm, valid, T = ring_inputs(
        rng, invalid=1.0 if case == "all_invalid" else 0.5)
    rows = pring.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                 torch.as_tensor(valid))
    state = twin_ring(p, mask, (rows,), T)
    x = np.asarray(rse3.transform_points(jnp.asarray(T), jnp.asarray(p)))
    r_q, r_n, r_w = reference_ring_correspond(x, mask, rows, RADIUS)
    w = state.w.numpy()
    differ = (np.any(state.q.numpy() != r_q, axis=1)
              | np.any(state.n.numpy() != r_n, axis=1) | (w != r_w))
    assert differ.mean() <= RING_MISMATCH_SHARE, np.flatnonzero(differ)
    np.testing.assert_array_equal(w[~differ], r_w[~differ])
    np.testing.assert_array_equal(state.q.numpy()[~differ], r_q[~differ])
    np.testing.assert_array_equal(state.n.numpy()[~differ], r_n[~differ])
    assert w[7] == 0.0 and float(state.score[7]) == float("inf")
    assert not bool(state.row[7].any())
    np.testing.assert_array_equal(
        state.x.numpy(), pring.transform_points_ordered(
            torch.as_tensor(T), torch.as_tensor(p)).numpy())
    if case == "all_invalid":
        assert not w.any() and not bool(state.row[:, 6].any())
        assert bool((state.score[torch.isfinite(state.x).all(1)]
                     > 9e29).all())
    else:
        assert 0.3 < w.mean() < 0.95


def test_ring_correspond_twin_hops_and_done():
    """Four hops over four shards equal one over the map; the first hop
    restarts the running best (stale buffers do not leak in); a DONE carry
    leaves the state as it is; the gates read the last hop's best."""
    rng = np.random.default_rng(5)
    p, mask, q, nrm, valid, T = ring_inputs(rng, n=300, m=1024)
    rows = pring.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                 torch.as_tensor(valid))
    one = twin_ring(p, mask, (rows,), T)
    four = twin_ring(p, mask, tuple(rows[i:i + 256] for i in range(0, 1024,
                                                                   256)), T)
    for a, b in zip(one, four):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    stale = pring.ring_state(300, "cpu")
    for t_ in stale:
        t_.fill_(-5.0)
    for s in range(2):
        pring.ring_correspond_hop_reference(
            torch.as_tensor(p), torch.as_tensor(mask), rows, stale,
            torch.as_tensor(T), s == 0, s == 1, RADIUS)
    for a, b in zip(one, stale):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    done = pring.ring_state(300, "cpu")
    for t_ in done:
        t_.zero_()
    carry = ep.init_carry(torch.as_tensor(T), 0)
    pring.ring_correspond_hop(torch.as_tensor(p), torch.as_tensor(mask), rows,
                              done, carry, True, True, RADIUS)
    assert all(not bool(t_.any()) for t_ in done)
    before = pring.counter.plain_calls
    live = pring.ring_state(300, "cpu")
    pring.ring_correspond_hop(torch.as_tensor(p), torch.as_tensor(mask), rows,
                              live, ep.init_carry(torch.as_tensor(T), 12),
                              True, True, RADIUS)
    assert pring.counter.plain_calls == before + 1
    for a, b in zip(one, live):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_ring_correspond_hop_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        pring.ring_correspond_hop(
            x, torch.empty(8, dtype=torch.bool, device=meta),
            torch.empty((16, 8), device=meta),
            pring.ring_state(8, meta), torch.empty(64, device=meta), True,
            True, 0.05)


# ---------------------------------------------------- the ring ICP's reduction


@pytest.mark.parametrize("n", [1, 5000, 16384])
def test_posed_partials_twin_bit_equal(n):
    """The ring ICP's reduction at the carry's pose on the CPU
    (`gn_reduce_partials_at_pose`, which moves the frame points itself) is
    bit-equal to the reference-shaped reduction of `transform_points_ordered
    (T, p)`, the x the ring's hops associate at (that reduction's twin is
    held to `gn_reduce_partials_pallas` by tests/test_torch_kernels.py).
    16,384 is the ring's frame shard on one rank.  It counts one twin call
    and no launch."""
    rng = np.random.default_rng(n)
    T = np.array(rse3.exp(jnp.asarray(POSE)))
    pn = rng.normal(size=(n, 3)).astype(np.float32)
    qn = pn @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=0.03, size=(n, 3))
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    p, q, nrm = (torch.as_tensor(a.astype(np.float32)) for a in (pn, qn, nn))
    w = torch.as_tensor((rng.uniform(size=n) < 0.8).astype(np.float32))
    carry = ep.init_carry(torch.as_tensor(T), 12)
    counter = gn_partials.counter
    before = (counter.launches, counter.plain_calls)
    got = gn_partials.gn_reduce_partials_at_pose(p, q, nrm, w,
                                                 carry[ep.T_SLICE], 0.05,
                                                 done=carry)
    assert (counter.launches, counter.plain_calls) == (before[0],
                                                       before[1] + 1)
    expect = gn_partials.gn_reduce_partials_reference(
        pring.transform_points_ordered(torch.as_tensor(T), p), q, nrm, w,
        0.05)
    assert torch.equal(got, expect)
    assert got.shape == (gn_partials.num_blocks(n), 32)


def test_posed_partials_other_devices_raise():
    meta = torch.device("meta")
    x = torch.empty((8, 3), device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        gn_partials.gn_reduce_partials_at_pose(
            x, x, x, torch.empty(8, device=meta),
            torch.empty(16, device=meta), 0.05)


def test_one_rank_ring_icp_solves_without_a_transform(monkeypatch):
    """The ring ICP on a one-rank CPU mesh ("kernel" backend) calls no se3
    product: the hops and the reductions move the frame points by the
    carry's pose themselves.  Its pose is the reference's
    `align_to_map_ring` on a one-device mesh within POSE_TOL."""
    src_world, dst = make_clouds(n=1024)
    T_true = rse3.exp(jnp.array([0.03, -0.02, 0.04, 0.015, -0.02, 0.02]))
    src = src_world.transform(rse3.inv(T_true))
    cfg = RICPConfig(max_iters=25, max_corr_dist=0.3, huber_delta=0.1)
    ref = r_align_ring(src, dst, jnp.eye(4), cfg, r_make_mesh(1),
                       backend="pallas")

    def no_product(*a, **k):
        raise AssertionError("the ring ICP called an se3 product")

    monkeypatch.setattr(ring_map.se3, "transform_points", no_product)
    monkeypatch.setattr(ring_map.se3, "rotate_vectors", no_product)

    def cloud(c):
        return PointCloud(*(torch.as_tensor(np.array(a))
                            for a in (c.points, c.normals, c.mask)))

    before = gn_partials.counter.plain_calls
    res = ring_map.align_to_map_ring(cloud(src), cloud(dst), torch.eye(4),
                                     cfg, make_mesh("cpu"))
    assert gn_partials.counter.plain_calls - before >= int(res.iters) > 0
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T),
                               atol=POSE_TOL)
    assert int(res.iters) == int(ref.iters)


def test_mix32_and_owner_bit_for_bit():
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 2 ** 31 - 1, size=4096, dtype=np.int64).astype(
        np.int32)
    lo = rng.integers(0, 2 ** 31 - 1, size=4096, dtype=np.int64).astype(
        np.int32)
    hi[:3] = [0, np.iinfo(np.int32).max, 1]
    lo[:3] = [np.iinfo(np.int32).max, 0, 1]
    h = hi.astype(np.uint32) * np.uint32(2654435761)
    h ^= lo.astype(np.uint32) * np.uint32(40503)
    h ^= h >> np.uint32(15)
    h *= np.uint32(2246822519)
    h ^= h >> np.uint32(13)
    got = map_fusion._mix32(torch.as_tensor(hi), torch.as_tensor(lo))
    np.testing.assert_array_equal(got.numpy(), h.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rfusion._mix32(jnp.asarray(hi),
                                               jnp.asarray(lo))))
    pts = rng.uniform(-2.5, 2.5, size=(4096, 3)).astype(np.float32)
    mask = rng.uniform(size=4096) > 0.1
    for n_dev in (1, 3, 4, 8):
        o, box = map_fusion.voxel_owner(torch.as_tensor(pts),
                                        torch.as_tensor(mask), n_dev,
                                        VoxelConfig(**VCFG))
        ro, rbox = rfusion.voxel_owner(jnp.asarray(pts), jnp.asarray(mask),
                                       n_dev, RVoxelConfig(**VCFG))
        np.testing.assert_array_equal(box.numpy(), np.asarray(rbox))
        np.testing.assert_array_equal(o.numpy()[box.numpy()],
                                      np.asarray(ro)[np.asarray(rbox)])


def test_one_rank_mesh_has_no_collectives():
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    t = torch.arange(6.0)
    assert mesh.all_reduce(t) is t and mesh.all_to_all(t) is t
    assert mesh.all_gather(t) is t
    c = PointCloud.from_points(torch.ones((5, 3)))
    assert shard_cloud(c, mesh).capacity == 5
    padded = pad_to_multiple(c.mask, 4, fill=False)
    assert padded.shape == (8,) and not padded[5:].any()
    with pytest.raises(ValueError, match="backend"):
        ring_map.make_ring_align_fn(mesh, RICPConfig(), "xla")


def run_ranks(case, tmp_path, arrays):
    """Start WORLD worker processes on `arrays`; their outputs by rank."""
    inp = tmp_path / "in.npz"
    np.savez(inp, **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"), case,
         str(r), str(WORLD), str(tmp_path / "rendezvous"), str(inp),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    assert not any(bool(o["jax_imported"]) for o in outs)
    return outs


def check_ring_icp_four_ranks(tmp_path, T0):
    """The ring ICP on 4 gloo ranks against `align_to_map_ring` on a
    4-device mesh, from the warm start T0, both backends."""
    src_world, dst = make_clouds(n=1024)
    T_true = rse3.exp(jnp.array([0.03, -0.02, 0.04, 0.015, -0.02, 0.02]))
    src = src_world.transform(rse3.inv(T_true))
    cfg = RICPConfig(max_iters=25, max_corr_dist=0.3, huber_delta=0.1)
    mask = np.zeros(dst.points.shape[0], dtype=bool)
    mask[:5] = True
    tiny = dst._replace(mask=jnp.asarray(mask & np.asarray(dst.mask)))
    mesh = r_make_mesh(WORLD)
    ref = {}
    for name, m in (("map", dst), ("tiny", tiny)):
        for backend, rb in (("ops", "xla"), ("kernel", "pallas")):
            ref[name, backend] = r_align_ring(src, m, jnp.asarray(T0), cfg,
                                              mesh, backend=rb)
    # every rank holds the reference's shard: the map padded to 4·128 rows
    arrays = {"T0": np.asarray(T0, np.float32), "max_iters": 25,
              "max_corr_dist": 0.3, "huber_delta": 0.1}
    for name, c in (("frame", src), ("map", dst), ("tiny", tiny)):
        pad = 1 if name == "frame" else WORLD * 128
        arrays[f"{name}_points"] = pad_to_multiple(
            torch.as_tensor(np.array(c.points)), pad).numpy()
        arrays[f"{name}_normals"] = pad_to_multiple(
            torch.as_tensor(np.array(c.normals)), pad).numpy()
        arrays[f"{name}_mask"] = pad_to_multiple(
            torch.as_tensor(np.array(c.mask)), pad, fill=False).numpy()
    outs = run_ranks("ring", tmp_path, arrays)
    for o in outs[1:]:                        # every rank ends identically
        for k, v in outs[0].items():
            np.testing.assert_array_equal(o[k], v, err_msg=k)
    got = outs[0]
    for backend in ("ops", "kernel"):
        r = ref["map", backend]
        np.testing.assert_allclose(got[f"map_{backend}_T"], np.asarray(r.T),
                                   atol=POSE_TOL)
        assert int(got[f"map_{backend}_iters"]) == int(r.iters)
        assert abs(float(got[f"map_{backend}_num_inliers"])
                   - float(r.num_inliers)) <= 2
        np.testing.assert_allclose(got[f"map_{backend}_flat"][:16],
                                   got[f"map_{backend}_T"].reshape(16))
        assert np.all(np.isfinite(got[f"tiny_{backend}_T"]))
        np.testing.assert_allclose(got[f"tiny_{backend}_T"],
                                   np.asarray(ref["tiny", backend].T),
                                   atol=POSE_TOL)


def test_ring_icp_four_ranks_match_reference(tmp_path):
    check_ring_icp_four_ranks(tmp_path, np.eye(4, dtype=np.float32))


def test_ring_icp_four_ranks_offset_warm_start(tmp_path):
    """From a warm start off the identity: the hops apply the carry's pose
    to the frame points in the kernel's order from the first iteration."""
    check_ring_icp_four_ranks(tmp_path, np.array(rse3.exp(jnp.asarray(
        [0.02, -0.01, 0.03, 0.01, -0.015, 0.01]))))


def test_ring_correspond_four_ranks_over_the_transport(tmp_path):
    """Each rank's frame slice against the four map shards passed round the
    ring (gloo P2P, two spare buffers): the scores equal one hop over the
    whole map bit for bit (a minimum does not depend on the hop order),
    rows, x, q, n and w too (no exact ties here); and against the
    reference's correspondence on a 4-device mesh."""
    rng = np.random.default_rng(6)
    p, mask, q, nrm, valid, T = ring_inputs(rng, n=4 * 128, m=4 * 512)
    rows = pring.pack_cloud_rows(torch.as_tensor(q), torch.as_tensor(nrm),
                                 torch.as_tensor(valid))
    outs = run_ranks("ring_hops", tmp_path, {
        "points": p, "mask": mask, "rows": rows.numpy(), "T": T,
        "max_dist": RADIUS})
    x = np.asarray(rse3.transform_points(jnp.asarray(T), jnp.asarray(p)))
    r_q, r_n, r_w = reference_ring_correspond(x, mask, rows, RADIUS, WORLD)
    for r, o in enumerate(outs):
        lo, hi = r * 128, (r + 1) * 128
        whole = twin_ring(p[lo:hi], mask[lo:hi], (rows,), T)
        for name, t_ in zip(whole._fields, whole):
            np.testing.assert_array_equal(o[name], t_.numpy(), err_msg=name)
        differ = (np.any(o["q"] != r_q[lo:hi], axis=1)
                  | (o["w"] != r_w[lo:hi]))
        assert differ.mean() <= RING_MISMATCH_SHARE, np.flatnonzero(differ)


def test_sharded_fusion_four_ranks_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    n = 2048
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.02]
    arrays = {"T": T, "num_clouds": 3, "new_capacity": n}
    rmesh = r_make_mesh(WORLD)
    ref = rfusion.ShardedVoxelMap(RVoxelConfig(**VCFG), rmesh,
                                  new_capacity=n)
    r_dropped = []
    for i in range(3):
        pts = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        mask = rng.uniform(size=n) > 0.1
        arrays.update({f"c{i}_points": pts, f"c{i}_normals": nrm,
                       f"c{i}_mask": mask})
        r_dropped.append(int(ref.insert(RCloud(
            points=jnp.asarray(pts), normals=jnp.asarray(nrm),
            mask=jnp.asarray(mask)), T).dropped))
    shard_cap = ref.shard_cap
    r_pts = np.asarray(ref.cloud_shards.points).reshape(WORLD, shard_cap, 3)
    r_nrm = np.asarray(ref.cloud_shards.normals).reshape(WORLD, shard_cap, 3)
    r_msk = np.asarray(ref.cloud_shards.mask).reshape(WORLD, shard_cap)
    outs = run_ranks("fusion", tmp_path, arrays)
    for r, o in enumerate(outs):
        assert o["points"].shape == (shard_cap, 3)
        np.testing.assert_array_equal(o["dropped"], r_dropped)
        assert int(o["size"]) == ref.size()
        assert o["gathered_mask"].sum() == ref.size()
        # same voxels in the same slots (both sort by voxel key)
        np.testing.assert_array_equal(o["mask"], r_msk[r])
        np.testing.assert_allclose(o["points"], r_pts[r], atol=1e-5)
        np.testing.assert_allclose(o["normals"], r_nrm[r], atol=1e-4)
