"""The port's grid-hash path (tpuslam_torch/kernels/correspond.py grid half,
icp.align_to_index / align_clouds, SlamSystem with map_track_mode="grid")
against the reference's, on the CPU (the port's plain twins; the reference
is XLA here, with no Pallas kernel on this path).

- `build_grid_index` with the reference's origin: keys, points and normals
  bit for bit, on a cloud whose cells hold up to ~60 points (the stable
  sort decides which 16 the probe scans); the origin derived from the
  centroid within 1e-6 (XLA and torch sum in other orders).
- `grid_hash_correspond` on the same queries and index: q, n, w, idx bit
  for bit, with masked queries, queries outside the grid and queries with
  no candidate (q = n = 0, idx = 0, w = 0).  The posed call equals the
  pose-less one at the ordered transform, and moves at most a share of
  1e-3 of the reference's associations (the transform's last bit).
- The table of occupied cells the card's probe reads: `cell_runs_reference`
  (what the table returns) against numpy.unique over the reference's
  sorted keys, exact, on dense and sparse surfaces, an all-masked index,
  one row and a crowded run ending at the last row; the host copy of the
  probe rule (`cell_table_lookup`, `cell_table_entries`) on a table built
  by the kernel's insert rule in numpy; a CPU index carries no table.
- `brute_force_correspond`: q, n, w, idx bit for bit, d2 at rtol 1e-6.
- `align_to_index`, `align_clouds` (grid and brute force): iterations and
  convergence equal, T within 5e-5 (tests/test_torch_icp.py's bound).
- `SlamSystem(track_against_map=True, map_track_mode="grid")` on the
  16-frame loop of tests/test_torch_map_slam.py: each of the reference's
  refinements replayed through the port on the same inputs (T within
  5e-5, the same gates); the whole system at 0.1 m map voxels with the
  same keyframes, map size and gates, poses within 1e-3 (see that test
  for why not 1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.icp as ricp
import tpuslam_torch.icp as picp
from tests.test_torch_map_slam import CFG as MAP_CFG
from tests.test_torch_map_slam import K, POSE_TOL, loop  # noqa: F401
from tests.test_torch_map_slam import run as run_map
from tpuslam.config import ICPConfig
from tpuslam.data.synthetic import default_scene, sample_cloud
from tpuslam.geom import se3 as rse3
from tpuslam.geom.cloud import PointCloud as RCloud
from tpuslam.kernels import correspond as rcor
from tpuslam.slam import SlamSystem as RSlam
from tpuslam_torch import config as pc
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.geom import se3 as pse3
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.interop import (
    config_from_reference,
    grid_index_from_reference,
)
from tpuslam_torch.kernels import correspond as pcor
from tpuslam_torch.kernels import gn_epilogue as ep
from tpuslam_torch.slam import SlamSystem as PSlam

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

CELL = 0.25
MAX_DIST = 0.2


def surface(kind: str, seed: int = 0):
    """A target cloud: "dense" — two 2 m planes of 6,000 points, ~60 to a
    0.25 m cell; "sparse" — the reference's scene sampled at 4,096 points;
    both with 10% of rows masked out, a few far outside the grid, and
    exact duplicates (distance ties)."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        m = 6000
        a = rng.uniform(-1.0, 1.0, (m // 2, 2))
        b = rng.uniform(-1.0, 1.0, (m // 2, 2))
        pts = np.concatenate([np.c_[a, np.zeros(m // 2)],
                              np.c_[np.ones(m // 2), b]])
        nrm = np.zeros_like(pts)
        nrm[: m // 2, 2] = 1.0
        nrm[m // 2:, 0] = -1.0
    else:
        pts, nrm = sample_cloud(default_scene(), 4096, seed=seed)
        m = pts.shape[0]
    pts, nrm = pts.astype(np.float32), nrm.astype(np.float32)
    pts[-40:] = pts[rng.integers(0, m - 40, 40)]          # ties
    pts[:5] += 200.0                                       # outside the grid
    mask = rng.uniform(size=m) > 0.1
    return pts, nrm, mask


def both_clouds(pts, nrm, mask):
    return (RCloud(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask)),
            PointCloud(torch.as_tensor(pts), torch.as_tensor(nrm),
                       torch.as_tensor(mask)))


def queries(pts, n, seed=1):
    rng = np.random.default_rng(seed)
    x = (pts[rng.integers(5, pts.shape[0], n)]
         + rng.normal(scale=0.06, size=(n, 3))).astype(np.float32)
    x[:3] += 500.0                    # outside the grid: no candidate
    x[3:6] += np.float32(0.7)         # in the grid, likely nothing near
    mask = rng.uniform(size=n) > 0.05
    return x, mask


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_build_grid_index_bit_equal(kind):
    pts, nrm, mask = surface(kind)
    rc, pcl = both_clouds(pts, nrm, mask)
    ri = rcor.build_grid_index(rc, cell=CELL)
    pi = pcor.build_grid_index(pcl, cell=CELL,
                               origin=torch.as_tensor(np.asarray(ri.origin)))
    np.testing.assert_array_equal(pi.keys.numpy(), np.asarray(ri.keys))
    np.testing.assert_array_equal(pi.points.numpy(), np.asarray(ri.points))
    np.testing.assert_array_equal(pi.normals.numpy(), np.asarray(ri.normals))
    keys = pi.keys.numpy()
    _, per_cell = np.unique(keys[keys != pcor._INVALID_KEY],
                            return_counts=True)
    if kind == "dense":
        # the 16-slot cut is the common case: which 16 is the sort's order
        assert per_cell.max() > 16 and np.mean(per_cell > 16) > 0.5
    assert (keys == pcor._INVALID_KEY).sum() >= (~mask).sum()


def test_grid_origin_from_centroid():
    pts, nrm, mask = surface("sparse")
    rc, pcl = both_clouds(pts, nrm, mask)
    ri = rcor.build_grid_index(rc, cell=CELL)
    pi = pcor.build_grid_index(pcl, cell=CELL)
    np.testing.assert_allclose(pi.origin.numpy(), np.asarray(ri.origin),
                               atol=1e-6)
    assert pi.cell == CELL and pi.rows.shape == (pts.shape[0], 8)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def probe_case(request):
    pts, nrm, mask = surface(request.param)
    rc, _ = both_clouds(pts, nrm, mask)
    ri = rcor.build_grid_index(rc, cell=CELL)
    x, xm = queries(pts, 2000)
    return ri, grid_index_from_reference(ri, "cpu"), x, xm


def test_grid_hash_correspond_bit_equal(probe_case):
    ri, pi, x, xm = probe_case
    rr = rcor.grid_hash_correspond(jnp.asarray(x), jnp.asarray(xm), ri,
                                   MAX_DIST)
    pr = pcor.grid_hash_correspond(torch.as_tensor(x), torch.as_tensor(xm),
                                   pi, MAX_DIST)
    for name, a, b in zip("qnwi", pr, rr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    w = pr.w.numpy()
    assert 0.5 < w.mean() < 1.0
    # no candidate: the reference's start values, nothing NaN
    assert not w[:3].any()
    assert not pr.q[:3].any() and not pr.n[:3].any() and not pr.idx[:3].any()
    assert torch.isfinite(pr.q).all() and torch.isfinite(pr.n).all()


def test_grid_correspond_at_pose(probe_case):
    """The posed call equals the pose-less call at the ordered transform
    (the kernel's); against the reference's transform → probe, at most a
    share of 1e-3 of the rows change their match or weight."""
    ri, pi, x, xm = probe_case
    T = pse3.exp(torch.tensor([0.01, -0.02, 0.015, 0.02, -0.01, 0.03]))
    carry = ep.init_carry(T, 10)
    pts, mask = torch.as_tensor(x), torch.as_tensor(xm)
    posed = pcor.grid_correspond_at_pose(pts, mask, pi, MAX_DIST, carry)
    out = pcor.correspondence_buffers(x.shape[0], "cpu")
    same = pcor.grid_correspond_at_pose(pts, mask, pi, MAX_DIST, carry,
                                        out=out)
    assert same is out
    flat = pcor.grid_hash_correspond(pse3.transform_points_ordered(T, pts),
                                     mask, pi, MAX_DIST)
    for a, b, c in zip(posed, flat, out):
        assert torch.equal(a, b) and torch.equal(a, c)
    rr = rcor.grid_hash_correspond(
        rse3.transform_points(jnp.asarray(T.numpy()), jnp.asarray(x)),
        jnp.asarray(xm), ri, MAX_DIST)
    moved = ((posed.idx.numpy() != np.asarray(rr.idx))
             | (posed.w.numpy() != np.asarray(rr.w)))
    assert moved.mean() <= 1e-3, moved.sum()


def table_case(kind: str):
    """Target clouds for the table: the probe surfaces, every row masked,
    one row, and a crowded cell (40 copies of one point) whose run ends at
    the last row (its key the largest, no row masked or outside the
    grid)."""
    if kind in ("dense", "sparse"):
        return surface(kind)
    rng = np.random.default_rng(2)
    if kind == "masked":
        pts, nrm, mask = surface("sparse")
        return pts, nrm, np.zeros_like(mask)
    if kind == "one":
        return (np.array([[0.1, 0.2, 0.3]], np.float32),
                np.array([[0.0, 0.0, 1.0]], np.float32), np.ones(1, bool))
    pts = np.concatenate([rng.uniform(-1.0, 0.0, (300, 3)),
                          np.full((40, 3), 1.5)]).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (340, 1))
    return pts, nrm, np.ones(340, bool)


TABLE_CASES = ["dense", "sparse", "masked", "one", "last-row"]


def reference_keys(kind):
    pts, nrm, mask = table_case(kind)
    rc, _ = both_clouds(pts, nrm, mask)
    return np.array(rcor.build_grid_index(rc, cell=CELL).keys)


@pytest.mark.parametrize("kind", TABLE_CASES)
def test_cell_runs_reference_matches_numpy_unique(kind):
    keys = reference_keys(kind)
    valid = keys[keys != pcor._INVALID_KEY]
    cells, first, runs = np.unique(valid, return_index=True,
                                   return_counts=True)
    pk, ps, pn = pcor.cell_runs_reference(torch.as_tensor(keys))
    np.testing.assert_array_equal(pk.numpy(), cells)
    np.testing.assert_array_equal(ps.numpy(), first)
    np.testing.assert_array_equal(pn.numpy(), np.minimum(runs, 16))
    if kind == "masked":
        assert cells.size == 0
    if kind == "one":
        assert list(ps.numpy()) == [0] and list(pn.numpy()) == [1]
    if kind == "last-row":
        # the crowded run ends at row M − 1; its first 16 rows are scanned
        assert first[-1] + runs[-1] == keys.size and runs[-1] == 40
        assert pn.numpy()[-1] == 16


def insert_table(keys: np.ndarray) -> np.ndarray:
    """A table filled by the insert kernel's rule, in row order: each
    run's first row puts ((start << 5 | count) << 32 | key) in the first
    empty slot from the top bits of key · 0x9E3779B1."""
    size = pcor.cell_table_size(keys.size)
    bits = size.bit_length() - 1
    table = np.full(size, -1, np.int64)
    for i, k in enumerate(keys.tolist()):
        if k == pcor._INVALID_KEY or (i and keys[i - 1] == k):
            continue
        count = 1
        while count < 16 and i + count < keys.size and keys[i + count] == k:
            count += 1
        h = ((k * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
        while table[h] != -1:
            h = (h + 1) & (size - 1)
        table[h] = np.int64(((i << 5) | count) << 32 | k)
    return table


@pytest.mark.parametrize("kind", TABLE_CASES)
def test_cell_table_lookup_rule(kind):
    """The host copy of the probe rule finds each cell's run and misses
    every absent key (neighbours of occupied cells, keys past the grid)."""
    keys = reference_keys(kind)
    table = torch.as_tensor(insert_table(keys))
    assert table.shape[0] >= max(64, 2 * keys.size)
    cells, start, count = pcor.cell_runs_reference(torch.as_tensor(keys))
    got = pcor.cell_table_entries(table)
    for a, b in zip(got, (cells, start, count)):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    s, c = pcor.cell_table_lookup(table, cells)
    assert torch.equal(s, start) and torch.equal(c, count)
    near = torch.unique(torch.cat([cells + 1, cells - 1, cells + 256,
                                   torch.tensor([0, 1 << 24, -5])]))
    absent = near[~torch.isin(near, cells)]
    s, c = pcor.cell_table_lookup(table, absent)
    assert not bool(c.any()) and not bool(s.any())


def test_cpu_grid_index_has_no_table():
    """The CPU twins search the keys: neither build path makes a table."""
    pts, nrm, mask = surface("sparse")
    rc, pcl = both_clouds(pts, nrm, mask)
    assert pcor.build_grid_index(pcl, cell=CELL).table is None
    ri = rcor.build_grid_index(rc, cell=CELL)
    pi = grid_index_from_reference(ri, "cpu")
    assert pi.table is None
    # the reference's keys and its points and normals as the port's rows
    np.testing.assert_array_equal(pi.keys.numpy(), np.asarray(ri.keys))
    np.testing.assert_array_equal(pi.points.numpy(), np.asarray(ri.points))
    np.testing.assert_array_equal(pi.normals.numpy(), np.asarray(ri.normals))
    assert not pi.rows[:, 6:].any()
    assert pi.cell == CELL


def test_brute_force_correspond_bit_equal():
    pts, nrm, mask = surface("sparse")
    pts, nrm, mask = pts[:1500], nrm[:1500], mask[:1500]
    rc, pcl = both_clouds(pts, nrm, mask)
    x, xm = queries(pts, 800)
    rr = rcor.brute_force_correspond(jnp.asarray(x), jnp.asarray(xm), rc,
                                     MAX_DIST)
    pr = pcor.brute_force_correspond(torch.as_tensor(x), torch.as_tensor(xm),
                                     pcl, MAX_DIST)
    for name, a, b in zip("qnwi", pr, rr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    d2_p = ((torch.as_tensor(x) - pr.q) ** 2).sum(-1).numpy()
    d2_r = np.asarray(jnp.sum((jnp.asarray(x) - rr.q) ** 2, axis=-1))
    np.testing.assert_allclose(d2_p, d2_r, rtol=1e-6)
    assert 0.5 < pr.w.numpy().mean() < 1.0


def clouds_pair(n=4096, noise=0.0):
    """tests/test_icp_synthetic.py's two-cloud pair, moved by a known T."""
    scene = default_scene()
    dst_pts, dst_nrm = sample_cloud(scene, n, seed=0)
    src_pts, src_nrm = sample_cloud(scene, n, seed=1, noise=noise)
    T_true = rse3.exp(jnp.array([0.04, -0.03, 0.05, 0.02, -0.03, 0.025]))
    src = RCloud.from_points(jnp.asarray(src_pts),
                             jnp.asarray(src_nrm)).transform(
        rse3.inv(T_true))
    dst = RCloud.from_points(jnp.asarray(dst_pts), jnp.asarray(dst_nrm))
    return src, dst, np.asarray(T_true)


def port_cloud(c) -> PointCloud:
    return PointCloud(*(torch.as_tensor(np.array(a)) for a in c))


ICP = dict(max_iters=30, max_corr_dist=0.3, huber_delta=0.1)


def assert_same_alignment(pr, rr, T_true, tol_true):
    assert int(pr.iters) == int(rr.iters)
    assert bool(pr.converged) == bool(rr.converged)
    np.testing.assert_allclose(pr.T.numpy(), np.asarray(rr.T), atol=5e-5)
    np.testing.assert_allclose(float(pr.inlier_fraction),
                               float(rr.inlier_fraction), atol=1e-3)
    np.testing.assert_allclose(pr.T.numpy(), T_true, atol=tol_true)


@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "brute"])
def test_align_clouds_matches_reference(use_grid):
    src, dst, T_true = clouds_pair(n=4096 if use_grid else 1536)
    cfg = ICPConfig(**ICP)
    rr = ricp.align_clouds(src, dst, rse3.identity(), cfg, use_grid=use_grid)
    pr = picp.align_clouds(port_cloud(src), port_cloud(dst), torch.eye(4),
                           pc.ICPConfig(**dataclasses.asdict(cfg)),
                           use_grid=use_grid)
    assert_same_alignment(pr, rr, T_true, 2e-2)


def test_align_to_index_matches_reference():
    """Against an index built once (the map path), from a warm start."""
    src, dst, T_true = clouds_pair(noise=0.002)
    cfg = ICPConfig(max_iters=20, max_corr_dist=0.25, huber_delta=0.05,
                    inner_steps=2)
    ri = ricp._build_index(dst, cfg)
    pi = grid_index_from_reference(ri, "cpu")
    T0 = T_true @ np.asarray(rse3.exp(jnp.array(
        [0.01, 0.005, -0.01, 0.005, 0.0, -0.005])))
    rr = ricp.align_to_index(src, ri, jnp.asarray(T0, jnp.float32), cfg)
    pr = picp.align_to_index(port_cloud(src), pi,
                             torch.as_tensor(T0, dtype=torch.float32),
                             pc.ICPConfig(**dataclasses.asdict(cfg)))
    assert_same_alignment(pr, rr, T_true, 1e-2)
    # the port's own index (origin from its centroid) gives the same pose
    own = picp.align_to_index(port_cloud(src),
                              picp._build_index(port_cloud(dst), pc.ICPConfig(
                                  **dataclasses.asdict(cfg))),
                              torch.as_tensor(T0, dtype=torch.float32),
                              pc.ICPConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(own.T.numpy(), pr.T.numpy(), atol=5e-5)


def test_grid_loop_is_one_probe_and_the_steps(monkeypatch):
    """Each outer iteration is one posed probe (no se3 product) and
    `inner` GN steps, until DONE."""
    from tpuslam_torch.kernels import gn_step

    def no_product(*a, **k):
        raise AssertionError("the ICP loop called an se3 product")

    src, dst, _ = clouds_pair()
    cfg = pc.ICPConfig(**ICP)
    index = picp._build_index(port_cloud(dst), cfg)
    monkeypatch.setattr(picp.se3, "transform_points", no_product)
    g0, s0 = pcor.grid_counter.plain_calls, gn_step.counter.plain_calls
    res = picp.align_to_index(port_cloud(src), index, torch.eye(4), cfg)
    probes = pcor.grid_counter.plain_calls - g0
    assert gn_step.counter.plain_calls - s0 == cfg.inner_steps * probes
    assert int(res.iters) == cfg.inner_steps * probes
    assert 2 <= probes <= 15


def test_slam_grid_refinements_match_reference_in_lockstep(loop,  # noqa: F811
                                                           monkeypatch):
    """Every grid refinement of the reference's SlamSystem on the 16-frame
    loop (0.02 m map voxels: most cells hold more than 16 points), replayed
    through the port's `align_to_index` on the same frame cloud, map index
    and warm start: iterations, convergence and the gates equal, T within
    5e-5."""
    import tpuslam.slam as rslam

    calls = []
    refine = rslam._refine_grid_jit

    def record(cloud, index, T0, cfg):
        flat = refine(cloud, index, T0, cfg)
        calls.append((cloud, index, T0, np.asarray(flat)))
        return flat

    monkeypatch.setattr(rslam, "_refine_grid_jit", record)
    _, depths = loop
    ref = RSlam(K, MAP_CFG, enable_loop_closure=False,
                track_against_map=True, map_track_mode="grid")
    run_map(ref, depths)
    assert len(calls) == len(ref.map_refine_stats) >= 10
    pcfg = config_from_reference(MAP_CFG).icp
    crowded = 0
    for (cloud, index, T0, flat), stats in zip(calls, ref.map_refine_stats):
        pi = grid_index_from_reference(index, "cpu")
        keys = pi.keys.numpy()
        crowded += np.unique(keys[keys != pcor._INVALID_KEY],
                             return_counts=True)[1].max() > 16
        res = picp.align_to_index(port_cloud(cloud), pi,
                                  torch.as_tensor(np.array(T0)), pcfg)
        s = picp.flat_icp_scalars(res).numpy()
        F = picp.FlatICP
        np.testing.assert_allclose(s[F.T], flat[F.T], atol=5e-5)
        assert s[F.CONVERGED] == flat[F.CONVERGED]
        assert abs(s[F.NUM_INLIERS] - flat[F.NUM_INLIERS]) <= 2
        assert (s[F.INLIER_FRACTION] > 0.3) == (flat[F.INLIER_FRACTION] > 0.3)
    assert crowded == len(calls)


def test_slam_grid_map_tracking_matches_reference(loop):  # noqa: F811
    """The whole system with grid refinement on the 16-frame loop, at 0.1 m
    map voxels: there a cell holds at most a few points and the probe is
    the exact nearest neighbour, so the reference's poses do not move when
    its grid's origin moves by 1e-4 m.  (At 0.02 m they move by up to
    0.36 m: the 16-slot cut makes the refinement chaotic, and no second
    implementation can follow it frame for frame; the lockstep test above
    holds each refinement there.)  The same keyframes, map size and gates;
    poses within 1e-3: the port's frame clouds differ from the reference's
    by a voxel now and then (a point on a voxel face), which moves a grid
    refinement by up to 2e-4 where the projective one moves by 2e-5."""
    cfg = dataclasses.replace(MAP_CFG, voxel=dataclasses.replace(
        MAP_CFG.voxel, map_voxel_size=0.1))
    gt, depths = loop
    ref = RSlam(K, cfg, enable_loop_closure=False, track_against_map=True,
                map_track_mode="grid")
    port = PSlam(PIntrinsics(*K), config_from_reference(cfg),
                 enable_loop_closure=False, track_against_map=True,
                 map_track_mode="grid", device="cpu")
    builds = []
    build_index = port.map.build_index
    port.map.build_index = lambda cell: builds.append(cell) or build_index(
        cell)
    r_kf, r_size, r_ok, r_est = run_map(ref, depths)
    g0 = pcor.grid_counter.plain_calls
    p_kf, p_size, p_ok, p_est = run_map(port, depths)
    assert pcor.grid_counter.plain_calls > g0
    assert p_kf == r_kf and len(p_kf) >= 4
    assert abs(p_size - r_size) <= 1e-3 * r_size
    assert p_ok == r_ok and np.mean(p_ok) > 0.5
    np.testing.assert_allclose(p_est, r_est, atol=1e-3)
    # the index is rebuilt lazily after a map insert, not every frame
    assert 1 <= len(builds) <= port.map.num_insertions < len(p_ok)
    assert builds[0] == cfg.icp.max_corr_dist
