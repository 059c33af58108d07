"""The port's voxel map (tpuslam_torch/mapping.py) and frame-to-map ICP
(icp.align_map_to_frame) against the reference, and the entry points'
default device.

- `VoxelMap`: the same valid voxels after three fusions (sorted points
  within 1e-5, normals 1e-4: the port sums voxels in float64, the
  reference in float32), the same count; its grid-hash index
  (`build_index`) the same keys, its rows to the same tolerances.
- `align_map_to_frame`, `fused_gn` False and True, against the reference's
  kernel path in interpret mode (TPUSLAM_FORCE_PALLAS=1): identical
  iteration count and convergence, the same inlier count to ±2 points,
  pose within 5e-5 (the bound tests/test_torch_icp.py holds frame-to-frame
  ICP to).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.icp as ricp
import tpuslam_torch.icp as picp
from tpuslam.config import ICPConfig, Intrinsics, VoxelConfig
from tpuslam.data.synthetic import orbit_trajectory, render_depth
from tpuslam.geom.backproject import backproject as r_backproject
from tpuslam.geom.cloud import PointCloud as RCloud
from tpuslam.geom.normals import organized_normals as r_normals
from tpuslam.geom.voxel import voxel_downsample as r_voxel
from tpuslam.mapping import VoxelMap as RVoxelMap
from tpuslam_torch import config as pc
from tpuslam_torch.backend.posegraph import GraphHost
from tpuslam_torch.frontend import Odometry
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.kernels.correspond import build_grid_index
from tpuslam_torch.mapping import VoxelMap
from tpuslam_torch.slam import SlamSystem

# The tests run in several worker processes on one machine: one intra-op
# thread each keeps PyTorch's CPU thread pools from oversubscribing the
# cores (which slows these small ops down by an order of magnitude).
torch.set_num_threads(1)

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
PK = pc.Intrinsics(*K)
H, W = 120, 160
VCFG = dict(voxel_size=0.05, map_voxel_size=0.05, capacity=1 << 11,
            map_capacity=1 << 13, origin=-2.0, extent=4.0)


def port_cloud(c) -> PointCloud:
    return PointCloud(*(torch.as_tensor(np.array(a)) for a in c))


def valid_sorted(points, normals, mask):
    p, n = np.asarray(points)[np.asarray(mask)], np.asarray(normals)[
        np.asarray(mask)]
    order = np.lexsort((p[:, 2], p[:, 1], p[:, 0]))
    return p[order], n[order]


def test_voxel_map_matches_reference():
    rng = np.random.default_rng(0)
    ref = RVoxelMap(VoxelConfig(**VCFG))
    port = VoxelMap(pc.VoxelConfig(**VCFG), device="cpu")
    for i in range(3):
        pts = rng.uniform(-1.5, 1.5, size=(2048, 3)).astype(np.float32)
        nrm = rng.normal(size=(2048, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        mask = rng.uniform(size=2048) > 0.1
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, -0.05, 0.02]
        c = RCloud(points=jnp.asarray(pts), normals=jnp.asarray(nrm),
                   mask=jnp.asarray(mask))
        ref.insert(c, T)
        port.insert(port_cloud(c), T)
    assert port.num_insertions == ref.num_insertions == 3
    assert port.size() == ref.size() > 1000
    p, n = valid_sorted(*port.cloud)
    rp, rn = valid_sorted(*ref.cloud)
    np.testing.assert_allclose(p, rp, atol=1e-5)
    np.testing.assert_allclose(n, rn, atol=1e-4)
    np.testing.assert_allclose(np.sort(port.points(), axis=0),
                               np.sort(ref.points(), axis=0), atol=1e-5)
    # the grid-hash index over the map: at the reference's origin the same
    # keys and rows to the map's own tolerances; the origin from the
    # centroid within 1e-5 (the centroid sums the float32 map)
    ri = ref.build_index(cell=0.25)
    pi = port.build_index(cell=0.25)
    np.testing.assert_allclose(pi.origin.numpy(), np.asarray(ri.origin),
                               atol=1e-5)
    pi = build_grid_index(port.cloud, 0.25,
                          origin=torch.as_tensor(np.asarray(ri.origin)))
    np.testing.assert_array_equal(pi.keys.numpy(), np.asarray(ri.keys))
    np.testing.assert_allclose(pi.points.numpy(), np.asarray(ri.points),
                               atol=1e-5)
    np.testing.assert_allclose(pi.normals.numpy(), np.asarray(ri.normals),
                               atol=1e-4)


def frame_at(T_world_cam):
    """The rendered depth at a pose as a reference and a port Frame."""
    d = render_depth(np.asarray(T_world_cam, np.float64), K, H, W)
    p, m = r_backproject(jnp.asarray(d), K, depth_min=0.1, depth_max=5.0)
    n, g = r_normals(p, m)
    rf = ricp.Frame(p, n, m & g)
    return rf, picp.Frame(*(torch.as_tensor(np.array(a)) for a in rf))


@pytest.fixture(scope="module")
def map_and_frame():
    """A world map fused from two keyframes of the orbit, and the frame of
    a later pose with a perturbed warm start."""
    poses = orbit_trajectory(12)
    ref = RVoxelMap(VoxelConfig(**VCFG))
    for k in (0, 4):
        rf, _ = frame_at(poses[k])
        cloud = r_voxel(rf.as_cloud(), VCFG["voxel_size"], VCFG["capacity"],
                        VCFG["origin"], VCFG["extent"])
        ref.insert(cloud, poses[k].astype(np.float32))
    T_true = poses[2].astype(np.float32)
    T0 = T_true.copy()
    T0[:3, 3] += [0.01, -0.008, 0.006]
    return ref.cloud, frame_at(T_true), T0, T_true


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_align_map_to_frame_matches_reference(map_and_frame, monkeypatch,
                                              fused):
    monkeypatch.setenv("TPUSLAM_FORCE_PALLAS", "1")
    rmap, (rf, pf), T0, T_true = map_and_frame
    cfg = ICPConfig(max_iters=30, max_corr_dist=0.25, huber_delta=0.05,
                    fused_gn=fused)
    rr = ricp.align_map_to_frame(rmap, rf, K, jnp.asarray(T0), cfg,
                                 use_pallas=True)
    pr = picp.align_map_to_frame(port_cloud(rmap), pf, PK,
                                 torch.as_tensor(T0),
                                 pc.ICPConfig(**dataclasses.asdict(cfg)))
    assert int(pr.iters) == int(rr.iters)
    assert bool(pr.converged) == bool(rr.converged)
    assert abs(float(pr.num_inliers) - float(rr.num_inliers)) <= 2
    np.testing.assert_allclose(float(pr.inlier_fraction),
                               float(rr.inlier_fraction), atol=1e-3)
    np.testing.assert_allclose(pr.T.numpy(), np.asarray(rr.T), atol=5e-5)
    # and the map pulled the 1.4 cm warm-start error to within the 5 cm
    # voxels' few millimetres
    np.testing.assert_allclose(pr.T.numpy(), T_true, atol=5e-3)
    assert (np.abs(pr.T.numpy()[:3, 3] - T_true[:3, 3]).max()
            < np.abs(T0[:3, 3] - T_true[:3, 3]).max())


def test_map_options_not_ported_raise():
    """The grid mode and map BA are ported: they build a system with a map
    (map BA alone enables it, as in the reference); an unknown mode still
    raises."""
    cfg = pc.SLAMConfig(height=H, width=W)
    grid = SlamSystem(PK, cfg, track_against_map=True, map_track_mode="grid",
                      device="cpu")
    assert grid.map_track_mode == "grid" and isinstance(grid.map, VoxelMap)
    ba = SlamSystem(PK, cfg, map_ba=True, device="cpu")
    assert ba.map_ba and isinstance(ba.map, VoxelMap)
    assert ba.map_ba_stats is None and not ba.refine_map_ba()
    with pytest.raises(ValueError, match="map_track_mode"):
        SlamSystem(PK, cfg, track_against_map=True, map_track_mode="xyz",
                   device="cpu")


def test_entry_points_default_to_the_card():
    """Without `device`, the entry points ask for the card: on a machine
    without CUDA they raise rather than run on the CPU twins."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = pc.SLAMConfig(height=H, width=W)
    for make in (lambda: SlamSystem(PK, cfg),
                 lambda: Odometry(PK, cfg),
                 lambda: GraphHost(cfg.posegraph)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert SlamSystem(PK, cfg, device="cpu").device == torch.device("cpu")
