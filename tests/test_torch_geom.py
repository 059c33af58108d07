"""The port's geometry and host modules against the reference on the same
numpy inputs: se3 (both sides of the sinc-series threshold θ² = 0.0625),
backprojection / projection / normals on a rendered depth, the vendored
synthetic renderer (byte-identical) and ATE."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.data.synthetic as rsyn
import tpuslam.eval.ate as rate
import tpuslam.geom.se3 as rse3
import tpuslam_torch.data.synthetic as psyn
import tpuslam_torch.eval.ate as pate
import tpuslam_torch.geom.se3 as pse3
from tpuslam.config import Intrinsics
from tpuslam.geom.backproject import backproject as r_backproject
from tpuslam.geom.backproject import project as r_project
from tpuslam.geom.normals import organized_normals as r_normals
from tpuslam_torch.config import Intrinsics as PIntrinsics
from tpuslam_torch.frontend import damped_velocity
from tpuslam_torch.geom.backproject import backproject as p_backproject
from tpuslam_torch.geom.backproject import project as p_project
from tpuslam_torch.geom.cloud import PointCloud
from tpuslam_torch.geom.normals import organized_normals as p_normals

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
ATOL = 1e-6


def twists(theta: float, n: int = 16, seed: int = 0) -> np.ndarray:
    """Random twists whose rotation part has norm `theta` exactly."""
    rng = np.random.default_rng(seed)
    tau = rng.normal(size=(n, 6)).astype(np.float32) * 0.2
    axis = tau[:, 3:] / np.linalg.norm(tau[:, 3:], axis=1, keepdims=True)
    tau[:, 3:] = axis * theta
    return tau.astype(np.float32)


THETAS = [0.0, 1e-4, 0.2, 0.2499, 0.2501, 0.3, 1.0, 3.0]


@pytest.mark.parametrize("theta", THETAS)
def test_se3_exp_log_match(theta):
    tau = twists(theta)
    Tr = np.array(rse3.exp(jnp.asarray(tau)))
    Tp = pse3.exp(torch.as_tensor(tau)).numpy()
    np.testing.assert_allclose(Tp, Tr, atol=ATOL)
    lr = np.asarray(rse3.log(jnp.asarray(Tr)))
    lp = pse3.log(torch.as_tensor(Tr)).numpy()
    np.testing.assert_allclose(lp, lr, atol=10 * ATOL if theta > 2.5 else ATOL)
    ar = np.asarray(rse3.rotation_angle(jnp.asarray(Tr)))
    ap = pse3.rotation_angle(torch.as_tensor(Tr)).numpy()
    np.testing.assert_allclose(ap, ar, atol=ATOL)


def test_se3_sinc_coeffs_at_threshold():
    ts = np.array([0.0, 1e-8, 0.0624, 0.0625, 0.0626, 0.5, 4.0], np.float32)
    for a, b in zip(rse3._sinc_coeffs(jnp.asarray(ts)),
                    pse3._sinc_coeffs(torch.as_tensor(ts))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_se3_relative_inv_transform_match():
    a, b = twists(0.3, seed=1), twists(0.1, seed=2)
    Ta_r, Tb_r = rse3.exp(jnp.asarray(a)), rse3.exp(jnp.asarray(b))
    Ta_p, Tb_p = pse3.exp(torch.as_tensor(a)), pse3.exp(torch.as_tensor(b))
    np.testing.assert_allclose(pse3.relative(Ta_p, Tb_p).numpy(),
                               np.asarray(rse3.relative(Ta_r, Tb_r)),
                               atol=ATOL)
    np.testing.assert_allclose(pse3.inv(Ta_p).numpy(),
                               np.asarray(rse3.inv(Ta_r)), atol=ATOL)
    pts = np.random.default_rng(3).normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pse3.transform_points(Ta_p[0], torch.as_tensor(pts)).numpy(),
        np.asarray(rse3.transform_points(Ta_r[0], jnp.asarray(pts))),
        atol=ATOL)
    np.testing.assert_allclose(
        pse3.translation_norm(Ta_p).numpy(),
        np.asarray(rse3.translation_norm(Ta_r)), atol=ATOL)


def test_damped_velocity_matches():
    from tpuslam.frontend import damped_velocity as r_damped

    T = rse3.exp(jnp.asarray(twists(0.05, n=1)[0]))
    for gamma in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            damped_velocity(torch.as_tensor(np.array(T)), gamma).numpy(),
            np.asarray(r_damped(T, gamma)), atol=ATOL)


def _depth(seed=0):
    poses = rsyn.orbit_trajectory(12)
    return rsyn.render_depth(poses[seed], K, H, W, seed=seed)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_backproject_normals_match(scale):
    d = _depth(3)
    Ks = K.scaled(scale)
    step = int(round(1 / scale))
    d = np.ascontiguousarray(d[::step, ::step])
    pr, mr = r_backproject(jnp.asarray(d), Ks, depth_min=0.1, depth_max=5.0)
    pp, mp = p_backproject(torch.as_tensor(d), PIntrinsics(*Ks),
                           depth_min=0.1, depth_max=5.0)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mr))
    np.testing.assert_allclose(pp.numpy(), np.asarray(pr), atol=1e-5)
    nr, gr = r_normals(pr, mr)
    npp, gp = p_normals(torch.as_tensor(np.array(pr)),
                        torch.as_tensor(np.array(mr)))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gr))
    np.testing.assert_allclose(npp.numpy(), np.asarray(nr), atol=1e-5)


def test_project_matches():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[:10, 2] = -1.0                      # behind the camera
    uv_r, v_r = r_project(jnp.asarray(pts), K)
    uv_p, v_p = p_project(torch.as_tensor(pts), PIntrinsics(*K))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    np.testing.assert_allclose(uv_p.numpy(), np.asarray(uv_r), atol=1e-5)


@pytest.mark.parametrize("noise", [0.0, 0.003])
def test_synthetic_depth_byte_identical(noise):
    for traj in ("orbit_trajectory", "loop_trajectory"):
        a = getattr(rsyn, traj)(12)
        b = getattr(psyn, traj)(12)
        assert a.tobytes() == b.tobytes()
    poses = rsyn.orbit_trajectory(4)
    for i in range(4):
        a = rsyn.render_depth(poses[i], K, H, W, noise=noise, seed=i)
        b = psyn.render_depth(poses[i], PIntrinsics(*K), H, W, noise=noise,
                              seed=i)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_ate_and_rpe_match():
    gt = rsyn.orbit_trajectory(20)
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(5).normal(scale=1e-3,
                                                     size=(20, 3))
    ts = np.arange(20) / 30.0
    assert pate.ate_rmse(ts, est, ts, gt, 0.005) == rate.ate_rmse(
        ts, est, ts, gt, 0.005)
    assert pate.rpe(ts, est, ts, gt) == rate.rpe(ts, est, ts, gt)


def test_point_cloud_ops():
    pts = torch.as_tensor(np.random.default_rng(6).normal(
        size=(10, 3)).astype(np.float32))
    c = PointCloud.from_points(pts, capacity=16)
    assert c.capacity == 16 and int(c.count()) == 10
    np.testing.assert_allclose(c.centroid().numpy(), pts.mean(0).numpy(),
                               atol=1e-6)
    T = pse3.exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.2]))
    moved = c.transform(T)
    np.testing.assert_allclose(moved.points[:10].numpy(),
                               pse3.transform_points(T, pts).numpy())
