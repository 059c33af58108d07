"""The benchmark's torch renderer and camera paths against the port's
synthetic fixture, and the seeded session pool."""

import numpy as np
import torch

from slambench.inputs import scene
from tpuslam_torch.data import synthetic
from tpuslam_torch.config import Intrinsics

torch.set_num_threads(1)


def test_paths_at_phase_zero_are_the_ports():
    np.testing.assert_allclose(
        scene.loop_path(120, 0.0, 2, 0.35),
        synthetic.loop_trajectory(120, cycles=2, radius=0.35), atol=1e-12)
    np.testing.assert_allclose(scene.orbit_path(240, 0.0, 0.05, 0.12),
                               synthetic.orbit_trajectory(240), atol=1e-12)


def test_renderer_equals_the_ports_at_a_small_size():
    K = scene.intrinsics(96, 128)
    poses = np.concatenate([scene.loop_path(6, 0.3, 2, 0.35),
                            scene.orbit_path(4, 0.7, 0.05, 0.12)])
    want = np.stack([synthetic.render_depth(p, Intrinsics(*K), 96, 128)
                     for p in poses])
    got = scene.render_depth(torch.as_tensor(poses), 96, 128, K).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_pool_is_seeded_and_stratified():
    traffic = {"trajectory": "orbit", "params": {"radius": 0.05,
                                                 "angle": 0.12},
               "frames": 8, "pool": 4}
    a = scene.render_pool(traffic, 48, 64, 2 ** 31 + 7, torch.device("cpu"))
    b = scene.render_pool(traffic, 48, 64, 2 ** 31 + 7, torch.device("cpu"))
    c = scene.render_pool(traffic, 48, 64, 99, torch.device("cpu"))
    assert torch.equal(a["depth"], b["depth"])
    assert not torch.equal(a["depth"], c["depth"])
    for pool in (a, c):
        assert sorted(pool["order"]) == [0, 1, 2, 3]
        np.testing.assert_array_equal(np.floor(pool["phases"] * 4),
                                      np.arange(4))
    assert a["depth"].shape == (4, 8, 48, 64)
    assert float(a["depth"].mean()) > 0.5


def test_hover_stays_under_the_keyframe_thresholds():
    for phase in np.linspace(0.0, 1.0, 17):
        P = scene.orbit_path(240, phase, 0.05, 0.12)
        rel = np.linalg.inv(P[0]) @ P
        assert np.linalg.norm(rel[:, :3, 3], axis=1).max() < 0.15
        cos = (np.trace(rel[:, :3, :3], axis1=1, axis2=2) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)).max() < 0.30
