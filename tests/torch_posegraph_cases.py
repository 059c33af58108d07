"""Pose graphs of the 32-node bucket that the dense pose-graph solve is
held to its twin on, for the tests and `chip_smoke.py`.

`synthetic_graph` builds a loop's graph on a device; `posegraph_cases`
names the graphs the kernel meets at its edges (loops of 15-32 nodes, a
fused attempt's candidates, rotations about the Taylor switch and near π,
a NaN candidate).  numpy and the port alone: no JAX, no GPU needed.

Tests import it as `torch_posegraph_cases` (pytest puts `tests/` on the
path); `chip_smoke.py` loads it by its file path.  Neither imports it as
`tests.torch_posegraph_cases`: the GPU host has another package named
`tests` on its path, which hides this directory's.
"""

from __future__ import annotations


def synthetic_graph(dev, nodes: int, seed: int = 0):
    """A bucketed pose graph over the first `nodes` poses of a two-lap
    loop (a node every 8 frames of a 16-keyframe lap), each off by ~1 cm,
    odometry edges from the true poses and a loop edge from each node of
    the second lap to its twin of the first, weight 2."""
    import numpy as np

    from tpuslam_torch.backend.posegraph import GraphHost
    from tpuslam_torch.config import PoseGraphConfig
    from tpuslam_torch.data.synthetic import loop_trajectory

    gt = loop_trajectory(8 * nodes, cycles=max(1, nodes // 16),
                         radius=0.35)[::8]
    rng = np.random.default_rng(seed)
    host = GraphHost(PoseGraphConfig(), device=dev)
    for k in range(nodes):
        T = gt[k].copy()
        T[:3, 3] += rng.normal(scale=0.01, size=3)
        host.add_node(T.astype(np.float32))
        if k:
            host.add_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k])
        if k >= 16:
            host.add_edge(k - 16, k, np.linalg.inv(gt[k - 16]) @ gt[k],
                          weight=2.0)
    return host


def posegraph_cases(dev) -> dict:
    """Graphs of the 32-node bucket that the dense solve's kernel is held
    to its twin on, by name: synthetic_graph's loops of 15, 19, 24 and 32
    nodes; 19 nodes with a fused attempt's four candidate edges (a loop
    closure, one 0.3 m off, whose weighted norm passes the Huber width,
    and two zero-weight repeats of the first); every node rotated by
    ±0.06, ±0.13 and ±1.56 rad about x, so that the first round's residual
    rotations fall below, above and near π past the Taylor switch at
    θ² = 0.0625; and a candidate pose with a NaN, at weight 0 and at 2
    (the guard leaves every pose as it was)."""
    import numpy as np
    import torch

    from tpuslam_torch.geom import se3

    cases = {f"loop {n}": synthetic_graph(dev, n).graph(bucketed=True)
             for n in (15, 19, 24, 32)}
    host = synthetic_graph(dev, 19)
    g = host.graph(bucketed=True)
    rng = np.random.default_rng(1)

    def closure(i, j, noise):
        T = np.linalg.inv(host._poses[i]) @ host._poses[j]
        T[:3, 3] += rng.normal(scale=noise, size=3)
        return T.astype(np.float32)

    cand_T = np.stack([closure(0, 17, 0.02), closure(2, 18, 0.3),
                       closure(0, 17, 0.0), closure(0, 17, 0.0)])

    def with_candidates(T, w):
        return g._replace(
            edge_i=torch.cat([g.edge_i, torch.tensor(
                [0, 2, 0, 0], dtype=torch.int32, device=dev)]),
            edge_j=torch.cat([g.edge_j, torch.tensor(
                [17, 18, 17, 17], dtype=torch.int32, device=dev)]),
            edge_T=torch.cat([g.edge_T, torch.as_tensor(T, device=dev)]),
            edge_weight=torch.cat([g.edge_weight, torch.tensor(
                w, dtype=torch.float32, device=dev)]))

    cases["candidates"] = with_candidates(cand_T, [2.0, 2.0, 0.0, 0.0])
    for ang in (0.06, 0.13, 1.56):
        turn = torch.stack([se3.exp(torch.tensor(
            [0.0, 0.0, 0.0, ang * (-1) ** k, 0.0, 0.0], device=dev))
            for k in range(g.poses.shape[0])])
        live = g.node_mask[:, None, None]
        cases[f"rotated {ang}"] = g._replace(
            poses=torch.where(live, turn @ g.poses, g.poses))
    bad = cand_T.copy()
    bad[2, 0, 0] = np.nan
    cases["nan candidate, weight 0"] = with_candidates(bad,
                                                       [2.0, 2.0, 0.0, 0.0])
    cases["nan candidate, weight 2"] = with_candidates(bad,
                                                       [2.0, 2.0, 2.0, 0.0])
    return cases
