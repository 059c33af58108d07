"""The dense pose-graph kernel's host side on the CPU.

The CPU path runs the plain twin (and counts it), a tensor on another
device never falls back to it, the engage decision is a function of the
device and the buckets alone, and the twin is the loop the dense solve
always ran.  The kernel's device code is also built here with g++ as one
thread a block (every strided loop then covers all its items and every
barrier is a no-op): that holds its arithmetic and indexing to the twin
on the CPU, though not its threads.  The kernel on the card against the
twin is in tests/test_torch_cuda.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_posegraph_cases import posegraph_cases, synthetic_graph
from tpuslam_torch.backend import posegraph
from tpuslam_torch.config import PoseGraphConfig
from tpuslam_torch.kernels import _build
from tpuslam_torch.kernels import posegraph_dense as pd

torch.set_num_threads(1)

CFG = PoseGraphConfig()
CASES = ["loop 15", "loop 19", "loop 24", "loop 32", "candidates",
         "rotated 0.06", "rotated 0.13", "rotated 1.56",
         "nan candidate, weight 0", "nan candidate, weight 2"]


@pytest.mark.parametrize("device,nodes,edges,want", [
    ("cuda", 32, 64, True), ("cuda", 32, 68, True), ("cuda", 32, 132, True),
    ("cuda", 32, 389, True), ("cuda", 32, 390, False), ("cuda", 1, 0, True),
    ("cuda", 64, 64, False), ("cuda", 128, 256, False),
    ("cuda", 256, 1024, False), ("cpu", 32, 64, False),
    ("meta", 32, 64, False)])
def test_engages_on_cuda_buckets_up_to_32(device, nodes, edges, want):
    assert pd.engages(device, nodes, edges) is want


def test_smem_layout_fits_the_block_at_the_largest_bucket():
    """H and b at 32 nodes: 193 × 193 floats, 145.5 KiB of the 227 KiB;
    with the panel, step, poses, inverse factors and offsets 155.5 KiB;
    188 B an edge."""
    assert 4 * 193 * 193 < pd.smem_bytes(32, 0) == 159272
    assert pd.smem_bytes(32, 389) <= pd.SMEM_LIMIT < pd.smem_bytes(32, 390)
    assert pd.smem_bytes(32, 68) - pd.smem_bytes(32, 64) == 4 * 47 * 4


@pytest.mark.parametrize("nodes", [15, 40])
def test_cpu_runs_the_twin_and_counts_it(nodes):
    """Buckets of 32 and 64 nodes on the CPU: the twin, counted by
    `plain()`, through every entry point; no launch."""
    g = synthetic_graph("cpu", nodes).graph(bucketed=True)
    pd.counter.reset()
    want = posegraph.optimize_dense_reference(g, CFG, 0.5)
    got = [posegraph.optimize_pose_graph(g, CFG),
           posegraph.optimize_pose_graph(g, CFG, eager=True),
           posegraph.optimize(g, CFG, live_nodes=nodes)]
    assert pd.counter.plain_calls == 4 and pd.counter.launches == 0
    for poses, cost in got:
        assert torch.equal(poses, want[0]) and torch.equal(cost, want[1])


def test_twin_is_the_dense_loop_bit_for_bit():
    """The twin is the rounds the dense solve ran before the kernel:
    edge_normal_system then solve_and_update, `gn_iters` times."""
    g = posegraph_cases("cpu")["candidates"]
    info = posegraph._info_vector(CFG, g.poses)
    poses, cost = g.poses, torch.full((), float("inf"))
    for _ in range(CFG.gn_iters):
        H, b, cost = posegraph.edge_normal_system(
            poses, g.edge_i, g.edge_j, g.edge_T, g.edge_weight, info, 0.5)
        poses = posegraph.solve_and_update(poses, g.node_mask, H, b, CFG)
    got = posegraph.optimize_dense_reference(g, CFG, 0.5)
    assert torch.equal(got[0], poses) and torch.equal(got[1], cost)


def test_launch_refuses_a_cpu_tensor():
    g = synthetic_graph("cpu", 15).graph(bucketed=True)
    with pytest.raises(ValueError, match="no kernel"):
        pd.launch(*g, CFG, 0.5)


def test_the_library_binds_the_entry_point():
    assert "posegraph_dense.cu" in _build.SOURCES
    assert len(_build._SIGNATURES["tpuslam_posegraph_dense"]) == 16


# ---- the kernel's device code, one thread a block, on the CPU --------------

_SHIM = r"""
#include <cmath>
#include <cstdint>
using std::isfinite;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
struct Dim { int x; };
static const Dim threadIdx = {0}, blockDim = {1};
static inline void __syncthreads() {}
static inline int __syncthreads_or(int v) { return v; }
static inline void __syncwarp() {}
static inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
static inline float __frsqrt_rn(float x) {
  return (float)(1.0 / std::sqrt((double)x));
}
static float g_smem[1 << 16];
"""

_DRIVER = r"""
extern "C" int run(const float* poses, const uint8_t* mask, const int* ei,
                   const int* ej, const float* eT, const float* ew, int N,
                   int E, float it, float ir, float hub, float damp,
                   int iters, float* out, float* cost) {
  if (4 * smem_words(N, E) > (long long)sizeof(g_smem)) return -1;
  for (auto& v : g_smem) v = NAN;     // a word read before it is set shows
  Params p;
  p.poses = poses; p.mask = mask; p.edge_i = ei; p.edge_j = ej;
  p.edge_T = eT; p.edge_w = ew; p.info_t = it; p.info_r = ir;
  p.huber = hub; p.damping = damp; p.iters = iters; p.n_nodes = N;
  p.n_edges = E; p.poses_out = out; p.cost_out = cost;
  posegraph_dense_kernel(p);
  return 0;
}
"""


@pytest.fixture(scope="module")
def one_thread_kernel(tmp_path_factory):
    """csrc/posegraph_dense.cu's device code (up to the end of its
    namespace) built by g++ for one thread: a warp of one lane, the block's
    shared memory a static array."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's device code")
    src = (_build.CSRC / "posegraph_dense.cu").read_text()
    dev = src[:src.index("}  // namespace")] + "}  // namespace\n"
    for old, new in (("#include <cuda_runtime.h>", ""),
                     ("constexpr int kLanes = 32;", "constexpr int kLanes = 1;"),
                     ("extern __shared__ float smem[];",
                      "float* smem = g_smem;")):
        assert old in dev, old
        dev = dev.replace(old, new)
    tmp = tmp_path_factory.mktemp("posegraph_dense")
    (tmp / "k.cpp").write_text(_SHIM + dev + _DRIVER)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(tmp / "k.so"),
                    str(tmp / "k.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp / "k.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.run.argtypes = [P] * 6 + [I, I, F, F, F, F, I, P, P]
    return lib


def run_one_thread(lib, g, cfg, huber=0.5):
    g = posegraph.PoseGraph(*(t.contiguous() for t in g))
    out = torch.empty_like(g.poses)
    cost = torch.empty((), dtype=torch.float32)
    scalars = np.array([cfg.trans_weight, cfg.rot_weight, huber,
                        cfg.damping], dtype=np.float32).tolist()
    rc = lib.run(*(t.data_ptr() for t in g), g.poses.shape[0],
                 g.edge_i.shape[0], *scalars, int(cfg.gn_iters),
                 out.data_ptr(), cost.data_ptr())
    assert rc == 0
    return out, cost


@pytest.fixture(scope="module")
def cases():
    return posegraph_cases("cpu")


@pytest.mark.parametrize("case", CASES)
def test_kernel_code_matches_the_twin(one_thread_kernel, cases, case):
    """Poses within pd.TOL_POSE of the twin's, the cost within
    pd.TOL_COST_REL (+ pd.TOL_COST_ABS), padding poses bit-equal to what
    came in; a NaN candidate leaves every pose as it was."""
    g = cases[case]
    want, want_cost = posegraph.optimize_dense_reference(g, CFG, 0.5)
    got, cost = run_one_thread(one_thread_kernel, g, CFG)
    live = int(g.node_mask.sum())
    assert torch.equal(got[live:], g.poses[live:])
    assert float((got - want).abs().max()) <= pd.TOL_POSE
    if case.startswith("nan"):
        assert torch.equal(got, g.poses) and torch.equal(want, g.poses)
        assert bool(torch.isnan(cost)) and bool(torch.isnan(want_cost))
    else:
        assert float((want - g.poses).abs().max()) > 1e-3    # it moved
        assert abs(float(cost - want_cost)) <= (
            pd.TOL_COST_REL * abs(float(want_cost)) + pd.TOL_COST_ABS)


def test_kernel_code_huber_engages_on_the_candidates(cases):
    """The 0.3 m candidate's weighted norm passes the Huber width at the
    first round (the case exercises the Huber branch)."""
    g = cases["candidates"]
    r = posegraph.edge_residual(g.poses[g.edge_i.long()],
                                g.poses[g.edge_j.long()], g.edge_T)
    info = posegraph._info_vector(CFG, g.poses)
    wr2 = (r * info * r).sum(-1)
    assert float(wr2[-3].sqrt()) > 0.5 > float(wr2[:-4].sqrt().max())


@pytest.mark.parametrize("iters", [0, 1])
def test_kernel_code_rounds(one_thread_kernel, cases, iters):
    """No round: the poses as they came and an infinite cost; one round:
    the twin's one round."""
    import dataclasses

    cfg = dataclasses.replace(CFG, gn_iters=iters)
    g = cases["candidates"]
    want = posegraph.optimize_dense_reference(g, cfg, 0.5)
    got = run_one_thread(one_thread_kernel, g, cfg)
    assert float((got[0] - want[0]).abs().max()) <= pd.TOL_POSE
    if iters == 0:
        assert torch.equal(got[0], g.poses)
        assert float(got[1]) == float(want[1]) == float("inf")
