// Point-to-plane Gauss-Newton reduction to per-block partial sums, with the
// source points moved by the ICP loop's pose in the kernel.
//
// Replaces: tpuslam/kernels/pallas_gn.py, _kernel (via
//   gn_reduce_partials_pallas), and the transform in front of it in the ring
//   ICP (tpuslam/dist/ring_map.py:127,141: x = se3.transform_points(T, p)).
//   Per point: x = R p + t, residual r = n.(x - q), Huber IRLS weight
//   min(1, delta / max(|r|, 1e-12)) times validity, Jacobian
//   J = [n, x cross n]; reduced to 30 sums: the 21 upper-triangle entries of
//   H = sum w J J^T (row-major order), the 6 entries of b = sum w r J, then
//   sum w r^2, sum validity, sum w.
//
// What bounds it on the H100: bytes at the finest frame level, latency at
//   the ring's size.  40 B read a point (p, q, n as (N, 3) float rows, w),
//   ~100 flops.  153,600 points are 6.1 MB, 1.8 us at 3.35 TB/s.  The ring
//   ICP reduces 16,384 frame points on one rank: 64 blocks of one point a
//   thread, 0.66 MB (0.2 us), so one wave on half the SMs, and what is left
//   is one load round trip, the block reduction (30 sums through 5 shuffle
//   steps and shared memory) and the launch.
//
// What the design does about it: the pose is read from the device (the
//   carry's T, rows 0-2) and applied in registers, so the cuBLAS transform
//   and the add that ran before every inner solve after the first, and the
//   x they wrote for this kernel to read back, are gone.  A grid-stride loop
//   with 30 accumulators a thread in registers, then a fixed-order reduction
//   (warp shuffles, then the block's 8 warp sums in warp order) to one
//   32-float row of partials a block.  No atomics: every run adds in the
//   same order, so results are bitwise reproducible.  The grid is capped at
//   two blocks an SM so the epilogue's fold stays short.  The (num_blocks,
//   32) layout replaces the reference's (G*32, 128) lane partials; the
//   epilogue kernel folds it after the ring's all-reduce.  The per-point
//   terms and the block reduction are gn_solve.cuh's, shared with gn_step.cu
//   and gn_fused.cu.
//
// Numerics: x = ((R0 p0 + R1 p1) + R2 p2) + t with __fmul_rn / __fadd_rn
//   (se3.transform_points_ordered's order, which ring_nn.cu uses too), so the
//   first solve of an outer iteration reduces at the x the ring's hops
//   associated at, bit for bit.
//
// The pose is required: the entry point refuses a null one with
// cudaErrorInvalidValue and launches nothing.  When *done != 0 (the ICP
// loop's device-side early exit) each block writes a zero row and reads no
// input.
//
// The ICP loop on one card calls gn_step.cu, which merges this reduction
// with the epilogue; this kernel serves the ring ICP (dist/ring_map.py),
// which all-reduces the partials across ranks before the solve.

#include <cuda_runtime.h>

#include "gn_solve.cuh"

namespace {

__global__ void __launch_bounds__(gn::kThreads) gn_partials_kernel(
    const float* __restrict__ pts, const float* __restrict__ pose,
    const float* __restrict__ q, const float* __restrict__ nrm,
    const float* __restrict__ wv, int n, float huber,
    const float* __restrict__ done, float* __restrict__ partials) {
  __shared__ float T[12];  // rows 0..2 of the pose, row-major
  __shared__ float warp_sums[gn::kWarps][gn::kRow];
  float acc[gn::kSums];
#pragma unroll
  for (int k = 0; k < gn::kSums; ++k) acc[k] = 0.0f;

  const bool skip = (done != nullptr) && (done[0] != 0.0f);
  if (!skip && threadIdx.x < 12) T[threadIdx.x] = pose[threadIdx.x];
  __syncthreads();
  if (!skip) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
      const float x0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], p0),
                                                     __fmul_rn(T[1], p1)),
                                           __fmul_rn(T[2], p2)), T[3]);
      const float x1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4], p0),
                                                     __fmul_rn(T[5], p1)),
                                           __fmul_rn(T[6], p2)), T[7]);
      const float x2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[8], p0),
                                                     __fmul_rn(T[9], p1)),
                                           __fmul_rn(T[10], p2)), T[11]);
      gn::accumulate_point(acc, x0, x1, x2, q[3 * i], q[3 * i + 1],
                           q[3 * i + 2], nrm[3 * i], nrm[3 * i + 1],
                           nrm[3 * i + 2], wv[i], huber);
    }
  }
  gn::block_reduce_row(acc, warp_sums, partials + blockIdx.x * gn::kRow);
}

}  // namespace

extern "C" int tpuslam_gn_partials(const void* pts, const void* pose,
                                   const void* q, const void* nrm,
                                   const void* w, int n, float huber,
                                   const void* done, void* partials,
                                   int num_blocks, void* stream) {
  if (pose == nullptr) return (int)cudaErrorInvalidValue;
  gn_partials_kernel<<<num_blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)pose, (const float*)q,
      (const float*)nrm, (const float*)w, n, huber, (const float*)done,
      (float*)partials);
  return (int)cudaGetLastError();
}
