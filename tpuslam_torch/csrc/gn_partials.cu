// Point-to-plane Gauss-Newton reduction to per-block partial sums.
//
// Replaces: tpuslam/kernels/pallas_gn.py, _kernel (via
//   gn_reduce_partials_pallas).  Per point: residual r = n.(x - q), Huber
//   IRLS weight min(1, delta / max(|r|, 1e-12)) times validity, Jacobian
//   J = [n, x cross n]; reduced to 30 sums: the 21 upper-triangle entries of
//   H = sum w J J^T (row-major order), the 6 entries of b = sum w r J, then
//   sum w r^2, sum validity, sum w.
//
// What bounds it on the H100: bytes.  40 B read per point (x, q, n as
//   (N, 3) float rows, w), ~90 flops; the finest level's 153,600 points are
//   6 MB, under 2 us at 3.35 TB/s, so at these sizes the launch and the
//   tail of the block reduction dominate, not the arithmetic.
//
// What the design does about it: a grid-stride loop with 30 accumulators
//   per thread in registers, then a fixed-order reduction (warp shuffles,
//   then the block's 8 warp sums in warp order) to one 32-float row of
//   partials per block.  No atomics: every run adds in the same order, so
//   results are bitwise reproducible.  The grid is capped at two blocks per
//   SM so the epilogue's fold stays short.  The (num_blocks, 32) layout
//   replaces the reference's (G*32, 128) lane partials; the epilogue kernel
//   folds it.  The per-point terms and the block reduction are
//   gn_solve.cuh's, shared with gn_step.cu.
//
// When *done != 0 (the ICP loop's device-side early exit) each block writes
// a zero row and reads no input.
//
// The ICP loop on one card calls gn_step.cu, which merges this reduction
// with the epilogue; this kernel serves the ring ICP (dist/ring_map.py),
// which all-reduces the partials across ranks before the solve.

#include <cuda_runtime.h>

#include "gn_solve.cuh"

namespace {

__global__ void __launch_bounds__(gn::kThreads) gn_partials_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    const float* __restrict__ nrm, const float* __restrict__ wv, int n,
    float huber, const float* __restrict__ done,
    float* __restrict__ partials) {
  __shared__ float warp_sums[gn::kWarps][gn::kRow];
  float acc[gn::kSums];
#pragma unroll
  for (int k = 0; k < gn::kSums; ++k) acc[k] = 0.0f;

  const bool skip = (done != nullptr) && (done[0] != 0.0f);
  if (!skip) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      gn::accumulate_point(acc, x[3 * i], x[3 * i + 1], x[3 * i + 2],
                           q[3 * i], q[3 * i + 1], q[3 * i + 2], nrm[3 * i],
                           nrm[3 * i + 1], nrm[3 * i + 2], wv[i], huber);
    }
  }
  gn::block_reduce_row(acc, warp_sums, partials + blockIdx.x * gn::kRow);
}

}  // namespace

extern "C" int tpuslam_gn_partials(const void* x, const void* q,
                                   const void* nrm, const void* w, int n,
                                   float huber, const void* done,
                                   void* partials, int num_blocks,
                                   void* stream) {
  gn_partials_kernel<<<num_blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)q, (const float*)nrm, (const float*)w, n,
      huber, (const float*)done, (float*)partials);
  return (int)cudaGetLastError();
}
