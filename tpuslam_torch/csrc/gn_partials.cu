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
//   folds it.
//
// When *done != 0 (the ICP loop's device-side early exit) each block writes
// a zero row and reads no input.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;
constexpr int kRow = 32;

__global__ void __launch_bounds__(kThreads) gn_partials_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    const float* __restrict__ nrm, const float* __restrict__ wv, int n,
    float huber, const float* __restrict__ done,
    float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps][kRow];
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const bool skip = (done != nullptr) && (done[0] != 0.0f);
  if (!skip) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
      float q0 = q[3 * i], q1 = q[3 * i + 1], q2 = q[3 * i + 2];
      float n0 = nrm[3 * i], n1 = nrm[3 * i + 1], n2 = nrm[3 * i + 2];
      float valid = wv[i];
      float r = n0 * (x0 - q0) + n1 * (x1 - q1) + n2 * (x2 - q2);
      float ar = fabsf(r);
      float hub = (ar <= huber) ? 1.0f : huber / fmaxf(ar, 1e-12f);
      float w = valid * hub;
      float j[6] = {n0, n1, n2, x1 * n2 - x2 * n1, x2 * n0 - x0 * n2,
                    x0 * n1 - x1 * n0};
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float wja = w * j[a];
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += wja * j[b];
      }
      float wr = w * r;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += wr * j[a];
      acc[27] += wr * r;
      acc[28] += valid;
      acc[29] += w;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRow) {
    const int k = threadIdx.x;
    float s = 0.0f;
    if (k < kSums) {
      for (int wp = 0; wp < kWarps; ++wp) s += warp_sums[wp][k];
    }
    partials[blockIdx.x * kRow + k] = s;
  }
}

}  // namespace

extern "C" int tpuslam_gn_partials(const void* x, const void* q,
                                   const void* nrm, const void* w, int n,
                                   float huber, const void* done,
                                   void* partials, int num_blocks,
                                   void* stream) {
  gn_partials_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)q, (const float*)nrm, (const float*)w, n,
      huber, (const float*)done, (float*)partials);
  return (int)cudaGetLastError();
}
