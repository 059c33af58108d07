// One Gauss-Newton solve of the ICP loop in one launch: transform the
// source points by the carry's pose, reduce the point-to-plane system,
// fold the blocks' rows, solve, and update the carry in place.
//
// Replaces: the GN step of tpuslam/icp.py:129-139 (_pallas_steps), which
//   is three launches on the TPU: x = se3.transform_points(T, src.points)
//   for k > 0, tpuslam/kernels/pallas_gn.py's _kernel (via
//   gn_reduce_partials_pallas) and tpuslam/kernels/pallas_epilogue.py's
//   _kernel (via gn_epilogue_pallas).  The per-point math is
//   gn_partials.cu's and the solve gn_epilogue.cu's (both in gn_solve.cuh).
//
// What bounds it on the H100: launch latency.  The bytes are 40 a point
//   (source point, q, n as (N, 3) float rows, w): 6.1 MB at the finest
//   level, 1.8 us at 3.35 TB/s; ~100 flops a point.  Two launches (a
//   reduction, then a one-warp epilogue whose serial fold waited on one L2
//   load after another) plus a cuBLAS GEMM and an add for the transform
//   become one launch.
//
// What the design does about it:
//   - The transform is in the kernel, x = R p + t in a fixed order with
//     __fmul_rn / __fadd_rn (no FMA contraction), so the plain twin
//     (kernels/gn_step.py) repeats it bit for bit.
//   - The points are read straight from their (N, 3) rows, not staged
//     through shared memory: a warp's three 4-byte loads of a row touch the
//     same 384 bytes, which the first load brings into L1 for the other
//     two; each byte still comes from device memory once.
//   - Each block reduces to one 32-float row (warp shuffles, warps in
//     order), writes it, fences, and draws a ticket.  The block that draws
//     the last ticket folds all rows in parallel in a fixed order (warp w
//     folds its contiguous share of the rows, lane = column; the warp sums
//     are then added in warp order), so every run gives the same bits.
//     atomicInc with the limit gridDim.x - 1 hands the last block that
//     ticket and stores 0 in the same operation: the word is ready for the
//     next launch.  Warp 0 of the last block then runs the solve, the
//     elimination spread over its lanes (one row a lane).
//   - After DONE (carry[0] != 0 at entry) every block returns before it
//     reads a point or touches the ticket, and nothing is written.  This is
//     safe in place: every block reads the pose and DONE before it draws
//     its ticket, and only the last block, after every ticket is drawn,
//     writes the carry.
//
// The ticket word and the partials scratch belong to the wrapper's module,
// one of each per stream: two launches that share them run in order on
// their stream, and launches on two streams get scratch of their own.

#include <cuda_runtime.h>

#include "gn_solve.cuh"

namespace {

__global__ void __launch_bounds__(gn::kThreads) gn_step_kernel(
    const float* __restrict__ pts, const float* __restrict__ q,
    const float* __restrict__ nrm, const float* __restrict__ wv, int n,
    float huber, float* carry, const float* __restrict__ nvalid_src,
    gn::SolveArgs args, float* __restrict__ partials,
    unsigned int* __restrict__ ticket) {
  __shared__ float pose[12];  // rows 0..2 of T
  __shared__ float warp_sums[gn::kWarps][gn::kRow];
  __shared__ float sums[gn::kRow];
  __shared__ bool is_last;

  if (carry[gn::kDone] != 0.0f) return;
  if (threadIdx.x < 12) pose[threadIdx.x] = carry[gn::kT + threadIdx.x];
  __syncthreads();
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];

  float acc[gn::kSums];
#pragma unroll
  for (int k = 0; k < gn::kSums; ++k) acc[k] = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
    const float x0 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r00, p0), __fmul_rn(r01, p1)),
                  __fmul_rn(r02, p2)), t0);
    const float x1 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r10, p0), __fmul_rn(r11, p1)),
                  __fmul_rn(r12, p2)), t1);
    const float x2 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r20, p0), __fmul_rn(r21, p1)),
                  __fmul_rn(r22, p2)), t2);
    gn::accumulate_point(acc, x0, x1, x2, q[3 * i], q[3 * i + 1],
                         q[3 * i + 2], nrm[3 * i], nrm[3 * i + 1],
                         nrm[3 * i + 2], wv[i], huber);
  }
  gn::block_reduce_row(acc, warp_sums, partials + blockIdx.x * gn::kRow);

  // the last block to finish folds every block's row
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  gn::fold_rows(partials, gridDim.x, warp_sums, sums);
  if (threadIdx.x < 32)
    gn::solve_and_update(sums, carry, nvalid_src[0], args, carry, nullptr);
}

}  // namespace

extern "C" int tpuslam_gn_step(const void* pts, const void* q,
                               const void* nrm, const void* w, int n,
                               float huber, void* carry,
                               const void* nvalid_src, float damping,
                               float damping_abs, float max_trans,
                               float max_rot, int is_last, int inner,
                               int max_iters, float tol_sq, void* partials,
                               void* ticket, int num_blocks, void* stream) {
  const gn::SolveArgs args{damping, damping_abs, max_trans, max_rot,
                           is_last, inner, max_iters, tol_sq};
  gn_step_kernel<<<num_blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)q, (const float*)nrm, (const float*)w,
      n, huber, (float*)carry, (const float*)nvalid_src, args,
      (float*)partials, (unsigned int*)ticket);
  return (int)cudaGetLastError();
}
