// The GN-step epilogue: fold the reduction's partials, damped 6x6 solve,
// trust region, SE(3) exp, compose, and the ICP loop's carry update, in
// one launch.
//
// Replaces: tpuslam/kernels/pallas_epilogue.py, _kernel (via
//   gn_epilogue_pallas), math in _epilogue_math.  The scalar code
//   (gn_solve.cuh's solve_and_update, shared with gn_step.cu) is that
//   function op for op: H and b from the 30 sums; damping
//   lambda*diag(H) + (lambda_abs*tr(H)/6 + 1e-9)*I; Gauss elimination on
//   the 6x7 augmented system without pivoting, masked exactly as the
//   reference masks it (so inf/NaN propagate the same way); the two-stage
//   non-finite guard; the trust region on |rho| and |phi|; exp through the
//   so(3) generator with the sinc series below theta^2 < 0.0625; and
//   T_new = exp(delta) * T.
//
// It also owns the ICP loop's carry (layout in kernels/gn_epilogue.py):
//   once carry[DONE] is set it copies the carry through unchanged; after
//   the last inner solve of an outer iteration it advances `it` and sets
//   DONE = !(it < max_iters && delta^2 > tol^2), the reference's
//   while-loop predicate, so the loop needs no host synchronisation.
//
// What bounds it on the H100: latency.  It reads (num_blocks x 32) floats
//   (34 KB at the finest level) and does a few hundred flops of serial
//   scalar math; a launch is a few microseconds and that is the floor.
//
// What the design does about it: one block of 256 threads.  The fold is
//   parallel and in a fixed order (gn_solve.cuh's fold_rows): each of the
//   8 warps adds its contiguous share of the rows, lane = column, and the
//   warp sums are added in warp order, so the chain of dependent L2 loads
//   is num_blocks / 8 deep instead of num_blocks, and each warp has 16
//   rows' loads in flight at once.  Warp 0 then runs the solve in
//   registers, the elimination spread over its lanes (one row a lane).
//   Everything the old ~100 tiny XLA ops did is this one launch.
//
// The ICP loop on one card calls gn_step.cu, and the fused loop gn_fused.cu,
// each of which does this fold and solve in the same launch as its
// reduction.  This kernel serves only the ring ICP, after the all-reduce of
// gn_partials.cu's rows.

#include <cuda_runtime.h>

#include "gn_solve.cuh"

namespace {

__global__ void __launch_bounds__(gn::kThreads) gn_epilogue_kernel(
    const float* __restrict__ partials, int num_blocks,
    const float* __restrict__ carry_in, const float* __restrict__ nvalid_src,
    gn::SolveArgs args, float* __restrict__ carry_out,
    float* __restrict__ step_out) {
  __shared__ float warp_sums[gn::kWarps][gn::kRow];
  __shared__ float sums[gn::kRow];
  gn::fold_rows(partials, num_blocks, warp_sums, sums);
  if (threadIdx.x < 32)
    gn::solve_and_update(sums, carry_in, nvalid_src[0], args, carry_out,
                         step_out);
}

}  // namespace

extern "C" int tpuslam_gn_epilogue(
    const void* partials, int num_blocks, const void* carry_in,
    const void* nvalid_src, float damping, float damping_abs, float max_trans,
    float max_rot, int is_last, int inner, int max_iters, float tol_sq,
    void* carry_out, void* step_out, void* stream) {
  const gn::SolveArgs args{damping, damping_abs, max_trans, max_rot,
                           is_last, inner, max_iters, tol_sq};
  gn_epilogue_kernel<<<1, gn::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, num_blocks, (const float*)carry_in,
      (const float*)nvalid_src, args, (float*)carry_out, (float*)step_out);
  return (int)cudaGetLastError();
}
