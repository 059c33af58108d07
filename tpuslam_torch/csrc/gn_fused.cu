// One Gauss-Newton solve of the fused projective ICP loop in one launch:
// each source point's association row, its gates at the association pose,
// its residual at the current pose, the 30-sum reduction, then the last
// block's fold and solve and the carry's update in place.
//
// Replaces: tpuslam/kernels/gn_fused.py, _kernel (called at :301 through
//   gn_fused_pallas; math in _gates_and_residual and _reduce_outputs), and
//   what surrounds it in the reference's fused loop (tpuslam/icp.py:252-290):
//   the association index (transform, project, round, clip), the gather
//   packed[flat], and solve_gn_step + se3.exp after every solve.  Per point:
//     x_g  = R_g p + t_g                 gate-time transform (association pose)
//     u, v = round(project(x_g))         in-bounds gate
//     flat = clip(v) * W + clip(u)       the association's row index
//     row  = table[flat]                 16-byte float16 (32-byte float32) row
//     n_r  = R_g n_src                   normal-compatibility gate
//     w    = mask * row_valid * gates    {0, 1} validity
//     x_r  = R_r p + t_r                 residual-time transform (current pose)
//     r    = n.(x_r - q); Huber; J = [n, x_r x n]; the 30 sums
//   then gn_solve.cuh's fold and solve, as in gn_step.cu.
//
// The poses come from the device.  The residual pose is the carry's T (rows
//   0-2).  The gate pose is the carry's T on the first solve of an outer
//   iteration (is_first); that solve's last block also stores it in a
//   12-float buffer, from which the outer iteration's later solves read it.
//
// What bounds it on the H100: bytes and two dependent memory trips a point.
//   A point reads 41 B: p 12, n_src 12, mask 1 and one 16 B table row (the
//   old design also read a 4 B row index, which a cuBLAS transform and ~19
//   small ops wrote first).  The finest level's 153,600 points are 6.3 MB,
//   1.9 us at 3.35 TB/s; ~170 flops a point.  The table (4.9 MB at 640x480
//   in float16) stays in the 50 MB L2 across an ICP loop, so the gather hits
//   L2, but it waits on the projection, which waits on the point's own
//   load.  After the reduction come the last block's fold and the one-warp
//   solve (about 4.5 us of dependent steps, gn_step.cu's).
//
// What the design does about it:
//   - One launch a solve and nothing else an outer iteration: the index
//     array, its transform, the carry's copy, the partials' allocation and
//     the standalone epilogue launch of the old design are gone.
//   - One point a thread per grid-stride step; its row gather is one
//     16-byte load into registers.  A variant with two points in flight a
//     thread (both points' loads and gathers issued before either was
//     added) was no faster on the card and took more registers.
//   - The grid is one block an SM (kernels/gn_step.py): the last block
//     folds half the rows of a two-blocks-an-SM grid.
//   - Each block reduces its 30 accumulators to one 32-float row (warp
//     shuffles, warps in order), fences and draws a ticket; atomicInc with
//     the limit gridDim.x - 1 gives the last block that ticket and stores 0
//     for the next launch.  The last block folds every row in a fixed order
//     and warp 0 solves and updates the carry (gn_solve.cuh), so every run
//     gives the same bits.
//   - After DONE (carry[0] != 0 at entry) every block returns before it
//     reads a point, touches the ticket or writes anything.  In place is
//     safe: every block reads the poses and DONE before it draws its
//     ticket, only the last block writes, and the gate buffer is read only
//     by solves that do not write it (is_first false).
//
// Numerics: the transforms, the projection and the gate products are
//   written with __fmul_rn / __fadd_rn / __fdiv_rn in the reference's
//   left-to-right order (se3.transform_points_ordered's for the
//   transforms), so nvcc cannot contract them into FMAs, and the rounding
//   is rintf (round half to even, like jnp.round / torch.round).  The
//   validity w and the row index are then bit-equal to the plain PyTorch
//   twin's (kernels/gn_fused.py).  The index comes from the projection that
//   gates the point, so a point is always gated against its own row; the
//   reference derives its index from another projection (XLA's) and can
//   gate a point on an exact half-pixel boundary against its neighbour's
//   row (tpuslam/icp.py:268-278).  The two indices differ for a measured
//   share of points (tests/test_torch_gn_fused.py, ROADMAP.md Queue 3).
//
// The ticket word and the rows' scratch are kernels/gn_step.py's, one of
// each per stream: two launches that share them run in order on their
// stream, and launches on two streams get scratch of their own.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_solve.cuh"

namespace {

// ((r[0]*a + r[1]*b) + r[2]*c) + t with every operation rounded on its own.
__device__ __forceinline__ float affine_row(const float* r, float a, float b,
                                            float c, float t) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], a), __fmul_rn(r[1], b)),
                __fmul_rn(r[2], c)),
      t);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

struct FusedArgs {
  int n, height, width, table_f16, is_first;
  float fx, fy, cx, cy, max_d2, nd_min, huber;
};

__global__ void __launch_bounds__(gn::kThreads) gn_fused_step_kernel(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const uint8_t* __restrict__ mask, const void* __restrict__ table,
    FusedArgs fa, float* carry, float* gate,
    const float* __restrict__ nvalid_src, gn::SolveArgs args,
    float* __restrict__ partials, unsigned int* __restrict__ ticket) {
  __shared__ float pose[24];  // rows 0..2 of the gate pose, then of T
  __shared__ float warp_sums[gn::kWarps][gn::kRow];
  __shared__ float sums[gn::kRow];
  __shared__ bool is_last;

  if (carry[gn::kDone] != 0.0f) return;
  if (threadIdx.x < 12) {
    const float t = carry[gn::kT + threadIdx.x];
    pose[12 + threadIdx.x] = t;
    pose[threadIdx.x] = fa.is_first ? t : gate[threadIdx.x];
  }
  __syncthreads();
  float rg[9], tg[3], rr[9], tr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      rg[3 * a + b] = pose[4 * a + b];
      rr[3 * a + b] = pose[12 + 4 * a + b];
    }
    tg[a] = pose[4 * a + 3];
    tr[a] = pose[12 + 4 * a + 3];
  }
  const float u_max = (float)(fa.width - 1), v_max = (float)(fa.height - 1);

  float acc[gn::kSums];
#pragma unroll
  for (int k = 0; k < gn::kSums; ++k) acc[k] = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < fa.n; i += stride) {
    const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
    const float s0 = nrm[3 * i], s1 = nrm[3 * i + 1], s2 = nrm[3 * i + 2];
    const bool msk = mask[i] != 0;
    // gate-time transform, projection, in-bounds gate and the row index
    float xg[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      xg[a] = affine_row(rg + 3 * a, p0, p1, p2, tg[a]);
    const bool front = xg[2] > 1e-6f;
    const float zs = front ? xg[2] : 1.0f;
    const float u = __fadd_rn(__fmul_rn(__fdiv_rn(xg[0], zs), fa.fx), fa.cx);
    const float v = __fadd_rn(__fmul_rn(__fdiv_rn(xg[1], zs), fa.fy), fa.cy);
    const float ui = rintf(u), vi = rintf(v);
    const bool inb =
        (ui >= 0.0f) && (ui <= u_max) && (vi >= 0.0f) && (vi <= v_max);
    // the pixel clipped to the image; a NaN coordinate clips to 0, as XLA's
    // float-to-int conversion gives it
    const int uc = (int)fminf(fmaxf(ui, 0.0f), u_max);
    const int vc = (int)fminf(fmaxf(vi, 0.0f), v_max);
    const int flat = vc * fa.width + uc;
    float row[7];
    if (fa.table_f16) {
      const uint4 raw = reinterpret_cast<const uint4*>(table)[flat];
      const __half* h = reinterpret_cast<const __half*>(&raw);
#pragma unroll
      for (int c = 0; c < 7; ++c) row[c] = __half2float(h[c]);
    } else {
      const float4* t = reinterpret_cast<const float4*>(table) + 2 * flat;
      const float4 a = t[0], b = t[1];
      row[0] = a.x; row[1] = a.y; row[2] = a.z; row[3] = a.w;
      row[4] = b.x; row[5] = b.y; row[6] = b.z;
    }
    // a gated point is added with w = 0 (so a non-finite point still turns
    // the sums non-finite)
    const float q0 = row[0], q1 = row[1], q2 = row[2];
    const float n0 = row[3], n1 = row[4], n2 = row[5];
    const float dq0 = __fsub_rn(xg[0], q0), dq1 = __fsub_rn(xg[1], q1),
                dq2 = __fsub_rn(xg[2], q2);
    const float d2 = dot3(dq0, dq1, dq2, dq0, dq1, dq2);
    const float nr0 = dot3(rg[0], rg[1], rg[2], s0, s1, s2);
    const float nr1 = dot3(rg[3], rg[4], rg[5], s0, s1, s2);
    const float nr2 = dot3(rg[6], rg[7], rg[8], s0, s1, s2);
    const float ndot = dot3(n0, n1, n2, nr0, nr1, nr2);
    const bool valid = msk && (row[6] > 0.5f) && front && inb &&
                       (d2 < fa.max_d2) && (ndot > fa.nd_min);
    float xr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      xr[a] = affine_row(rr + 3 * a, p0, p1, p2, tr[a]);
    gn::accumulate_point(acc, xr[0], xr[1], xr[2], q0, q1, q2, n0, n1, n2,
                         valid ? 1.0f : 0.0f, fa.huber);
  }
  gn::block_reduce_row(acc, warp_sums, partials + blockIdx.x * gn::kRow);

  // the last block to finish folds every block's row and solves
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  gn::fold_rows(partials, gridDim.x, warp_sums, sums);
  if (threadIdx.x < 32) {
    // the association pose, for the outer iteration's later solves
    if (fa.is_first && threadIdx.x < 12) gate[threadIdx.x] = pose[threadIdx.x];
    gn::solve_and_update(sums, carry, nvalid_src[0], args, carry, nullptr);
  }
}

}  // namespace

extern "C" int tpuslam_gn_fused_step(
    const void* pts, const void* nrm, const void* mask, const void* table,
    int table_f16, int n, int height, int width, float fx, float fy, float cx,
    float cy, float max_d2, float nd_min, float huber, void* carry, void* gate,
    int is_first, const void* nvalid_src, float damping, float damping_abs,
    float max_trans, float max_rot, int is_last, int inner, int max_iters,
    float tol_sq, void* partials, void* ticket, int num_blocks,
    void* stream) {
  const FusedArgs fa{n,  height, width, table_f16, is_first, fx,
                     fy, cx,     cy,    max_d2,    nd_min,   huber};
  const gn::SolveArgs args{damping, damping_abs, max_trans, max_rot,
                           is_last, inner, max_iters, tol_sq};
  gn_fused_step_kernel<<<num_blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)nrm, (const uint8_t*)mask, table, fa,
      (float*)carry, (float*)gate, (const float*)nvalid_src, args,
      (float*)partials, (unsigned int*)ticket);
  return (int)cudaGetLastError();
}
