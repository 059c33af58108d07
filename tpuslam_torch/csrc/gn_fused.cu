// Fused projective GN step: gates + residual + Huber + 30-sum reduction,
// with the association's row gather inside the kernel.
//
// Replaces: tpuslam/kernels/gn_fused.py, _kernel (via gn_fused_pallas; math
//   in _gates_and_residual and _reduce_outputs).  Per source point:
//     x_g = R_g p + t_g                    gate-time transform (association pose)
//     u, v = round(project(x_g)); bounds   in-bounds gate, re-derived here
//     row  = table[flat]                   16-byte float16 (or 32-byte float32) row
//     n_r  = R_g n_src                     normal-compatibility gate
//     w    = mask * row_valid * gates      {0, 1} validity
//     x_r  = R_r p + t_r                   residual-time transform (current pose)
//     r    = n.(x_r - q); Huber; J = [n, x_r x n]
//   reduced to the 30 sums of gn_partials.cu (21 upper-triangle H, 6 b,
//   sum w r^2, sum validity, sum w), same order, same (num_blocks, 32) table,
//   which gn_epilogue.cu then folds and solves.
//
// What bounds it on the H100: bytes and one dependent random read.  Per
//   point it reads 28 B of source data (p, n_src, mask), 4 B of row index
//   and one 16 B table row, ~210 flops; the finest level's 153,600 points
//   are ~7 MB, about 2 us at 3.35 TB/s.  The table (4.9 MB at 640x480,
//   float16) stays in the 50 MB L2 across an ICP loop.
//
// What the design does about it: one thread per point in a grid-stride
//   loop, the row gather is a single 16-byte load into registers (the
//   reference materializes an (N, 8) gathered array between two passes;
//   here it never leaves registers), and the 30 accumulators stay in
//   registers until the fixed-order block reduction of gn_partials.cu (warp
//   shuffles, then warps in order).  No atomics: bitwise reproducible.
//
// The two poses are read from device memory (T_gate: the pose at the
//   association, T_res: the freshly updated pose; rows 0-2 of row-major 4x4
//   matrices), so an ICP loop never builds a parameter vector on the host.
//
// Numerics: the gate-time transform, the projection and the gate products
//   are written with __fmul_rn / __fadd_rn / __fdiv_rn in the reference's
//   left-to-right order, so nvcc cannot contract them into FMAs, and the
//   rounding is rintf (round half to even, like jnp.round / torch.round).
//   The validity w is then bit-equal to the plain PyTorch twin's
//   (kernels/gn_fused.py).  The projection here is not the one that chose
//   `flat` (the caller's); a point on a half-pixel boundary can be gated
//   against its neighbour's row, as in the reference (tpuslam/icp.py:268).
//
// When *done != 0 (the ICP loop's device-side early exit) each block writes
// a zero row and reads no input.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;
constexpr int kRow = 32;

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

__global__ void __launch_bounds__(kThreads) gn_fused_kernel(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const uint8_t* __restrict__ mask, const void* __restrict__ table,
    int table_f16, const int* __restrict__ flat, int n,
    const float* __restrict__ T_gate, const float* __restrict__ T_res,
    float fx, float fy, float cx, float cy, float u_max, float v_max,
    float max_d2, float nd_min, float huber, const float* __restrict__ done,
    float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps][kRow];
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const bool skip = (done != nullptr) && (done[0] != 0.0f);
  if (!skip) {
    float rg[9], tg[3], rr[9], tr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        rg[3 * a + b] = T_gate[4 * a + b];
        rr[3 * a + b] = T_res[4 * a + b];
      }
      tg[a] = T_gate[4 * a + 3];
      tr[a] = T_res[4 * a + 3];
    }
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
      const float s0 = nrm[3 * i], s1 = nrm[3 * i + 1], s2 = nrm[3 * i + 2];

      // gate-time transform and projection gates
      const float xg0 = affine_row(rg + 0, p0, p1, p2, tg[0]);
      const float xg1 = affine_row(rg + 3, p0, p1, p2, tg[1]);
      const float xg2 = affine_row(rg + 6, p0, p1, p2, tg[2]);
      const bool in_front = xg2 > 1e-6f;
      const float zs = in_front ? xg2 : 1.0f;
      const float u = __fadd_rn(__fmul_rn(__fdiv_rn(xg0, zs), fx), cx);
      const float v = __fadd_rn(__fmul_rn(__fdiv_rn(xg1, zs), fy), cy);
      const float ui = rintf(u), vi = rintf(v);
      const bool in_bounds =
          (ui >= 0.0f) && (ui <= u_max) && (vi >= 0.0f) && (vi <= v_max);

      // the association's row, widened in registers
      float row[7];
      const int f = flat[i];
      if (table_f16) {
        const uint4 raw = reinterpret_cast<const uint4*>(table)[f];
        const __half* h = reinterpret_cast<const __half*>(&raw);
#pragma unroll
        for (int k = 0; k < 7; ++k) row[k] = __half2float(h[k]);
      } else {
        const float4* t = reinterpret_cast<const float4*>(table) + 2 * f;
        const float4 a = t[0], b = t[1];
        row[0] = a.x; row[1] = a.y; row[2] = a.z; row[3] = a.w;
        row[4] = b.x; row[5] = b.y; row[6] = b.z;
      }
      const float q0 = row[0], q1 = row[1], q2 = row[2];
      const float n0 = row[3], n1 = row[4], n2 = row[5];

      // distance and normal-compatibility gates at the gate-time pose
      const float dq0 = __fsub_rn(xg0, q0), dq1 = __fsub_rn(xg1, q1),
                  dq2 = __fsub_rn(xg2, q2);
      const float d2 = dot3(dq0, dq1, dq2, dq0, dq1, dq2);
      const float nr0 = dot3(rg[0], rg[1], rg[2], s0, s1, s2);
      const float nr1 = dot3(rg[3], rg[4], rg[5], s0, s1, s2);
      const float nr2 = dot3(rg[6], rg[7], rg[8], s0, s1, s2);
      const float ndot = dot3(n0, n1, n2, nr0, nr1, nr2);
      const bool valid = (mask[i] != 0) && (row[6] > 0.5f) && in_front &&
                         in_bounds && (d2 < max_d2) && (ndot > nd_min);
      const float wv = valid ? 1.0f : 0.0f;

      // residual-time transform, residual, Huber, Jacobian
      const float xr0 = affine_row(rr + 0, p0, p1, p2, tr[0]);
      const float xr1 = affine_row(rr + 3, p0, p1, p2, tr[1]);
      const float xr2 = affine_row(rr + 6, p0, p1, p2, tr[2]);
      const float r = n0 * (xr0 - q0) + n1 * (xr1 - q1) + n2 * (xr2 - q2);
      const float ar = fabsf(r);
      const float hub = (ar <= huber) ? 1.0f : huber / fmaxf(ar, 1e-12f);
      const float w = wv * hub;
      const float j[6] = {n0, n1, n2, xr1 * n2 - xr2 * n1,
                          xr2 * n0 - xr0 * n2, xr0 * n1 - xr1 * n0};
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float wja = w * j[a];
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += wja * j[b];
      }
      const float wr = w * r;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += wr * j[a];
      acc[27] += wr * r;
      acc[28] += wv;
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

extern "C" int tpuslam_gn_fused(
    const void* pts, const void* nrm, const void* mask, const void* table,
    int table_f16, const void* flat, int n, const void* T_gate,
    const void* T_res, float fx, float fy, float cx, float cy, float u_max,
    float v_max, float max_d2, float nd_min, float huber, const void* done,
    void* partials, int num_blocks, void* stream) {
  gn_fused_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)nrm, (const uint8_t*)mask, table,
      table_f16, (const int*)flat, n, (const float*)T_gate,
      (const float*)T_res, fx, fy, cx, cy, u_max, v_max, max_d2, nd_min, huber,
      (const float*)done, (float*)partials);
  return (int)cudaGetLastError();
}
