// Projective association gather: one 16-byte float16 row per source point,
// with the source moved into the target camera by the loop carry's pose.
//
// Replaces: the XLA gather of tpuslam/kernels/correspond.py,
//   projective_correspond_packed (project -> round -> bounds/front gates ->
//   packed[flat] -> distance/validity/normal gates), and the two products in
//   front of it at tpuslam/icp.py:180-182 (x = se3.transform_points(T, p),
//   n_rot = se3.rotate_vectors(T, n)).  Not a Pallas kernel in the
//   reference, but the hottest step of every ICP iteration there.
//
// What bounds it on the H100: bytes, and the latency of a dependent random
//   read.  Per point it reads 12 B of source point, 12 B of source normal
//   and 1 B of mask (the 48 B pose once per block), gathers one 16 B table
//   row and writes 32 B (q, n, w, flat): ~73 B/point, 11.2 MB for the
//   finest level's 153,600 points, i.e. ~3.4 us at 3.35 TB/s, less the
//   table rows that repeat.  The table (4.9 MB at 640x480 in float16) fits
//   the 50 MB L2, so the gathers hit L2 after the first touch; what is left
//   is one load-to-use latency per thread.  ~50 float operations a point.
//
// What the design does about it: one thread per point, one 16-byte vector
//   load (uint4) per row, so every gather is a single L2 transaction; the
//   table stays float16 (half the bytes of float32) and is widened in
//   registers with __half2float.  The source arrays are read as
//   interleaved (N, 3) float rows: neighbouring threads read neighbouring
//   12-byte records, which coalesce into whole cache lines.  The pose is
//   applied in registers, so the two cuBLAS products and the add that used
//   to run in front of the kernel (and wrote x and n_rot to memory, for the
//   kernel to read back) are gone: one launch an outer ICP iteration.
//
// Numerics: the transform is x = ((R0 p0 + R1 p1) + R2 p2) + t and the
//   rotation ((R0 n0 + R1 n1) + R2 n2), each product and sum rounded with
//   __fmul_rn / __fadd_rn (kernels/gn_step.py's transform_points_ordered,
//   the order gn_step.cu uses), so the first GN solve of an outer iteration
//   sees the x this association used.  The projection is written with
//   __fdiv_rn / __fmul_rn / __fadd_rn so nvcc cannot contract it into an
//   FMA (an FMA can move a point on a half-pixel boundary to the
//   neighbouring pixel), and the rounding is __float2int_rn (round half to
//   even, like jnp.round and torch.round).  The plain PyTorch twins in
//   kernels/correspond.py then give bit-equal q, n, flat and w.
//
// The pose is required: the entry point refuses a null one with
// cudaErrorInvalidValue and launches nothing.  The kernel skips all work
// when *done != 0 (the ICP loop's device-side early exit): it reads nothing
// else and leaves its outputs unwritten, and nothing reads them.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) correspond_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ x_mask,
    const float* __restrict__ nrm, const float* __restrict__ pose,
    const uint4* __restrict__ packed, int n, int height, int width, float fx,
    float fy, float cx, float cy, float max_dist_sq, float normal_dot_min,
    int use_normal_gate, const float* __restrict__ done,
    float* __restrict__ q_out, float* __restrict__ n_out,
    float* __restrict__ w_out, int* __restrict__ flat_out) {
  __shared__ float T[12];  // rows 0..2 of the pose, row-major
  if (done != nullptr && done[0] != 0.0f) return;
  if (threadIdx.x < 12) T[threadIdx.x] = pose[threadIdx.x];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float p0 = pts[3 * i + 0], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
  const float x0 =
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], p0), __fmul_rn(T[1], p1)),
                          __fmul_rn(T[2], p2)), T[3]);
  const float x1 =
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4], p0), __fmul_rn(T[5], p1)),
                          __fmul_rn(T[6], p2)), T[7]);
  const float x2 =
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[8], p0), __fmul_rn(T[9], p1)),
                          __fmul_rn(T[10], p2)), T[11]);
  bool in_front = x2 > 1e-6f;
  float zs = in_front ? x2 : 1.0f;
  float u = __fadd_rn(__fmul_rn(__fdiv_rn(x0, zs), fx), cx);
  float v = __fadd_rn(__fmul_rn(__fdiv_rn(x1, zs), fy), cy);
  int ui = __float2int_rn(u);
  int vi = __float2int_rn(v);
  bool in_bounds = (ui >= 0) && (ui < width) && (vi >= 0) && (vi < height);
  int uc = min(max(ui, 0), width - 1);
  int vc = min(max(vi, 0), height - 1);
  int flat = vc * width + uc;

  uint4 raw = packed[flat];
  const __half* row = reinterpret_cast<const __half*>(&raw);
  float q0 = __half2float(row[0]), q1 = __half2float(row[1]),
        q2 = __half2float(row[2]);
  float m0 = __half2float(row[3]), m1 = __half2float(row[4]),
        m2 = __half2float(row[5]);
  bool dmask = __half2float(row[6]) > 0.5f;

  float d0 = __fsub_rn(x0, q0), d1 = __fsub_rn(x1, q1), d2 = __fsub_rn(x2, q2);
  float dist_sq = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                            __fmul_rn(d2, d2));
  bool valid = (x_mask[i] != 0) && in_front && in_bounds && dmask &&
               (dist_sq < max_dist_sq);
  if (use_normal_gate) {
    const float a0 = nrm[3 * i + 0], a1 = nrm[3 * i + 1], a2 = nrm[3 * i + 2];
    const float s0 = __fadd_rn(__fadd_rn(__fmul_rn(T[0], a0),
                                         __fmul_rn(T[1], a1)),
                               __fmul_rn(T[2], a2));
    const float s1 = __fadd_rn(__fadd_rn(__fmul_rn(T[4], a0),
                                         __fmul_rn(T[5], a1)),
                               __fmul_rn(T[6], a2));
    const float s2 = __fadd_rn(__fadd_rn(__fmul_rn(T[8], a0),
                                         __fmul_rn(T[9], a1)),
                               __fmul_rn(T[10], a2));
    float dot = __fadd_rn(__fadd_rn(__fmul_rn(m0, s0), __fmul_rn(m1, s1)),
                          __fmul_rn(m2, s2));
    valid = valid && (dot > normal_dot_min);
  }

  q_out[3 * i + 0] = q0;
  q_out[3 * i + 1] = q1;
  q_out[3 * i + 2] = q2;
  n_out[3 * i + 0] = m0;
  n_out[3 * i + 1] = m1;
  n_out[3 * i + 2] = m2;
  w_out[i] = valid ? 1.0f : 0.0f;
  flat_out[i] = flat;
}

}  // namespace

extern "C" int tpuslam_correspond(
    const void* pts, const void* x_mask, const void* nrm, const void* pose,
    const void* packed, int n, int height, int width, float fx, float fy,
    float cx, float cy, float max_dist_sq, float normal_dot_min,
    int use_normal_gate, const void* done, void* q_out, void* n_out,
    void* w_out, void* flat_out, void* stream) {
  if (pose == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  correspond_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const uint8_t*)x_mask, (const float*)nrm,
      (const float*)pose, (const uint4*)packed, n, height, width, fx, fy, cx,
      cy, max_dist_sq, normal_dot_min, use_normal_gate, (const float*)done,
      (float*)q_out, (float*)n_out, (float*)w_out, (int*)flat_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tpuslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
