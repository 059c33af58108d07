// Projective association gather: one 16-byte float16 row per source point.
//
// Replaces: the XLA gather of tpuslam/kernels/correspond.py,
//   projective_correspond_packed (project -> round -> bounds/front gates ->
//   packed[flat] -> distance/validity/normal gates).  Not a Pallas kernel in
//   the reference, but the hottest step of every ICP iteration there.
//
// What bounds it on the H100: bytes, and the latency of a dependent random
//   read.  Per point it reads 40 B of source data (x, n_rot, mask), gathers
//   one 16 B table row and writes 32 B (q, n, w, flat): ~90 B/point, 14 MB
//   for the finest level's 153,600 points, i.e. ~4 us at 3.35 TB/s.  The
//   table (4.9 MB at 640x480 in float16) fits the 50 MB L2, so the gathers
//   hit L2 after the first touch; what is left is one load-to-use latency
//   per thread.
//
// What the design does about it: one thread per point, one 16-byte vector
//   load (uint4) per row, so every gather is a single L2 transaction; the
//   table stays float16 (half the bytes of float32) and is widened in
//   registers with __half2float.  The source arrays are read as
//   interleaved (N, 3) float rows: neighbouring threads read neighbouring
//   12-byte records, which coalesce into whole cache lines.
//
// Numerics: the projection is written with __fdiv_rn / __fmul_rn /
//   __fadd_rn so nvcc cannot contract it into an FMA (an FMA can move a
//   point on a half-pixel boundary to the neighbouring pixel), and the
//   rounding is __float2int_rn (round half to even, like jnp.round and
//   torch.round).  The plain PyTorch twin in kernels/correspond.py then
//   gives bit-equal q, n, flat and w.
//
// The kernel skips all work when *done != 0 (the ICP loop's device-side
// early exit); its outputs are then left unwritten and nothing reads them.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void correspond_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ x_mask,
    const float* __restrict__ n_src, const uint4* __restrict__ packed,
    int n, int height, int width, float fx, float fy, float cx, float cy,
    float max_dist_sq, float normal_dot_min, int use_normal_gate,
    const float* __restrict__ done, float* __restrict__ q_out,
    float* __restrict__ n_out, float* __restrict__ w_out,
    int* __restrict__ flat_out) {
  if (done != nullptr && done[0] != 0.0f) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float x0 = x[3 * i + 0], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
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
    float s0 = n_src[3 * i + 0], s1 = n_src[3 * i + 1], s2 = n_src[3 * i + 2];
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
    const void* x, const void* x_mask, const void* n_src, const void* packed,
    int n, int height, int width, float fx, float fy, float cx, float cy,
    float max_dist_sq, float normal_dot_min, int use_normal_gate,
    const void* done, void* q_out, void* n_out, void* w_out, void* flat_out,
    void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  correspond_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)x_mask, (const float*)n_src,
      (const uint4*)packed, n, height, width, fx, fy, cx, cy, max_dist_sq,
      normal_dot_min, use_normal_gate, (const float*)done, (float*)q_out,
      (float*)n_out, (float*)w_out, (int*)flat_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tpuslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
