// Depth preprocessing: a depth frame's whole pyramid [finest..coarsest] of
// organized points, normals and masks in one launch.
//
// Replaces no Pallas kernel.  The reference writes preprocessing as jnp
// (tpuslam/frontend.py preprocess: tpuslam/geom/backproject.py backproject
// and tpuslam/geom/normals.py organized_normals at every level), which XLA
// fuses into a few kernels.  Run op by op, the port's PyTorch twin
// (kernels/preprocess.py preprocess_reference) is ~220 kernels a VGA frame
// at three levels: rolls, stacks, three-wide sums and elementwise passes
// over (H, W, 3) tensors, each launch costing more than its bytes.
//
// What bounds it on the H100: bytes.  It reads the finest depth once
//   (1.23 MB of float32 at 640x480) and writes 25 B a pixel of every level
//   (points and normals as (H, W, 3) float32, the mask as one byte):
//   403,200 pixels at three levels, 10.08 MB, 3.4 us at 3.35 TB/s.  ~60
//   float operations a pixel.
//
// What the design does about it: one thread an output pixel of every
//   level, the levels laid end to end over one grid.  Level l's pixel
//   (v, u) reads the finest depth at (v 2^l, u 2^l) (the composition of
//   the twin's [::2, ::2] slices), so no decimated plane is written.  A
//   thread backprojects its pixel and its four neighbours in registers;
//   the neighbours' depths are the next threads' own, so they come from L1
//   or L2 and each depth byte comes from device memory about once.
//   Nothing is staged through device memory between the steps.
//
// Numerics: bit-equal to the twin's eager PyTorch ops on the same CUDA
//   tensors.  Every rounding step is written with __fsub_rn, __fmul_rn,
//   __fdiv_rn, __fadd_rn and __fsqrt_rn, so nvcc cannot contract a
//   multiply and an add into an FMA, in the twin's order:
//   x = ((u - cx) / fx) * z, the depth gates, central differences, the
//   discontinuity gates, the cross product, the norm, the normalisation,
//   the orientation flip and the border (every pixel the twin's roll
//   wraps).  The two three-wide sums (n.n and n.p) add as PyTorch's CUDA
//   reduction does for a contiguous 3-wide row: two threads a row, the
//   first adding elements 0 and 2, then the second's element 1, so
//   (x0 + x2) + x1.  The intrinsics and gates arrive rounded to float32 on
//   the host, as PyTorch rounds a Python scalar.  uint16 counts are
//   divided by the depth scale with an IEEE divide, as the twin's divide
//   by a 0-d device tensor is.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

struct Level {
  float fx, fy, cx, cy;  // the level's intrinsics
  int h, w;
  int shift;             // log2 of the level's stride into the finest depth
  int start;             // the level's first thread
  float* pts;            // (h, w, 3)
  float* nrm;            // (h, w, 3)
  uint8_t* mask;         // (h, w)
};

struct Params {
  const void* depth;
  long long sv, su;      // the depth's strides, in elements
  float scale;           // uint16 counts a metre
  float dmin, dmax;      // the depth gates
  float disc;            // the normals' discontinuity gate
  float eps;             // the normals' least norm
  int levels, total;
  Level lv[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ float to_metres(T raw, float scale);

template <>
__device__ __forceinline__ float to_metres<float>(float raw, float) {
  return raw;
}

template <>
__device__ __forceinline__ float to_metres<double>(double raw, float) {
  return __double2float_rn(raw);
}

template <>
__device__ __forceinline__ float to_metres<__half>(__half raw, float) {
  return __half2float(raw);
}

template <>
__device__ __forceinline__ float to_metres<uint16_t>(uint16_t raw,
                                                     float scale) {
  return __fdiv_rn(__uint2float_rn(raw), scale);
}

struct Point {
  float x, y, z;
  bool ok;
};

// Pixel (v, u) of level L, backprojected: zeros where the depth gates fail.
template <typename T>
__device__ __forceinline__ Point backproject(const Params& p, const Level& L,
                                             int v, int u) {
  const T* d = static_cast<const T*>(p.depth);
  const float z = to_metres<T>(
      d[(static_cast<long long>(v) << L.shift) * p.sv +
        (static_cast<long long>(u) << L.shift) * p.su],
      p.scale);
  Point q;
  q.ok = z > p.dmin && z < p.dmax && isfinite(z);
  if (!q.ok) {
    q.x = q.y = q.z = 0.0f;
    return q;
  }
  q.x = __fmul_rn(__fdiv_rn(__fsub_rn(__int2float_rn(u), L.cx), L.fx), z);
  q.y = __fmul_rn(__fdiv_rn(__fsub_rn(__int2float_rn(v), L.cy), L.fy), z);
  q.z = z;
  return q;
}

// torch.sum over a contiguous 3-wide row on CUDA.
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    preprocess_kernel(const __grid_constant__ Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.total) return;
  int l = 0;
  while (l + 1 < p.levels && i >= p.lv[l + 1].start) ++l;
  const Level& L = p.lv[l];
  const int j = i - L.start;
  const int v = j / L.w;
  const int u = j - v * L.w;

  const Point c = backproject<T>(p, L, v, u);
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  bool good = false;
  if (c.ok && v >= 1 && v <= L.h - 2 && u >= 1 && u <= L.w - 2) {
    const Point r = backproject<T>(p, L, v, u + 1);
    const Point f = backproject<T>(p, L, v, u - 1);
    const Point dn = backproject<T>(p, L, v + 1, u);
    const Point up = backproject<T>(p, L, v - 1, u);
    if (r.ok && f.ok && dn.ok && up.ok) {
      const float du0 = __fsub_rn(r.x, f.x), du1 = __fsub_rn(r.y, f.y),
                  du2 = __fsub_rn(r.z, f.z);
      const float dv0 = __fsub_rn(dn.x, up.x), dv1 = __fsub_rn(dn.y, up.y),
                  dv2 = __fsub_rn(dn.z, up.z);
      const bool ok_u = fabsf(__fsub_rn(r.z, c.z)) < p.disc &&
                        fabsf(__fsub_rn(f.z, c.z)) < p.disc;
      const bool ok_v = fabsf(__fsub_rn(dn.z, c.z)) < p.disc &&
                        fabsf(__fsub_rn(up.z, c.z)) < p.disc;
      const float m0 = __fsub_rn(__fmul_rn(du1, dv2), __fmul_rn(du2, dv1));
      const float m1 = __fsub_rn(__fmul_rn(du2, dv0), __fmul_rn(du0, dv2));
      const float m2 = __fsub_rn(__fmul_rn(du0, dv1), __fmul_rn(du1, dv0));
      const float norm = __fsqrt_rn(
          sum3(__fmul_rn(m0, m0), __fmul_rn(m1, m1), __fmul_rn(m2, m2)));
      good = ok_u && ok_v && norm > p.eps;
      if (good) {
        // norm > eps, so the twin's clamp(norm, min=eps) is norm
        n0 = __fdiv_rn(m0, norm);
        n1 = __fdiv_rn(m1, norm);
        n2 = __fdiv_rn(m2, norm);
        if (sum3(__fmul_rn(n0, c.x), __fmul_rn(n1, c.y),
                 __fmul_rn(n2, c.z)) > 0.0f) {
          n0 = -n0;
          n1 = -n1;
          n2 = -n2;
        }
      }
    }
  }
  L.pts[3 * j + 0] = c.x;
  L.pts[3 * j + 1] = c.y;
  L.pts[3 * j + 2] = c.z;
  L.nrm[3 * j + 0] = n0;
  L.nrm[3 * j + 1] = n1;
  L.nrm[3 * j + 2] = n2;
  L.mask[j] = good ? 1 : 0;
}

template <typename T>
void launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.total + kThreads - 1) / kThreads;
  preprocess_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 uint16 (counts, divided by `scale`),
// 3 float64; sv and su the depth's strides in elements.  Host arrays:
// intr, levels x (fx, fy, cx, cy) floats; pts, nrm and mask, each level's
// output (a device pointer a level).  Level l is ceil(h / 2^l) x
// ceil(w / 2^l).
extern "C" int tpuslam_preprocess(
    const void* depth, int dtype, int h, int w, int sv, int su, float scale,
    float dmin, float dmax, float disc, float eps, int levels,
    const void* intr, const void* pts, const void* nrm, const void* mask,
    void* stream) {
  if (levels < 1 || levels > kMaxLevels || dtype < 0 || dtype > 3)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.depth = depth;
  p.sv = sv;
  p.su = su;
  p.scale = scale;
  p.dmin = dmin;
  p.dmax = dmax;
  p.disc = disc;
  p.eps = eps;
  p.levels = levels;
  const float* k = static_cast<const float*>(intr);
  void* const* out_pts = static_cast<void* const*>(pts);
  void* const* out_nrm = static_cast<void* const*>(nrm);
  void* const* out_mask = static_cast<void* const*>(mask);
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    Level& L = p.lv[l];
    L.fx = k[4 * l + 0];
    L.fy = k[4 * l + 1];
    L.cx = k[4 * l + 2];
    L.cy = k[4 * l + 3];
    L.h = h;
    L.w = w;
    L.shift = l;
    L.start = start;
    L.pts = static_cast<float*>(out_pts[l]);
    L.nrm = static_cast<float*>(out_nrm[l]);
    L.mask = static_cast<uint8_t*>(out_mask[l]);
    start += h * w;
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
  p.total = start;
  if (p.total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: launch<float>(p, s); break;
    case 1: launch<__half>(p, s); break;
    case 2: launch<uint16_t>(p, s); break;
    default: launch<double>(p, s); break;
  }
  return (int)cudaGetLastError();
}
