// The warm start of a frame's tracking, T0 = T_kf_cam · exp(γ · log Δ), in
// one launch: Δ the last inter-frame motion, γ the damping of the
// constant-velocity model (SLAMConfig.cv_damping).
//
// Replaces no Pallas kernel.  The reference writes the warm start as jnp
// (tpuslam/frontend.py damped_velocity and the product in _track), which
// XLA fuses into a few kernels.  Run op by op, the port's PyTorch twin
// (kernels/warm_start.py warm_start_reference: tpuslam_torch/geom/se3.py
// log, the scale, exp and the product) is ~270 operations on one 4x4 pose,
// ~211 of them device kernels, each launch costing far more than its work.
//
// What bounds it on the H100: neither bytes nor operations.  It reads two
//   4x4 float32 poses (128 B) and writes one (64 B): 0.06 us at 3.35
//   TB/s.  A few hundred float operations (the logarithm, two 3x3
//   Jacobians, the exponential, four small products) and five
//   transcendental calls, all in one chain of dependent steps: the bound is
//   that chain's latency and one launch.
//
// What the design does about it: one thread.  It reads both poses into
//   registers, runs se3's whole chain there and writes the 16 floats of the
//   product; nothing is staged through memory, and there is nothing to
//   share between threads.
//
// Numerics: the twin's eager ops on the same CUDA tensors, op for op.
//   Every elementwise step is written with __fmul_rn, __fadd_rn, __fsub_rn
//   and __fdiv_rn, so nvcc cannot contract a multiply and an add into an
//   FMA, in the twin's order; sinf, cosf, acosf and IEEE sqrt as PyTorch's
//   float32 sin, cos, arccos and sqrt call them; clamps pass NaN through as
//   torch.clamp does.  A division by a Python scalar is a product with its
//   float32 reciprocal (PyTorch's CUDA divide by a CPU scalar), and every
//   other Python scalar is its float32 rounding.  A sum over a (3,) vector
//   adds (x0 + x2) + x1, as PyTorch's reduction does with two threads a
//   row; a column sum of a contiguous (3, 3) adds (x0 + x1) + x2, one thread
//   an output.  The branches (so3_log's series in u = 1 - cos θ and its
//   near-π axis, the sinc coefficients' series below θ² = 0.0625, the
//   Jacobian inverse's) are selects, both sides finite, and torch.argmax's
//   pick of the near-π axis (the first NaN, else the first largest) is a
//   select too.  The twin's three small matrix products (W @ W, J @ ρ, the
//   product with T_kf_cam) go to cuBLAS, which does not document its
//   order; on the H100 it takes k two at a time, a fused multiply-add onto
//   the first product of each pair, and adds the pairs:
//   fma(a1, b1, a0 b0) + a2 b2 at k = 3, fma(a1, b1, a0 b0) +
//   fma(a3, b3, a2 b2) at k = 4 (every entry of 400 seeded products of each
//   shape), and so does this kernel.

#include <cuda_runtime.h>

namespace {

constexpr float kSeriesThetaSq = 0.0625f;  // se3._SINC_SERIES_THETA_SQ

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}

// x / n for a Python scalar n: x times float32(1) / float32(n)
__device__ __forceinline__ float over(float x, float n) {
  return mul(x, __fdiv_rn(1.0f, n));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.sum over a (3,) vector
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(x0, x2), x1);
}

// torch.sum(M, dim=-2) of a contiguous (3, 3): column j
__device__ __forceinline__ float col_sum3(const float* m, int j) {
  return add(add(m[j], m[3 + j]), m[6 + j]);
}

// an entry of a small product as cuBLAS sums it: k two at a time
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}

__device__ __forceinline__ float dot4(float a0, float a1, float a2, float a3,
                                      float b0, float b1, float b2,
                                      float b3) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), __fmaf_rn(a3, b3, mul(a2, b2)));
}

// C = A @ B, (3, 3) row-major
__device__ __forceinline__ void matmul3(const float* a, const float* b,
                                        float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = dot3(a[3 * i], a[3 * i + 1], a[3 * i + 2], b[j],
                          b[3 + j], b[6 + j]);
}

// y = A @ x, (3, 3) row-major
__device__ __forceinline__ void matvec3(const float* a, const float* x,
                                        float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = dot3(a[3 * i], a[3 * i + 1], a[3 * i + 2], x[0], x[1], x[2]);
}

__device__ __forceinline__ float eye(int i, int j) {
  return i == j ? 1.0f : 0.0f;
}

// se3.hat
__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

__device__ __forceinline__ float norm_sq(const float* w) {
  return sum3(mul(w[0], w[0]), mul(w[1], w[1]), mul(w[2], w[2]));
}

// se3._sinc_coeffs: (sin θ / θ, (1 - cos θ) / θ², (θ - sin θ) / θ³)
struct Sinc {
  float a, b, c;
};

__device__ __forceinline__ Sinc sinc_coeffs(float t2) {
  const float safe = clamp_min(t2, kSeriesThetaSq);
  const float theta = __fsqrt_rn(safe);
  const bool small = t2 < kSeriesThetaSq;
  const float t4 = mul(t2, t2);
  const float s = sinf(theta);
  Sinc k;
  k.a = small ? add(sub(1.0f, over(t2, 6.0f)), over(t4, 120.0f))
              : quo(s, theta);
  k.b = small ? add(sub(0.5f, over(t2, 24.0f)), over(t4, 720.0f))
              : quo(sub(1.0f, cosf(theta)), safe);
  k.c = small ? add(sub((float)(1.0 / 6.0), over(t2, 120.0f)),
                    over(t4, 5040.0f))
              : quo(sub(theta, s), mul(safe, theta));
  return k;
}

// se3.so3_log: rotation -> axis-angle
__device__ __forceinline__ void so3_log(const float* R, float* phi) {
  const float trace = add(add(R[0], R[4]), R[8]);
  const float cos_t = clamp(mul(sub(trace, 1.0f), 0.5f), -1.0f, 1.0f);
  const float w[3] = {mul(sub(R[7], R[5]), 0.5f), mul(sub(R[2], R[6]), 0.5f),
                      mul(sub(R[3], R[1]), 0.5f)};
  const float u = sub(1.0f, cos_t);
  const float c_safe =
      clamp(cos_t, (float)(-1.0 + 1e-6), (float)(1.0 - 1e-6));
  const float s_exact =
      quo(acosf(c_safe), __fsqrt_rn(sub(1.0f, mul(c_safe, c_safe))));
  const float s_series = add(add(over(u, 3.0f), 1.0f),
                             mul(mul(u, (float)(2.0 / 15.0)), u));
  const float scale = u < (float)1e-3 ? s_series : s_exact;
  const float theta = acosf(clamp(cos_t, -1.0f, -0.5f));
  const bool near_pi = theta > 3.0f;

  // near π: the axis is the largest column of sym(R) - cos θ · I
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] = sub(mul(add(R[3 * i + j], R[3 * j + i]), 0.5f),
                         mul(cos_t, eye(i, j)));
  float sq[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) sq[i] = mul(M[i], M[i]);
  // torch.argmax: the first NaN, else the first largest
  int k = 0;
  float best = col_sum3(sq, 0);
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    const float v = col_sum3(sq, j);
    if ((isnan(v) && !isnan(best)) || v > best) {
      k = j;
      best = v;
    }
  }
  float axis[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    axis[i] = k == 0 ? M[3 * i] : (k == 1 ? M[3 * i + 1] : M[3 * i + 2]);
  const float sign =
      sum3(mul(axis[0], w[0]), mul(axis[1], w[1]), mul(axis[2], w[2])) < 0.0f
          ? -1.0f
          : 1.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) axis[i] = mul(axis[i], sign);
  const float n = __fsqrt_rn(clamp_min(norm_sq(axis), (float)1e-12));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    phi[i] = near_pi ? mul(quo(axis[i], n), theta) : mul(w[i], scale);
}

// se3._left_jacobian_inv
__device__ __forceinline__ void left_jacobian_inv(const float* phi,
                                                  float* J) {
  const float t2 = norm_sq(phi);
  const Sinc k = sinc_coeffs(t2);
  float W[9], W2[9];
  hat(phi, W);
  matmul3(W, W, W2);
  const float coeff =
      t2 < kSeriesThetaSq
          ? add(add(over(t2, 720.0f), (float)(1.0 / 12.0)),
                over(mul(t2, t2), 30240.0f))
          : quo(sub(1.0f, quo(k.a, mul(clamp_min(k.b, (float)1e-8), 2.0f))),
                clamp_min(t2, kSeriesThetaSq));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J[3 * i + j] = add(sub(eye(i, j), mul(W[3 * i + j], 0.5f)),
                         mul(coeff, W2[3 * i + j]));
}

__global__ void __launch_bounds__(1)
    warm_start_kernel(const float* __restrict__ T_kf_cam,
                      const float* __restrict__ delta, float gamma,
                      float* __restrict__ out) {
  float T[16], D[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    T[i] = T_kf_cam[i];
    D[i] = delta[i];
  }

  // se3.log(Δ): φ from the rotation, ρ = J⁻¹(φ) t
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = D[4 * i + j];
    t[i] = D[4 * i + 3];
  }
  float phi[3], rho[3], Jinv[9];
  so3_log(R, phi);
  left_jacobian_inv(phi, Jinv);
  matvec3(Jinv, t, rho);

  // the twist scaled by γ
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rho[i] = mul(rho[i], gamma);
    phi[i] = mul(phi[i], gamma);
  }

  // se3.exp: R = I + aW + bW², t = (I + bW + cW²) ρ
  const Sinc k = sinc_coeffs(norm_sq(phi));
  float W[9], W2[9], J[9];
  hat(phi, W);
  matmul3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = 3 * i + j;
      R[e] = add(add(eye(i, j), mul(k.a, W[e])), mul(k.b, W2[e]));
      J[e] = add(add(eye(i, j), mul(k.b, W[e])), mul(k.c, W2[e]));
    }
  matvec3(J, rho, t);

  // from_rt, then T_kf_cam @ it
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) E[4 * i + j] = R[3 * i + j];
    E[4 * i + 3] = t[i];
  }
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = dot4(T[4 * i], T[4 * i + 1], T[4 * i + 2],
                            T[4 * i + 3], E[j], E[4 + j], E[8 + j],
                            E[12 + j]);
}

}  // namespace

// T_kf_cam, delta and out: contiguous (4, 4) float32 on the device.
extern "C" int tpuslam_warm_start(const void* T_kf_cam, const void* delta,
                                  float gamma, void* out, void* stream) {
  if (T_kf_cam == nullptr || delta == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  warm_start_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(T_kf_cam), static_cast<const float*>(delta),
      gamma, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
