// Dense pose-graph Gauss-Newton: every round of backend/posegraph.py's
// dense solve (_optimize_dense) in one launch of one thread block.
//
// Replaces no Pallas kernel.  The reference writes the solve as jnp
// (tpuslam/backend/posegraph.py: edge residuals, jax.jacfwd Jacobians, a
// scatter-add of the (6N, 6N) normal system, jnp.linalg.solve, se3.exp) and
// XLA fuses each round into a few kernels.  The port's plain twin
// (posegraph.optimize_dense_reference) runs it op by op: a 32-node bucket is
// ~11,700 kernels a solve (20 rounds of float64 Jacobian products, six
// sorting scatters into an (N, N, 6, 6) tensor and a cuSOLVER LU of the
// 192 x 192 system), ~27 ms a solve on an H100 for a few MFLOP.
//
// What bounds it on the H100: not bytes (a few KiB in and out) and not
//   operations (20 rounds of ~1.9 kFLOP an edge, the assembly and the
//   factorization's (6n)^3 / 3: ~13 MFLOP at n = 19 live nodes and E = 68
//   edges, 0.2 us at 67 TFLOP/s).  It is the chain of dependent steps:
//   every round needs the last round's poses, and block column k of the
//   factorization needs block column k - 1.
//
// What the design does about it: one block of 512 threads holds the whole
//   system in shared memory (H as 6n + 1 rows of 6N + 1 floats, the odd
//   stride keeping column reads free of bank conflicts: at N = 32, 145.5
//   KiB of the 227 KiB a block may have, 155.5 KiB with the rest, and 188 B
//   an edge, up to 389 edges) and runs all rounds without returning to the
//   host or to device memory.  A round is: one thread an edge for its
//   residual, Jacobian and Huber-weighted 6 x 6 block; one thread the six
//   entries of a block row of H (and a node's six of b, kept as row 6n),
//   summing that node's edges in edge order; a right-looking Cholesky by
//   6-column block columns, two barriers a block column: the panel, each
//   row below (b's included, so L y = b comes out of the factorization)
//   times the diagonal factor's inverse, then the trailing update, one
//   thread an entry, reading a transposed copy of the panel, while warp 0
//   updates the next diagonal block and factors and inverts it, one step
//   ahead; the back substitution by block rows with the inverses; the
//   guard; and one thread a node for exp(-x) . T.  Only the live n <= N
//   nodes enter it: padding nodes (masked, beyond the last live node and
//   touched by no weighted edge) have b = 0 and a diagonal block, so the
//   twin's update of them is exactly zero, and their poses are left as
//   they came.  On an H100 (80GB HBM3, 700 W) the look-ahead, the inverses
//   in place of divisions and the block-row assembly took a 19-node solve
//   from 1.78 to 0.85 ms; the factorization is still ~60% of it, ~2.6k
//   cycles a block column.
//
// Numerics: the twin's mathematics in the twin's precision, in another
//   summation order and with another factorization (so equal within a
//   stated tolerance, not bit for bit): the residual log(T_meas^-1 . T_i^-1
//   . T_j) in float32; the Jacobian J_l^-1(-r) . Ad(T_j^-1) in float64,
//   rounded once to float32, with the se3 module's Taylor switch at
//   theta^2 = 0.0625 (a branch: both sides are the twin's formulas); the
//   Huber weight on the whole edge's weighted norm times the edge weight
//   and the diagonal information; the gauge prior and damping of _prior /
//   solve_and_update; a float32 Cholesky of the regularized system, which
//   is symmetric positive definite (J^T W J plus a positive diagonal), in
//   place of the twin's LU: both solve it exactly up to rounding, and
//   Cholesky needs half the work, no pivot search and only the lower
//   triangle.  Its diagonal blocks are inverted (each diagonal entry one
//   IEEE reciprocal square root) so that the panel and the back
//   substitution multiply where a division chain would wait.  A round
//   whose step is not finite leaves every pose as it was (the twin's
//   guard).  An edge of weight 0 (padding, a rejected candidate) adds
//   exactly 0 to H and b unless its terms are not finite, when the twin's
//   H turns NaN and its guard fires: it is left out of the sums and fires
//   the guard in that case.  Sums run in a fixed order and nothing uses
//   atomics, so every launch gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 32;             // threads a warp
constexpr int kMaxNodes = 32;
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use
constexpr int kRec = 43;               // an edge's record: M (36), g (6), cost
constexpr int kMaxDevices = 64;

struct Params {
  const float* poses;      // (N, 4, 4)
  const uint8_t* mask;     // (N,) live nodes
  const int* edge_i;       // (E,)
  const int* edge_j;       // (E,)
  const float* edge_T;     // (E, 4, 4) measured T_i^-1 . T_j
  const float* edge_w;     // (E,)
  float info_t, info_r;    // the diagonal information
  float huber;             // Huber width on the whole-edge weighted norm
  float damping;
  int iters;
  int n_nodes, n_edges;
  float* poses_out;        // (N, 4, 4)
  float* cost_out;         // ()
};

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- float32 SO(3) / SE(3), as tpuslam_torch/geom/se3.py -------------------

// se3._sinc_coeffs: sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3
__device__ __forceinline__ void sinc_coeffs(float t2, float& a, float& b,
                                            float& c) {
  const bool small = t2 < 0.0625f;
  const float safe = clamp_min(t2, 0.0625f);
  const float th = sqrtf(safe);
  const float sn = sinf(th), cs = cosf(th);
  a = small ? (1.0f - t2 / 6.0f) + t2 * t2 / 120.0f : sn / th;
  b = small ? (0.5f - t2 / 24.0f) + t2 * t2 / 720.0f : (1.0f - cs) / safe;
  c = small ? (1.0f / 6.0f - t2 / 120.0f) + t2 * t2 / 5040.0f
            : (th - sn) / (safe * th);
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

__device__ __forceinline__ void mul3(const float* A, const float* B,
                                     float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = (A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c]) +
                     A[3 * r + 2] * B[6 + c];
}

// se3._left_jacobian_inv: I - W/2 + coeff W^2
__device__ __forceinline__ void left_jacobian_inv(const float* phi,
                                                  float* J) {
  const float t2 = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  float a, b, c;
  sinc_coeffs(t2, a, b, c);
  float W[9], W2[9];
  hat(phi, W);
  mul3(W, W, W2);
  const float coeff =
      t2 < 0.0625f
          ? (1.0f / 12.0f + t2 / 720.0f) + t2 * t2 / 30240.0f
          : (1.0f - a / (2.0f * clamp_min(b, 1e-8f))) / clamp_min(t2, 0.0625f);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    J[q] = ((q % 4 == 0 ? 1.0f : 0.0f) - 0.5f * W[q]) + coeff * W2[q];
}

// se3.so3_log: axis-angle of R, safe on [0, pi]
__device__ __forceinline__ void so3_log(const float* R, float* phi) {
  const float trace = (R[0] + R[4]) + R[8];
  const float ct = clamp((trace - 1.0f) * 0.5f, -1.0f, 1.0f);
  const float w[3] = {(R[7] - R[5]) * 0.5f, (R[2] - R[6]) * 0.5f,
                      (R[3] - R[1]) * 0.5f};
  const float u = 1.0f - ct;
  const float cs = clamp(ct, (float)(-1.0 + 1e-6), (float)(1.0 - 1e-6));
  const float s_exact = acosf(cs) / sqrtf(1.0f - cs * cs);
  const float s_series = (1.0f + u / 3.0f) + ((float)(2.0 / 15.0) * u) * u;
  const float scale = u < 1e-3f ? s_series : s_exact;
  const float theta = acosf(clamp(ct, -1.0f, -0.5f));
  if (theta > 3.0f) {
    // near pi: the axis is the symmetric part's largest column
    float M[9], best = -1.0f;
    int k = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        M[3 * r + c] = 0.5f * (R[3 * r + c] + R[3 * c + r]) -
                       (r == c ? ct : 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float s = (M[c] * M[c] + M[3 + c] * M[3 + c]) + M[6 + c] * M[6 + c];
      if (s > best || c == 0) {
        best = s;
        k = c;
      }
    }
    float ax[3] = {M[k], M[3 + k], M[6 + k]};
    const float dot = (ax[0] * w[0] + ax[1] * w[1]) + ax[2] * w[2];
    const float sign = dot < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) ax[q] *= sign;
    const float n2 = (ax[0] * ax[0] + ax[1] * ax[1]) + ax[2] * ax[2];
    const float nrm = sqrtf(clamp_min(n2, 1e-12f));
#pragma unroll
    for (int q = 0; q < 3; ++q) phi[q] = ax[q] / nrm * theta;
    return;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) phi[q] = w[q] * scale;
}

// the top three rows of inv(T): [R^T | -R^T t]
__device__ __forceinline__ void inv_rows(const float* T, float* X) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) X[4 * r + c] = T[4 * c + r];
    X[4 * r + 3] = -((T[r] * T[3] + T[4 + r] * T[7]) + T[8 + r] * T[11]);
  }
}

// ---- float64 Jacobian pieces -----------------------------------------------

struct D3 {
  double m[9];
};

__device__ __forceinline__ D3 dmul(const D3& A, const D3& B) {
  D3 C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C.m[3 * r + c] = (A.m[3 * r] * B.m[c] + A.m[3 * r + 1] * B.m[3 + c]) +
                       A.m[3 * r + 2] * B.m[6 + c];
  return C;
}

__device__ __forceinline__ D3 dhat(double x, double y, double z) {
  D3 W = {{0.0, -z, y, z, 0.0, -x, -y, x, 0.0}};
  return W;
}

// One edge at the current poses: its residual r, Jacobian J_j (J_i = -J_j),
// Huber weight w and weighted norm wr2, reduced to the record the assembly
// reads: M = J_j^T S J_j (S = w . info: H_ii = H_jj = M, H_ij = -M),
// g = J_j^T S r (b_i = -g, b_j = g) and the cost term w . wr2.  Returns
// whether M and g are finite.
__device__ bool edge_record(const Params& p, int e, int i, int j,
                            const float* pose, float* out) {
  if (i < 0 || i >= p.n_nodes || j < 0 || j >= p.n_nodes) {
    out[kRec - 1] = NAN;
    return false;
  }
  const float* Tm = p.edge_T + 16 * e;
  const float* Ti = pose + 16 * i;
  const float* Tj = pose + 16 * j;

  // r = log(T_meas^-1 . T_i^-1 . T_j), float32
  float Am[12], Ai[12], X[12], Y[12];
  inv_rows(Tm, Am);
  inv_rows(Ti, Ai);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      X[4 * r + c] = ((Am[4 * r] * Ai[c] + Am[4 * r + 1] * Ai[4 + c]) +
                      Am[4 * r + 2] * Ai[8 + c]) +
                     (c == 3 ? Am[4 * r + 3] : 0.0f);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      Y[4 * r + c] = ((X[4 * r] * Tj[c] + X[4 * r + 1] * Tj[4 + c]) +
                      X[4 * r + 2] * Tj[8 + c]) +
                     X[4 * r + 3] * Tj[12 + c];
  float RY[9], res[6], Jl[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) RY[3 * r + c] = Y[4 * r + c];
  so3_log(RY, res + 3);
  left_jacobian_inv(res + 3, Jl);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    res[r] = (Jl[3 * r] * Y[3] + Jl[3 * r + 1] * Y[7]) + Jl[3 * r + 2] * Y[11];

  // J_j = J_l^-1(-r) . Ad(T_j^-1) in float64 (the block form of
  // posegraph._se3_left_jacobian_inv and _adjoint), rounded once
  const double rho[3] = {-(double)res[0], -(double)res[1], -(double)res[2]};
  const double ph[3] = {-(double)res[3], -(double)res[4], -(double)res[5]};
  const D3 W = dhat(ph[0], ph[1], ph[2]);
  const D3 P = dhat(rho[0], rho[1], rho[2]);
  const double t2 = (ph[0] * ph[0] + ph[1] * ph[1]) + ph[2] * ph[2];
  // the Taylor switch as a branch: an edge computes only its own side
  double c1, c2, c3, a, b, coeff;
  if (t2 < 0.0625) {
    c1 = (1.0 / 6 - t2 / 120) + t2 * t2 / 5040;
    c2 = (1.0 / 24 - t2 / 720) + t2 * t2 / 40320;
    c3 = (1.0 / 120 - t2 / 2520) + t2 * t2 / 120960;
    a = (1.0 - t2 / 6) + t2 * t2 / 120;
    b = (0.5 - t2 / 24) + t2 * t2 / 720;
    coeff = (1.0 / 12 + t2 / 720) + t2 * t2 / 30240;
  } else {
    const double safe = clamp_min(t2, 0.0625);
    const double th = sqrt(safe), sn = sin(th), cs = cos(th);
    c1 = (th - sn) / (safe * th);
    c2 = (safe + 2 * cs - 2) / (2 * safe * safe);
    c3 = (2 * th - 3 * sn + th * cs) / (2 * safe * safe * th);
    a = sn / th;
    b = (1.0 - cs) / safe;
    coeff = (1.0 - a / (2.0 * clamp_min(b, 1e-8))) / safe;
  }
  const D3 WP = dmul(W, P), PW = dmul(P, W), WW = dmul(W, W);
  const D3 WPW = dmul(WP, W);
  const D3 WWP = dmul(WW, P), PWW = dmul(PW, W), WPWW = dmul(WPW, W);
  const D3 WWPW = dmul(WWP, W);
  D3 Q;
#pragma unroll
  for (int q = 0; q < 9; ++q)
    Q.m[q] = ((0.5 * P.m[q] + c1 * ((WP.m[q] + PW.m[q]) + WPW.m[q])) +
              c2 * ((WWP.m[q] + PWW.m[q]) - 3 * WPW.m[q])) +
             c3 * (WPWW.m[q] + WWPW.m[q]);
  // se3._left_jacobian_inv(phi) in float64
  D3 Ji, nJi;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    Ji.m[q] = ((q % 4 == 0 ? 1.0 : 0.0) - 0.5 * W.m[q]) + coeff * WW.m[q];
    nJi.m[q] = -Ji.m[q];
  }
  // Ad(T_j^-1) = [[R', hat(t') R'], [0, R']], T_j^-1 in float32
  float Tinv[12];
  inv_rows(Tj, Tinv);
  D3 Rp;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) Rp.m[3 * r + c] = (double)Tinv[4 * r + c];
  const D3 HR = dmul(dhat(Tinv[3], Tinv[7], Tinv[11]), Rp);
  const D3 A1 = dmul(Ji, Rp);                       // both diagonal blocks
  const D3 B1 = dmul(Ji, HR);
  const D3 C1 = dmul(dmul(dmul(nJi, Q), Ji), Rp);   // -J Q J . R'
  float J[36];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J[6 * r + c] = (float)A1.m[3 * r + c];
      J[6 * r + 3 + c] = (float)(B1.m[3 * r + c] + C1.m[3 * r + c]);
      J[6 * (r + 3) + c] = 0.0f;
      J[6 * (r + 3) + 3 + c] = (float)A1.m[3 * r + c];
    }

  // Huber weight on the whole-edge weighted norm, float32
  const float info[6] = {p.info_t, p.info_t, p.info_t,
                         p.info_r, p.info_r, p.info_r};
  float wr2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) wr2 += (res[k] * info[k]) * res[k];
  const float rn = sqrtf(clamp_min(wr2, 1e-18f));
  const float scale = rn <= p.huber ? 1.0f : (1.0f / rn) * p.huber;
  const float w = p.edge_w[e] * scale;
  float s[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = w * info[k];
  bool finite = true;
#pragma unroll
  for (int a6 = 0; a6 < 6; ++a6) {
    float WJ[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) WJ[k] = J[6 * k + a6] * s[k];
#pragma unroll
    for (int b6 = 0; b6 < 6; ++b6) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) v += WJ[k] * J[6 * k + b6];
      out[6 * a6 + b6] = v;
      finite &= isfinite(v);
    }
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) v += WJ[k] * res[k];
    out[36 + a6] = v;
    finite &= isfinite(v);
  }
  out[kRec - 1] = w * wr2;
  return finite;
}

// Cholesky of the 6 x 6 diagonal block at D0 (row stride ld, lower part
// read): the factor's entries below the diagonal, packed lower (L[t][s] at
// t(t+1)/2 + s), and the reciprocals of its diagonal, each one IEEE
// reciprocal square root (nothing reads the diagonal itself).
__device__ __forceinline__ void chol6(const float* D0, int ld, float* L,
                                      float* inv) {
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int t = s; t < 6; ++t) {
      float v = D0[t * ld + s];
#pragma unroll
      for (int q = 0; q < s; ++q)
        v -= L[t * (t + 1) / 2 + q] * L[s * (s + 1) / 2 + q];
      if (t == s)
        inv[s] = __frsqrt_rn(v);
      else
        L[t * (t + 1) / 2 + s] = v * inv[s];
    }
}

// L^-1 of chol6's factor, packed lower
__device__ __forceinline__ void inv6(const float* L, const float* inv,
                                     float* Li) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    Li[s * (s + 1) / 2 + s] = inv[s];
#pragma unroll
    for (int t = s + 1; t < 6; ++t) {
      float v = 0.0f;
#pragma unroll
      for (int q = s; q < t; ++q)
        v += L[t * (t + 1) / 2 + q] * Li[q * (q + 1) / 2 + s];
      Li[t * (t + 1) / 2 + s] = -v * inv[t];
    }
  }
}

// Lane 0 of a warp: the inverse Cholesky factor of diagonal block kb of A
// (row stride ld), packed lower into Linv[21 kb ...].
__device__ __forceinline__ void factor_block(const float* A, int ld, int kb,
                                             float* Linv, int lane) {
  if (lane != 0) return;
  float D[21], dinv[6], Li[21];
  chol6(A + 6 * kb * ld + 6 * kb, ld, D, dinv);
  inv6(D, dinv, Li);
#pragma unroll
  for (int q = 0; q < 21; ++q) Linv[21 * kb + q] = Li[q];
}

// exp(d) . T for one node, float32 (se3.exp, then the 4 x 4 product)
__device__ __forceinline__ void exp_update(const float* d, float* T) {
  const float* ph = d + 3;
  const float t2 = (ph[0] * ph[0] + ph[1] * ph[1]) + ph[2] * ph[2];
  float a, b, c;
  sinc_coeffs(t2, a, b, c);
  float W[9], W2[9], R[9], V[9], t[3];
  hat(ph, W);
  mul3(W, W, W2);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float I = q % 4 == 0 ? 1.0f : 0.0f;
    R[q] = (I + a * W[q]) + b * W2[q];
    V[q] = (I + b * W[q]) + c * W2[q];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    t[r] = (V[3 * r] * d[0] + V[3 * r + 1] * d[1]) + V[3 * r + 2] * d[2];
  float out[12];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      out[4 * r + c4] = ((R[3 * r] * T[c4] + R[3 * r + 1] * T[4 + c4]) +
                         R[3 * r + 2] * T[8 + c4]) +
                        t[r] * T[12 + c4];
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = out[q];
}

// shared memory, in 4-byte words, for N nodes and E edges (the wrapper's
// kernels/posegraph_dense.py smem_bytes mirrors it)
constexpr long long smem_words(int N, int E) {
  return (6LL * N + 1) * (6LL * N + 7) + 44LL * N + 47LL * E + 3;
}

__global__ void __launch_bounds__(kThreads, 1)
    posegraph_dense_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const int N = p.n_nodes, E = p.n_edges;
  const int ld = 6 * N + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kLanes, row = tid / kLanes, rows = nt / kLanes;
  float* A = smem;                    // H (lower) and b (row 6n), ld a row
  float* P = A + ld * ld;             // the panel, transposed: 6 x ld
  float* x = P + 6 * ld;              // the step, 6N
  float* pose = x + 6 * N;            // N x 16
  float* Linv = pose + 16 * N;        // N x 21: each diagonal factor's inverse
  float* rec = Linv + 21 * N;         // E x kRec
  int* ei = reinterpret_cast<int*>(rec + kRec * E);
  int* ej = ei + E;
  int* off = ej + E;                  // N + 1: each node's edges in adj
  int* adj = off + N + 1;             // 2E
  int* live = adj + 2 * E;            // the live nodes n
  float* cost = reinterpret_cast<float*>(live + 1);

  for (int q = tid; q < 16 * N; q += nt) pose[q] = p.poses[q];
  for (int e = tid; e < E; e += nt) {
    ei[e] = p.edge_i[e];
    ej[e] = p.edge_j[e];
  }
  __syncthreads();
  // an edge enters the system if it carries weight between two nodes
  auto active = [&](int e) {
    const int i = ei[e], j = ej[e];
    return p.edge_w[e] != 0.0f && i != j && i >= 0 && i < N && j >= 0 &&
           j < N;
  };
  for (int a = tid; a < N; a += nt) {
    int c = 0;
    for (int e = 0; e < E; ++e) c += active(e) && (ei[e] == a || ej[e] == a);
    off[a + 1] = c;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    off[0] = 0;
    for (int a = 0; a < N; ++a) {
      if (p.mask[a] || off[a + 1] > 0) n = a + 1;
      off[a + 1] += off[a];
    }
    *live = n;
    *cost = INFINITY;
  }
  __syncthreads();
  // each node's edges in edge order: the edge, its other node and
  // whether this node is its j side
  for (int a = tid; a < N; a += nt) {
    int k = off[a];
    for (int e = 0; e < E; ++e)
      if (active(e) && (ei[e] == a || ej[e] == a))
        adj[k++] = e | (ei[e] == a ? ej[e] : ei[e]) << 16 |
                   (ej[e] == a ? (int)(1u << 31) : 0);
  }
  const int n = *live, m = 6 * n;

  for (int it = 0; it < p.iters; ++it) {
    __syncthreads();
    bool bad = false;
    for (int e = tid; e < E; e += nt)
      bad |= !edge_record(p, e, ei[e], ej[e], pose, rec + kRec * e);
    const bool poison = __syncthreads_or(bad);
    if (tid < kLanes) {
      float s = 0.0f;
      for (int e = lane; e < E; e += kLanes) s += rec[kRec * e + kRec - 1];
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) *cost = s;
    }
    if (poison) continue;              // the twin's H is not finite

    // H's lower triangle and b (row m): a thread the six entries of one
    // row k of a block (a, bn), bn <= a, summing node a's edges in edge
    // order, the prior and damping on the diagonal; b by node
    const int nblk = 6 * (n * (n + 1) / 2);
    for (int w = tid; w < nblk + n; w += nt) {
      if (w >= nblk) {
        const int a = w - nblk;
        float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = off[a]; q < off[a + 1]; ++q) {
          const int at = adj[q];
          const float* g = rec + kRec * (at & 0xffff) + 36;
#pragma unroll
          for (int l = 0; l < 6; ++l) v[l] += at < 0 ? g[l] : -g[l];
        }
#pragma unroll
        for (int l = 0; l < 6; ++l) A[m * ld + 6 * a + l] = v[l];
        continue;
      }
      const int k = w % 6, pair = w / 6;
      int a = 0;
      while ((a + 1) * (a + 2) / 2 <= pair) ++a;
      const int bn = pair - a * (a + 1) / 2;
      float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = off[a]; q < off[a + 1]; ++q) {
        const int at = adj[q];
        const float* M = rec + kRec * (at & 0xffff);
        if (a == bn) {
#pragma unroll
          for (int l = 0; l < 6; ++l) v[l] += M[6 * k + l];
        } else if (((at >> 16) & 0x7fff) == bn) {
          // H_ij = -M on (i, j), its transpose on (j, i)
#pragma unroll
          for (int l = 0; l < 6; ++l)
            v[l] -= at < 0 ? M[6 * l + k] : M[6 * k + l];
        }
      }
      const int r = 6 * a + k;
      if (a == bn) {
        const float prior = (((a == 0 ? 1e6f : 0.0f) + p.damping) + 1e-6f) *
                            (p.mask[a] ? 1.0f : 1e6f);
        v[k] += prior + p.damping * fabsf(v[k]);
      }
#pragma unroll
      for (int l = 0; l < 6; ++l)
        if (a != bn || l <= k) A[r * ld + 6 * bn + l] = v[l];
    }
    __syncthreads();

    // right-looking Cholesky by block columns, b's row riding along as
    // the last panel row (so it ends as y with L y = b).  Warp 0 factors
    // each diagonal block one step ahead (its inverse, to Linv), while the
    // other warps update the rest of the trailing matrix.
    if (tid < kLanes && n > 0) factor_block(A, ld, 0, Linv, lane);
    __syncthreads();
    for (int kb = 0; kb < n; ++kb) {
      const int c0 = 6 * kb;
      // the panel: each row below (b's included) times L_kk^-T
      if (c0 + 6 + tid - lane <= m) {           // warps that hold a row
        float li[21];
#pragma unroll
        for (int q = 0; q < 21; ++q) li[q] = Linv[21 * kb + q];
        for (int r = c0 + 6 + tid; r <= m; r += nt) {
          float h[6];
#pragma unroll
          for (int t = 0; t < 6; ++t) h[t] = A[r * ld + c0 + t];
#pragma unroll
          for (int t = 0; t < 6; ++t) {
            float v = 0.0f;
#pragma unroll
            for (int s = 0; s <= t; ++s) v += h[s] * li[t * (t + 1) / 2 + s];
            A[r * ld + c0 + t] = v;
            P[t * ld + r] = v;
          }
        }
      }
      __syncthreads();
      const int c1 = c0 + 6;
      if (tid < kLanes) {
        if (c1 < m) {
          // the next diagonal block's lower entries, then its factor
          for (int q = lane; q < 21; q += kLanes) {
            int t = 0;
            while ((t + 1) * (t + 2) / 2 <= q) ++t;
            const int s = q - t * (t + 1) / 2;
            float v = 0.0f;
#pragma unroll
            for (int u = 0; u < 6; ++u)
              v += P[u * ld + c1 + t] * P[u * ld + c1 + s];
            A[(c1 + t) * ld + c1 + s] -= v;
          }
          __syncwarp();
          factor_block(A, ld, kb + 1, Linv, lane);
        }
      }
      if (row > 0 || rows == 1) {     // every warp but 0 (or the only one)
        const int g = rows > 1 ? row - 1 : 0, gs = rows > 1 ? rows - 1 : 1;
        for (int r = c1 + 6 + g; r <= m; r += gs) {
          float pr[6];
#pragma unroll
          for (int t = 0; t < 6; ++t) pr[t] = P[t * ld + r];
          const int cmax = r == m ? m - 1 : r;
          float* __restrict__ Ar = A + r * ld;
          const float* __restrict__ Pc = P;
#pragma unroll 2
          for (int c = c1 + lane; c <= cmax; c += kLanes) {
            float v = 0.0f;
#pragma unroll
            for (int t = 0; t < 6; ++t) v += pr[t] * Pc[t * ld + c];
            Ar[c] -= v;
          }
        }
      }
      __syncthreads();
    }

    // L^T x = y by block rows from the last: x_k = L_kk^-T y_k, six
    // threads; then y_r -= L_kr^T x_k, a thread a row above; then the guard
    float* yw = A + m * ld;
    for (int kb = n - 1; kb >= 0; --kb) {
      const int c0 = 6 * kb;
      for (int t = tid; t < 6; t += nt) {
        const float* Li = Linv + 21 * kb;
        float v = 0.0f;
        for (int s = t; s < 6; ++s) v += Li[s * (s + 1) / 2 + t] * yw[c0 + s];
        x[c0 + t] = v;
      }
      __syncthreads();
      for (int r = tid; r < c0; r += nt) {
        float v = yw[r];
#pragma unroll
        for (int t = 0; t < 6; ++t) v -= A[(c0 + t) * ld + r] * x[c0 + t];
        yw[r] = v;
      }
      __syncthreads();
    }
    bool nonfinite = false;
    for (int r = tid; r < m; r += nt) nonfinite |= !isfinite(x[r]);
    if (!__syncthreads_or(nonfinite)) {
      for (int a = tid; a < n; a += nt) {
        float d[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) d[q] = -x[6 * a + q];
        exp_update(d, pose + 16 * a);
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < 16 * N; q += nt) p.poses_out[q] = pose[q];
  if (tid == 0) *p.cost_out = *cost;
}

}  // namespace

// poses (N, 4, 4) float32, mask (N,) bool, edge_i / edge_j (E,) int32,
// edge_T (E, 4, 4) float32, edge_w (E,) float32, all contiguous on the
// device; writes poses_out (N, 4, 4) and cost_out () float32.  One block.
extern "C" int tpuslam_posegraph_dense(
    const void* poses, const void* mask, const void* edge_i,
    const void* edge_j, const void* edge_T, const void* edge_w, int n_nodes,
    int n_edges, float info_t, float info_r, float huber, float damping,
    int iters, void* poses_out, void* cost_out, void* stream) {
  if (n_nodes < 1 || n_nodes > kMaxNodes || n_edges < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const long long bytes = 4 * smem_words(n_nodes, n_edges);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KiB only once the kernel is allowed it, once a device
  static bool allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < kMaxDevices && !allowed[dev]) {
    err = cudaFuncSetAttribute(posegraph_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  Params p;
  p.poses = static_cast<const float*>(poses);
  p.mask = static_cast<const uint8_t*>(mask);
  p.edge_i = static_cast<const int*>(edge_i);
  p.edge_j = static_cast<const int*>(edge_j);
  p.edge_T = static_cast<const float*>(edge_T);
  p.edge_w = static_cast<const float*>(edge_w);
  p.info_t = info_t;
  p.info_r = info_r;
  p.huber = huber;
  p.damping = damping;
  p.iters = iters;
  p.n_nodes = n_nodes;
  p.n_edges = n_edges;
  p.poses_out = static_cast<float*>(poses_out);
  p.cost_out = static_cast<float*>(cost_out);
  posegraph_dense_kernel<<<1, kThreads, (size_t)bytes,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
