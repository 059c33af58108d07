// The GN-step epilogue: fold the reduction's partials, damped 6x6 solve,
// trust region, SE(3) exp, compose, and the ICP loop's carry update, in
// one launch.
//
// Replaces: tpuslam/kernels/pallas_epilogue.py, _kernel (via
//   gn_epilogue_pallas), math in _epilogue_math.  The scalar code below is
//   that function op for op: H and b from the 30 sums; damping
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
// What the design does about it: one block of one warp.  Lane k folds
//   column k over the blocks in block order (fixed order, coalesced 128-byte
//   rows), then lane 0 runs the solve in registers.  Everything the old
//   ~100 tiny XLA ops did is this one launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// carry layout (float32[64]) — mirrored in kernels/gn_epilogue.py
constexpr int kDone = 0, kIt = 1, kDeltaSq = 2, kRms = 3, kInlierFrac = 4,
              kNumInliers = 5, kT = 6, kH = 22, kCarry = 64;
// step layout (float32[64]) — mirrored in kernels/gn_epilogue.py
constexpr int kStepT = 0, kStepH = 16, kStepDeltaSq = 52, kStepWsq = 53,
              kStepNinl = 54, kStepWsum = 55, kStep = 64;
constexpr float kSeriesThetaSq = 0.0625f;

__global__ void gn_epilogue_kernel(
    const float* __restrict__ partials, int num_blocks,
    const float* __restrict__ carry_in, const float* __restrict__ nvalid_src,
    float damping, float damping_abs, float max_trans, float max_rot,
    int is_last, int inner, int max_iters, float tol_sq,
    float* __restrict__ carry_out, float* __restrict__ step_out) {
  __shared__ float sums[32];
  const int lane = threadIdx.x;
  float col = 0.0f;
  for (int b = 0; b < num_blocks; ++b) col += partials[b * 32 + lane];
  sums[lane] = col;
  __syncwarp();
  if (lane != 0) return;

  // --- the 30 sums as the reference reads them ---
  // The reference extracts sum k as a masked full reduce, sum(sums *
  // onehot_k), so one non-finite sum makes every OTHER sum NaN (0 * inf);
  // H and b, assembled the same way, are then all NaN.  Reproduced here so
  // the carry's stats match the reference on a non-finite system.
  int nonfinite = 0;
  for (int i = 0; i < 32; ++i) nonfinite += isfinite(sums[i]) ? 0 : 1;
  float s[30];
  for (int i = 0; i < 30; ++i) {
    const int others = nonfinite - (isfinite(sums[i]) ? 0 : 1);
    s[i] = (others > 0) ? __int_as_float(0x7fc00000) : sums[i];
  }

  // --- assemble H (6x6 symmetric) and b ---
  float H[6][6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      H[i][j] = s[k];
      H[j][i] = s[k];
      ++k;
    }
  float bvec[6];
  for (int i = 0; i < 6; ++i) bvec[i] = s[21 + i];
  if (nonfinite > 0) {
    const float qnan = __int_as_float(0x7fc00000);
    for (int i = 0; i < 6; ++i) {
      bvec[i] = qnan;
      for (int j = 0; j < 6; ++j) H[i][j] = qnan;
    }
  }
  const float wsq = s[27], ninl = s[28], wsum = s[29];

  // --- damping (solve_gn_step parity) ---
  float trace = 0.0f;
  for (int i = 0; i < 6; ++i) trace += H[i][i];
  const float lam_abs = damping_abs * (trace / 6.0f) + 1e-9f;
  float aug[6][7];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      float d = (i == j) ? H[i][i] : 0.0f;
      float e = (i == j) ? 1.0f : 0.0f;
      aug[i][j] = H[i][j] + damping * d + lam_abs * e;
    }
    aug[i][6] = -bvec[i];
  }

  // --- Gauss elimination without pivoting, masked like the reference ---
  for (int kk = 0; kk < 6; ++kk) {
    const float akk = aug[kk][kk];
    float colk[6], rowk[7];
    for (int i = 0; i < 6; ++i) colk[i] = aug[i][kk];
    for (int j = 0; j < 7; ++j) rowk[j] = aug[kk][j];
    for (int i = 0; i < 6; ++i) {
      const float f = ((i > kk) ? 1.0f : 0.0f) * colk[i] / akk;
      for (int j = 0; j < 7; ++j) aug[i][j] = aug[i][j] - f * rowk[j];
    }
  }
  for (int kk = 5; kk >= 0; --kk) {
    const float akk = aug[kk][kk];
    float colk[6], rowk[7];
    for (int j = 0; j < 7; ++j) rowk[j] = aug[kk][j] / akk;
    for (int i = 0; i < 6; ++i) colk[i] = aug[i][kk];
    for (int i = 0; i < 6; ++i) {
      const float f = ((i < kk) ? 1.0f : 0.0f) * colk[i];
      for (int j = 0; j < 7; ++j) aug[i][j] = aug[i][j] - f * rowk[j];
    }
    for (int i = 0; i < 6; ++i) {
      const float sel = (i == kk) ? 1.0f : 0.0f;
      for (int j = 0; j < 7; ++j)
        aug[i][j] = aug[i][j] * (1.0f - sel) + sel * rowk[j];
    }
  }
  float delta[6];
  for (int i = 0; i < 6; ++i) delta[i] = aug[i][6];

  // --- non-finite guard (two stages) + trust region ---
  float finite = 1.0f;
  for (int i = 0; i < 6; ++i)
    if (!isfinite(delta[i])) finite = 0.0f;
  for (int i = 0; i < 6; ++i)
    delta[i] = (isfinite(delta[i]) ? delta[i] : 0.0f) * finite;
  const float t_norm =
      sqrtf(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
  const float r_norm =
      sqrtf(delta[3] * delta[3] + delta[4] * delta[4] + delta[5] * delta[5]);
  const float scale =
      fminf(1.0f, fminf(max_trans / fmaxf(t_norm, 1e-12f),
                        max_rot / fmaxf(r_norm, 1e-12f)));
  float delta_sq = 0.0f;
  for (int i = 0; i < 6; ++i) {
    delta[i] = delta[i] * scale;
    delta_sq += delta[i] * delta[i];
  }

  // --- SE(3) exp via the so(3) generator ---
  const float px = delta[3], py = delta[4], pz = delta[5];
  const float W[3][3] = {{0.0f, -pz, py}, {pz, 0.0f, -px}, {-py, px, 0.0f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int m = 0; m < 3; ++m) acc += W[i][m] * W[m][j];
      W2[i][j] = acc;
    }
  const float t2 = px * px + py * py + pz * pz;
  const float ts_safe = fmaxf(t2, kSeriesThetaSq);
  const float theta = sqrtf(ts_safe);
  const bool small = t2 < kSeriesThetaSq;
  const float a_co = small ? 1.0f - t2 / 6.0f + t2 * t2 / 120.0f
                           : sinf(theta) / theta;
  const float b_co = small ? 0.5f - t2 / 24.0f + t2 * t2 / 720.0f
                           : (1.0f - cosf(theta)) / ts_safe;
  const float c_co = small ? 1.0f / 6.0f - t2 / 120.0f + t2 * t2 / 5040.0f
                           : (theta - sinf(theta)) / (ts_safe * theta);
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float eye = (i == j) ? 1.0f : 0.0f;
      E[i][j] = eye + a_co * W[i][j] + b_co * W2[i][j];
      t += (eye + b_co * W[i][j] + c_co * W2[i][j]) * delta[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;

  const float* T = carry_in + kT;
  float Tn[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
      for (int m = 0; m < 4; ++m) acc += E[i][m] * T[m * 4 + j];
      Tn[i * 4 + j] = acc;
    }

  // --- step outputs (always written) ---
  for (int i = 0; i < kStep; ++i) step_out[i] = 0.0f;
  for (int i = 0; i < 16; ++i) step_out[kStepT + i] = Tn[i];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) step_out[kStepH + i * 6 + j] = H[i][j];
  step_out[kStepDeltaSq] = delta_sq;
  step_out[kStepWsq] = wsq;
  step_out[kStepNinl] = ninl;
  step_out[kStepWsum] = wsum;

  // --- carry update ---
  for (int i = 0; i < kCarry; ++i) carry_out[i] = carry_in[i];
  if (carry_in[kDone] != 0.0f) return;
  for (int i = 0; i < 16; ++i) carry_out[kT + i] = Tn[i];
  if (!is_last) return;
  const float it = carry_in[kIt] + (float)inner;
  carry_out[kIt] = it;
  carry_out[kDeltaSq] = delta_sq;
  carry_out[kRms] = sqrtf(wsq / fmaxf(ninl, 1.0f));
  carry_out[kInlierFrac] = ninl / fmaxf(nvalid_src[0], 1.0f);
  carry_out[kNumInliers] = ninl;
  for (int i = 0; i < 36; ++i) carry_out[kH + i] = step_out[kStepH + i];
  const bool keep_going = (it < (float)max_iters) && (delta_sq > tol_sq);
  carry_out[kDone] = keep_going ? 0.0f : 1.0f;
}

}  // namespace

extern "C" int tpuslam_gn_epilogue(
    const void* partials, int num_blocks, const void* carry_in,
    const void* nvalid_src, float damping, float damping_abs, float max_trans,
    float max_rot, int is_last, int inner, int max_iters, float tol_sq,
    void* carry_out, void* step_out, void* stream) {
  gn_epilogue_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)partials, num_blocks, (const float*)carry_in,
      (const float*)nvalid_src, damping, damping_abs, max_trans, max_rot,
      is_last, inner, max_iters, tol_sq, (float*)carry_out,
      (float*)step_out);
  return (int)cudaGetLastError();
}
