// Device code shared by the point-to-plane GN kernels, so that each piece
// of it exists once:
//   gn_partials.cu  — accumulate_point + block_reduce_row (the reduction
//                     the ring ICP all-reduces across ranks);
//   gn_epilogue.cu  — fold_rows + solve_and_update (after gn_partials and
//                     the all-reduce on the ring, its only caller);
//   gn_step.cu      — all four in one launch (the ICP loop's GN solve);
//   gn_fused.cu     — all four in one launch, with the association's row
//                     and gates inside (the fused ICP loop's GN solve).
//
// Everything here is __forceinline__: the solve's arrays are indexed only
// by compile-time constants after unrolling, so they live in registers.
// Build with -Xptxas -v to see registers, stack frame and spills.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gn {

constexpr int kThreads = 256;  // every GN kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;
constexpr int kRow = 32;  // a partials row: the 30 sums and two zeros

// carry layout (float32[64]) — mirrored in kernels/gn_epilogue.py
constexpr int kDone = 0, kIt = 1, kDeltaSq = 2, kRms = 3, kInlierFrac = 4,
              kNumInliers = 5, kT = 6, kH = 22, kCarry = 64;
// step layout (float32[64]) — mirrored in kernels/gn_epilogue.py
constexpr int kStepT = 0, kStepH = 16, kStepDeltaSq = 52, kStepWsq = 53,
              kStepNinl = 54, kStepWsum = 55, kStep = 64;
constexpr float kSeriesThetaSq = 0.0625f;

struct SolveArgs {
  float damping, damping_abs, max_trans, max_rot;
  int is_last, inner, max_iters;
  float tol_sq;
};

// One matched point's terms added into the 30 accumulators: residual
// r = n.(x - q), Huber IRLS weight min(1, delta / max(|r|, 1e-12)) times
// validity, Jacobian J = [n, x cross n]; the 21 upper-triangle entries of
// w J J^T (row-major order), the 6 of w r J, then w r^2, validity, w.
__device__ __forceinline__ void accumulate_point(
    float (&acc)[kSums], float x0, float x1, float x2, float q0, float q1,
    float q2, float n0, float n1, float n2, float valid, float huber) {
  float r = n0 * (x0 - q0) + n1 * (x1 - q1) + n2 * (x2 - q2);
  float ar = fabsf(r);
  float hub = (ar <= huber) ? 1.0f : huber / fmaxf(ar, 1e-12f);
  float w = valid * hub;
  float j[6] = {n0, n1, n2, x1 * n2 - x2 * n1, x2 * n0 - x0 * n2,
                x0 * n1 - x1 * n0};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float wja = w * j[a];
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += wja * j[b];
  }
  float wr = w * r;
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += wr * j[a];
  acc[27] += wr * r;
  acc[28] += valid;
  acc[29] += w;
}

// The block's accumulators to one 32-float row (sums 30 and 31 zero):
// warp shuffles, then the warps' sums added in warp order, so the row is
// the same bits on every run.  Every thread of the block calls it; threads
// 0..31 write row[0..31].
__device__ __forceinline__ void block_reduce_row(float (&acc)[kSums],
                                                 float (*warp_sums)[kRow],
                                                 float* row) {
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
    row[k] = s;
  }
}

// Fold `rows` partials rows (row-major, kRow floats each) into sums[kRow]
// in shared memory, in a fixed order: warp w adds rows [w*rows/kWarps,
// (w+1)*rows/kWarps) one after another, lane = column; then the kWarps
// warp sums are added in warp order.  A warp loads kFoldBatch rows before
// it adds them in order, so their L2 latencies overlap; the adds stay one
// chain in row order.  Loads go through L2 (__ldcg): in gn_step the rows
// were written by other blocks of the same launch.  Every thread of the
// block calls it; sums is ready after it returns.
constexpr int kFoldBatch = 16;

__device__ __forceinline__ void fold_rows(const float* partials, int rows,
                                          float (*warp_sums)[kRow],
                                          float* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * rows / kWarps;
  const int r1 = (warp + 1) * rows / kWarps;
  float s = 0.0f;
  int r = r0;
  for (; r + kFoldBatch <= r1; r += kFoldBatch) {
    float v[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u)
      v[u] = __ldcg(&partials[(r + u) * kRow + lane]);
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) s += v[u];
  }
  for (; r < r1; ++r) s += __ldcg(&partials[r * kRow + lane]);
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (threadIdx.x < kRow) {
    float t = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) t += warp_sums[wp][threadIdx.x];
    sums[threadIdx.x] = t;
  }
  __syncthreads();
}

// The GN-step epilogue on one warp: from the 32 folded sums and the pose
// carry_in[kT..kT+16), the damped 6x6 solve, the trust region, SE(3) exp
// and compose, then the ICP loop's carry update.  All 32 lanes of one warp
// call it.
//
// This is tpuslam/kernels/pallas_epilogue.py's _epilogue_math op for op:
// H and b from the 30 sums; damping lambda*diag(H) + (lambda_abs*tr(H)/6
// + 1e-9)*I; Gauss elimination on the 6x7 augmented system without
// pivoting, masked exactly as the reference masks it (so inf/NaN
// propagate the same way); the two-stage non-finite guard; the trust
// region on |rho| and |phi|; exp through the so(3) generator with the sinc
// series below theta^2 < 0.0625; and T_new = exp(delta) * T.
//
// The elimination is the one part worth spreading: lane i < 6 holds row i
// of the augmented system and each pivot step broadcasts the pivot row by
// shuffles, so a step costs one row's arithmetic instead of six.  Every
// element gets the same operations in the same order as on one thread
// (lanes 6..31 shadow row 5 and write nothing).  What follows the
// elimination is a few hundred scalar operations, run by every lane alike.
//
// The carry: once carry_in[DONE] is set it is copied through unchanged;
// otherwise T is replaced, and after the last inner solve of an outer
// iteration `it` advances, the stats and H are stored and DONE = !(it <
// max_iters && delta^2 > tol^2), the reference's while-loop predicate.
// Every lane reads the carry before any lane writes it (__syncwarp), so
// carry_out may be carry_in (gn_step updates it in place).  step_out, when
// not null, gets T_new, the undamped H and [delta^2, sum w r^2, sum valid,
// sum w].
__device__ __forceinline__ void solve_and_update(const float* sums,
                                                 const float* carry_in,
                                                 float nvalid,
                                                 const SolveArgs& a,
                                                 float* carry_out,
                                                 float* step_out) {
  constexpr unsigned kAll = 0xffffffffu;
  const float qnan = __int_as_float(0x7fc00000);
  const int lane = threadIdx.x & 31;
  const int row = lane < 6 ? lane : 5;
  const float done_in = carry_in[kDone];
  const float it_in = carry_in[kIt];
  float T[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = carry_in[kT + i];

  // --- the 30 sums as the reference reads them ---
  // The reference extracts sum k as a masked full reduce, sum(sums *
  // onehot_k), so one non-finite sum makes every OTHER sum NaN (0 * inf);
  // H and b, assembled the same way, are then all NaN.  Reproduced here so
  // the carry's stats match the reference on a non-finite system.  Lane k
  // holds sum k.
  const float sv = sums[lane];
  const int nonfinite = __popc(__ballot_sync(kAll, !isfinite(sv)));
  const int others = nonfinite - (isfinite(sv) ? 0 : 1);
  const float sk = (others > 0) ? qnan : sv;

  // --- row `row` of H (6x6 symmetric) and of b ---
  float Hrow[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int r = min(row, j), c = max(row, j);
    // index of (r, c) in the row-major upper triangle
    Hrow[j] = __shfl_sync(kAll, sk, r * 6 - r * (r - 1) / 2 + (c - r));
  }
  float b_row = __shfl_sync(kAll, sk, 21 + row);
  const float wsq = __shfl_sync(kAll, sk, 27);
  const float ninl = __shfl_sync(kAll, sk, 28);
  const float wsum = __shfl_sync(kAll, sk, 29);
  if (nonfinite > 0) {
    b_row = qnan;
#pragma unroll
    for (int j = 0; j < 6; ++j) Hrow[j] = qnan;
  }
  float diag = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) diag = (j == row) ? Hrow[j] : diag;

  // --- damping (solve_gn_step parity) ---
  float trace = 0.0f;
#pragma unroll
  for (int r = 0; r < 6; ++r) trace += __shfl_sync(kAll, diag, r);
  const float lam_abs = a.damping_abs * (trace / 6.0f) + 1e-9f;
  float aug[7];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = (row == j) ? diag : 0.0f;
    float e = (row == j) ? 1.0f : 0.0f;
    aug[j] = Hrow[j] + a.damping * d + lam_abs * e;
  }
  aug[6] = -b_row;

  // --- Gauss elimination without pivoting, masked like the reference ---
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    float rowk[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) rowk[j] = __shfl_sync(kAll, aug[j], kk);
    const float akk = rowk[kk];
    const float colk = aug[kk];
    const float f = ((row > kk) ? 1.0f : 0.0f) * colk / akk;
#pragma unroll
    for (int j = 0; j < 7; ++j) aug[j] = aug[j] - f * rowk[j];
  }
#pragma unroll
  for (int kk = 5; kk >= 0; --kk) {
    float rowk[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) rowk[j] = __shfl_sync(kAll, aug[j], kk);
    const float akk = rowk[kk];
#pragma unroll
    for (int j = 0; j < 7; ++j) rowk[j] = rowk[j] / akk;
    const float colk = aug[kk];
    const float f = ((row < kk) ? 1.0f : 0.0f) * colk;
#pragma unroll
    for (int j = 0; j < 7; ++j) aug[j] = aug[j] - f * rowk[j];
    const float sel = (row == kk) ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < 7; ++j)
      aug[j] = aug[j] * (1.0f - sel) + sel * rowk[j];
  }
  float delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = __shfl_sync(kAll, aug[6], i);

  // --- non-finite guard (two stages) + trust region ---
  float finite = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (!isfinite(delta[i])) finite = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    delta[i] = (isfinite(delta[i]) ? delta[i] : 0.0f) * finite;
  const float t_norm =
      sqrtf(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
  const float r_norm =
      sqrtf(delta[3] * delta[3] + delta[4] * delta[4] + delta[5] * delta[5]);
  const float scale =
      fminf(1.0f, fminf(a.max_trans / fmaxf(t_norm, 1e-12f),
                        a.max_rot / fmaxf(r_norm, 1e-12f)));
  float delta_sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    delta[i] = delta[i] * scale;
    delta_sq += delta[i] * delta[i];
  }

  // --- SE(3) exp via the so(3) generator ---
  const float px = delta[3], py = delta[4], pz = delta[5];
  const float W[3][3] = {{0.0f, -pz, py}, {pz, 0.0f, -px}, {-py, px, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = (i == j) ? 1.0f : 0.0f;
      E[i][j] = eye + a_co * W[i][j] + b_co * W2[i][j];
      t += (eye + b_co * W[i][j] + c_co * W2[i][j]) * delta[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;

  float Tn[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) acc += E[i][m] * T[m * 4 + j];
      Tn[i * 4 + j] = acc;
    }

  // --- outputs: lane 0 the pose and scalars, lanes 0..5 a row of H ---
  __syncwarp();
  if (step_out != nullptr) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) step_out[kStepT + i] = Tn[i];
      step_out[kStepDeltaSq] = delta_sq;
      step_out[kStepWsq] = wsq;
      step_out[kStepNinl] = ninl;
      step_out[kStepWsum] = wsum;
      for (int i = kStepWsum + 1; i < kStep; ++i) step_out[i] = 0.0f;
    }
    if (lane < 6) {
#pragma unroll
      for (int j = 0; j < 6; ++j) step_out[kStepH + lane * 6 + j] = Hrow[j];
    }
  }
  if (carry_out != carry_in) {
    for (int i = lane; i < kCarry; i += 32) carry_out[i] = carry_in[i];
    __syncwarp();
  }
  if (done_in != 0.0f) return;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) carry_out[kT + i] = Tn[i];
  }
  if (!a.is_last) return;
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) carry_out[kH + lane * 6 + j] = Hrow[j];
  }
  if (lane == 0) {
    const float it = it_in + (float)a.inner;
    carry_out[kIt] = it;
    carry_out[kDeltaSq] = delta_sq;
    carry_out[kRms] = sqrtf(wsq / fmaxf(ninl, 1.0f));
    carry_out[kInlierFrac] = ninl / fmaxf(nvalid, 1.0f);
    carry_out[kNumInliers] = ninl;
    const bool keep_going =
        (it < (float)a.max_iters) && (delta_sq > a.tol_sq);
    carry_out[kDone] = keep_going ? 0.0f : 1.0f;
  }
}

}  // namespace gn
