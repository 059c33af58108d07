// Grid-hash association: the nearest target row among the 27 cells around
// each query, over a target sorted by packed cell key.
//
// Replaces: tpuslam/kernels/correspond.py grid_hash_correspond (XLA, not
//   Pallas: 27 unrolled cells, each a searchsorted, four (N, 16) gathers, an
//   argmin, four take_along_axis and four where; ~400 launches an
//   association in plain PyTorch), and the transform in front of it at
//   tpuslam/icp.py:180-182 (x = se3.transform_points(T, p)).  It runs at the
//   start of every outer iteration of the grid ICP loop (frame-to-map
//   tracking with map_track_mode="grid") and once, pose-less, over every
//   keyframe point when map BA builds its problem.
//
// What bounds it on the H100: neither bytes nor operations, but latency.
//   Per query it reads 12 B of point and 1 B of mask and writes 32 B (q, n,
//   w, idx).  Of the index it needs only the cells it scans: for each, the
//   4 B key and the 32 B row of at most 16 slots (masked rows sort last and
//   are never read; a crowded cell's later rows neither), a few hundred KB
//   of the 4.7 MB a 131,072-row index holds, which the 50 MB L2 keeps after
//   the first touch.  So the bytes bound is well under a microsecond at
//   16,384 queries (chip_smoke.py computes it).  But each of the 27 cells is
//   a binary search of <= 17 dependent loads, then up to 16 slots, each a
//   key load and a 32 B row: the chain of dependent L2 reads a thread walks
//   is what sets the time.
//
// What the design does about it: one thread a query (16,384 queries fill
//   the 132 SMs with 64 blocks of 256).  The search and the scan stop early:
//   an out-of-grid cell is never searched, and the slot scan stops at the
//   first key that differs (the keys are sorted, so no later slot of the
//   cell can match; a slot clipped to the last row repeats a row already
//   seen, whose equal distance cannot win a strict <).  A candidate's point
//   and normal sit in one 32-byte row (two float4 loads, one sector), read
//   only when its key matches.  The pose is applied in registers (posed
//   call), so no transform runs before the kernel.
//
// Numerics: the transform is x = ((R0 p0 + R1 p1) + R2 p2) + t, each product
//   and sum rounded with __fmul_rn / __fadd_rn (transform_points_ordered's
//   order, as correspond.cu and gn_step.cu).  The cell coordinate is
//   floorf(__fdiv_rn(__fsub_rn(x, origin), cell)), a true divide nvcc
//   cannot contract; it is clamped to [-2, 257] (NaN to -2) before the
//   cast, which keeps every out-of-grid cell out of grid.  d2 is
//   ((dx*dx + dy*dy) + dz*dz) with __fmul_rn / __fadd_rn.  The tie rules
//   are the reference's: inside a cell the first of equal minima, across
//   cells (dx, dy, dz nested in that order, dz innermost) a strict <; a
//   sequential scan with a strict < over the cells' slots in that order
//   picks the same row.  The plain PyTorch twins in kernels/correspond.py
//   then give bit-equal q, n, w and idx.  A query with no candidate writes
//   q = n = 0, idx = 0, w = 0 (the reference's start values).
//
// pose == nullptr: the queries are already in the index's frame (map BA's
// call).  The kernel skips all work when *done != 0 (the ICP loop's
// device-side early exit): it reads nothing else and leaves its outputs
// unwritten, and nothing reads them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGridDims = 256;
constexpr int kSlots = 16;

// searchsorted-left: the first position whose key is >= `key`
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int cell_coord(float x, float origin, float cell) {
  float f = floorf(__fdiv_rn(__fsub_rn(x, origin), cell));
  if (!(f >= -2.0f)) f = -2.0f;  // NaN too
  if (f > 257.0f) f = 257.0f;
  return static_cast<int>(f);
}

__global__ void __launch_bounds__(kThreads) grid_correspond_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ x_mask,
    const float* __restrict__ pose, const int* __restrict__ keys,
    const float4* __restrict__ rows, int m, const float* __restrict__ origin,
    float cell, int n, float max_dist_sq, const float* __restrict__ done,
    float* __restrict__ q_out, float* __restrict__ n_out,
    float* __restrict__ w_out, int* __restrict__ idx_out) {
  __shared__ float T[12];  // rows 0..2 of the pose, row-major
  __shared__ float O[3];
  if (done != nullptr && done[0] != 0.0f) return;
  if (pose != nullptr && threadIdx.x < 12) T[threadIdx.x] = pose[threadIdx.x];
  if (threadIdx.x < 3) O[threadIdx.x] = origin[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float p0 = pts[3 * i + 0], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
  float x0 = p0, x1 = p1, x2 = p2;
  if (pose != nullptr) {
    x0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], p0), __fmul_rn(T[1], p1)),
                             __fmul_rn(T[2], p2)), T[3]);
    x1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4], p0), __fmul_rn(T[5], p1)),
                             __fmul_rn(T[6], p2)), T[7]);
    x2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[8], p0), __fmul_rn(T[9], p1)),
                             __fmul_rn(T[10], p2)), T[11]);
  }
  const int c0 = cell_coord(x0, O[0], cell);
  const int c1 = cell_coord(x1, O[1], cell);
  const int c2 = cell_coord(x2, O[2], cell);

  float best = INFINITY;
  float bq0 = 0.0f, bq1 = 0.0f, bq2 = 0.0f;
  float bn0 = 0.0f, bn1 = 0.0f, bn2 = 0.0f;
  int bi = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    const int a = c0 + dx;
    if (a < 0 || a >= kGridDims) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int b = c1 + dy;
      if (b < 0 || b >= kGridDims) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int z = c2 + dz;
        if (z < 0 || z >= kGridDims) continue;
        const int key = (a << 16) | (b << 8) | z;
        const int start = lower_bound(keys, m, key);
        for (int j = 0; j < kSlots; ++j) {
          const int idx = min(start + j, m - 1);
          if (__ldg(keys + idx) != key) break;
          const float4 r0 = __ldg(rows + 2 * idx);
          const float4 r1 = __ldg(rows + 2 * idx + 1);
          const float e0 = __fsub_rn(x0, r0.x), e1 = __fsub_rn(x1, r0.y),
                      e2 = __fsub_rn(x2, r0.z);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)),
              __fmul_rn(e2, e2));
          if (d2 < best) {
            best = d2;
            bq0 = r0.x; bq1 = r0.y; bq2 = r0.z;
            bn0 = r0.w; bn1 = r1.x; bn2 = r1.y;
            bi = idx;
          }
          if (idx == m - 1) break;  // later slots repeat this row
        }
      }
    }
  }
  const float nn = __fadd_rn(__fadd_rn(__fmul_rn(bn0, bn0), __fmul_rn(bn1, bn1)),
                             __fmul_rn(bn2, bn2));
  const bool valid = (x_mask[i] != 0) && isfinite(best) &&
                     (best < max_dist_sq) && (nn > 0.5f);
  q_out[3 * i + 0] = bq0;
  q_out[3 * i + 1] = bq1;
  q_out[3 * i + 2] = bq2;
  n_out[3 * i + 0] = bn0;
  n_out[3 * i + 1] = bn1;
  n_out[3 * i + 2] = bn2;
  w_out[i] = valid ? 1.0f : 0.0f;
  idx_out[i] = bi;
}

}  // namespace

extern "C" int tpuslam_grid_correspond(
    const void* pts, const void* x_mask, const void* pose, const void* keys,
    const void* rows, int m, const void* origin, float cell, int n,
    float max_dist_sq, const void* done, void* q_out, void* n_out,
    void* w_out, void* idx_out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  grid_correspond_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const uint8_t*)x_mask, (const float*)pose,
      (const int*)keys, (const float4*)rows, m, (const float*)origin, cell, n,
      max_dist_sq, (const float*)done, (float*)q_out, (float*)n_out,
      (float*)w_out, (int*)idx_out);
  return (int)cudaGetLastError();
}
