// Grid-hash association: the nearest target row among the 27 cells around
// each query, over a target sorted by packed cell key; and the table of the
// occupied cells that the probe reads in place of a search of the keys.
//
// Replaces: tpuslam/kernels/correspond.py grid_hash_correspond (XLA, not
//   Pallas: 27 unrolled cells, each a searchsorted, four (N, 16) gathers, an
//   argmin, four take_along_axis and four where; ~400 launches an
//   association in plain PyTorch), and the transform in front of it at
//   tpuslam/icp.py:180-182 (x = se3.transform_points(T, p)).  The table
//   takes the place of the searchsorted at tpuslam/kernels/correspond.py:246
//   and is built with the index (build_grid_index, :196).  The probe runs at
//   the start of every outer iteration of the grid ICP loop (frame-to-map
//   tracking with map_track_mode="grid", the grid-hash loop-closure
//   verification) and once, pose-less, over every keyframe point when map BA
//   builds its problem.
//
// What bounds it on the H100: neither bytes nor operations, but latency
//   and instructions.  Per query it reads 12 B of point and 1 B of mask
//   and writes 32 B (q, n, w, idx).  Of the index it needs only the cells
//   it scans: for each, one 8-byte table entry and the first 16 bytes of
//   the 32-byte row of at most 16 slots (masked rows sort last and are
//   never read; a crowded cell's later rows neither), a few hundred KB of
//   the 6.8 MB an index of 131,072 rows holds with its table, which the
//   50 MB L2 keeps after the first touch.  So the bound is under a
//   microsecond at 16,384 queries (chip_smoke.py computes it).  What sets
//   the time is each query's chain of dependent reads (the point, the
//   cell's table entry, the list, the rows, the winner's row) and the
//   instructions around it.
//   Leaving out one stage at a time (variants timed when this design was
//   chosen, H100 SXM at 700 W, 16,384 queries x 131,072 rows, ~150 points
//   a cell)
//   splits a 13 us launch into about 3.4 us for the point, its cell and
//   the merge and writes, 5.8 us for the lookups and the list, and 4 us
//   for the scan, of which the row loads are 0.6 us: the bytes are not
//   what costs.
//
// What the design does about it:
//   - The table (grid_table_*_kernel) is an open-addressing hash of the
//     index's distinct valid keys, built once an index: a fill, then one
//     thread a sorted row; a row that starts a run of its key counts up to
//     16 rows of the run and inserts (start << 5 | count) << 32 | key with
//     atomicCAS, probing linearly from the multiplicative hash's top bits.
//     A key is inserted once, so a lookup's answer does not depend on the
//     order of the atomics (only the layout does).  Its size is a power of
//     two >= 2M entries (>= 64), so at most half of it is filled and a
//     lookup is about one or two dependent 8-byte loads, where the binary
//     search it replaces was up to 17.  Bytes: 8 an entry, 2 MiB at M =
//     131,072.
//   - Half a warp (kLanes = 16 lanes) takes one query, each lane two of
//     the 27 cells in order: it looks them up, a prefix sum over the lanes
//     places each cell's (cell, slot) pairs in the scan's order, and each
//     lane writes the rows of its cells into the query's list in shared
//     memory, in a rotated order so that lanes whose runs start 16 words
//     apart do not write one bank.  The lanes then spread over that list,
//     kBatch row loads in flight a lane before any is used; no slot waits
//     on a key compare.  16,384 queries are 8,192 warps in blocks of 8
//     queries, where the first design ran 64 blocks of one thread a query.
//     Only a row's first float4 (its point) is read in the scan; the
//     winner's row is read once at the end.  A warp a query, 8 lanes a
//     query, 16 queries a block, 2 loads in flight, list writes in plain
//     order or a cell at a time by all of a query's lanes time slower; 8
//     loads in flight and a hash that keeps a cell's z-neighbours in one
//     sector within 3%.
//   - The lanes' best candidates merge by a shuffle minimum over (d2,
//     position in the scan's order), which is the sequential scan's answer:
//     the first of the equal minima in (dx, dy, dz, slot) order.
//   - The pose is applied in registers (posed call), so no transform runs
//     before the kernel.
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
//   candidate replaces the best only when its d2 is below it, starting
//   from inf, so a d2 of inf or NaN never wins.  A cell's candidates are
//   its first min(count, 16) sorted rows, the reference's 16 slots less
//   those whose key differs or that repeat the last row.  The plain
//   PyTorch twins in kernels/correspond.py then give bit-equal q, n, w and
//   idx.  A query with no candidate writes q = n = 0, idx = 0, w = 0 (the
//   reference's start values).
//
// pose == nullptr: the queries are already in the index's frame (map BA's
// call).  The probe skips all work when *done != 0 (the ICP loop's
// device-side early exit): it reads nothing else and leaves its outputs
// unwritten, and nothing reads them.  `keys` stays in the probe's C
// interface; the probe reads only the table and the rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGridDims = 256;
constexpr int kSlots = 16;
constexpr int kCells = 27;
constexpr int kLanes = 16;                    // lanes a query
constexpr int kQueries = 8;                   // queries a block
constexpr int kThreads = kLanes * kQueries;
constexpr int kCellsPerLane = (kCells + kLanes - 1) / kLanes;
constexpr int kBatch = 4;                     // row loads in flight a lane
constexpr int kInvalidKey = 0x7fffffff;
constexpr unsigned long long kEmpty = ~0ull;  // key field -1: no valid key
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t table_slot(int key, int bits) {
  return (static_cast<uint32_t>(key) * kHashMul) >> (32 - bits);
}

// (start << 5 | count) of `key`'s run, 0 when the index has no such key
__device__ __forceinline__ uint32_t lookup(
    const unsigned long long* __restrict__ table, uint32_t mask, int bits,
    int key) {
  uint32_t h = table_slot(key, bits);
  while (true) {
    const unsigned long long e = __ldg(table + h);
    const int k = static_cast<int>(static_cast<uint32_t>(e));
    if (k == key) return static_cast<uint32_t>(e >> 32);
    if (k == -1) return 0u;
    h = (h + 1) & mask;
  }
}

__global__ void grid_table_fill_kernel(unsigned long long* __restrict__ table,
                                       int size) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x) {
    table[i] = kEmpty;
  }
}

__global__ void grid_table_insert_kernel(const int* __restrict__ keys, int m,
                                         unsigned long long* __restrict__ table,
                                         int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int key = keys[i];
  if (key == kInvalidKey || (i > 0 && keys[i - 1] == key)) return;
  int count = 1;
  while (count < kSlots && i + count < m && keys[i + count] == key) ++count;
  const unsigned long long entry =
      (static_cast<unsigned long long>((static_cast<uint32_t>(i) << 5) |
                                       static_cast<uint32_t>(count)) << 32) |
      static_cast<uint32_t>(key);
  const int bits = 31 - __clz(size);
  const uint32_t mask = static_cast<uint32_t>(size) - 1u;
  uint32_t h = table_slot(key, bits);
  while (atomicCAS(table + h, kEmpty, entry) != kEmpty) h = (h + 1) & mask;
}

__device__ __forceinline__ int cell_coord(float x, float origin, float cell) {
  float f = floorf(__fdiv_rn(__fsub_rn(x, origin), cell));
  if (!(f >= -2.0f)) f = -2.0f;  // NaN too
  if (f > 257.0f) f = 257.0f;
  return static_cast<int>(f);
}

__global__ void __launch_bounds__(kThreads) grid_correspond_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ x_mask,
    const float* __restrict__ pose, const float4* __restrict__ rows,
    const unsigned long long* __restrict__ table, int table_size,
    const float* __restrict__ origin, float cell, int n, float max_dist_sq,
    const float* __restrict__ done, float* __restrict__ q_out,
    float* __restrict__ n_out, float* __restrict__ w_out,
    int* __restrict__ idx_out) {
  __shared__ int cand[kQueries][kCells * kSlots];  // rows in scan order
  __shared__ float T[12];  // rows 0..2 of the pose, row-major
  __shared__ float O[3];
  if (done != nullptr && done[0] != 0.0f) return;
  if (pose != nullptr && threadIdx.x < 12) T[threadIdx.x] = pose[threadIdx.x];
  if (threadIdx.x < 3) O[threadIdx.x] = origin[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int q = threadIdx.x / kLanes;
  const int i = blockIdx.x * kQueries + q;
  // every lane stays to the end: the shuffles below take the whole warp
  const bool live = i < n;
  int* list = cand[q];

  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  int c0 = -2, c1 = -2, c2 = -2;  // out of grid: no lookups
  if (live) {
    const float p0 = pts[3 * i + 0], p1 = pts[3 * i + 1],
                p2 = pts[3 * i + 2];
    x0 = p0; x1 = p1; x2 = p2;
    if (pose != nullptr) {
      x0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], p0),
                                         __fmul_rn(T[1], p1)),
                               __fmul_rn(T[2], p2)), T[3]);
      x1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4], p0),
                                         __fmul_rn(T[5], p1)),
                               __fmul_rn(T[6], p2)), T[7]);
      x2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[8], p0),
                                         __fmul_rn(T[9], p1)),
                               __fmul_rn(T[10], p2)), T[11]);
    }
    c0 = cell_coord(x0, O[0], cell);
    c1 = cell_coord(x1, O[1], cell);
    c2 = cell_coord(x2, O[2], cell);
  }

  // this lane's cells: their runs, then their place in the scan's order
  const int bits = 31 - __clz(table_size);
  const uint32_t tmask = static_cast<uint32_t>(table_size) - 1u;
  uint32_t run[kCellsPerLane];
  int own = 0;
#pragma unroll
  for (int k = 0; k < kCellsPerLane; ++k) {
    const int c = lane * kCellsPerLane + k;
    const int a = c0 + c / 9 - 1, b = c1 + (c / 3) % 3 - 1,
              z = c2 + c % 3 - 1;
    run[k] = 0u;
    if (c < kCells && a >= 0 && a < kGridDims && b >= 0 && b < kGridDims &&
        z >= 0 && z < kGridDims) {
      run[k] = lookup(table, tmask, bits, (a << 16) | (b << 8) | z);
    }
    own += static_cast<int>(run[k] & 31u);
  }
  int incl = own;
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d, kLanes);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, kLanes - 1, kLanes);
  int at = incl - own;
#pragma unroll
  for (int k = 0; k < kCellsPerLane; ++k) {
    const int start = static_cast<int>(run[k] >> 5);
    const int count = static_cast<int>(run[k] & 31u);
    // in a rotated order: lanes whose runs start a bank apart write
    // different banks
    for (int j = 0; j < kSlots; ++j) {
      const int s = (j + lane) & (kSlots - 1);
      if (s < count) list[at + s] = start + s;
    }
    at += count;
  }
  __syncwarp();

  // the scan: position t of the list is the t-th (cell, slot) pair
  float best = INFINITY;
  int best_t = 0x7fffffff;
  int bi = 0;
  for (int t0 = lane; t0 < total; t0 += kBatch * kLanes) {
    int r[kBatch];
    float4 p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * kLanes;
      r[u] = t < total ? list[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      p[u] = r[u] >= 0 ? __ldg(rows + 2 * r[u])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] < 0) continue;
      const float e0 = __fsub_rn(x0, p[u].x), e1 = __fsub_rn(x1, p[u].y),
                  e2 = __fsub_rn(x2, p[u].z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)), __fmul_rn(e2, e2));
      if (d2 < best) {
        best = d2;
        best_t = t0 + u * kLanes;
        bi = r[u];
      }
    }
  }
#pragma unroll
  for (int d = kLanes / 2; d >= 1; d >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, d, kLanes);
    const int ot = __shfl_xor_sync(kFull, best_t, d, kLanes);
    const int oi = __shfl_xor_sync(kFull, bi, d, kLanes);
    if (ob < best || (ob == best && ot < best_t)) {
      best = ob;
      best_t = ot;
      bi = oi;
    }
  }
  if (!live || lane != 0) return;

  float bq0 = 0.0f, bq1 = 0.0f, bq2 = 0.0f;
  float bn0 = 0.0f, bn1 = 0.0f, bn2 = 0.0f;
  if (best_t != 0x7fffffff) {
    const float4 r0 = __ldg(rows + 2 * bi);
    const float4 r1 = __ldg(rows + 2 * bi + 1);
    bq0 = r0.x; bq1 = r0.y; bq2 = r0.z;
    bn0 = r0.w; bn1 = r1.x; bn2 = r1.y;
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

extern "C" int tpuslam_grid_table(const void* keys, int m, void* table,
                                  int table_size, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int need = (table_size + threads - 1) / threads;
  const int fill_blocks = need < 1024 ? need : 1024;
  grid_table_fill_kernel<<<fill_blocks, threads, 0, s>>>(
      (unsigned long long*)table, table_size);
  if (m > 0) {
    grid_table_insert_kernel<<<(m + threads - 1) / threads, threads, 0, s>>>(
        (const int*)keys, m, (unsigned long long*)table, table_size);
  }
  return (int)cudaGetLastError();
}

extern "C" int tpuslam_grid_correspond(
    const void* pts, const void* x_mask, const void* pose, const void* keys,
    const void* rows, int m, const void* table, int table_size,
    const void* origin, float cell, int n, float max_dist_sq,
    const void* done, void* q_out, void* n_out, void* w_out, void* idx_out,
    void* stream) {
  (void)keys;
  (void)m;
  const int blocks = (n + kQueries - 1) / kQueries;
  grid_correspond_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const uint8_t*)x_mask, (const float*)pose,
      (const float4*)rows, (const unsigned long long*)table, table_size,
      (const float*)origin, cell, n, max_dist_sq, (const float*)done,
      (float*)q_out, (float*)n_out, (float*)w_out, (int*)idx_out);
  return (int)cudaGetLastError();
}
