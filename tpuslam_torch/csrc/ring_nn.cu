// One hop of the ring map-exchange nearest neighbour: every query against
// the map shard held at this hop, merged into the running best.
//
// Replaces: tpuslam/kernels/pallas_ring.py:100, _ring_nn_kernel (via
//   ring_nn).  For each query x it finds, over the shard's rows
//   q = [q, n, valid, 0], the least score
//       s = (|q|^2 + (1 - valid) * 1e30) - (2x).q
//   (|x|^2 is added back outside, in dist/ring_map.py), takes the first row
//   on ties within the hop and replaces the running best only where the
//   hop's score is strictly less, then gathers the winning 32-byte row.
//   The TPU kernel ran all D hops in one pallas_call with remote DMAs; here
//   one launch is one hop and the ring transport is a torch.distributed
//   P2P exchange outside the kernel (dist/ring_map.py), posted before the
//   launch so that it overlaps it.
//
// What bounds it on the H100: instruction issue, not bytes.  At the map
//   path's shapes (16,384 queries x 131,072 rows) a hop is 2.15e9 score
//   cells of 3 multiplies, 3 adds and a compare-select each; the shard is
//   4 MB and the queries 0.2 MB.  6 FLOP a cell (an FMA counting two)
//   against 67 TFLOP/s of non-tensor fp32 is 0.19 ms a hop, ~0.5 ms counted
//   as issued instructions (132 SMs x 128 lanes x 1.98 GHz), since the
//   rounded order forbids FMAs.  chip_smoke.py times the kernel beside that
//   bound.
//
// What the design does about it: blocks tile queries x map slices.  A block
//   stages a tile of 1,024 rows in shared memory as float4 (q, |q|^2 +
//   (1-valid)*1e30), so each row costs one broadcast 16-byte shared load
//   that four queries per thread reuse; the scores live in registers only.
//   Each block writes a (score, index) partial per query for its slice.  The
//   last block of a query tile to finish (an atomic ticket) folds the
//   partials in slice order with a strict <, which reproduces the first
//   index on ties, merges into the running best and gathers the winning row
//   (the row gather replaces the TPU's one-hot matmul).  16,384 queries fill
//   only 32 query tiles; splitting the rows into 64 slices gives 2,048
//   blocks.
//
// Numerics: every product and sum is __fmul_rn / __fadd_rn / __fsub_rn in
//   the twin's order (no FMA contraction), so scores, indices and rows are
//   bit-equal to ring_nn_hop_reference in kernels/ring_nn.py.  A NaN query
//   compares false everywhere and keeps its running best (+inf and a zero
//   row on the first hop).  Map rows are finite (voxel centroids and zero
//   padding).
//
// The kernel does nothing when *done != 0 (the ICP loop's device-side early
// exit); the running best is then left as it was.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 4;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kTile = 1024;          // rows staged in shared memory at once
constexpr int kSliceRows = 2048;     // rows of the shard one block scans

__global__ void __launch_bounds__(kThreads) ring_nn_kernel(
    const float* __restrict__ x, const float4* __restrict__ shard, int n,
    int m, const float* __restrict__ done, float* __restrict__ part_score,
    int* __restrict__ part_idx, unsigned int* __restrict__ tickets,
    float* __restrict__ best_score, float4* __restrict__ best_row) {
  if (done != nullptr && done[0] != 0.0f) return;
  __shared__ float4 tile[kTile];
  __shared__ bool is_last;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int slice = blockIdx.y;
  const int r0 = slice * kSliceRows;
  const int r1 = min(r0 + kSliceRows, m);

  float x0[kQueriesPerThread], x1[kQueriesPerThread], x2[kQueriesPerThread];
  float bs[kQueriesPerThread];
  int bj[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    int i = q0 + threadIdx.x + k * kThreads;
    bool in = i < n;
    // 2x: an exact scaling, so (2x).q rounds as 2(x.q) does
    x0[k] = in ? __fmul_rn(2.0f, x[3 * i + 0]) : 0.0f;
    x1[k] = in ? __fmul_rn(2.0f, x[3 * i + 1]) : 0.0f;
    x2[k] = in ? __fmul_rn(2.0f, x[3 * i + 2]) : 0.0f;
    bs[k] = __int_as_float(0x7f800000);  // +inf
    bj[k] = -1;
  }

  for (int t0 = r0; t0 < r1; t0 += kTile) {
    const int cnt = min(kTile, r1 - t0);
    __syncthreads();
    for (int c = threadIdx.x; c < cnt; c += kThreads) {
      float4 a = shard[2 * (t0 + c)];      // qx qy qz nx
      float4 b = shard[2 * (t0 + c) + 1];  // ny nz valid 0
      float qq = __fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)),
                           __fmul_rn(a.z, a.z));
      float cst = __fadd_rn(qq, __fmul_rn(__fsub_rn(1.0f, b.z), 1e30f));
      tile[c] = make_float4(a.x, a.y, a.z, cst);
    }
    __syncthreads();
    for (int c = 0; c < cnt; ++c) {
      const float4 q = tile[c];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        float g = __fadd_rn(__fadd_rn(__fmul_rn(x0[k], q.x),
                                      __fmul_rn(x1[k], q.y)),
                            __fmul_rn(x2[k], q.z));
        float s = __fsub_rn(q.w, g);
        if (s < bs[k]) {
          bs[k] = s;
          bj[k] = t0 + c;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    int i = q0 + threadIdx.x + k * kThreads;
    if (i < n) {
      part_score[slice * n + i] = bs[k];
      part_idx[slice * n + i] = bj[k];
    }
  }
  // the last block of this query tile folds every slice's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int ticket = atomicAdd(&tickets[blockIdx.x], 1u);
    is_last = ticket == gridDim.y - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    int i = q0 + threadIdx.x + k * kThreads;
    if (i >= n) continue;
    float best = best_score[i];
    int win = -1;
    for (int s = 0; s < (int)gridDim.y; ++s) {
      float v = __ldcg(&part_score[s * n + i]);
      if (v < best) {
        best = v;
        win = __ldcg(&part_idx[s * n + i]);
      }
    }
    if (win >= 0) {
      best_score[i] = best;
      best_row[2 * i] = shard[2 * win];
      best_row[2 * i + 1] = shard[2 * win + 1];
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;  // ready for the next hop
}

}  // namespace

extern "C" int tpuslam_ring_nn_slices(int m) {
  return m > 0 ? (m + kSliceRows - 1) / kSliceRows : 1;
}

extern "C" int tpuslam_ring_nn_query_tiles(int n) {
  return (n + kQueriesPerBlock - 1) / kQueriesPerBlock;
}

extern "C" int tpuslam_ring_nn(const void* x, const void* shard, int n, int m,
                               const void* done, void* part_score,
                               void* part_idx, void* tickets,
                               void* best_score, void* best_row,
                               void* stream) {
  dim3 grid(tpuslam_ring_nn_query_tiles(n), tpuslam_ring_nn_slices(m));
  ring_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float4*)shard, n, m, (const float*)done,
      (float*)part_score, (int*)part_idx, (unsigned int*)tickets,
      (float*)best_score, (float4*)best_row);
  return (int)cudaGetLastError();
}
