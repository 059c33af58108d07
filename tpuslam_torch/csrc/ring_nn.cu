// One hop of the ring map-exchange nearest neighbour: every query against
// the map shard held at this hop, merged into the running best; on the
// ring's first hop it starts the running best, on its last it applies the
// correspondence gates and writes what the GN reduction reads.
//
// Replaces: tpuslam/kernels/pallas_ring.py:100, _ring_nn_kernel (via
//   ring_nn), and around it tpuslam/dist/ring_map.py:87-106
//   (_ring_best_correspond_pallas: the query transform in front, the gates
//   after).  For each query x it finds, over the shard's rows
//   q = [q, n, valid, 0], the least score
//       s = (|q|^2 + (1 - valid) * 1e30) - (2x).q
//   takes the first row on ties within the hop and replaces the running
//   best only where the hop's score is strictly less, then gathers the
//   winning 32-byte row.  The TPU kernel ran all D hops in one pallas_call
//   with remote DMAs; here one launch is one hop and the ring transport is
//   a torch.distributed P2P exchange outside the kernel (dist/ring_map.py),
//   posted before the launch so that it overlaps it.
//
// What bounds it on the H100: instruction issue, not bytes.  At the map
//   path's shapes (16,384 queries x 131,072 rows, about half of them valid)
//   a hop is 1.07e9 score cells over the valid rows, each 3 multiplies, 3
//   adds and a compare-select; the shard is 4 MB and the queries 0.2 MB.  6
//   FLOP a cell against 67 TFLOP/s of non-tensor fp32 is 0.096 ms a hop.
//   The twin's rounded order forbids FMAs, so a cell issues ~9
//   instructions (3 FMUL, 3 FADD, FSETP, FSEL, SEL in the SASS) plus one
//   broadcast 16-byte shared load for every 16 cells: ~0.29 ms at 132 SMs
//   x 128 lanes x 1.98 GHz.  chip_smoke.py times the kernel beside the
//   bound.
//
// What the design does about it:
//   - Only valid rows are scored.  The shard is cut into tiles of 256
//     rows; block (t, s) of query tile t scans tiles s, s + S, s + 2S, ...
//     (S blocks a query tile, as many as fill the card's resident blocks
//     once), so valid rows that cluster in the shard still spread over the
//     blocks.  Tiles are staged with cp.async into two shared buffers (the
//     next loads while this one is scored).  Each staged tile is compacted:
//     its valid rows, in order, become (q, |q|^2) float4s beside their
//     original indices, so an invalid row costs no score cell.  Every invalid row scores the same 1e30 (|q|^2 and
//     2x.q are below half an ulp of 1e30 for map coordinates under 1e10
//     m), so only the block's first invalid row can win among them: it is
//     scored once at the end of the block's scan, with the first-index rule
//     against the valid rows' best.  That keeps the twin's answer when a
//     shard has no valid row.
//   - Each thread holds 16 queries, so one 16-byte broadcast shared load
//     of a row feeds 16 cells; the scores live in registers only (168 of
//     them a thread, three blocks an SM).  8 or 12 queries, 256 threads,
//     512-row tiles and two waves of blocks timed the same or slower on
//     the H100 when this tiling was chosen.
//   - The queries are moved by the loop carry's pose in registers (x = R p
//     + t in kernels/gn_step.py's rounded order), so no product runs in
//     front of the kernel.
//   - Each block writes a (score, row) partial per query.  The last block
//     of a query tile to finish (an atomic ticket, atomicInc with the limit
//     gridDim.y - 1, which leaves the word at 0 for the next launch) takes
//     the least (score, row) pair over the partials, the lower row on equal
//     scores (the first index on ties), merges it into the running best
//     with a strict < (on the first hop: starts it) and gathers the winning row (the row gather
//     replaces the TPU's one-hot matmul).  On the last hop the same thread
//     then computes d2 = max(score + |x|^2, 0), found, has_normal, the
//     max_dist gate and the source mask, and writes x, q, n and w.
//   - The partials and tickets are persistent buffers of the wrapper's
//     module, one of each per device: a hop allocates and fills nothing.
//
// Numerics: every product and sum is __fmul_rn / __fadd_rn / __fsub_rn in
//   the twin's order (no FMA contraction), so scores, indices, rows and the
//   gated outputs are bit-equal to the twins in kernels/ring_nn.py.  A NaN
//   query compares false everywhere and keeps its running best (+inf and a
//   zero row from the first hop).  Map rows are finite (voxel centroids and
//   zero padding).
//
// The pose is required: the entry point refuses a null one with
// cudaErrorInvalidValue and launches nothing.  The kernel does nothing when
// *done != 0 (the ICP loop's device-side early exit): it reads no point and
// no row, touches no ticket and writes nothing.
// The tickets and partials are the wrapper's, one of each per stream: two
// launches that share them run in order on their stream.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQueriesPerThread = 16;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kTile = 256;           // rows staged in shared memory at once
constexpr int kMinBlocks = 3;        // resident blocks an SM, at least
constexpr int kFoldBatch = 16;       // partials loaded before they are compared

// The last hop's gates and outputs (all null on the other hops).
struct Gates {
  const uint8_t* mask;
  float max_dist_sq;
  float* x_out;
  float* q_out;
  float* n_out;
  float* w_out;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the most recent) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage rows [r, r + cnt) of the shard (two float4s each) into smem.
__device__ __forceinline__ void stage_tile(float4* smem,
                                           const float4* __restrict__ shard,
                                           int r, int cnt) {
  for (int c = threadIdx.x; c < 2 * cnt; c += kThreads)
    cp_async16(smem + c, shard + 2 * r + c);
}

// x = ((R0 p0 + R1 p1) + R2 p2) + t, unfused
__device__ __forceinline__ void to_pose(const float* T, float p0, float p1,
                                        float p2, float& x0, float& x1,
                                        float& x2) {
  x0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], p0), __fmul_rn(T[1], p1)),
                           __fmul_rn(T[2], p2)), T[3]);
  x1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4], p0), __fmul_rn(T[5], p1)),
                           __fmul_rn(T[6], p2)), T[7]);
  x2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[8], p0), __fmul_rn(T[9], p1)),
                           __fmul_rn(T[10], p2)), T[11]);
}

// |q|^2 + (1 - valid) * 1e30 in the twin's order
__device__ __forceinline__ float row_cost(float4 a, float valid) {
  const float qq = __fadd_rn(
      __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)), __fmul_rn(a.z, a.z));
  return __fadd_rn(qq, __fmul_rn(__fsub_rn(1.0f, valid), 1e30f));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) ring_nn_kernel(
    const float* __restrict__ pts, const float* __restrict__ pose,
    const float4* __restrict__ shard, int n, int m,
    const float* __restrict__ done, float2* __restrict__ part,
    unsigned int* __restrict__ tickets, float* __restrict__ best_score,
    float4* __restrict__ best_row, int first, Gates gates) {
  __shared__ __align__(16) float4 raw[2][2 * kTile];  // staged rows
  __shared__ float4 cand[kTile];         // this tile's valid rows: q, cost
  __shared__ int cand_row[kTile];        // their indices in the shard
  __shared__ int warp_count[kWarps];
  __shared__ int first_invalid;          // the block's first invalid row
  __shared__ float T[12];                // rows 0..2 of the pose
  __shared__ bool is_last;

  if (done != nullptr && done[0] != 0.0f) return;
  if (threadIdx.x < 12) T[threadIdx.x] = pose[threadIdx.x];
  if (threadIdx.x == 0) first_invalid = INT_MAX;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int slice = blockIdx.y, slices = gridDim.y;
  // this block's tiles: slice, slice + slices, ... (spread over the shard,
  // so clustered valid rows do not pile up on a few blocks)
  const int tiles = (m + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (slice < tiles)
    stage_tile(raw[0], shard, slice * kTile, min(kTile, m - slice * kTile));
  cp_async_commit();
  __syncthreads();  // the pose

  float x0[kQueriesPerThread], x1[kQueriesPerThread], x2[kQueriesPerThread];
  float bs[kQueriesPerThread];
  int bj[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int i = q0 + threadIdx.x + k * kThreads;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    if (i < n) to_pose(T, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], a, b, c);
    // 2x: an exact scaling, so (2x).q rounds as 2(x.q) does
    x0[k] = __fmul_rn(2.0f, a);
    x1[k] = __fmul_rn(2.0f, b);
    x2[k] = __fmul_rn(2.0f, c);
    bs[k] = __int_as_float(0x7f800000);  // +inf
    bj[k] = -1;
  }

  for (int t = slice, stage = 0; t < tiles; t += slices, stage ^= 1) {
    const int t0 = t * kTile;
    const int cnt = min(kTile, m - t0);
    if (t + slices < tiles)
      stage_tile(raw[stage ^ 1], shard, t0 + slices * kTile,
                 min(kTile, m - t0 - slices * kTile));
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile t has landed; the last tile's scoring is done

    // compact: the tile's valid rows, in order, into cand
    const float4* rows = raw[stage];
    int kept = 0;
    for (int p = 0; p < cnt; p += kThreads) {
      const int j = p + threadIdx.x;
      bool keep = false;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float valid = 0.0f;
      if (j < cnt) {
        a = rows[2 * j];
        valid = rows[2 * j + 1].z;
        keep = valid != 0.0f;
        if (!keep) atomicMin(&first_invalid, t0 + j);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_count[w] : 0;
        total += warp_count[w];
      }
      if (keep) {
        const int pos =
            kept + before + __popc(ballot & ((1u << lane) - 1u));
        cand[pos] = make_float4(a.x, a.y, a.z, row_cost(a, valid));
        cand_row[pos] = t0 + j;
      }
      kept += total;
      __syncthreads();  // warp_count is reused; cand is complete
    }

    // score: strict < in row order keeps the first index on ties
    int bt[kQueriesPerThread];
#pragma unroll
    for (int k = 0; k < kQueriesPerThread; ++k) bt[k] = -1;
#pragma unroll 2
    for (int c = 0; c < kept; ++c) {
      const float4 q = cand[c];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        const float g = __fadd_rn(
            __fadd_rn(__fmul_rn(x0[k], q.x), __fmul_rn(x1[k], q.y)),
            __fmul_rn(x2[k], q.z));
        const float s = __fsub_rn(q.w, g);
        if (s < bs[k]) {
          bs[k] = s;
          bt[k] = c;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQueriesPerThread; ++k)
      if (bt[k] >= 0) bj[k] = cand_row[bt[k]];
  }
  __syncthreads();  // first_invalid is final

  // the block's first invalid row, against the valid rows' best with the
  // first-index rule
  const int fi = first_invalid;
  float4 ia = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float icost = 0.0f;
  if (fi != INT_MAX) {
    ia = shard[2 * fi];
    icost = row_cost(ia, shard[2 * fi + 1].z);
  }
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    if (fi != INT_MAX) {
      const float g = __fadd_rn(
          __fadd_rn(__fmul_rn(x0[k], ia.x), __fmul_rn(x1[k], ia.y)),
          __fmul_rn(x2[k], ia.z));
      const float s = __fsub_rn(icost, g);
      if (s < bs[k] || (s == bs[k] && fi < bj[k])) {
        bs[k] = s;
        bj[k] = fi;
      }
    }
    const int i = q0 + threadIdx.x + k * kThreads;
    if (i < n) part[slice * n + i] = make_float2(bs[k], __int_as_float(bj[k]));
  }

  // the last block of this query tile folds every slice's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(&tickets[blockIdx.x], slices - 1) == slices - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const bool last = gates.w_out != nullptr;
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int i = q0 + threadIdx.x + k * kThreads;
    if (i >= n) break;
    // the hop's least (score, row), the lower row on equal scores
    float hop = __int_as_float(0x7f800000);
    int win = -1;
    for (int s0 = 0; s0 < slices; s0 += kFoldBatch) {
      float2 v[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        v[u] = s0 + u < slices ? __ldcg(&part[(s0 + u) * n + i])
                               : make_float2(0.0f, __int_as_float(-1));
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        const int j = __float_as_int(v[u].y);
        if (j >= 0 && (win < 0 || v[u].x < hop ||
                       (v[u].x == hop && j < win))) {
          hop = v[u].x;
          win = j;
        }
      }
    }
    // merge: strictly less than the running best (an earlier hop wins)
    float best = first ? __int_as_float(0x7f800000) : best_score[i];
    const bool take = win >= 0 && hop < best;
    float4 ra = make_float4(0.0f, 0.0f, 0.0f, 0.0f), rb = ra;
    if (take) {
      best = hop;
      ra = shard[2 * win];
      rb = shard[2 * win + 1];
    }
    if (take || first) {
      best_score[i] = best;
      best_row[2 * i] = ra;
      best_row[2 * i + 1] = rb;
    } else if (last) {
      ra = best_row[2 * i];
      rb = best_row[2 * i + 1];
    }
    if (!last) continue;
    float a, b, c;
    to_pose(T, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], a, b, c);
    const float xx = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                               __fmul_rn(c, c));
    float d2 = __fadd_rn(best, xx);
    d2 = d2 < 0.0f ? 0.0f : d2;
    const bool found = rb.z > 0.5f && isfinite(best);
    const float nn = __fadd_rn(
        __fadd_rn(__fmul_rn(ra.w, ra.w), __fmul_rn(rb.x, rb.x)),
        __fmul_rn(rb.y, rb.y));
    const bool valid = gates.mask[i] != 0 && found &&
                       d2 < gates.max_dist_sq && nn > 0.5f;
    gates.x_out[3 * i] = a;
    gates.x_out[3 * i + 1] = b;
    gates.x_out[3 * i + 2] = c;
    gates.q_out[3 * i] = ra.x;
    gates.q_out[3 * i + 1] = ra.y;
    gates.q_out[3 * i + 2] = ra.z;
    gates.n_out[3 * i] = ra.w;
    gates.n_out[3 * i + 1] = rb.x;
    gates.n_out[3 * i + 2] = rb.y;
    gates.w_out[i] = valid ? 1.0f : 0.0f;
  }
}

}  // namespace

// The blocks of one query tile: as many as fill the resident blocks of the
// card once with all query tiles (one wave), at most one a 256-row tile.
extern "C" int tpuslam_ring_nn_slices(int n, int m) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_nn_kernel,
                                                  kThreads, 0);
    resident = std::max(1, sms * per_sm);
  }
  const int query_tiles =
      std::max(1, (n + kQueriesPerBlock - 1) / kQueriesPerBlock);
  const int tiles = std::max(1, (m + kTile - 1) / kTile);
  return std::max(1, std::min(tiles, resident / query_tiles));
}

extern "C" int tpuslam_ring_nn_query_tiles(int n) {
  return (n + kQueriesPerBlock - 1) / kQueriesPerBlock;
}

extern "C" int tpuslam_ring_nn(
    const void* pts, const void* pose, const void* shard, int n, int m,
    int slices, const void* done, void* part, void* tickets,
    void* best_score, void* best_row, int first, const void* mask,
    float max_dist_sq, void* x_out, void* q_out, void* n_out, void* w_out,
    void* stream) {
  if (pose == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid(tpuslam_ring_nn_query_tiles(n), slices);
  const Gates gates{(const uint8_t*)mask, max_dist_sq, (float*)x_out,
                    (float*)q_out, (float*)n_out, (float*)w_out};
  ring_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)pose, (const float4*)shard, n, m,
      (const float*)done, (float2*)part, (unsigned int*)tickets,
      (float*)best_score, (float4*)best_row, first, gates);
  return (int)cudaGetLastError();
}
