// Per-Gaussian sums of per-instance gradient rows:
//   out[g, c] = sum of rows[k, c] over the instances k with ids[k] == g,
// with `ids` sorted ascending; rows whose id is < 0 or >= n are dropped.
//
// Replaces clm_gs_tpu/ops/segreduce.py:45 _kernel (reached through
// segment_reduce_sorted from rasterize._gather_attrs_bwd), which reduces
// with a one-hot MXU matmul per chunk.
//
// Bound on the H100: bytes. Each id and row is read once and each output row
// written once; there is one add per input value. Design: one launch, no
// scratch in device memory, no atomics.
// - Each block owns kGauss Gaussians [g0, g1). A block-wide search of the
//   sorted ids (every thread probes one position a round, __syncthreads_count
//   narrows the range 256-fold) finds its contiguous rows [lo, hi); ids
//   outside [0, n) fall outside every block's range.
// - The block streams those rows in batches of kBatch, one row a thread,
//   staged with 16-byte cp.async a batch ahead (stream_copy.cuh); each
//   thread loads its row's id itself (staging the ids too was slower).
// - A warp sums runs of equal ids with a segmented scan over shuffles (ids
//   are sorted, so an equal id at distance o means one run), stopping as soon
//   as no run in the warp is longer than the distance; the last row of each
//   run adds the parts of its run in earlier warps of the batch, nearest
//   first, and adds the batch's sum into the block's kGauss x 9 accumulator
//   in shared memory. A deep Gaussian costs a few more scan steps, never a
//   serial walk, and every sum is taken in an order fixed by the data, so
//   the output is bit-identical from run to run.
// - The accumulator, zero for Gaussians without instances, is written once
//   with 16-byte stores.

#include <cuda_runtime.h>

#include "stream_copy.cuh"

namespace {

constexpr int kCols = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGauss = 512;       // Gaussians per block
constexpr int kBatch = kThreads;  // rows per batch, one a thread
constexpr int kStage = kBatch * kCols + 4;  // a batch and its unaligned head
constexpr unsigned kFull = 0xffffffffu;

// Lower bounds in the sorted ids[0, m) of t0 and t1 (the first index whose
// id is >= t), found by all threads together. The answer stays in
// [lo, lo + len]; each round probes kThreads evenly spaced positions and
// keeps the gap after the last probe still below t.
__device__ __forceinline__ void block_lower_bounds(const int* __restrict__ ids,
                                                   int m, int t0, int t1,
                                                   int& r0, int& r1) {
  int lo[2] = {0, 0}, len[2] = {m, m};
  const int t[2] = {t0, t1};
  while (len[0] > 0 || len[1] > 0) {
    int step[2];
    bool below[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      step[i] = (len[i] + kThreads - 1) / kThreads;
      const long long p = lo[i] + (long long)(threadIdx.x + 1) * step[i] - 1;
      below[i] = len[i] > 0 && p < (long long)lo[i] + len[i] && ids[p] < t[i];
    }
    const int c0 = __syncthreads_count(below[0]);
    const int c1 = __syncthreads_count(below[1]);
    const int c[2] = {c0, c1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (len[i] == 0) continue;
      const int next = lo[i] + c[i] * step[i];
      len[i] = min(step[i] - 1, lo[i] + len[i] - next);
      lo[i] = next;
    }
  }
  r0 = lo[0];
  r1 = lo[1];
}

__global__ void __launch_bounds__(kThreads, 6)  // 40 registers: 6 blocks an SM
segment_sums(const int* __restrict__ ids, const float* __restrict__ rows, int m,
             int n, float* __restrict__ out) {
  __shared__ __align__(16) float stage[2][kStage];
  __shared__ __align__(16) float acc[kGauss * kCols];
  __shared__ float part[kWarps][kCols];
  __shared__ int first_id[kWarps], last_id[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = blockIdx.x * kGauss;
  const int g1 = min(g0 + kGauss, n);
  for (int i = tid; i < kGauss * kCols; i += kThreads) acc[i] = 0.f;
  int lo, hi;
  block_lower_bounds(ids, m, g0, g1, lo, hi);
  const int nbatch = (hi - lo + kBatch - 1) / kBatch;
  auto issue = [&](int b) {
    const long long rs = lo + (long long)b * kBatch;
    const long long re = min((long long)hi, rs + kBatch);
    clmgs::stage_range(stage[b & 1], rows, rs * kCols, re * kCols, tid, kThreads);
  };
  if (nbatch > 0) issue(0);
  clmgs::cp_async_commit();
  for (int b = 0; b < nbatch; ++b) {
    if (b + 1 < nbatch) issue(b + 1);
    clmgs::cp_async_commit();
    const int rs = lo + b * kBatch;
    const bool active = tid < hi - rs;
    const int id = active ? ids[rs + tid] : -1;
    clmgs::cp_async_wait<1>();
    __syncthreads();
    // row rs + tid in the stage: after the batch's unaligned head
    const float* s = stage[b & 1] + ((unsigned)rs * kCols & 3u) + tid * kCols;
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = active ? s[c] : 0.f;
    // segmented inclusive scan of the warp's rows
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, id, o);
      const bool take = active && lane >= o && up == id;
      if (!__any_sync(kFull, take)) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float u = __shfl_up_sync(kFull, v[c], o);
        if (take) v[c] += u;
      }
    }
    const int next = __shfl_down_sync(kFull, id, 1);
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[warp][c] = v[c];
      last_id[warp] = id;
    }
    if (lane == 0) first_id[warp] = id;
    __syncthreads();
    const int next_id = lane < 31 ? next : (warp + 1 < kWarps ? first_id[warp + 1] : -1);
    if (active && next_id != id) {
      // this row ends its run in the batch: add the run's parts in earlier
      // warps, nearest first
      if (first_id[warp] == id) {
        for (int k = warp - 1; k >= 0 && last_id[k] == id; --k) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[c] += part[k][c];
          if (first_id[k] != id) break;
        }
      }
      float* a = acc + (id - g0) * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) a[c] += v[c];
    }
    __syncthreads();
  }
  __syncthreads();
  clmgs::store_range(out, acc, (long long)g0 * kCols, (long long)g1 * kCols, tid,
                     kThreads);
}

}  // namespace

// ids: (m,) int32 sorted; rows: (m, cols) f32 with cols == 9; out: (n, cols)
// f32, every entry written.
extern "C" int clmgs_segment_reduce(const int* ids, const float* rows, int m,
                                    int n, int cols, float* out, void* stream) {
  if (cols != kCols || m < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = ((long long)n + kGauss - 1) / kGauss;
  if (blocks > 0) {
    segment_sums<<<(unsigned)blocks, kThreads, 0, s>>>(ids, rows, m, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
