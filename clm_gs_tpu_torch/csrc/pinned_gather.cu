// Row gather out of pinned host memory:
//   out[k, :] = table[ids[k], :]  for k < n,
// where `table` is the (C, 48) float32 SH table in pinned (page-locked) host
// memory, read by the card through its mapped device address, `ids` an int32
// or int64 list on the card, and `out` (n, 48) float32 in device memory.
//
// Replaces clm_gs_tpu/utils/hostmem.py:117 PinnedShTable.fetch, the JAX
// package's --pinned_host transport: an XLA gather program over a table
// placed in the `pinned_host` memory space (not a Pallas kernel). Both stand
// for the reference CLM-GS's send_shs2gpu_stream: the visible SH rows read
// straight out of pinned host memory by a device index list, with no host
// gather into a staging buffer and no separate upload.
//
// Bound on the H100: bytes over PCIe, host to card. Each row's 192 bytes
// cross the bus once (64 GB/s a direction published for Gen5 x16; a copy
// engine reaches ~55 GB/s); the ids and the output stay in device memory,
// 1/50 of the bus's time at HBM's rate. What holds the bus is the reads in
// flight: by Little's law it needs rate x round trip, 64 GB/s x ~1.5-2 us,
// some 100-130 KB. Past 4-16 blocks the SMs' reads of host memory stop
// scaling (utils/pinned_probe.py's sweep: no larger grid is 10% faster), at
// a rate that differs from host to host (~24 to ~49 GB/s on the H100 hosts
// measured, PERF.md §6), so more resident threads buy nothing. Design:
// - A small fixed grid (utils/hostmem.py `pinned_grid`, GATHER_BLOCKS: 16
//   blocks of 256 threads; PINNED_DEPTH 8), not one sized by the SM count:
//   a grid of every SM held the card until the last row had crossed (the
//   previous design's 8 blocks of 256 threads an SM: 40 matmuls 15.6%
//   slower beside a scatter of that shape). 16 x 8 came within 6.1% of the
//   best grid on the tables clm makes on each host swept, and was the
//   fastest of the four grids timed on the fastest host, where 4 blocks
//   lost 37%.
//   The gather runs on the compute stream, in line with the micro step, so
//   its speed matters more than the card beside it.
// - Each block walks one contiguous range of rows_per_block rows (the ids
//   ascend, so a block's reads walk the table forward). A warp moves 8 rows
//   as a group of 96 float4 words, 3 a lane, twelve lanes a row; a warp's
//   step is kDepth groups, 8 x kDepth rows, and each lane issues all its
//   3 x kDepth loads of the host words before it stores any: reads in flight
//   come from the depth, not from resident threads.
// - A row is 192 bytes, three 64-byte segments, and the table starts on a
//   page: no two rows share a segment, so the host Adam's writes to other
//   rows never meet a row the card reads.
// - Loads are ld.global.cv: a cached line of system memory counts as stale
//   and is fetched again, so a row the host rewrote after an earlier launch
//   is never served from the L2. Cached loads (ld.global.cg, .ca, .nc) and
//   a TMA bulk copy of whole rows into shared memory (cp.async.bulk on an
//   mbarrier) were tried: neither gained enough to give that guarantee up.
// - An id outside [0, C) traps (the launch fails, and the next
//   synchronisation raises) instead of reading outside the table.
//
// The card's address of the table is looked up with cudaPointerGetAttributes
// on every call (clmgs_pinned_device_ptr): the caching host allocator
// (cudaHostAlloc) maps it at the host address under UVA, cudaHostRegister
// may map it elsewhere, and the caller's table is replaced when it grows.

#include <cuda_runtime.h>

#include "pinned_rows.cuh"

namespace {

// Groups of 8 rows a warp step. The probe builds the other depths of its
// sweep with -DPINNED_DEPTH=d (utils/pinned_probe.py).
#ifndef PINNED_DEPTH
#define PINNED_DEPTH 8
#endif
constexpr int kDepth = PINNED_DEPTH;

template <typename Id>
__global__ void __launch_bounds__(pinned::kThreads)
gather_rows(const float4* __restrict__ table, long long C, const Id* __restrict__ ids,
            long long n, long long rows_per_block, float4* __restrict__ out) {
  using namespace pinned;
  const Lane lane(threadIdx.x & 31);
  const long long begin = (long long)blockIdx.x * rows_per_block;
  const long long end = begin + rows_per_block < n ? begin + rows_per_block : n;
  constexpr int kStepRows = kGroupRows * kDepth;
  for (long long base = begin + (long long)(threadIdx.x >> 5) * kStepRows; base < end;
       base += (long long)kWarps * kStepRows) {
    long long src[kDepth][kLaneWords];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int w = 0; w < kLaneWords; ++w) {
        const long long k = base + d * kGroupRows + lane.row[w];
        src[d][w] = k < end ? word_of(ids[k], C, lane.col[w]) : -1;
      }
    }
    float4 v[kDepth][kLaneWords];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int w = 0; w < kLaneWords; ++w) {
        if (src[d][w] >= 0) v[d][w] = __ldcv(table + src[d][w]);
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int w = 0; w < kLaneWords; ++w) {
        const long long k = base + d * kGroupRows + lane.row[w];
        if (src[d][w] >= 0) out[k * kWords + lane.col[w]] = v[d][w];
      }
    }
  }
}

template <typename Id>
cudaError_t launch(const float4* t, long long C, const Id* ids, long long n,
                   long long rows_per_block, float4* o, unsigned blocks, cudaStream_t s) {
  gather_rows<Id><<<blocks, pinned::kThreads, 0, s>>>(t, C, ids, n, rows_per_block, o);
  return cudaGetLastError();
}

}  // namespace

// Status codes of clmgs_pinned_device_ptr besides cudaError values.
constexpr int kNotPinnedHost = -1;
constexpr int kNoDevicePointer = -2;

// The card's address of pinned host memory at `host` (the start of its
// allocation or registration): 0 and *dev set, kNotPinnedHost when the
// memory is not page-locked host memory known to CUDA, kNoDevicePointer when
// the current card cannot address it, or a cudaError.
extern "C" int clmgs_pinned_device_ptr(const void* host, void** dev) {
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, host);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  if (a.type != cudaMemoryTypeHost) return kNotPinnedHost;
  if (a.devicePointer == nullptr) return kNoDevicePointer;
  *dev = a.devicePointer;
  return 0;
}

// table: the card's address of the (C, 48) f32 table, 16-byte aligned;
// ids: (n,) int32 (id64 == 0) or int64 on the card; out: (n, 48) f32 on
// the card, every entry written. blocks x rows_per_block must cover n
// (hostmem.pinned_grid).
extern "C" int clmgs_pinned_gather(const void* table, long long C, const void* ids,
                                   int id64, long long n, float* out, int blocks,
                                   long long rows_per_block, void* stream) {
  if (!pinned::valid(table, C, n, blocks, rows_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out);
  cudaError_t e = id64 ? launch(t, C, static_cast<const long long*>(ids), n, rows_per_block,
                                o, static_cast<unsigned>(blocks), s)
                       : launch(t, C, static_cast<const int*>(ids), n, rows_per_block, o,
                                static_cast<unsigned>(blocks), s);
  return static_cast<int>(e);
}
