// Row scatter-add into pinned host memory:
//   table[ids[k], :] += rows[k, :]  for n_store <= k < n  (accumulate != 0)
//   table[ids[k], :]  = 0 + rows[k, :]  for k < n_store   (accumulate != 0)
//   table[ids[k], :]  = rows[k, :]  for k < n              (accumulate == 0)
// where `table` is the (C, 48) float32 SH-gradient table in pinned
// (page-locked) host memory, read and written by the card through its mapped
// device address, `rows` (n, 48) float32 in device memory and `ids` an int32
// or int64 list on the card, unique within a launch. The first n_store rows
// go to slots the caller knows to hold +0.0 (clm's first departures of a
// batch): they are written as 0 + row, the bits an add into the zero slot
// gives (-0.0 included), without reading the slot.
//
// Replaces clm_gs_tpu/utils/hostmem.py:135 PinnedGradBuffer.offload, the JAX
// package's D2H direction of the pinned transport: an XLA scatter-add program
// over a table donated in the `pinned_host` memory space (not a Pallas
// kernel). Both stand for the reference CLM-GS's
// send_shs2cpu_grad_buffer_stream: the SH-gradient rows that leave the
// working set added straight into a pinned host buffer by a device index
// list, with no download into a staging buffer and no host scatter.
//
// Bound on the H100: bytes over PCIe. An added row's 192 bytes cross the
// bus twice, read (host to card) and written back (card to host), one in
// each direction at once; a stored row is written only. 64 GB/s a
// direction published for Gen5 x16. What holds the bus: the reads in flight
// (Little's law: rate x round trip, ~100-130 KB), and PCIe's ordering: a
// read request may not pass the posted writes its requester sent before it,
// so a read issued behind the kernel's own writes waits for them. Design:
// - A small fixed grid (utils/hostmem.py `pinned_grid`, SCATTER_BLOCKS: 4
//   blocks of 256 threads; PINNED_DEPTH 2), not one sized by the SM count.
//   clm launches it on the comm stream beside the next camera's micro step,
//   and its reads and writes in flight slow the card's other work in
//   proportion to their number, not to the SMs they hold
//   (utils/pinned_probe.py `beside_grids`: 40 matmuls beside grids of 4 to
//   1,056 blocks, PERF.md §6). It is not on the critical path: the drain
//   waits for it a camera later. The price is its own time: adding, it
//   stays above twice its bound at this grid (6.3 ms at 663,139 rows
//   against 1.99 on an H100, PERF.md §6), where 16 blocks reach 3.4 ms on a
//   fast host. Spread over a large table of 4 KiB pages, its address
//   translation slows the card's other work at any grid;
//   hostmem.pinned_zeros backs such tables with 2 MiB pages.
// - Each block walks one contiguous range of rows; a warp's step is kDepth
//   groups of 8 rows (96 float4 words, 3 a lane, twelve lanes a row). A
//   lane issues every read of its step's host words before it writes any
//   of them: reads go out in batches of 8 x kDepth rows a warp, not one word
//   behind each write, and their number in flight comes from the depth.
// - Rows below n_store are not read: their slots are known to be zero.
// - The read of the host word is ld.global.cv: a cached line of system
//   memory counts as stale and is fetched again. The host Adam zeroes the
//   rows it consumed between launches, so a row written by an earlier launch
//   must never be served from the L2.
// - No atomics: PCIe offers no host-native atomics on this machine, and the
//   caller's ids are unique within a launch (clm's leaving rows and flushes
//   are each a camera's unique visible ids). With a duplicate id the result
//   is undefined; the plain version sums every duplicate.
// - Visibility: each thread ends with __threadfence_system(), the reference's
//   set_signal idiom: its stores are then ordered, for the host as for every
//   other observer, before anything the card does after the fence, the
//   launch's completion and the event recorded behind it included. The host
//   reads the rows only after waiting on that event.
// - Rows are 192 bytes, three whole 64-byte lines, and the table starts on a
//   page (cudaHostAlloc, or cudaHostRegister of page-aligned numpy memory):
//   a row the card writes never shares a line with a row the host Adam thread
//   updates at the same time.
// - An id outside [0, C) traps (the launch fails, and the next
//   synchronisation raises) instead of writing outside the table.
//
// The card's address of the table is looked up on every call, with
// pinned_gather.cu's clmgs_pinned_device_ptr: the caller's table is replaced
// when it grows, is restored, or leaves a mesh.

#include <cuda_runtime.h>

#include "pinned_rows.cuh"

namespace {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Groups of 8 rows a warp step. The probe builds the other depths of its
// sweep with -DPINNED_DEPTH=d (utils/pinned_probe.py).
#ifndef PINNED_DEPTH
#define PINNED_DEPTH 2
#endif
constexpr int kDepth = PINNED_DEPTH;

template <typename Id, bool Accumulate>
__global__ void __launch_bounds__(pinned::kThreads)
scatter_rows(float4* __restrict__ table, long long C, const Id* __restrict__ ids,
             long long n, long long n_store, long long rows_per_block,
             const float4* __restrict__ rows) {
  using namespace pinned;
  const Lane lane(threadIdx.x & 31);
  const long long begin = (long long)blockIdx.x * rows_per_block;
  const long long end = begin + rows_per_block < n ? begin + rows_per_block : n;
  constexpr int kStepRows = kGroupRows * kDepth;
  for (long long base = begin + (long long)(threadIdx.x >> 5) * kStepRows; base < end;
       base += (long long)kWarps * kStepRows) {
    long long dst[kDepth][kLaneWords];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int w = 0; w < kLaneWords; ++w) {
        const long long k = base + d * kGroupRows + lane.row[w];
        dst[d][w] = k < end ? word_of(ids[k], C, lane.col[w]) : -1;
      }
    }
    float4 old[kDepth][kLaneWords];
    if (Accumulate) {  // every read of the step before any write
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
#pragma unroll
        for (int w = 0; w < kLaneWords; ++w) {
          const long long k = base + d * kGroupRows + lane.row[w];
          old[d][w] = dst[d][w] >= 0 && k >= n_store ? __ldcv(table + dst[d][w])
                                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int w = 0; w < kLaneWords; ++w) {
        if (dst[d][w] < 0) continue;
        const long long k = base + d * kGroupRows + lane.row[w];
        const float4 v = rows[k * kWords + lane.col[w]];
        table[dst[d][w]] = Accumulate ? add4(old[d][w], v) : v;
      }
    }
  }
  __threadfence_system();
}

template <typename Id>
cudaError_t launch(float4* t, long long C, const Id* ids, long long n, long long n_store,
                   long long rpb, const float4* r, int accumulate, unsigned blocks,
                   cudaStream_t s) {
  if (accumulate) {
    scatter_rows<Id, true><<<blocks, pinned::kThreads, 0, s>>>(t, C, ids, n, n_store, rpb, r);
  } else {
    scatter_rows<Id, false><<<blocks, pinned::kThreads, 0, s>>>(t, C, ids, n, n_store, rpb, r);
  }
  return cudaGetLastError();
}

}  // namespace

// table: the card's address of the (C, 48) f32 table, 16-byte aligned;
// ids: (n,) int32 (id64 == 0) or int64 on the card, unique; rows: (n, 48)
// f32 on the card; accumulate: add (1) or store (0); n_store in [0, n]: with
// accumulate, the leading rows whose slots are zero (written, not read).
// blocks x rows_per_block must cover n (hostmem.pinned_grid).
extern "C" int clmgs_pinned_scatter(void* table, long long C, const void* ids, int id64,
                                    long long n, const float* rows, int accumulate,
                                    long long n_store, int blocks, long long rows_per_block,
                                    void* stream) {
  if (!pinned::valid(table, C, n, blocks, rows_per_block) || n_store < 0 || n_store > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* t = static_cast<float4*>(table);
  const float4* r = reinterpret_cast<const float4*>(rows);
  const unsigned b = static_cast<unsigned>(blocks);
  cudaError_t e =
      id64 ? launch(t, C, static_cast<const long long*>(ids), n, n_store, rows_per_block, r,
                    accumulate, b, s)
           : launch(t, C, static_cast<const int*>(ids), n, n_store, rows_per_block, r,
                    accumulate, b, s);
  return static_cast<int>(e);
}
