// Row scatter-add into pinned host memory:
//   table[ids[k], :] += rows[k, :]  for k < n   (accumulate != 0)
//   table[ids[k], :]  = rows[k, :]  for k < n   (accumulate == 0)
// where `table` is the (C, 48) float32 SH-gradient table in pinned
// (page-locked) host memory, read and written by the card through its mapped
// device address, `rows` (n, 48) float32 in device memory and `ids` an int32
// or int64 list on the card, unique within a launch.
//
// Replaces clm_gs_tpu/utils/hostmem.py:135 PinnedGradBuffer.offload, the JAX
// package's D2H direction of the pinned transport: an XLA scatter-add program
// over a table donated in the `pinned_host` memory space (not a Pallas
// kernel). Both stand for the reference CLM-GS's
// send_shs2cpu_grad_buffer_stream: the SH-gradient rows that leave the
// working set added straight into a pinned host buffer by a device index
// list, with no download into a staging buffer and no host scatter.
//
// Bound on the H100: bytes over PCIe. With accumulate, each row's 192 bytes
// cross the bus twice, read (host to card) and written back (card to host),
// one in each direction; without it, written only. Design:
// - The n x 12 float4 words are dealt to the threads in order, so twelve
//   neighbouring lanes carry one row as twelve 16-byte words, as in
//   pinned_gather.cu.
// - A grid-stride loop over enough resident threads keeps far more reads in
//   flight than the bus's latency needs.
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
//   reads the rows only after waiting on that event. Plain stores and one
//   fence a thread were chosen over write-through stores on every word: the
//   fence is one wait a thread, at its end, and does not depend on how the
//   L2 treats stores to system memory.
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

namespace {

constexpr int kCols = 48;
constexpr int kWords = kCols / 4;  // float4 words a row
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;    // 2048 resident threads an SM

template <typename Id, bool Accumulate>
__global__ void __launch_bounds__(kThreads)
scatter_rows(float4* __restrict__ table, long long C, const Id* __restrict__ ids,
             long long n, const float4* __restrict__ rows) {
  const long long total = n * kWords;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long k = i / kWords;
    const long long id = static_cast<long long>(ids[k]);
    if (id < 0 || id >= C) __trap();
    float4* dst = table + id * kWords + (i - k * kWords);
    float4 v = rows[i];
    if (Accumulate) {
      const float4 old = __ldcv(dst);
      v.x = old.x + v.x;
      v.y = old.y + v.y;
      v.z = old.z + v.z;
      v.w = old.w + v.w;
    }
    *dst = v;
  }
  __threadfence_system();
}

template <typename Id>
void launch(float4* t, long long C, const Id* ids, long long n, const float4* rows,
            int accumulate, unsigned blocks, cudaStream_t s) {
  if (accumulate) {
    scatter_rows<Id, true><<<blocks, kThreads, 0, s>>>(t, C, ids, n, rows);
  } else {
    scatter_rows<Id, false><<<blocks, kThreads, 0, s>>>(t, C, ids, n, rows);
  }
}

}  // namespace

// table: the card's address of the (C, 48) f32 table, 16-byte aligned;
// ids: (n,) int32 (id64 == 0) or int64 on the card, unique; rows: (n, 48)
// f32 on the card; accumulate: add (1) or store (0).
extern "C" int clmgs_pinned_scatter(void* table, long long C, const void* ids, int id64,
                                    long long n, const float* rows, int accumulate,
                                    void* stream) {
  if (C < 0 || n < 0 || (reinterpret_cast<unsigned long long>(table) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (n * kWords + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* t = static_cast<float4*>(table);
  const float4* r = reinterpret_cast<const float4*>(rows);
  if (id64) {
    launch(t, C, static_cast<const long long*>(ids), n, r, accumulate, blocks, s);
  } else {
    launch(t, C, static_cast<const int*>(ids), n, r, accumulate, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
