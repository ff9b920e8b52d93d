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
// Bound on the H100: bytes over PCIe. Each row's 192 bytes cross the bus
// once; the ids and the output stay in device memory. Design:
// - The n x 12 float4 words of the output are dealt to the threads in order,
//   so twelve neighbouring lanes carry one row as twelve 16-byte loads and a
//   warp covers two and two-thirds rows. A row is 192 bytes, three 64-byte
//   segments, and the table starts on a page: no two rows share a segment,
//   so the host Adam's writes to other rows never meet a row the card reads.
// - A grid-stride loop over enough resident threads keeps far more reads in
//   flight than the bus's latency needs.
// - Loads are ld.global.cv: a cached line of system memory counts as stale
//   and is fetched again, so a row the host rewrote after an earlier launch
//   is never served from the L2.
// - An id outside [0, C) traps (the launch fails, and the next
//   synchronisation raises) instead of reading outside the table.
//
// The card's address of the table is looked up with cudaPointerGetAttributes
// on every call (clmgs_pinned_device_ptr): the caching host allocator
// (cudaHostAlloc) maps it at the host address under UVA, cudaHostRegister
// may map it elsewhere, and the caller's table is replaced when it grows.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 48;
constexpr int kWords = kCols / 4;  // float4 words a row
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;    // 2048 resident threads an SM

template <typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rows(const float4* __restrict__ table, long long C, const Id* __restrict__ ids,
            long long n, float4* __restrict__ out) {
  const long long total = n * kWords;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long k = i / kWords;
    const long long id = static_cast<long long>(ids[k]);
    if (id < 0 || id >= C) __trap();
    out[i] = __ldcv(table + id * kWords + (i - k * kWords));
  }
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
// the card, every entry written.
extern "C" int clmgs_pinned_gather(const void* table, long long C, const void* ids,
                                   int id64, long long n, float* out, void* stream) {
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
  const float4* t = static_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out);
  if (id64) {
    gather_rows<long long><<<blocks, kThreads, 0, s>>>(
        t, C, static_cast<const long long*>(ids), n, o);
  } else {
    gather_rows<int><<<blocks, kThreads, 0, s>>>(t, C, static_cast<const int*>(ids), n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
