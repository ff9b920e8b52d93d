// Forward fill of C int32 channels, "rightmost valid wins", where a slot is
// valid when channel 0 is nonzero; slots before the first valid one get 0.
//
// Replaces clm_gs_tpu/ops/fill_pallas.py:35 _fill_kernel (dispatched from
// ops/tiles.py _forward_fill in the binning expansion).
//
// Bound on the H100: bytes. Each element is read once and written once per
// channel; the arithmetic is a max-scan of slot indices. Design: one launch,
// each block fills a tile of kTile slots.
// - The tile of every channel, and the kBefore slots before it, are staged
//   in shared memory with 16-byte cp.async (stream_copy.cuh keeps each
//   row's alignment, so rows that start off a 16-byte boundary, n % 4 != 0,
//   still move in 16-byte pieces). The block's carry, the rightmost valid
//   slot before its tile, is nearly always among the staged slots before it,
//   values and all: in the binning every Gaussian's first slot is valid, so
//   the gap is shorter than one Gaussian's instance count (at most 131 on
//   the bench scene).
// - Only when those slots hold no valid one does the block look further
//   back, through flags that every block publishes in a persistent scratch:
//   "prefix" (the rightmost valid slot up to its tile's end) as soon as it
//   knows it, or "empty" (no valid slot in its tile, prefix not known yet).
//   A warp reads 32 flags at a time and stops at the nearest prefix, so any
//   input stays O(n). Each flag carries the call's epoch, so the scratch is
//   never cleared. Waiting on an earlier block relies on blocks starting in
//   index order, as CUB's single-pass scan does.
// - A max-scan of (valid ? slot : -1) over the tile in slot order (warp
//   shuffles, then one warp over the warp maxima) gives each slot its
//   source; each invalid slot copies its source's value in place, in shared
//   memory (sources are valid slots, which are never written), and the tile
//   goes back with 16-byte stores.

#include <cuda_runtime.h>

#include "stream_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                     // slots a thread: s = r * kThreads + tid
constexpr int kTile = kThreads * kRows;      // slots a block
constexpr int kBefore = 512;                 // slots staged before the tile
constexpr int kStride = kBefore + kTile + 8;  // ints of shared memory a channel
constexpr int kMaxChannels = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPrefix = 1ull << 31;  // flag kind; else "empty"

constexpr int kPerLane = kRows * kWarps / 32;  // warp maxima a lane of warp 0 scans
static_assert(kRows * kWarps % 32 == 0, "warp 0 scans the warp maxima");

__device__ __forceinline__ unsigned long long flag_word(unsigned epoch, bool prefix,
                                                        int slot) {
  return ((unsigned long long)epoch << 32) | (prefix ? kPrefix : 0ull) |
         (unsigned long long)(slot + 1);
}

__device__ __forceinline__ void publish(unsigned long long* flags, int b,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(flags + b) = word;
}

// The rightmost valid slot before tile b (-1 if none), from the flags of
// tiles b-1, b-2, ..., 32 at a time, by one whole warp.
__device__ int look_back(const unsigned long long* flags, int b, unsigned epoch,
                         int lane) {
  for (int k0 = b - 1;; k0 -= 32) {
    const int k = k0 - lane;
    unsigned long long f = 0;
    if (k >= 0) {
      do {
        f = *reinterpret_cast<const volatile unsigned long long*>(flags + k);
      } while ((unsigned)(f >> 32) != epoch);
    }
    const bool stop = k < 0 || (f & kPrefix);
    const unsigned hit = __ballot_sync(kFull, stop);
    if (hit) {
      const int v = k < 0 ? -1 : (int)(f & 0x7fffffffu) - 1;
      return __shfl_sync(kFull, v, __ffs(hit) - 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fill_tile(const int* __restrict__ in, int* __restrict__ out, int n, int c,
          unsigned long long* __restrict__ flags, unsigned epoch) {
  extern __shared__ __align__(16) int buf[];  // c channels, kStride ints each
  __shared__ int excl[kRows * kWarps];        // warp maxima, then their prefixes
  __shared__ int window[kWarps];
  __shared__ int carry_slot;
  __shared__ int carry_val[kMaxChannels];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ts = blockIdx.x * kTile;
  const int len = min(kTile, n - ts);
  const int pre = min(kBefore, ts);
  for (int ch = 0; ch < c; ++ch) {
    const long long e0 = (long long)ch * n + ts;
    clmgs::stage_range(buf + ch * kStride, in, e0 - pre, e0 + len, tid, kThreads);
  }
  clmgs::cp_async_commit();
  clmgs::cp_async_wait<0>();
  __syncthreads();
  // channel ch's buffer index of tile slot 0, in stage_range's layout
  auto off = [&](int ch) {
    const long long e = (long long)ch * n + ts;
    return (int)(e - ((e - pre) & ~3LL));
  };
  const int* row0 = buf + off(0);
  // the rightmost valid slot among those staged before the tile
  int wbest = -1;
  for (int j = tid; j < pre; j += kThreads) {
    if (row0[j - pre] != 0) wbest = ts - pre + j;
  }
  wbest = __reduce_max_sync(kFull, wbest);
  if (lane == 0) window[warp] = wbest;
  int src[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = r * kThreads + tid;
    int v = (s < len && row0[s] != 0) ? ts + s : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = max(v, u);
    }
    src[r] = v;
    if (lane == 31) excl[r * kWarps + warp] = v;
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive max-scan of the warp maxima in slot order, kPerLane a lane
    int mine[kPerLane];
    int incl = -1;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      mine[j] = excl[kPerLane * lane + j];
      incl = max(incl, mine[j]);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, u);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = -1;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      excl[kPerLane * lane + j] = before;
      before = max(before, mine[j]);
    }
    const int agg = __shfl_sync(kFull, incl, 31);
    int carry = __reduce_max_sync(kFull, lane < kWarps ? window[lane] : -1);
    // the staged slots before the tile reach slot 0, or hold a valid slot
    const bool known = carry >= 0 || pre == ts;
    if (lane == 0) {
      if (agg >= 0 || known) {
        publish(flags, blockIdx.x, flag_word(epoch, true, max(agg, carry)));
      } else {
        publish(flags, blockIdx.x, flag_word(epoch, false, -1));
      }
    }
    if (!known) {
      carry = look_back(flags, blockIdx.x, epoch, lane);
      if (lane == 0 && agg < 0) {
        publish(flags, blockIdx.x, flag_word(epoch, true, carry));
      }
      if (lane < c && carry >= 0) carry_val[lane] = in[(long long)lane * n + carry];
    }
    if (lane == 0) carry_slot = carry;
  }
  __syncthreads();

  const int carry = carry_slot;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = r * kThreads + tid;
    const int from = max(src[r], max(excl[r * kWarps + warp], carry));
    if (s >= len || from == ts + s) continue;
    for (int ch = 0; ch < c; ++ch) {
      int* row = buf + ch * kStride + off(ch);
      row[s] = from >= ts - pre ? row[from - ts] : (from >= 0 ? carry_val[ch] : 0);
    }
  }
  __syncthreads();
  for (int ch = 0; ch < c; ++ch) {
    const long long e0 = (long long)ch * n + ts;
    clmgs::store_range(out, buf + ch * kStride + off(ch) - (int)(e0 & 3), e0, e0 + len,
                       tid, kThreads);
  }
}

}  // namespace

// in, out: (c, n) int32 contiguous on the device, 1 <= c <= 4; flags:
// nflags >= ceil(n / kTile) 64-bit words kept between calls (zeros when
// new); epoch: nonzero and different from the previous call's on the same
// flags.
extern "C" int clmgs_forward_fill(const int* in, int* out, int n, int c,
                                  unsigned long long* flags, int nflags,
                                  unsigned epoch, void* stream) {
  const int nblocks = (int)(((long long)n + kTile - 1) / kTile);
  if (n < 0 || c < 1 || c > kMaxChannels || epoch == 0 || nflags < nblocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * kStride * c;
  if (nblocks > 0) {
    fill_tile<<<nblocks, kThreads, smem, s>>>(in, out, n, c, flags, epoch);
  }
  return static_cast<int>(cudaGetLastError());
}
