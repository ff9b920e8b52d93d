// Block-wide copies between a range of a 4-byte-element array in device
// memory and shared memory, shared by segreduce.cu and fill.cu.
//
// Element e of the range [e0, e1) sits at smem[e - (e0 & ~3)]: shared memory
// keeps the array's 16-byte alignment, so every aligned group of 4 elements
// that lies wholly inside the range moves as one 16-byte copy, and only the
// partial groups at the two ends move element by element. That holds for any
// e0, so a row of a (C, n) tensor moves with 16-byte copies whatever n is.
// `smem` is 16-byte aligned and holds e1 - (e0 & ~3) elements rounded up to
// a multiple of 4. Every thread of the block calls with its own `tid`.
#pragma once

#include <cuda_runtime.h>

namespace clmgs {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start (cp.async, not waited for) the copy of gmem[e0, e1) into smem.
template <typename T>
__device__ __forceinline__ void stage_range(T* smem, const T* gmem, long long e0,
                                            long long e1, int tid, int nthreads) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const long long base = e0 & ~3LL;
  const int groups = static_cast<int>((e1 - base + 3) >> 2);
  for (int q = tid; q < groups; q += nthreads) {
    const long long g = base + 4LL * q;
    if (g >= e0 && g + 4 <= e1) {
      cp_async16(smem + 4 * q, gmem + g);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (g + j >= e0 && g + j < e1) cp_async4(smem + 4 * q + j, gmem + g + j);
      }
    }
  }
}

// Write smem, laid out as stage_range lays it out, to gmem[e0, e1).
template <typename T>
__device__ __forceinline__ void store_range(T* gmem, const T* smem, long long e0,
                                            long long e1, int tid, int nthreads) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const long long base = e0 & ~3LL;
  const int groups = static_cast<int>((e1 - base + 3) >> 2);
  for (int q = tid; q < groups; q += nthreads) {
    const long long g = base + 4LL * q;
    if (g >= e0 && g + 4 <= e1) {
      *reinterpret_cast<int4*>(gmem + g) = *reinterpret_cast<const int4*>(smem + 4 * q);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (g + j >= e0 && g + j < e1) gmem[g + j] = smem[4 * q + j];
      }
    }
  }
}

}  // namespace clmgs
