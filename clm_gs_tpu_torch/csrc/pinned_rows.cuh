// The geometry pinned_gather.cu and pinned_scatter.cu share: a block of
// kThreads walks one contiguous range of rows; a warp moves kGroupRows rows
// of 48 floats as 96 float4 words, kLaneWords a lane, each .cu's kDepth groups a step.
#pragma once

#include <cuda_runtime.h>

namespace pinned {

constexpr int kCols = 48;
constexpr int kWords = kCols / 4;  // float4 words a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 8;                           // rows a warp group moves
constexpr int kLaneWords = kGroupRows * kWords / 32;  // 3 words a lane a group

// A lane's three words of a group: word lane + 32 w is word col[w] of the
// group's row row[w].
struct Lane {
  int row[kLaneWords];
  int col[kLaneWords];
  __device__ explicit Lane(int lane) {
#pragma unroll
    for (int w = 0; w < kLaneWords; ++w) {
      const int j = lane + 32 * w;
      row[w] = j / kWords;
      col[w] = j - row[w] * kWords;
    }
  }
};

// The table's float4 index of word `col` of row `id`; an id outside [0, C)
// traps.
template <typename Id>
__device__ __forceinline__ long long word_of(Id raw, long long C, int col) {
  const long long id = static_cast<long long>(raw);
  if (id < 0 || id >= C) __trap();
  return id * kWords + col;
}

// The C entries' argument check: a 16-byte aligned table, and `blocks`
// ranges of rows_per_block rows that cover the n rows.
inline bool valid(const void* table, long long C, long long n, int blocks,
                  long long rows_per_block) {
  if (C < 0 || n < 0 || (reinterpret_cast<unsigned long long>(table) & 15) != 0) return false;
  if (n == 0) return true;
  return blocks > 0 && rows_per_block > 0 && (long long)blocks * rows_per_block >= n;
}

}  // namespace pinned
