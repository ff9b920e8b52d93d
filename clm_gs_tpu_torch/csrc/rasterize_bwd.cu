// Compositing backward: the hand-derived VJP of rasterize_fwd.cu. For each
// instance k it writes one row of 9 gradients, summed over its tile's pixels:
// d/d(mx, my, ca, cb, cc, op, r, g, b).
//
// Replaces clm_gs_tpu/ops/rasterize.py:372 _bwd_kernel (pallas_call at :892
// in _rasterize_sorted_bwd). Same math, front to back: with w_k = alpha_k T_k
// the compositing weight, ctilde = [rgb, 1] and v4 = [v_rgb, v_alpha],
//   d<v4, out>/d alpha_k = T_k <ctilde_k, v4> - (d_tot - E_k) / (1 - alpha_k),
//   d_tot = <v4, out>,  E_k = sum_{j <= k} w_j <ctilde_j, v4>,
// where out already holds the background term. No gradient flows through the
// 0.999 clamp. A pixel takes part up to the last instance the forward
// composited there (saved per pixel), which replays the forward's
// termination without re-deciding it; T is replayed with the forward's own
// arithmetic (raster_common.cuh).
//
// Bound on the H100: operations (an exp, compares and f32 sums per pair,
// plus a 9-value sum over the tile's pixels per instance). Tensor cores do
// not fit: nothing here is a matrix product. What cost the earlier design
// (one block per tile, 8 pixels per thread) its time was walking pairs that
// do no work, reducing instances no pixel of a warp touched, and the exp of
// pairs that fail the alpha test. The design:
// - A 64x32 tile runs as a cluster of eight blocks, one per 16x16 sub-tile,
//   one pixel per thread. A warp covers a compact 16x2 patch and stops its
//   pixel work after the deepest saved last index of its 32 pixels (the
//   walk falls from 594M to 314M slots on the bench scene); a block stops
//   after its sub-tile's. The cluster walks to the deepest of its eight.
// - Per instance a warp sums its 9 values with a reduce-scatter of 12
//   shuffles, and skips it when no lane touched the instance.
// - Per batch of 96 instances each block adds its warps' sums in shared
//   memory; block r then adds the eight blocks' sums of its 12 instances
//   through distributed shared memory, in rank order, and writes each row
//   once. No atomics, no scratch in device memory: rows are bit-identical
//   from run to run. Blocks and warps that have ended add nothing. The
//   cluster barrier is split (arrive after a batch's sums, wait before the
//   next batch's rows are written), so the blocks drift a batch apart
//   instead of meeting after every batch. Rows after the tile's last
//   contributor are written as 0.
// - The next batch's table rows are staged with cp.async into a double
//   buffer (rows padded to 12 floats) while the current one is computed,
//   with each row's sigma_cut, so most pairs are rejected without the exp
//   (past_cut, raster_common.cuh).
// - 1 / (1 - alpha) in the gradient is __fdividef (2 ulp); 48 registers let
//   five blocks share an SM.
// Determinism has a price: waiting for the deepest sub-tile and the
// cluster's barriers; PERF.md times a variant that adds with atomics.

#include <cooperative_groups.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace clmgs;

constexpr int kSub = 16;  // 16x16 sub-tile per block, one pixel per thread
constexpr int kThreads = kSub * kSub;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = (kTileW / kSub) * (kTileH / kSub);  // 8 blocks
constexpr int kBatch = 96;
constexpr int kShare = kBatch / kCluster;  // rows each block writes per batch
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int half_up(int n) { return (n + 1) / 2; }

// One step of the transpose reduction: lanes with bit O clear keep the
// first half of the N values, lanes with it set the second half, each
// adding its partner's copy of the half it keeps.
template <int N, int O>
__device__ __forceinline__ void halve(const float (&in)[N],
                                      float (&out)[half_up(N)], int lane) {
  constexpr int L = half_up(N);
  const bool hi = lane & O;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float a = in[j], b = j + L < N ? in[j + L] : 0.f;
    out[j] = (hi ? b : a) + __shfl_xor_sync(kFull, hi ? a : b, O);
  }
}

// Sum each of the 9 values over the warp's 32 lanes (a reduce-scatter):
// every step halves the values a lane holds (9, 5, 3, 2, 1, 1), 12 shuffles
// where 9 separate shuffle trees take 45. The sum of column rs_col(lane)
// ends in the lane.
__device__ __forceinline__ float reduce_scatter(const float (&g)[kCols],
                                                int lane) {
  constexpr int L1 = half_up(kCols), L2 = half_up(L1), L3 = half_up(L2),
                L4 = half_up(L3);
  float a1[L1], a2[L2], a3[L3], a4[L4], out[1];
  halve<kCols, 16>(g, a1, lane);
  halve<L1, 8>(a1, a2, lane);
  halve<L2, 4>(a2, a3, lane);
  halve<L3, 2>(a3, a4, lane);
  halve<L4, 1>(a4, out, lane);
  return out[0];
}

// The column whose sum reduce_scatter leaves in `lane`, or -1: the lanes
// whose halvings all kept real columns, one of each pair.
__device__ __forceinline__ int rs_col(int lane) {
  int n = kCols, col = 0, count = kCols;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int lo = half_up(n);
    if (lane & o) {
      col += lo;
      count = max(0, count - lo);
    } else {
      count = min(count, lo);
    }
    n = lo;
  }
  return count > 0 ? col : -1;
}

// 4-byte asynchronous copy from device to shared memory (cp.async, sm_80+).
// Table rows are 36 bytes, so a row is not 16-byte aligned in device memory.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 5)
    rasterize_bwd_kernel(const float* __restrict__ table,
                         const int* __restrict__ ids,
                         const int* __restrict__ tile_offsets, int width,
                         int height, int tiles_x,
                         const float* __restrict__ image,
                         const float* __restrict__ alpha,
                         const int* __restrict__ last,
                         const float* __restrict__ v_image,
                         const float* __restrict__ v_alpha,
                         float* __restrict__ rows) {
  __shared__ __align__(16) float s_attr[2][kBatch][kRowStride];
  __shared__ float s_warp[kWarps][kBatch][kCols];
  __shared__ float s_blk[2][kBatch][kCols];
  __shared__ int s_wlast[kWarps];
  __shared__ int s_blast;
  __shared__ int s_rlast[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = (tile % tiles_x) * kTileW + (rank % (kTileW / kSub)) * kSub +
                (threadIdx.x % kSub);
  const int y = (tile / tiles_x) * kTileH + (rank / (kTileW / kSub)) * kSub +
                (threadIdx.x / kSub);
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];

  int lastp = -1;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, dtot = 0.f;
  if (x < width && y < height) {
    const long long hw = (long long)width * height;
    const long long p = (long long)y * width + x;
    lastp = last[p];
    v0 = v_image[p];
    v1 = v_image[hw + p];
    v2 = v_image[2 * hw + p];
    v3 = v_alpha[p];
    dtot = v0 * image[p] + v1 * image[hw + p] + v2 * image[2 * hw + p] +
           v3 * alpha[p];
  }
  int wlast = lastp;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wlast = max(wlast, __shfl_xor_sync(kFull, wlast, o));
  if (lane == 0) s_wlast[warp] = wlast;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = s_wlast[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, s_wlast[w]);
    s_blast = m;
  }
  cluster.sync();  // every block's s_blast is set, and every peer is running
  if (threadIdx.x < kCluster)
    s_rlast[threadIdx.x] = *cluster.map_shared_rank(&s_blast, threadIdx.x);
  __syncthreads();
  int cmax = s_rlast[0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) cmax = max(cmax, s_rlast[r]);
  const int blast = s_rlast[rank];
  const int kend = min(end, max(start, cmax + 1));
  const int col = rs_col(lane);

  // Thread t < kBatch stages row t of each batch: its 9 columns with
  // cp.async, a batch ahead, and its sigma_cut from a plain load of the
  // opacity, stored after that batch's compute so the load's latency hides.
  int nid = -1;          // id of the row this thread stages next
  float nop = 0.f;       // the staged row's opacity
  bool staged = false;   // whether this thread staged a row for the next batch
  auto load_id = [&](int b0) {
    const int k = b0 + threadIdx.x;
    nid = threadIdx.x < kBatch && k < kend ? ids[k] : -1;
  };
  auto stage = [&](int b0, int buf) {
    // a block whose sub-tile has ended stages nothing
    staged = b0 <= blast && nid >= 0;
    if (staged) {
      const float* row = table + (long long)nid * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) cp_async4(&s_attr[buf][threadIdx.x][c], row + c);
      nop = row[5];
    }
    cp_async_commit();
  };
  auto stage_cut = [&](int buf) {
    if (staged) s_attr[buf][threadIdx.x][kCols] = sigma_cut(nop);
  };
  // rows of batch b0 from the eight blocks' sums in s_blk[buf]: this block
  // writes its share, adding the blocks in rank order
  auto write_rows = [&](int b0, int buf) {
    if (threadIdx.x < kShare * kCols) {
      const int i = rank * kShare + threadIdx.x / kCols;
      const int c = threadIdx.x % kCols;
      const int k = b0 + i;
      if (k < kend) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          if (k <= s_rlast[r])
            s += cluster.map_shared_rank(&s_blk[buf][0][0], r)[i * kCols + c];
        rows[(long long)k * kCols + c] = s;
      }
    }
  };
  load_id(start);
  stage(start, 0);
  stage_cut(0);
  load_id(start + kBatch);

  float T = 1.f, E = 0.f;  // the pixel's replayed transmittance and E_k
  int buf = 0;
  for (int b0 = start; b0 < kend; b0 += kBatch, buf ^= 1) {
    const int nb = min(kBatch, kend - b0);
    stage(b0 + kBatch, buf ^ 1);  // an empty group past the end
    load_id(b0 + 2 * kBatch);
    cp_async_wait<1>();
    __syncthreads();  // this batch's rows are in shared memory
    if (b0 <= blast) {
      for (int i = 0; i < nb && b0 + i <= wlast; ++i) {
        float a[kRowStride];
        load_row(s_attr[buf][i], a);
        float g[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) g[c] = 0.f;
        bool touched = false;
        float dx, dy, vis, ga, al;
        if (b0 + i <= lastp && !past_cut(a, px, py) &&
            splat_alpha(a, px, py, dx, dy, vis, ga, al)) {
          touched = true;
          const float om = 1.f - al;
          const float w = al * T;
          const float dot1 = a[6] * v0 + a[7] * v1 + a[8] * v2 + v3;
          E += w * dot1;
          if (ga <= kMaxAlpha) {
            const float v_a = T * dot1 - __fdividef(dtot - E, om);
            const float v_sigma = -ga * v_a;
            g[0] = -(a[2] * dx + a[3] * dy) * v_sigma;
            g[1] = -(a[4] * dy + a[3] * dx) * v_sigma;
            g[2] = 0.5f * dx * dx * v_sigma;
            g[3] = dx * dy * v_sigma;
            g[4] = 0.5f * dy * dy * v_sigma;
            g[5] = vis * v_a;
          }
          g[6] = w * v0;
          g[7] = w * v1;
          g[8] = w * v2;
          T = T * om;  // the forward's next_T = T * (1 - alpha)
        }
        // a compact 16x2 patch is missed by many instances
        float sum = 0.f;
        if (__any_sync(kFull, touched)) sum = reduce_scatter(g, lane);
        if (col >= 0) s_warp[warp][i][col] = sum;
      }
    }
    __syncthreads();
    // the previous batch's rows, once every block has its sums in s_blk;
    // waiting here rather than after this batch's compute lets the blocks
    // of a cluster drift a batch apart
    if (b0 > start) {
      cluster_wait();
      write_rows(b0 - kBatch, buf ^ 1);
    }
    if (b0 <= blast) {
      // the block's sum per instance, over the warps still walking there
      for (int q = threadIdx.x; q < nb * kCols; q += kThreads) {
        const int i = q / kCols;
        const int k = b0 + i;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (k <= s_wlast[w]) s += s_warp[w][i][q - i * kCols];
        s_blk[buf][i][q - i * kCols] = s;
      }
    }
    cluster_arrive();
    stage_cut(buf ^ 1);  // published by the next batch's barrier
  }
  if (kend > start) {
    cluster_wait();
    write_rows(kend - 1 - (kend - 1 - start) % kBatch, buf ^ 1);
  }
  // instances after the tile's last contributor get zero gradient
  for (long long q = (long long)kend * kCols + rank * kThreads + threadIdx.x;
       q < (long long)end * kCols; q += kThreads * kCluster)
    rows[q] = 0.f;
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while a peer may still read its s_blk
}

}  // namespace

// Inputs as saved by clmgs_rasterize_fwd plus the cotangents v_image
// (3, H, W) and v_alpha (H, W). rows: (M, 9) f32, every row written. One
// cluster of 8 blocks per tile.
extern "C" int clmgs_rasterize_bwd(const float* table, const int* ids,
                                   const int* tile_offsets, int width,
                                   int height, int tiles_x, int tiles_y,
                                   const float* image, const float* alpha,
                                   const int* last, const float* v_image,
                                   const float* v_alpha, float* rows,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rasterize_bwd_kernel<<<tiles_x * tiles_y * kCluster, kThreads, 0, s>>>(
      table, ids, tile_offsets, width, height, tiles_x, image, alpha, last,
      v_image, v_alpha, rows);
  return static_cast<int>(cudaGetLastError());
}
