// Compositing forward: for each pixel, front-to-back alpha compositing of its
// tile's depth-ordered instances, alpha = min(0.999, op * exp(-sigma)); an
// instance with alpha < 1/255 is skipped and a pixel stops before the
// instance that would bring its transmittance T to <= 1e-4.
//
// Replaces clm_gs_tpu/ops/rasterize.py:321 _fwd_kernel (pallas_call at :762
// in _rasterize_sorted_fwd), which evaluates the same rule in closed form
// over (chunk x pixel) matrices.
//
// Bound on the H100: operations. Every (instance, pixel) pair up to the
// pixel's termination costs at least a quadratic form, while the bytes are
// one 36-byte table row per instance and a few floats per pixel. Tensor
// cores do not fit: nothing here is a matrix product. Most pairs (four in
// five on the bench scene) fail the alpha test, so the design makes that
// test cheap and keeps pixels moving:
// - A 64x32 tile is split into eight 16x16 blocks of one pixel per thread,
//   so 8x as many blocks as tiles fill the 132 SMs; each walks its tile's
//   instance range [tile_offsets[t], tile_offsets[t+1]) in batches of 256
//   table rows, read through gauss_ids into shared memory (one row per
//   thread, padded to 12 floats and read back as three 16-byte loads), and
//   leaves the loop as soon as every pixel of the block has terminated.
// - The thread that stages a row also stores its sigma_cut
//   (raster_common.cuh), so a pair whose sigma is past it is rejected
//   without the exp.
// - A thread tests kGroup instances before it composites any of them: the
//   tests are independent, so their latencies overlap.
// Each pixel writes its colour with the background folded in, its alpha,
// and for the backward its final T and the index of its last composited
// instance (-1 when none).

#include "raster_common.cuh"

namespace {

using namespace clmgs;

constexpr int kSub = 16;  // 16x16 sub-block, one pixel per thread
constexpr int kThreads = kSub * kSub;
constexpr int kBatch = kThreads;
constexpr int kGroup = 8;  // instances a thread alpha-tests together

__global__ void __launch_bounds__(kThreads)
    rasterize_fwd_kernel(const float* __restrict__ table,
                         const int* __restrict__ ids,
                         const int* __restrict__ tile_offsets,
                         const float* __restrict__ bg, int width, int height,
                         int tiles_x, float* __restrict__ image,
                         float* __restrict__ alpha_out,
                         float* __restrict__ t_out, int* __restrict__ last_out) {
  __shared__ __align__(16) float s_attr[kBatch][kRowStride];
  const int tile = blockIdx.x;
  const int sub = blockIdx.y;  // 4 across, 2 down
  const int x = (tile % tiles_x) * kTileW + (sub & 3) * kSub + (threadIdx.x % kSub);
  const int y = (tile / tiles_x) * kTileH + (sub >> 2) * kSub + (threadIdx.x / kSub);
  const bool inside = x < width && y < height;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];

  float T = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, acc = 0.f;
  int last = -1;
  bool done = !inside;
  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier before the batch buffer is overwritten
    if (__syncthreads_count(done) == kThreads) break;
    const int k = b0 + threadIdx.x;
    if (k < end) {
      const float* row = table + (long long)ids[k] * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s_attr[threadIdx.x][c] = row[c];
      s_attr[threadIdx.x][kCols] = sigma_cut(row[5]);
    }
    __syncthreads();
    const int nb = min(kBatch, end - b0);
    for (int i0 = 0; i0 < nb && !done; i0 += kGroup) {
      float al[kGroup];
      unsigned hit = 0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (i0 + j >= nb) break;
        float a[kRowStride];
        load_row(s_attr[i0 + j], a);
        float dx, dy, vis, ga;
        if (!past_cut(a, px, py) && splat_alpha(a, px, py, dx, dy, vis, ga, al[j]))
          hit |= 1u << j;
      }
      if (!hit) continue;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (!((hit >> j) & 1u) || done) continue;
        const float* a = s_attr[i0 + j];
        const float next_T = T * (1.f - al[j]);
        if (next_T <= kTEps) {
          done = true;
          continue;
        }
        const float w = al[j] * T;
        c0 += w * a[6];
        c1 += w * a[7];
        c2 += w * a[8];
        acc += w;
        T = next_T;
        last = b0 + i0 + j;
      }
    }
  }
  if (inside) {
    const long long hw = (long long)width * height;
    const long long p = (long long)y * width + x;
    image[p] = c0 + T * bg[0];
    image[hw + p] = c1 + T * bg[1];
    image[2 * hw + p] = c2 + T * bg[2];
    alpha_out[p] = acc;
    t_out[p] = T;
    last_out[p] = last;
  }
}

}  // namespace

// table: (N, 9) f32; ids: (M,) int32 tile-major instance list; tile_offsets:
// (num_tiles + 1,) int32; bg: (3,) f32. Outputs image (3, H, W), alpha,
// t_final (H, W) f32 and last (H, W) int32; every pixel is written.
extern "C" int clmgs_rasterize_fwd(const float* table, const int* ids,
                                   const int* tile_offsets, const float* bg,
                                   int width, int height, int tiles_x,
                                   int tiles_y, float* image, float* alpha,
                                   float* t_final, int* last, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles_x * tiles_y, (kTileW / kSub) * (kTileH / kSub));
  rasterize_fwd_kernel<<<grid, kThreads, 0, s>>>(
      table, ids, tile_offsets, bg, width, height, tiles_x, image, alpha,
      t_final, last);
  return static_cast<int>(cudaGetLastError());
}
