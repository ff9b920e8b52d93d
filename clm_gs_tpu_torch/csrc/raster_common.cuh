// Per-instance compositing math shared by rasterize_fwd.cu and
// rasterize_bwd.cu. Both kernels must evaluate alpha with the same rounding
// so the backward replays the forward's transmittance exactly; the sigma
// form uses round-to-nearest intrinsics, which also keeps the compiler from
// contracting it into FMAs (as the plain PyTorch version does not).
#pragma once

#include <cuda_runtime.h>

namespace clmgs {

constexpr int kTileW = 64;  // tile shape of clm_gs_tpu/ops/rasterize.py:65-67
constexpr int kTileH = 32;
constexpr int kCols = 9;  // table columns: mx, my, ca, cb, cc, op, r, g, b
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;

// sigma of splat `a` (kCols floats) at the pixel centre (px, py), with the
// offsets dx, dy. Round-to-nearest intrinsics: both kernels get the same bits.
__device__ __forceinline__ float splat_sigma(const float* a, float px, float py,
                                             float& dx, float& dy) {
  dx = __fsub_rn(px, a[0]);
  dy = __fsub_rn(py, a[1]);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a[2], dx), dx),
                            __fmul_rn(__fmul_rn(a[4], dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(a[3], dx), dy));
}

// Beyond this sigma an instance of opacity op has alpha < 1/255 whatever
// expf rounds to: op * exp(-sigma) < exp(-1e-3) / 255, a margin far above the
// errors of logf, expf and the product. Staged with each row, in its pad slot
// kCols.
__device__ __forceinline__ float sigma_cut(float op) {
  return logf(255.f * op) + 1e-3f;
}

// True when the staged row `a` (a table row followed by its sigma_cut) is
// past its cut at (px, py): then splat_alpha would return false. Tested
// first, it rejects most pairs without the exp.
__device__ __forceinline__ bool past_cut(const float* a, float px, float py) {
  float dx, dy;
  return splat_sigma(a, px, py, dx, dy) > a[kCols];
}

// alpha of splat `a` at the pixel centre (px, py). Returns false when the
// instance is skipped there (sigma < 0 or alpha < 1/255).
__device__ __forceinline__ bool splat_alpha(const float* a, float px, float py,
                                            float& dx, float& dy, float& vis,
                                            float& ga, float& alpha) {
  const float sigma = splat_sigma(a, px, py, dx, dy);
  if (sigma < 0.f) return false;
  vis = expf(-sigma);
  ga = __fmul_rn(a[5], vis);
  alpha = fminf(kMaxAlpha, ga);
  return alpha >= kAlphaThreshold;
}

// Shared-memory table rows are padded to 12 floats, so a row reads as three
// 16-byte loads: the 9 columns, the row's sigma_cut and two unused floats.
constexpr int kRowStride = 12;

__device__ __forceinline__ void load_row(const float* s_row, float (&a)[kRowStride]) {
  const float4* r = reinterpret_cast<const float4*>(s_row);
#pragma unroll
  for (int j = 0; j < kRowStride / 4; ++j) {
    const float4 f = r[j];
    a[4 * j] = f.x;
    a[4 * j + 1] = f.y;
    a[4 * j + 2] = f.z;
    a[4 * j + 3] = f.w;
  }
}

}  // namespace clmgs
