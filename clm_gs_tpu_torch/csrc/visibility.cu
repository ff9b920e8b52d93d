// clm's visibility pass: vis[b, r] = 1 where row r's Gaussian projects into
// camera b with a radius above radius_clip, for one row chunk and every
// camera of the batch.
//
// Replaces no Pallas kernel. The JAX package's counterpart,
// clm_gs_tpu/strategies/offload_common.py calculate_filters, maps the
// projection over the cameras inside one jit, which XLA fuses into a few
// kernels; the port's plain version (strategies/offload_common.py
// visibility_plain) launches each of the ~100 elementwise ops of
// ops/projection.py _project_one_cam alone, per camera and row chunk.
//
// Exactness: the mask equals visibility_plain's bit for bit. Every step is
// one of PyTorch's elementwise kernels there, rounded on its own, so this
// file takes the same operations in the same order through the _rn
// intrinsics, which are never contracted into FMAs, and the functions those
// kernels call (rsqrtf, expf, sqrtf, ceilf, IEEE division). Constants are
// the double literals PyTorch casts to float. The per-camera constants (the
// view rotation and translation, fx, fy, cx, cy and the clamp limits) come
// from the wrapper's camera_table, computed by the plain version's own torch
// expressions. NaN propagates through the clamps as PyTorch's clamp and
// clamp_min propagate it.
//
// Bound on the H100: a row reads 41 bytes (xyz, quat, log_scale, alive) and
// costs 106 float32 operations (its rotation and world covariance); a
// (row, camera) pair writes one byte and costs 20 operations to the plane
// tests, 150 more between the planes, none fused. So at B = 64 cameras the
// kernel is bound by operations (BigCity's 2^21-row chunk: 86 MB read and
// 134 MB written, 0.07 ms of HBM, against ~14.6 G operations, 0.22 ms at
// 67 TFLOP/s); at B <= 4 by bytes. Design: one thread a row, one launch a
// chunk for all cameras.
// - A thread reads its row once (quat in one 16-byte load) and keeps the
//   normalised rotation's world covariance in registers.
// - The cameras' constants pass through shared memory in tiles of kCamTile,
//   so any B works; each thread then loops over the tile's cameras, and
//   every camera's store of the block is one coalesced run of bytes.
// - A row that is dead, or behind or beyond a camera's planes, skips the
//   rest of that camera's arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCamTile = 64;
// floats a camera: Rcw row-major (9), tcw (3), fx, fy, cx, cy, the clamp
// bounds -lim_x_neg, lim_x_pos, -lim_y_neg, lim_y_pos
constexpr int kCamFloats = 20;

// PyTorch's float32 scalars: the Python doubles cast to float
constexpr float kNear = static_cast<float>(0.01);   // NEAR_PLANE
constexpr float kFar = static_cast<float>(1e10);    // FAR_PLANE
constexpr float kEps2d = static_cast<float>(0.3);   // EPS2D
constexpr float kQuatEps = static_cast<float>(1e-24);
constexpr float kDiscMin = static_cast<float>(0.01);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp(v, lo, hi) with finite bounds: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp_min(v, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ((a0 * b0 + a1 * b1) + a2 * b2), each step rounded
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

struct Row {
  float x, y, z;
  float cw[3][3];  // world covariance, symmetric
};

// ops/projection.py _rot_cols and covar_cols, in their order
__device__ __forceinline__ void world_covar(float4 q, float3 ls, float cw[3][3]) {
  float w = q.x, x = q.y, y = q.z, z = q.w;
  const float inv =
      rsqrtf(add(add(add(add(mul(w, w), mul(x, x)), mul(y, y)), mul(z, z)), kQuatEps));
  w = mul(w, inv);
  x = mul(x, inv);
  y = mul(y, inv);
  z = mul(z, inv);
  const float r[9] = {
      sub(1.f, mul(2.f, add(mul(y, y), mul(z, z)))),
      mul(2.f, sub(mul(x, y), mul(w, z))),
      mul(2.f, add(mul(x, z), mul(w, y))),
      mul(2.f, add(mul(x, y), mul(w, z))),
      sub(1.f, mul(2.f, add(mul(x, x), mul(z, z)))),
      mul(2.f, sub(mul(y, z), mul(w, x))),
      mul(2.f, sub(mul(x, z), mul(w, y))),
      mul(2.f, add(mul(y, z), mul(w, x))),
      sub(1.f, mul(2.f, add(mul(x, x), mul(y, y)))),
  };
  const float sx = expf(ls.x), sy = expf(ls.y), sz = expf(ls.z);
  const float s0 = mul(sx, sx), s1 = mul(sy, sy), s2 = mul(sz, sz);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      const float v = add(add(mul(mul(r[3 * i], r[3 * j]), s0),
                              mul(mul(r[3 * i + 1], r[3 * j + 1]), s1)),
                          mul(mul(r[3 * i + 2], r[3 * j + 2]), s2));
      cw[i][j] = v;
      cw[j][i] = v;
    }
  }
}

// ops/projection.py _project_one_cam(...)[0] > 0 for one row and camera c
// (kCamFloats floats), in its order
__device__ __forceinline__ bool visible(const Row& g, const float* c, float width,
                                       float height, float radius_clip) {
  const float* R = c;
  const float *t = c + 9, fx = c[12], fy = c[13], cx = c[14], cy = c[15];
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = add(dot3(g.x, R[3 * i], g.y, R[3 * i + 1], g.z, R[3 * i + 2]), t[i]);
  }
  const float z = p[2];
  if (!(z > kNear && z < kFar)) return false;  // z != 0, so zs == z

  const float rz = __fdiv_rn(1.f, z);
  const float rz2 = mul(rz, rz);
  const float tx = mul(z, clamp_nan(mul(p[0], rz), c[16], c[17]));
  const float ty = mul(z, clamp_nan(mul(p[1], rz), c[18], c[19]));

  // t[i][a] = sum_k Rcw[i, k] Cw[k][a]; cam(i, j) = sum_a t[i][a] Rcw[j, a]
  float tc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      tc[i][a] = dot3(R[3 * i], g.cw[0][a], R[3 * i + 1], g.cw[1][a], R[3 * i + 2],
                      g.cw[2][a]);
    }
  }
  auto cam = [&](int i, int j) {
    return dot3(tc[i][0], R[3 * j], tc[i][1], R[3 * j + 1], tc[i][2], R[3 * j + 2]);
  };
  const float c00 = cam(0, 0), c01 = cam(0, 1), c02 = cam(0, 2);
  const float c11 = cam(1, 1), c12 = cam(1, 2), c22 = cam(2, 2);

  const float j00 = mul(fx, rz);
  const float j02 = mul(mul(-fx, tx), rz2);
  const float j11 = mul(fy, rz);
  const float j12 = mul(mul(-fy, ty), rz2);
  const float sxx = add(add(mul(j00, add(mul(j00, c00), mul(j02, c02))),
                            mul(j02, add(mul(j00, c02), mul(j02, c22)))),
                        kEps2d);
  const float sxy = add(mul(j00, add(mul(j11, c01), mul(j12, c02))),
                        mul(j02, add(mul(j11, c12), mul(j12, c22))));
  const float syy = add(add(mul(j11, add(mul(j11, c11), mul(j12, c12))),
                            mul(j12, add(mul(j11, c12), mul(j12, c22)))),
                        kEps2d);
  const float det = sub(mul(sxx, syy), mul(sxy, sxy));
  if (!(det > 0.f)) return false;  // det_safe == det past here

  const float b = mul(0.5f, add(sxx, syy));
  const float v1 = add(b, sqrtf(clamp_min_nan(sub(mul(b, b), det), kDiscMin)));
  const float radius = ceilf(mul(3.f, sqrtf(v1)));
  const float mx = add(mul(mul(fx, p[0]), rz), cx);
  const float my = add(mul(mul(fy, p[1]), rz), cy);
  return add(mx, radius) > 0.f && sub(mx, radius) < width && add(my, radius) > 0.f &&
         sub(my, radius) < height && radius > radius_clip && radius > 0.f;
}

__global__ void __launch_bounds__(kThreads)
visibility(const float* __restrict__ xyz, const float4* __restrict__ quat,
           const float* __restrict__ log_scale, const unsigned char* __restrict__ alive,
           int rows, const float* __restrict__ cams, int n_cams, float width,
           float height, float radius_clip, unsigned char* __restrict__ vis) {
  __shared__ float tile[kCamTile * kCamFloats];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in = r < rows;
  bool live = in && (alive == nullptr || alive[r] != 0);
  Row g;
  if (live) {
    g.x = xyz[3 * r];
    g.y = xyz[3 * r + 1];
    g.z = xyz[3 * r + 2];
    const float3 ls = make_float3(log_scale[3 * r], log_scale[3 * r + 1],
                                  log_scale[3 * r + 2]);
    world_covar(quat[r], ls, g.cw);
  }
  for (int c0 = 0; c0 < n_cams; c0 += kCamTile) {
    const int nc = min(kCamTile, n_cams - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc * kCamFloats; i += kThreads) {
      tile[i] = cams[(size_t)c0 * kCamFloats + i];
    }
    __syncthreads();
    if (!in) continue;
    unsigned char* out = vis + (size_t)c0 * rows + r;
    for (int c = 0; c < nc; ++c) {
      out[(size_t)c * rows] =
          live && visible(g, tile + c * kCamFloats, width, height, radius_clip);
    }
  }
}

}  // namespace

// xyz, log_scale: (rows, 3) float32; quat: (rows, 4) float32, 16-byte
// aligned; alive: (rows,) bool or null (every row alive); cams: (n_cams,
// kCamFloats) float32; vis: (n_cams, rows) bool, written whole. All
// contiguous on the device.
extern "C" int clmgs_visibility(const float* xyz, const float* quat,
                                const float* log_scale, const unsigned char* alive,
                                int rows, const float* cams, int n_cams, int cam_floats,
                                float width, float height, float radius_clip,
                                unsigned char* vis, void* stream) {
  if (rows < 0 || n_cams < 0 || cam_floats != kCamFloats ||
      reinterpret_cast<size_t>(quat) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && n_cams > 0) {
    const int blocks = (int)(((long long)rows + kThreads - 1) / kThreads);
    visibility<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        xyz, reinterpret_cast<const float4*>(quat), log_scale, alive, rows, cams, n_cams,
        width, height, radius_clip, vis);
  }
  return static_cast<int>(cudaGetLastError());
}
