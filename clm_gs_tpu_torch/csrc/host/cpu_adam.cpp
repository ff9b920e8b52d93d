// SIMD host-side Adam over the concatenated (N, 48) SH parameter buffer.
//
// Native replacement for the reference's cpu-adam submodule
// (cpu_adam.FusedCPUAdam / batched_sparse_step, SURVEY.md §2.3c): the CPU half
// of the clm_offload strategy updates SH rows whose last use in the batch has
// passed, overlapped with the accelerator's remaining microbatches. Features
// mirrored from the call sites (optimizer.py:130-144,
// clm_offload/engine.py:301-335):
//   - per-column learning rates (dc columns vs rest),
//   - global-step bias correction, eps = 1e-15 semantics,
//   - sparse row updates by index list, with grad rows zeroed in place after
//     consumption (version=3 behavior) and an optional 1/bsz grad scale,
//   - dense step over the first n rows.
//
// Vectorized with AVX2 when available (48 f32 = 6 x 8-lane AVX vectors per
// row); plain scalar loop otherwise. OpenMP-free: the caller shards rows
// across its own threads if needed.
//
// C ABI for ctypes; all pointers are float32 row-major (N, cols).

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

// Run fn(lo, hi) over [0, n) split across `threads` std::threads (the work is
// DRAM-bandwidth-bound streaming over distinct rows, so plain chunking is the
// right schedule; callers guarantee row-disjoint chunks — index lists are
// unique within one call at every call site).
template <typename F>
static void parallel_ranges(int64_t n, int threads, F fn) {
  if (threads <= 1 || n < 4096) {
    fn((int64_t)0, n);
    return;
  }
  if (threads > 16) threads = 16;
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// Like parallel_ranges but hands the callback its thread slot (t, lo, hi)
// with a FIXED chunking shared by every call at the same (n, threads) — the
// two-pass count/place algorithms below depend on both passes seeing
// identical per-thread ranges, so the chunking lives in exactly one place.
template <typename F>
static int parallel_slots(int64_t n, int threads, F fn) {
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  if (n < 65536) threads = 1;
  const int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(t, lo, hi); });
  }
  for (auto& th : pool) th.join();
  return threads;
}

static void adam_sparse_range(float* params, float* grads, float* exp_avg,
                              float* exp_avg_sq, const int32_t* indices,
                              int64_t k0, int64_t k1, int cols,
                              const float* lr_cols, float beta1, float beta2,
                              float eps, float grad_scale, int64_t step) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;

#if defined(__AVX2__)
  const __m256 vb1 = _mm256_set1_ps(beta1);
  const __m256 vb2 = _mm256_set1_ps(beta2);
  const __m256 v1mb1 = _mm256_set1_ps(1.0f - beta1);
  const __m256 v1mb2 = _mm256_set1_ps(1.0f - beta2);
  const __m256 veps = _mm256_set1_ps(eps);
  const __m256 vscale = _mm256_set1_ps(grad_scale);
  const __m256 vibc1 = _mm256_set1_ps(inv_bc1);
  const __m256 vibc2 = _mm256_set1_ps(inv_bc2);
  const __m256 vzero = _mm256_setzero_ps();
#endif

  constexpr int64_t PF = 4;  // 4 buffers x 4 rows ahead = ~16 misses in flight
  for (int64_t k = k0; k < k1; ++k) {
    if (k + PF < k1) {
      const int64_t r = (int64_t)indices[k + PF];
      for (int c = 0; c < cols * 4; c += 64) {
        __builtin_prefetch((const char*)(params + r * cols) + c, 1, 1);
        __builtin_prefetch((const char*)(grads + r * cols) + c, 1, 1);
        __builtin_prefetch((const char*)(exp_avg + r * cols) + c, 1, 1);
        __builtin_prefetch((const char*)(exp_avg_sq + r * cols) + c, 1, 1);
      }
    }
    const int64_t row = (int64_t)indices[k];
    float* p = params + row * cols;
    float* g = grads + row * cols;
    float* m = exp_avg + row * cols;
    float* v = exp_avg_sq + row * cols;
    int c = 0;
#if defined(__AVX2__)
    for (; c + 8 <= cols; c += 8) {
      __m256 gv = _mm256_mul_ps(_mm256_loadu_ps(g + c), vscale);
      __m256 mv = _mm256_fmadd_ps(v1mb1, gv, _mm256_mul_ps(vb1, _mm256_loadu_ps(m + c)));
      __m256 vv = _mm256_fmadd_ps(v1mb2, _mm256_mul_ps(gv, gv),
                                  _mm256_mul_ps(vb2, _mm256_loadu_ps(v + c)));
      _mm256_storeu_ps(m + c, mv);
      _mm256_storeu_ps(v + c, vv);
      __m256 mhat = _mm256_mul_ps(mv, vibc1);
      __m256 denom = _mm256_add_ps(
          _mm256_sqrt_ps(_mm256_mul_ps(vv, vibc2)), veps);
      __m256 lr = _mm256_loadu_ps(lr_cols + c);
      __m256 upd = _mm256_div_ps(_mm256_mul_ps(lr, mhat), denom);
      _mm256_storeu_ps(p + c, _mm256_sub_ps(_mm256_loadu_ps(p + c), upd));
      _mm256_storeu_ps(g + c, vzero);
    }
#endif
    for (; c < cols; ++c) {
      float gv = g[c] * grad_scale;
      m[c] = beta1 * m[c] + (1.0f - beta1) * gv;
      v[c] = beta2 * v[c] + (1.0f - beta2) * gv * gv;
      float mhat = m[c] * inv_bc1;
      float vhat = v[c] * inv_bc2;
      p[c] -= lr_cols[c] * mhat / (std::sqrt(vhat) + eps);
      g[c] = 0.0f;
    }
  }
}

extern "C" {

// Bumped on any signature change of the entry points below; the Python
// binding refuses a library whose version does not match (a stale .so with
// same-named symbols but a different ABI would corrupt memory silently).
int64_t native_abi_version() { return 3; }

// Update rows listed in `indices` (n_idx of them). grads rows are zeroed
// after use. lr_cols is a per-column learning-rate array of length `cols`.
// `threads` > 1 shards the index list across std::threads (indices are
// unique per call at every call site, so row writes never race).
void adam_sparse_step_mt(float* params, float* grads, float* exp_avg,
                         float* exp_avg_sq, const int32_t* indices,
                         int64_t n_idx, int cols, const float* lr_cols,
                         float beta1, float beta2, float eps, float grad_scale,
                         int64_t step, int threads) {
  parallel_ranges(n_idx, threads, [=](int64_t lo, int64_t hi) {
    adam_sparse_range(params, grads, exp_avg, exp_avg_sq, indices, lo, hi,
                      cols, lr_cols, beta1, beta2, eps, grad_scale, step);
  });
}

void adam_sparse_step(float* params, float* grads, float* exp_avg,
                      float* exp_avg_sq, const int32_t* indices, int64_t n_idx,
                      int cols, const float* lr_cols, float beta1, float beta2,
                      float eps, float grad_scale, int64_t step) {
  adam_sparse_step_mt(params, grads, exp_avg, exp_avg_sq, indices, n_idx, cols,
                      lr_cols, beta1, beta2, eps, grad_scale, step, 1);
}

// Dense step over rows [0, n).
void adam_dense_step_mt(float* params, float* grads, float* exp_avg,
                        float* exp_avg_sq, int64_t n, int cols,
                        const float* lr_cols, float beta1, float beta2,
                        float eps, float grad_scale, int64_t step,
                        int threads) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;
  parallel_ranges(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t row = lo; row < hi; ++row) {
      float* p = params + row * cols;
      float* g = grads + row * cols;
      float* m = exp_avg + row * cols;
      float* v = exp_avg_sq + row * cols;
      for (int c = 0; c < cols; ++c) {
        float gv = g[c] * grad_scale;
        m[c] = beta1 * m[c] + (1.0f - beta1) * gv;
        v[c] = beta2 * v[c] + (1.0f - beta2) * gv * gv;
        p[c] -= lr_cols[c] * (m[c] * inv_bc1) /
                (std::sqrt(v[c] * inv_bc2) + eps);
        g[c] = 0.0f;
      }
    }
  });
}

void adam_dense_step(float* params, float* grads, float* exp_avg,
                     float* exp_avg_sq, int64_t n, int cols,
                     const float* lr_cols, float beta1, float beta2, float eps,
                     float grad_scale, int64_t step) {
  adam_dense_step_mt(params, grads, exp_avg, exp_avg_sq, n, cols, lr_cols,
                     beta1, beta2, eps, grad_scale, step, 1);
}

// Scatter-add gradient rows into the host grad buffer:
// buf[indices[k], :] += rows[k, :]   (the send_shs2cpu analogue's host half).
// MT-safe for unique index lists (true at all call sites).
void scatter_add_rows_mt(float* buf, const float* rows, const int32_t* indices,
                         int64_t n_idx, int cols, int accumulate,
                         int threads) {
  parallel_ranges(n_idx, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      float* dst = buf + (int64_t)indices[k] * cols;
      const float* src = rows + k * cols;
      if (accumulate) {
        for (int c = 0; c < cols; ++c) dst[c] += src[c];
      } else {
        for (int c = 0; c < cols; ++c) dst[c] = src[c];
      }
    }
  });
}

void scatter_add_rows(float* buf, const float* rows, const int32_t* indices,
                      int64_t n_idx, int cols, int accumulate) {
  scatter_add_rows_mt(buf, rows, indices, n_idx, cols, accumulate, 1);
}

// Gather rows from the host param buffer: out[k, :] = buf[indices[k], :]
// (the send_shs2gpu analogue's host half).
void gather_rows_mt(const float* buf, float* out, const int32_t* indices,
                    int64_t n_idx, int cols, int threads) {
  // software-prefetch PF rows ahead: the gather is DRAM-latency-bound
  // (random ~192 B rows from a multi-GB buffer), so keeping ~8 misses in
  // flight per thread is the lever, not bandwidth
  constexpr int64_t PF = 8;
  parallel_ranges(n_idx, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      if (k + PF < hi) {
        const char* p = (const char*)(buf + (int64_t)indices[k + PF] * cols);
        for (int c = 0; c < cols * 4; c += 64)
          __builtin_prefetch(p + c, 0, 1);
      }
      const float* src = buf + (int64_t)indices[k] * cols;
      float* dst = out + k * cols;
      for (int c = 0; c < cols; ++c) dst[c] = src[c];
    }
  });
}

void gather_rows(const float* buf, float* out, const int32_t* indices,
                 int64_t n_idx, int cols) {
  gather_rows_mt(buf, out, indices, n_idx, cols, 1);
}

// H/D/G retention classification for one camera pair: single-pass merge of
// two sorted-unique int64 id lists (the host half of the reference's
// nonzero_static retention split, clm_offload/engine.py:568-636; replaces a
// numpy searchsorted whose ~21 binary-search probes per element are
// cache-hostile at 2M-row visible sets).
//   pd[k]: positions in a whose id also appears in b   (D: keep on device)
//   pn[k]: the matching positions in b
//   gp[k]: positions in a not in b                     (G: grads to host)
//   hn[k]: positions in b not in a                     (H: load from host)
// counts[0..3] = n_pd, n_gp, n_hn (counts[1] unused, kept for alignment).
void classify_sorted(const int32_t* a, int64_t na, const int32_t* b,
                     int64_t nb, int32_t* pd, int32_t* pn, int32_t* gp,
                     int32_t* hn, int64_t* counts) {
  int64_t i = 0, j = 0, nd = 0, ng = 0, nh = 0;
  while (i < na && j < nb) {
    if (a[i] == b[j]) {
      pd[nd] = (int32_t)i;
      pn[nd] = (int32_t)j;
      ++nd; ++i; ++j;
    } else if (a[i] < b[j]) {
      gp[ng++] = (int32_t)i++;
    } else {
      hn[nh++] = (int32_t)j++;
    }
  }
  while (i < na) gp[ng++] = (int32_t)i++;
  while (j < nb) hn[nh++] = (int32_t)j++;
  counts[0] = nd;
  counts[1] = nd;
  counts[2] = ng;
  counts[3] = nh;
}

// last_use[ids[k]] = pos for one camera's visible-id list (the order-encoded
// bitmap build of order_calculation, engine.py:197-262, re-expressed as a
// last-wins stamp). Rows are unique within one call, so thread chunks never
// collide; the caller iterates cameras in order for last-wins semantics.
void stamp_rows_i16(int16_t* last_use, const int32_t* ids, int64_t n,
                    int16_t pos, int threads) {
  parallel_ranges(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) last_use[ids[k]] = pos;
  });
}

// MT two-pass nonzero over an int16 stamp array: writes the (ascending)
// indices where pred holds into `out` and returns the count. mode 0:
// last_use[i] >= 0 (the visible union); mode 1: last_use[i] == -1 &&
// alive[i] (the never-visible set). Per-thread counts carve disjoint output
// ranges, so order stays ascending.
int64_t nonzero_stamp_i16(const int16_t* last_use, const uint8_t* alive,
                          int64_t n, int mode, int32_t* out, int threads) {
  auto pred = [&](int64_t i) {
    return mode == 0 ? (last_use[i] >= 0)
                     : (last_use[i] == -1 && alive[i] != 0);
  };
  std::vector<int64_t> cnt(16, 0);
  parallel_slots(n, threads, [&](int t, int64_t lo, int64_t hi) {
    int64_t c = 0;
    for (int64_t i = lo; i < hi; ++i) c += pred(i) ? 1 : 0;
    cnt[t] = c;
  });
  std::vector<int64_t> off(16, 0);
  int64_t total = 0;
  for (int t = 0; t < 16; ++t) {
    off[t] = total;
    total += cnt[t];
  }
  parallel_slots(n, threads, [&](int t, int64_t lo, int64_t hi) {
    int64_t w = off[t];
    for (int64_t i = lo; i < hi; ++i)
      if (pred(i)) out[w++] = (int32_t)i;
  });
  return total;
}

// Stable counting-sort permutation for small-range int16 keys (the per-batch
// finish-set split: 21.6M-row visible union, <= 64 distinct camera positions
// — numpy's generic stable argsort costs ~250 ms there, two streaming passes
// cost ~25 ms). MT-stable: per-thread histograms, bucket-major/thread-minor
// exclusive prefix, then each thread places its contiguous input range at
// precomputed offsets. Keys MUST lie in [0, n_buckets) — the Python wrapper
// asserts this (unchecked here for speed).
void counting_sort_perm_counts_i16(const int16_t* keys, int64_t n,
                                   int n_buckets, int32_t* perm,
                                   int64_t* bucket_counts, int threads) {
  std::vector<std::vector<int64_t>> hist(
      16, std::vector<int64_t>(n_buckets, 0));
  parallel_slots(n, threads, [&](int t, int64_t lo, int64_t hi) {
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) ++h[keys[i]];
  });
  // exclusive prefix over (bucket, thread) in stable order; also emit the
  // per-bucket totals (saves the caller a 21.6M-element np.bincount)
  int64_t run = 0;
  for (int b = 0; b < n_buckets; ++b) {
    int64_t btotal = 0;
    for (int t = 0; t < 16; ++t) {
      int64_t c = hist[t][b];
      hist[t][b] = run;
      run += c;
      btotal += c;
    }
    if (bucket_counts) bucket_counts[b] = btotal;
  }
  parallel_slots(n, threads, [&](int t, int64_t lo, int64_t hi) {
    auto& off = hist[t];
    for (int64_t i = lo; i < hi; ++i) perm[off[keys[i]]++] = (int32_t)i;
  });
}

}  // extern "C"
