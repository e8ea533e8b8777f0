// The activation prologue's element values and rms_norm row sum, shared by
// K1 (qgemm_fused.cu) and K4 (qgemm_grouped.cu).
//
// The row sum of squares is added in the order that the JAX package's
// reference compiles to: XLA's CPU backend rewrites a row reduction longer
// than 32 into windows of 32 (the row zero-padded evenly on both sides to a
// multiple of 32), sums each window from left to right, and reduces the
// window sums the same way until 32 or fewer remain, which it adds from left
// to right.  Following that order, every addition rounded on its own,
// keeps the rms_norm scale, and so the int8 codes, those of the reference.

#pragma once

#include <cuda_bf16.h>

namespace tmac {

constexpr int kSumWindow = 32;

// The prologue's value at column k of row xr, before rms_norm: x, or
// silu(g) * u with the gate half in columns [0, K) and the up half in
// [K, 2K); zero past the logical K.
__device__ __forceinline__ float glu_value(const __nv_bfloat16* xr, int k,
                                           int K, int glu) {
  if (k >= K) return 0.f;
  float v = __bfloat162float(xr[k]);
  if (glu) {
    const float u = __bfloat162float(xr[K + k]);
    v = __fmul_rn(__fmul_rn(v, 1.0f / (1.0f + expf(-v))), u);
  }
  return v;
}

// One level of the window tree: the sum of window w of n values (read by
// `get`), the level padded by `padl` zeros on the left.
template <typename Get>
__device__ __forceinline__ float window_sum(Get get, int w, int n, int padl) {
  float s = 0.f;
  for (int j = 0; j < kSumWindow; ++j) {
    const int i = w * kSumWindow + j - padl;
    if (i >= 0 && i < n) s = __fadd_rn(s, get(i));
  }
  return s;
}

// Sum over k < Kp of glu_value(xr, k)^2 in XLA's CPU order (above).  The
// whole block calls it; every thread gets the sum.  `scratch` holds
// ceil(Kp / 32) floats, and the block has at least that many threads.
__device__ float sumsq_xla_order(const __nv_bfloat16* xr, int K, int Kp,
                                 int glu, float* scratch) {
  int n = Kp;
  int nwin = (n + kSumWindow - 1) / kSumWindow;
  int padl = (nwin * kSumWindow - n) / 2;
  if (n <= kSumWindow) {
    nwin = 0;  // a single left-to-right sum, below
  } else {
    const int w = threadIdx.x;
    float s = 0.f;
    if (w < nwin)
      s = window_sum([&](int k) {
        const float v = glu_value(xr, k, K, glu);
        return __fmul_rn(v, v);
      }, w, n, padl);
    __syncthreads();
    if (w < nwin) scratch[w] = s;
    __syncthreads();
    n = nwin;
    while (n > kSumWindow) {
      nwin = (n + kSumWindow - 1) / kSumWindow;
      padl = (nwin * kSumWindow - n) / 2;
      s = 0.f;
      if (w < nwin) s = window_sum([&](int i) { return scratch[i]; }, w, n, padl);
      __syncthreads();
      if (w < nwin) scratch[w] = s;
      __syncthreads();
      n = nwin;
    }
  }
  float total = 0.f;
  for (int i = 0; i < n; ++i) {
    if (nwin == 0) {
      const float v = glu_value(xr, i, K, glu);
      total = __fadd_rn(total, __fmul_rn(v, v));
    } else {
      total = __fadd_rn(total, scratch[i]);
    }
  }
  __syncthreads();  // scratch is free again
  return total;
}

// rms_norm's row factor 1 / sqrt(sum * (1 / K) + eps), each step rounded
// on its own (IEEE sqrt and division).
__device__ __forceinline__ float rms_factor(float sumsq, float inv_norm_k,
                                            float eps) {
  return 1.0f / sqrtf(__fadd_rn(__fmul_rn(sumsq, inv_norm_k), eps));
}

}  // namespace tmac
