// The activation prologue's element values and rms_norm row sum, shared by
// K1 (qgemm_fused.cu), K3 and K5 (qgemm_large.cu), K4 (qgemm_grouped.cu), K7
// (qgemm_expert.cu) and K10 (block_kernel.cu); the block reductions, the
// unpack of packed words into per-column words and the per-group
// quantization, byte transpose and f32 fold of K4 and K7.
//
// A row sum is added in the order that the JAX package's reference compiles
// to: XLA's CPU backend rewrites a row reduction longer than 32 into windows
// of 32 (the row zero-padded evenly on both sides to a multiple of 32), sums
// each window from left to right, and reduces the window sums the same way
// until 32 or fewer remain, which it adds from left to right.  Following
// that order, every addition rounded on its own, keeps the rms_norm scale,
// and so the int8 codes, those of the reference.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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

// Sum of get(i) over i < n in XLA's CPU order (above).  The whole block
// calls it; every thread gets the sum.  `scratch` holds ceil(n / 32)
// floats, and the block has at least that many threads.
template <typename Get>
__device__ float sum_xla_order(Get get, int n, float* scratch) {
  int nwin = (n + kSumWindow - 1) / kSumWindow;
  int padl = (nwin * kSumWindow - n) / 2;
  if (n <= kSumWindow) {
    nwin = 0;  // a single left-to-right sum, below
  } else {
    const int w = threadIdx.x;
    float s = 0.f;
    if (w < nwin) s = window_sum(get, w, n, padl);
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
  for (int i = 0; i < n; ++i)
    total = __fadd_rn(total, nwin == 0 ? get(i) : scratch[i]);
  __syncthreads();  // scratch is free again
  return total;
}

// Sum over k < Kp of glu_value(xr, k)^2 in XLA's CPU order.
__device__ float sumsq_xla_order(const __nv_bfloat16* xr, int K, int Kp,
                                 int glu, float* scratch) {
  return sum_xla_order([&](int k) {
    const float v = glu_value(xr, k, K, glu);
    return __fmul_rn(v, v);
  }, Kp, scratch);
}

// rms_norm's row factor 1 / sqrt(sum * (1 / K) + eps), each step rounded
// on its own (IEEE sqrt and division).
__device__ __forceinline__ float rms_factor(float sumsq, float inv_norm_k,
                                            float eps) {
  return 1.0f / sqrtf(__fadd_rn(__fmul_rn(sumsq, inv_norm_k), eps));
}

// The prologue's value at column k (zero past the logical K): glu, then
// rms_norm with row factor rs, each step rounded on its own.
__device__ __forceinline__ float prologue_value(const __nv_bfloat16* xr, int k,
                                                int K, int glu,
                                                const __nv_bfloat16* norm_w,
                                                float rs) {
  float v = glu_value(xr, k, K, glu);
  if (norm_w != nullptr && k < K)
    v = __fmul_rn(__fmul_rn(v, rs), __bfloat162float(norm_w[k]));
  return v;
}

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduction over the whole block; every thread gets the result: an xor
// butterfly within each warp, then the warps' values in warp order.  `red`
// holds one value per warp and is free again on return.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

// One warp quantizes one group of gs values, get(k) for k in [k0, k0 + gs)
// (K4 and K7): absmax, then, as XLA compiles the reference's
// `max(amax, 1e-20) / 127.0`, the scale times the f32 reciprocal of 127;
// int8 codes by a true division, rint and a clamp to +-127, written to
// codes[k]; lane 0 stores the scale and the code sum times the scale.
template <typename Get>
__device__ __forceinline__ void quant_group_warp(Get get, int k0, int gs,
                                                 int8_t* codes, float* xs,
                                                 float* xsum) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int i = lane; i < gs; i += 32) amax = fmaxf(amax, fabsf(get(k0 + i)));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  int qsum = 0;
  for (int i = lane; i < gs; i += 32) {
    const int q = (int)fminf(fmaxf(rintf(get(k0 + i) / sc), -127.f), 127.f);
    codes[k0 + i] = (int8_t)q;
    qsum += q;
  }
  for (int o = 16; o > 0; o >>= 1) qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
  if (lane == 0) {
    *xs = sc;
    *xsum = __fmul_rn((float)qsum, sc);
  }
}

// out[i] = byte i of a, b, c, d, in that order (a 4x4 byte transpose): the
// bytes of one column in 4 words (K1, K3, K4, K7 and K10).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t out[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(ab_lo, cd_lo, 0x5410);        // a0 b0 c0 d0
  out[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  out[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// The weights of packed word q for the 4 adjacent columns m0 .. m0+3, one
// 32-bit word per column (K1 and K10): bits=2, the 4 fields of packed row q
// (field j in byte j, the weight of k = q + j*Kp/4); bits=8, the signed
// codes of rows 4q .. 4q+3 (byte j: k = 4q + j).
template <int BITS>
__device__ __forceinline__ void unpack_cols(const uint8_t* packed, int q,
                                            int Mp, int m0, uint32_t col[4]) {
  if (BITS == 2) {
    const uint32_t w = ldg32(packed + (size_t)q * Mp + m0);
    transpose4(w & 0x03030303u, (w >> 2) & 0x03030303u,
               (w >> 4) & 0x03030303u, (w >> 6) & 0x03030303u, col);
  } else {
    const uint8_t* p = packed + (size_t)(4 * q) * Mp + m0;
    transpose4(ldg32(p), ldg32(p + Mp), ldg32(p + 2 * (size_t)Mp),
               ldg32(p + 3 * (size_t)Mp), col);
  }
}

// The reference's f32 fold of one output, in the order XLA compiles its
// grouped epilogue to on the CPU (K4 and K7): with x_g = xs_g * scale_g
// rounded, acc = fma(p_0, x_0, p_1 * x_1), then acc = fma(p_g, x_g, acc)
// for g = 2, 3, ...; z = fma(xsum_g, sub_g, z) from z = 0 in group order;
// the result acc - z.  step() takes the groups in order, from g = 0; G >= 2.
struct GroupFold {
  float acc = 0.f, z = 0.f, p0 = 0.f, x0 = 0.f;
  __device__ __forceinline__ void step(int g, float p, float xs, float scale,
                                       float xsum, float sub) {
    const float x = __fmul_rn(xs, scale);
    if (g == 0) {
      p0 = p;
      x0 = x;
    } else if (g == 1) {
      acc = __fmaf_rn(p0, x0, __fmul_rn(p, x));
    } else {
      acc = __fmaf_rn(p, x, acc);
    }
    z = __fmaf_rn(xsum, sub, z);
  }
  __device__ __forceinline__ float result() const { return __fsub_rn(acc, z); }
};

}  // namespace tmac
