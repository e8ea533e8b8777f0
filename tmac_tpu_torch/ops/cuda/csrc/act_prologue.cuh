// The activation prologue's element values and rms_norm row sum, shared by
// K1 (qgemm_fused.cu), K3 and K5 (qgemm_large.cu), K4 (qgemm_grouped.cu), K7
// (qgemm_expert.cu) and K10 (block_kernel.cu); the block reductions, the
// unpack of packed words into per-column words and the per-group
// quantization, byte transpose and f32 fold of K4 and K7; the row staged
// once in shared memory (stage_row, sum_staged, norm_row) for K1's and
// K4's prologues; programmatic dependent launch (pdl_trigger, pdl_wait).
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
// A long row (LONG below: more than kSumWindow values a thread of the
// block, Qwen2-7B's down of 18944 in K4's and K5's 512-thread prologues):
// the first level of window sums gives a thread every blockDim.x-th window
// into a scratch of kMaxWindows sums, and the row is read an element a
// load; K4's and K5's prologues take rows up to kMaxRowK
constexpr int kMaxRowK = 32768;
constexpr int kMaxWindows = kMaxRowK / kSumWindow;

// The prologue's value at column k of row xr, before rms_norm: x, or
// silu(g) * u with the gate half in columns [0, K) and the up half in
// [K, 2K); zero past the logical K.
// silu(g) * u, each step rounded on its own (IEEE exp and division)
__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), u);
}

__device__ __forceinline__ float glu_value(const __nv_bfloat16* xr, int k,
                                           int K, int glu) {
  if (k >= K) return 0.f;
  float v = __bfloat162float(xr[k]);
  if (glu) v = silu_mul(v, __bfloat162float(xr[K + k]));
  return v;
}

// Programmatic dependent launch (sm_90): a prologue lets the kernel
// launched after it with the programmatic-serialization attribute start
// now; that kernel waits for the prologue's writes with pdl_wait().
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Whether stage_row and norm_row may read rows of x (N, x_cols) and the
// norm weight with 16-byte loads
inline int row_loads_vec(const void* x, int x_cols, int K, const void* norm_w) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_cols % 8 == 0 && K % 8 == 0 &&
         reinterpret_cast<uintptr_t>(norm_w) % 16 == 0;
}

// 16-byte pieces of a row a thread of a 512-thread prologue block loads at
// once (K <= 16384)
constexpr int kRowLoads = 4;

// The staged row's layout in shared memory: value k at staged(k), one
// float of padding after every 32, so that the threads of a warp, each
// summing its own window of 32 (sum_staged), read 32 distinct banks.
__device__ __forceinline__ int staged(int k) { return k + (k >> 5); }

// Floats of shared memory a staged row of n values takes
__host__ __device__ constexpr int staged_floats(int n) { return n + (n + 31) / 32; }

// The prologue's values of row xr before rms_norm, glu_value(xr, k) for k
// < Kp, into shared memory at vals[staged(k)], each x element read once:
// 16-byte loads when vec (x's row and K a multiple of 8 elements, the row
// 16-byte aligned), else one element a load.  The whole block calls it;
// vals is complete on return.
__device__ void stage_row(const __nv_bfloat16* xr, int K, int Kp, int glu,
                          int vec, float* vals) {
  if (vec) {
    // every load first, then the values: one round trip to memory
    const uint4* g4 = reinterpret_cast<const uint4*>(xr);
    const uint4* u4 = reinterpret_cast<const uint4*>(xr + K);
    uint4 gw[kRowLoads], uw[kRowLoads];
#pragma unroll
    for (int r = 0; r < kRowLoads; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i < K / 8) {
        gw[r] = g4[i];
        if (glu) uw[r] = u4[i];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowLoads; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i >= K / 8) continue;
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&gw[r]);
      const __nv_bfloat16* u = reinterpret_cast<const __nv_bfloat16*>(&uw[r]);
      float* d = vals + staged(8 * i);  // 8 | 32: the 8 values are contiguous
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = glu ? silu_mul(__bfloat162float(g[e]), __bfloat162float(u[e]))
                   : __bfloat162float(g[e]);
    }
    for (int k = K + threadIdx.x; k < Kp; k += blockDim.x) vals[staged(k)] = 0.f;
  } else {
    for (int k = threadIdx.x; k < Kp; k += blockDim.x)
      vals[staged(k)] = glu_value(xr, k, K, glu);
  }
  __syncthreads();
}

// The sum of src[staged(i)] (squared first when `square`) over i < n in
// XLA's CPU order (kSumWindow above), each addition rounded on its own;
// every thread gets it.  The whole block calls it, with at least
// ceil(n / 32) threads (LONG: ceil(n / 1024)); `scratch` (not src) holds
// staged_floats(ceil(n / 32)) floats and is free again on return.  Values
// past either end of a window add +0, which leaves a sum of non-negative
// values unchanged, bit for bit.
template <bool LONG = false>
__device__ float sum_staged(const float* src, int n, bool square, float* scratch) {
  const int w = threadIdx.x;
  while (n > kSumWindow) {
    const int nwin = (n + kSumWindow - 1) / kSumWindow;
    const int padl = (nwin * kSumWindow - n) / 2;
    if (LONG && nwin > (int)blockDim.x) {
      // the first level of a long row (src is the row): each window's sum
      // is stored as it is made
      for (int v = w; v < nwin; v += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < kSumWindow; ++j) {
          const int i = v * kSumWindow + j - padl;
          const float x = (i >= 0 && i < n) ? src[staged(i)] : 0.f;
          s = __fadd_rn(s, square ? __fmul_rn(x, x) : x);
        }
        scratch[staged(v)] = s;
      }
      __syncthreads();
      src = scratch;
      square = false;
      n = nwin;
      continue;
    }
    float s = 0.f;
    if (w < nwin) {
      float v[kSumWindow];
#pragma unroll
      for (int j = 0; j < kSumWindow; ++j) {
        const int i = w * kSumWindow + j - padl;
        const float x = (i >= 0 && i < n) ? src[staged(i)] : 0.f;
        v[j] = square ? __fmul_rn(x, x) : x;
      }
#pragma unroll
      for (int j = 0; j < kSumWindow; ++j) s = __fadd_rn(s, v[j]);
    }
    __syncthreads();
    if (w < nwin) scratch[staged(w)] = s;
    __syncthreads();
    src = scratch;
    square = false;
    n = nwin;
  }
  float v[kSumWindow];
#pragma unroll
  for (int i = 0; i < kSumWindow; ++i) {
    const float x = i < n ? src[staged(i)] : 0.f;
    v[i] = square ? __fmul_rn(x, x) : x;
  }
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kSumWindow; ++i) total = __fadd_rn(total, v[i]);
  __syncthreads();  // scratch is free again
  return total;
}

// rms_norm of the staged row in place (k < K; zeros past K stay zero):
// the sum of squares in XLA's order, then (v * rs) * w[k], each step rounded
// on its own, as prologue_value computes it.  Whole block; `scratch` as
// sum_staged's (LONG: sum_staged<true>'s); vals is complete on return.
template <bool LONG = false>
__device__ void norm_row(float* vals, int K, int Kp,
                         const __nv_bfloat16* norm_w, float eps,
                         float inv_norm_k, int vec, float* scratch);

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
// floats, and the block has at least that many threads (LONG: a thread
// sums every blockDim.x-th window of the first level, which get reads
// without scratch).
template <bool LONG = false, typename Get>
__device__ float sum_xla_order(Get get, int n, float* scratch) {
  int nwin = (n + kSumWindow - 1) / kSumWindow;
  int padl = (nwin * kSumWindow - n) / 2;
  if (n <= kSumWindow) {
    nwin = 0;  // a single left-to-right sum, below
  } else {
    const int w = threadIdx.x;
    float s = 0.f;
    if (LONG) {
      for (int v = w; v < nwin; v += blockDim.x) scratch[v] = window_sum(get, v, n, padl);
    } else {
      if (w < nwin) s = window_sum(get, w, n, padl);
      __syncthreads();
      if (w < nwin) scratch[w] = s;
    }
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
template <bool LONG = false>
__device__ float sumsq_xla_order(const __nv_bfloat16* xr, int K, int Kp,
                                 int glu, float* scratch) {
  return sum_xla_order<LONG>([&](int k) {
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

// The same for an operation whose result does not depend on the order
// (an integer sum, a maximum), in two warp butterflies: each warp combines
// the warps' values (`identity` past the last warp) itself.  `red` holds
// 32 values.
template <typename T, typename Op>
__device__ T block_allreduce(T v, Op op, T identity, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : identity;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// One warp quantizes one group of gs values, get(k) for k in [k0, k0 + gs)
// (K4 and K7): absmax, then, as XLA compiles the reference's
// `max(amax, 1e-20) / 127.0`, the scale times the f32 reciprocal of 127;
// int8 codes by a true division, rint and a clamp to +-127, written to
// codes[k]; lane 0 stores the scale and the code sum times the scale.
// quant_group_core is its work without the stores: it returns the scale and
// gives the code sum, to every lane (K4's ags form keeps both).
template <typename Get>
__device__ __forceinline__ float quant_group_core(Get get, int k0, int gs, int8_t* codes,
                                                  int& qsum_out) {
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
  qsum_out = qsum;
  return sc;
}

template <typename Get>
__device__ __forceinline__ void quant_group_warp(Get get, int k0, int gs,
                                                 int8_t* codes, float* xs,
                                                 float* xsum) {
  int qsum;
  const float sc = quant_group_core(get, k0, gs, codes, qsum);
  if ((threadIdx.x & 31) == 0) {
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
  // the same two chains apart (K4's ags form): term() takes the fold
  // chunks c = 0, 1, ... with their factors xs_c * scale_c, zero() the
  // weight groups' zero-point terms in order
  __device__ __forceinline__ void term(int c, float p, float xs, float scale) {
    const float x = __fmul_rn(xs, scale);
    if (c == 0) {
      p0 = p;
      x0 = x;
    } else if (c == 1) {
      acc = __fmaf_rn(p0, x0, __fmul_rn(p, x));
    } else {
      acc = __fmaf_rn(p, x, acc);
    }
  }
  __device__ __forceinline__ void zero(float xsum, float sub) { z = __fmaf_rn(xsum, sub, z); }
  __device__ __forceinline__ float result() const { return __fsub_rn(acc, z); }
};

template <bool LONG>
__device__ void norm_row(float* vals, int K, int Kp,
                         const __nv_bfloat16* norm_w, float eps,
                         float inv_norm_k, int vec, float* scratch) {
  // the weight's loads are issued before the row sum, which hides them
  uint4 wv[kRowLoads];
  if (vec) {
#pragma unroll
    for (int r = 0; r < kRowLoads; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i < K / 8) wv[r] = reinterpret_cast<const uint4*>(norm_w)[i];
    }
  }
  const float rs = rms_factor(sum_staged<LONG>(vals, Kp, true, scratch), inv_norm_k, eps);
  if (vec) {
#pragma unroll
    for (int r = 0; r < kRowLoads; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i >= K / 8) continue;
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&wv[r]);
      float* d = vals + staged(8 * i);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = __fmul_rn(__fmul_rn(d[e], rs), __bfloat162float(w[e]));
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      vals[staged(k)] = __fmul_rn(__fmul_rn(vals[staged(k)], rs), __bfloat162float(norm_w[k]));
  }
  __syncthreads();
}

// dp4a of unsigned bytes a with signed bytes b, added to c
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

}  // namespace tmac
