// K1: fused activation quantization + packed low-bit matmul, for Hopper.
//
// Replaces tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel with
// fused_quant=True, int_acc=True (per-tensor scale, G == 1), which the JAX
// package reaches through qgemm_pallas(act="fused").  It computes
//
//   x (N, K) bf16 [or (N, 2K) for the SwiGLU prologue]
//     -> optional silu(g) * u, optional rms_norm (variance over the
//        logical K)
//     -> per-row absmax int8 codes (scale xs = max(amax, 1e-20) * (1/127),
//        codes rint(x / xs) clamped to +-127) and the dequantized code
//        sum xsum
//     -> exact int32 dot with the packed weights
//     -> acc * scale * xs - xsum * sub (+ residual)  in f32, (N, Mp).
//
// What bounds it: at decode (N = 1) each packed weight byte is read once
// and feeds 4 (bits=2) or 1 (bits=8) multiply-adds, far below the card's
// operations-per-byte balance, so device-memory bytes bound it.  The
// design keeps that byte stream dense and coalesced: a thread loads the 4
// adjacent columns of one packed row as one 32-bit word, a block covers a
// 32-column strip and splits the packed rows over 32 slices (enough blocks
// to spread the wide projections over the SMs), and the arithmetic is
// dp4a on codes regrouped with byte permutes.  The int32 partial sums of
// the 32 slices are added in shared memory, so the result does not depend
// on scheduling.
//
// The prologue cannot stay where the TPU kernel had it (grid step 0,
// into scratch that persists across a sequential grid): blocks here run in
// no order and share nothing.  It is a small kernel of its own, one block
// per row, launched just before the matmul; redoing it in every matmul
// block would repeat the two block-wide reductions hundreds of times.
//
// Field j of packed row r holds the weight for k = r + j*K/4 (bits=2,
// biased-unsigned {1,2,3}; sub = 2*scale folds the midpoint).  bits=8
// stores one signed code per byte.  The prologue writes the activation
// codes in the same grouping, 4 codes to a 32-bit word, so one word of
// activations meets one word of weight fields in each dp4a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 512;
constexpr int kTX = 8;            // threads across the columns of a block
constexpr int kTY = 32;           // packed-row slices of a block
constexpr int kCols = 4 * kTX;    // output columns of a block
constexpr int kRowsMany = 8;      // output rows of a block when N > 1

struct SumOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
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

// The prologue's value at column k of row xr, before rms_norm.
__device__ __forceinline__ float glu_value(const __nv_bfloat16* xr, int k,
                                           int K, int glu) {
  if (k >= K) return 0.f;  // K zero-padded up to Kp
  float v = __bfloat162float(xr[k]);
  if (glu) {
    const float u = __bfloat162float(xr[K + k]);
    v = v * (1.0f / (1.0f + expf(-v))) * u;
  }
  return v;
}

__global__ void __launch_bounds__(kQuantThreads) act_quant_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int glu,
    const __nv_bfloat16* __restrict__ norm_w, float eps, float inv_norm_k,
    int bits, int8_t* __restrict__ codes, float* __restrict__ xs,
    float* __restrict__ xsum) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int n = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)n * x_cols;

  float rs = 1.f;
  if (norm_w != nullptr) {
    // rounded step by step (no FMA) in a fixed order that the plain
    // version repeats: per thread over k = tid + i*blockDim, then the
    // block reduction
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = glu_value(xr, k, K, glu);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = block_reduce(ss, SumOp(), redf);
    // var = sum * (1 / logical K); x * rsqrt(var + eps) * w, as in JAX
    rs = 1.0f / sqrtf(__fadd_rn(__fmul_rn(ss, inv_norm_k), eps));
  }

  float amax = 0.f;
  for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
    float v = glu_value(xr, k, K, glu);
    if (norm_w != nullptr && k < K) v = v * rs * __bfloat162float(norm_w[k]);
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_reduce(amax, MaxOp(), redf);
  // the row scale as the JAX package's compiled graph computes it: XLA
  // folds its division by 127 into a multiply by the f32 reciprocal
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);

  const int nq = Kp / 4;
  int8_t* cr = codes + (size_t)n * Kp;
  int qsum = 0;
  for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
    float v = glu_value(xr, k, K, glu);
    if (norm_w != nullptr && k < K) v = v * rs * __bfloat162float(norm_w[k]);
    const int q = (int)fminf(fmaxf(rintf(v / sc), -127.f), 127.f);
    qsum += q;
    // bits=2: byte j of word r holds k = r + j*nq, like the packed fields
    cr[bits == 8 ? k : (k % nq) * 4 + k / nq] = (int8_t)q;
  }
  qsum = block_reduce(qsum, SumOp(), redi);
  if (threadIdx.x == 0) {
    xs[n] = sc;
    xsum[n] = __fmul_rn((float)qsum, sc);
  }
}

// out[i] = byte i of a, b, c, d, in that order (a 4x4 byte transpose).
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

template <int BITS, int NT>
__global__ void __launch_bounds__(kTX * kTY) qgemm_kernel(
    const int32_t* __restrict__ xq, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int nq,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const float* __restrict__ sub, int Mp,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  __shared__ int red[kTY][NT][kCols];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int m0 = blockIdx.x * kCols + 4 * tx;
  const int n0 = blockIdx.y * NT;
  const int nrows = min(NT, N - n0);
  const int32_t* xrow = xq + (size_t)n0 * nq;

  int acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0;

#pragma unroll 4
  for (int q = ty; q < nq; q += kTY) {
    uint32_t col[4];  // col[c]: the 4 weights of column m0 + c for word q
    if (BITS == 2) {
      const uint32_t w = ldg32(packed + (size_t)q * Mp + m0);
      transpose4(w & 0x03030303u, (w >> 2) & 0x03030303u,
                 (w >> 4) & 0x03030303u, (w >> 6) & 0x03030303u, col);
    } else {
      const uint8_t* p = packed + (size_t)(4 * q) * Mp + m0;
      transpose4(ldg32(p), ldg32(p + Mp), ldg32(p + 2 * (size_t)Mp),
                 ldg32(p + 3 * (size_t)Mp), col);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nrows) {
        const int xv = __ldg(xrow + (size_t)n * nq + q);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = __dp4a((int)col[c], xv, acc[n][c]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][n][4 * tx + c] = acc[n][c];
  __syncthreads();

  for (int i = threadIdx.x; i < NT * kCols; i += blockDim.x) {
    const int n = i / kCols, c = i % kCols;
    if (n >= nrows) continue;
    int s = 0;
    for (int t = 0; t < kTY; ++t) s += red[t][n][c];
    const int m = blockIdx.x * kCols + c;
    const size_t row = (size_t)(n0 + n);
    // f32 epilogue in the TPU kernel's order, each step rounded on its own
    float o = __fmul_rn(__fmul_rn((float)s, scales[m]), xs[row]);
    o = __fsub_rn(o, __fmul_rn(xsum[row], sub[m]));
    if (residual != nullptr) o = __fadd_rn(o, __bfloat162float(residual[row * Mp + m]));
    out[row * Mp + m] = o;
  }
}

template <int BITS>
void launch_gemm(const int32_t* xq, const float* xs, const float* xsum, int N,
                 int nq, const uint8_t* packed, const float* scales,
                 const float* sub, int Mp, const __nv_bfloat16* residual,
                 float* out, cudaStream_t stream) {
  const dim3 block(kTX * kTY);
  if (N == 1) {
    qgemm_kernel<BITS, 1><<<dim3(Mp / kCols, 1), block, 0, stream>>>(
        xq, xs, xsum, N, nq, packed, scales, sub, Mp, residual, out);
  } else {
    const int ny = (N + kRowsMany - 1) / kRowsMany;
    qgemm_kernel<BITS, kRowsMany><<<dim3(Mp / kCols, ny), block, 0, stream>>>(
        xq, xs, xsum, N, nq, packed, scales, sub, Mp, residual, out);
  }
}

}  // namespace

// Prologue: x (N, x_cols) bf16 -> codes (N, Kp) int8 in dp4a grouping,
// xs (N,) and xsum (N,) f32.  norm_w (K,) bf16 or null.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int tmac_act_quant(const void* x, int N, int x_cols, int K, int Kp,
                              int glu, const void* norm_w, float eps,
                              float inv_norm_k, int bits, void* codes,
                              float* xs, float* xsum, void* stream) {
  if (N <= 0 || Kp % 4 != 0 || (bits != 2 && bits != 8)) return (int)cudaErrorInvalidValue;
  act_quant_kernel<<<N, kQuantThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k, bits,
      static_cast<int8_t*>(codes), xs, xsum);
  return (int)cudaGetLastError();
}

// Matmul: codes (N, Kp) from tmac_act_quant, packed (Kp/4, Mp) (bits=2) or
// (Kp, Mp) (bits=8) uint8, scales/sub (Mp,) f32, residual (N, Mp) bf16 or
// null -> out (N, Mp) f32.  Mp must be a multiple of 32.
extern "C" int tmac_qgemm(const void* codes, const float* xs,
                          const float* xsum, int N, int Kp, int bits,
                          const void* packed, const float* scales,
                          const float* sub, int Mp, const void* residual,
                          float* out, void* stream) {
  if (N <= 0 || Kp % 4 != 0 || Mp % kCols != 0) return (int)cudaErrorInvalidValue;
  const int32_t* xq = static_cast<const int32_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2) {
    launch_gemm<2>(xq, xs, xsum, N, Kp / 4, pk, scales, sub, Mp, res, out, s);
  } else if (bits == 8) {
    launch_gemm<8>(xq, xs, xsum, N, Kp / 4, pk, scales, sub, Mp, res, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
