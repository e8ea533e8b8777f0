// K1: fused activation quantization + packed low-bit matmul, for Hopper.
//
// Replaces tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel with
// fused_quant=True, int_acc=True (one scale row, G == 1: BitNet's
// per-tensor scale, or w_fp's per-column scales and zero points at
// group_size -1), which the JAX package reaches through
// qgemm_pallas(act="fused").  It computes
//
//   x (N, K) bf16 [or (N, 2K) for the SwiGLU prologue]
//     -> optional silu(g) * u, optional rms_norm (variance over the
//        logical K)
//     -> per-row absmax int8 codes (scale xs = max(amax, 1e-20) * (1/127),
//        codes rint(x / xs) clamped to +-127) and their sum
//     -> exact int32 dot with the packed weights
//     -> the f32 epilogue, (N, Mp), in the form the JAX reference compiles
//        to for N < 64 (XLA contracts one multiply-add into an FMA; q = the
//        code sum): fma(acc * scale, xs, -(q * xs) * sub) (+ residual).
//
// The matmul serves N < 64 rows, the reference's small-N route.  From 64
// rows the reference takes another kernel, K3 (qgemm_large.cu), which runs
// on this file's prologue with large_n set (the bare code sum, for K3's
// epilogue) and the dp4a code grouping (below).
//
// What bounds it: at decode (N = 1) each packed weight byte is read once
// and feeds 8 (bits 1), 4 (bits 2), 8/3 (bits 3), 2 (bits 4) or 1 (bits 8)
// multiply-adds, far below the card's
// operations-per-byte balance, so device-memory bytes bound it, and at a
// few microseconds a call its fixed costs as much.  Two launches a call:
//   1. the prologue, one block per row: the row is read once, with 16-byte
//      loads, into shared memory (silu(g) * u computed once an element),
//      and the rms_norm sum, the absmax and the codes run from there.  It is
//      launched programmatically (its launch overlaps the kernel before
//      it, on whose completion it waits first), and then lets the matmul
//      start (programmatic dependent launch);
//   2. the matmul (decode_matmul.cuh): it streams its packed weights into
//      shared memory while the prologue runs, waits for the codes, and
//      splits K over a thread-block cluster whose int32 partials are added
//      through distributed shared memory before the epilogue.
// The prologue cannot stay where the TPU kernel had it (grid step 0, into
// scratch that persists across a sequential grid): blocks here run in no
// order and share nothing, and redoing it in every matmul block would
// repeat the row's reductions hundreds of times.
//
// Field j of packed row r holds the weight for k = r + j*Kp/p (p = 8 /
// bits fields a byte, biased-unsigned; sub folds the midpoint or the
// column's zero point).  Bits 3 is a 2-bit lo plane (field j of row r: k = r
// + j*Kp/4) and a 1-bit hi plane (field j of row r: k = r + j*Kp/8), code
// = lo + 4 * hi.  bits=8 stores one signed code per byte.  The matmul reads
// the codes in natural k order (4 packed rows' field j meet the 4
// consecutive codes k = j*Kb + r .. +3, Kb = Kp / P with P slots a row,
// decode_matmul.cuh); K3 reads them in its own grouping, k' = F*r + j
// holding k = r + j*Kp/F (F = 8 at bits 1 and 3, 4 at bits 2, 2 at bits 4:
// the slots of a row, so that one step of K3 meets whole packed rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"
#include "decode_matmul.cuh"

namespace {

constexpr int kQuantThreads = 512;

__global__ void __launch_bounds__(kQuantThreads) act_quant_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int glu,
    const __nv_bfloat16* __restrict__ norm_w, float eps, float inv_norm_k,
    int bits, int large_n, int dp4a, int vec, int8_t* __restrict__ codes,
    float* __restrict__ xs, float* __restrict__ xsum) {
  // launched programmatically: wait for the kernels before, then let the
  // matmul after start
  tmac::pdl_wait();
  tmac::pdl_trigger();
  extern __shared__ __align__(16) float vals[];  // the row, staged (act_prologue.cuh)
  __shared__ float redf[tmac::staged_floats(kQuantThreads)];
  __shared__ int redi[32];
  const int n = blockIdx.x;
  tmac::stage_row(x + (size_t)n * x_cols, K, Kp, glu, vec, vals);
  // rms_norm: the sum of squares over the padded row in the reference's
  // order (act_prologue.cuh); var = sum * (1 / logical K); x * rsqrt(var +
  // eps) * w, as in JAX
  if (norm_w != nullptr) tmac::norm_row(vals, K, Kp, norm_w, eps, inv_norm_k, vec, redf);

  float amax = 0.f;
  for (int k = threadIdx.x; k < Kp; k += blockDim.x)
    amax = fmaxf(amax, fabsf(vals[tmac::staged(k)]));
  amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, redf);
  // the row scale as the JAX package's compiled graph computes it: XLA
  // folds its division by 127 into a multiply by the f32 reciprocal
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  auto code = [&](int k) {
    return (int)fminf(fmaxf(rintf(vals[tmac::staged(k)] / sc), -127.f), 127.f);
  };

  int8_t* cr = codes + (size_t)n * Kp;
  int qsum = 0;
  if (dp4a && bits != 8) {
    // K3's order: byte j of the F bytes at F*r holds k = r + j*nq, like the
    // packed fields (bits 3: the slots of lo rows r and r + nq and hi row r)
    const int F = tmac::decode::fields(bits), nq = Kp / F;
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
      const int q = code(k);
      qsum += q;
      cr[(k % nq) * F + k / nq] = (int8_t)q;
    }
  } else {
    // natural order, 4 codes a 32-bit store
    for (int w = threadIdx.x; w < Kp / 4; w += blockDim.x) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = code(4 * w + e);
        qsum += q;
        word |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
      }
      reinterpret_cast<uint32_t*>(cr)[w] = word;
    }
  }
  qsum = tmac::block_allreduce(qsum, tmac::SumOp(), 0, redi);
  if (threadIdx.x == 0) {
    xs[n] = sc;
    // the N >= 64 epilogue takes the bare code sum, the other the
    // dequantized one
    xsum[n] = large_n ? (float)qsum : __fmul_rn((float)qsum, sc);
  }
}

// the ring's stages: bits 3's stage is three planes of 32 rows (12 KB), as
// K4's (qgemm_kernel.decode_stages)
template <int BITS>
__host__ __device__ constexpr int k1_stages() {
  return BITS == 3 ? 3 : tmac::decode::kStages;
}

// EXT: the external-int8 form (int8 x from the caller; no activation
// scale, the epilogue fma(acc, scale, -(xsum * sub))), its own instance
template <int BITS, int NT, bool EXT>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k1_decode_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, false, false, k1_stages<BITS>(), false,
                              __nv_bfloat16, EXT>(a);
}

// NT: 1 token row a block, or 4 (2 at 8 slots a row, bits 1 and 3, whose
// int32 sums take 32 registers a token row: qgemm_kernel.decode_nt)
template <int BITS, bool EXT>
int launch_decode(const tmac::decode::Args& a, int ksplit, int nt,
                  cudaStream_t stream) {
  constexpr int P = tmac::decode::fields(BITS), S = k1_stages<BITS>();
  constexpr int W = tmac::decode::planes(BITS), NT = P == 8 ? 2 : 4;
  if (nt == 1) {
    const tmac::decode::Layout L(P, 1, false, a.nunits, a.unit_rows, ksplit, 1, S, W);
    return tmac::decode::launch(k1_decode_kernel<BITS, 1, EXT>, a, ksplit, 1, L.total, stream);
  }
  const tmac::decode::Layout L(P, NT, false, a.nunits, a.unit_rows, ksplit, 1, S, W);
  return tmac::decode::launch(k1_decode_kernel<BITS, NT, EXT>, a, ksplit, NT, L.total, stream);
}

template <int BITS>
int launch_decode_form(const tmac::decode::Args& a, int ksplit, int nt, cudaStream_t stream) {
  return a.xs == nullptr ? launch_decode<BITS, true>(a, ksplit, nt, stream)
                         : launch_decode<BITS, false>(a, ksplit, nt, stream);
}

}  // namespace

// Prologue (K1's, and K3's with large_n): x (N, x_cols) bf16 -> codes
// (N, Kp) int8, in natural k order or (dp4a, bits 1 to 4) K3's grouping,
// xs (N,) and xsum (N,) f32 (the code sum, times xs unless large_n).
// norm_w (K,) bf16 or null.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int tmac_act_quant(const void* x, int N, int x_cols, int K, int Kp,
                              int glu, const void* norm_w, float eps,
                              float inv_norm_k, int bits, int large_n, int dp4a,
                              void* codes, float* xs, float* xsum,
                              void* stream) {
  if (N <= 0 || bits < 1 || (bits > 4 && bits != 8) ||
      Kp % (4 * tmac::decode::fields(bits)) != 0 || Kp > tmac::kSumWindow * kQuantThreads)
    return (int)cudaErrorInvalidValue;
  const int smem = tmac::staged_floats(Kp) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      act_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return tmac::decode::launch_programmatic(
      act_quant_kernel, dim3(N), dim3(kQuantThreads), smem, (cudaStream_t)stream,
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k, bits, large_n, dp4a,
      tmac::row_loads_vec(x, x_cols, K, norm_w), static_cast<int8_t*>(codes), xs, xsum);
}

// K1's matmul: codes (N, Kp) in natural order from tmac_act_quant (large_n
// off), packed (Kp * bits / 8, Mp) uint8 (bits 3: the lo plane (Kp / 4, Mp)
// and packed_hi, the hi plane (Kp / 8, Mp); else packed_hi null), scales/sub
// (Mp,) f32 (per column), residual (N, Mp) bf16 or null -> out (N, Mp) f32.
// xs null: the external-int8 form (the caller's int8 x, xsum its bare code
// sum; out = fma(acc, scale, -(xsum * sub)) (+ residual)).
// 1 <= N < 64; bits 1 to 4 or 8; Kp a multiple of 4 * P (P = 8 at bits 1
// and 3, 8 / bits at 2 and 4, 1 at 8); Mp of 128; a cluster of ksplit
// (1-8) blocks along K, nt (1, or 4; 2 at bits 1 and 3) token rows a block.
// Launched programmatically after the prologue.  Returns the CUDA error
// (cudaErrorInvalidConfiguration for a cluster the card cannot place).
extern "C" int tmac_decode_qgemm(const void* codes, const float* xs,
                                 const float* xsum, int N, int Kp, int bits,
                                 const void* packed, const void* packed_hi,
                                 const float* scales, const float* sub, int Mp,
                                 const void* residual, float* out, int ksplit, int nt,
                                 void* stream) {
  if (bits < 1 || (bits > 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  const int P = tmac::decode::fields(bits), nt_max = P == 8 ? 2 : 4;
  if (N <= 0 || N >= 64 || Kp % (4 * P) != 0 || Mp % tmac::decode::kStrip != 0 ||
      ksplit < 1 || ksplit > tmac::decode::kMaxSplit || (nt != 1 && nt != nt_max) ||
      (bits == 3) != (packed_hi != nullptr))
    return (int)cudaErrorInvalidValue;
  tmac::decode::Args a{};
  a.codes = static_cast<const int8_t*>(codes);
  a.xs = xs;
  a.xsum = xsum;
  a.packed = static_cast<const uint8_t*>(packed);
  a.packed_hi = static_cast<const uint8_t*>(packed_hi);
  a.scales = scales;
  a.sub = sub;
  a.residual = static_cast<const __nv_bfloat16*>(residual);
  a.out = out;
  a.N = N;
  a.Kp = Kp;
  a.Kb = Kp / P;
  a.Mp = Mp;
  a.G = 1;
  a.unit_rows = tmac::decode::kStageRows;
  a.nunits = (a.Kb + a.unit_rows - 1) / a.unit_rows;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 1: return launch_decode_form<1>(a, ksplit, nt, s);
    case 2: return launch_decode_form<2>(a, ksplit, nt, s);
    case 3: return launch_decode_form<3>(a, ksplit, nt, s);
    case 4: return launch_decode_form<4>(a, ksplit, nt, s);
    default: return launch_decode_form<8>(a, ksplit, nt, s);
  }
}
