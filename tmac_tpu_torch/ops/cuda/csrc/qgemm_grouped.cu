// K4: per-group activation quantization + grouped-scale packed low-bit
// matmul, for Hopper.
//
// Replaces the grouped chunk path of
// tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel (G > 1 scale groups,
// int8 activations quantized per (token, weight group)): its fused form
// (fused_quant=True, which qgemm_pallas(act="fused") takes for N < 64) and
// its external-int8 form (grouped_int=True, which the same call takes for
// N >= 64 after an XLA prologue).  Both compute
//
//   x (N, K) bf16 [or (N, 2K) for the SwiGLU prologue]
//     -> optional silu(g) * u, optional rms_norm (variance over the
//        logical K)
//     -> per (row n, group g of gs columns): xs = max(amax, 1e-20) * (1/127),
//        int8 codes rint(x / xs) clamped to +-127, xsum = (code sum) * xs
//     -> per group: exact int32 dot of the codes with the weight codes
//     -> acc = sum over g of part[g] * (xs[n, g] * scale[g, m]),
//        minus xsum @ sub, plus an optional bf16 residual, in f32 (N, Mp).
//
// The f32 steps follow what the JAX reference compiles to on the CPU, so
// that the port can be held to it: x_g = xs * scale rounded;
// acc = fma(part_0, x_0, part_1 * x_1), then acc = fma(part_g, x_g, acc)
// for g = 2, 3, ...; z = fma(xsum_g, sub_g, z) from z = 0 in g order;
// out = acc - z (+ residual), every step rounded on its own.
//
// Bits 1 to 4 and 8; bits 3 is a 2-bit lo plane (Kp / 4 rows) and a 1-bit
// hi plane (Kp / 8 rows), code = lo + 4 * hi (ops/packing.py); bits 8 (GGUF's
// Q8_0) one signed code a byte (the reference's wq - 128, the shift folded
// into sub), multiplied s8 x s8.  Kp is a multiple of gs * 8 at bits 1 and
// 3 (the packing's padding), so the reference's fold chunk is the group,
// which these kernels require.  Group sizes: 16 (GGUF's Q2_K and Q3_K) or a
// multiple of 32; a 16-row unit is half a ring stage of the decode matmul
// (decode_matmul.cuh) and half a depth step of K4L.
//
// What bounds it: at decode (N = 1) each packed weight byte feeds 8
// (bits 1), 4 (bits 2), 8/3 (bits 3) or 2 (bits 4) multiply-adds, far
// below the card's
// operations-per-byte balance, so device-memory bytes bound it, and at a
// few microseconds a call its fixed costs as much.  Two launches a call:
//   1. the prologue, one block per row (blocks share nothing, so the TPU
//      kernel's step-0 scratch becomes a kernel of its own): the row read
//      once, with 16-byte loads, into shared memory (silu(g) * u computed
//      once an element), the rms_norm sum from there, then one warp per
//      group: codes in natural k order, xs (N, G) and xsum (N, G).  It is
//      launched programmatically (its launch overlaps the kernel before
//      it, on whose completion it waits first), and then lets the matmul
//      start (programmatic dependent launch);
//   2. the matmul (decode_matmul.cuh, k4_decode_kernel): it streams its
//      packed weights and its fold's scales and zero points into shared
//      memory while the prologue runs, splits K over a thread-block
//      cluster by chunks of gs packed rows (field j of chunk c holds the gs
//      consecutive k of group j * nchunks + c; Kp / p is a multiple of gs),
//      keeps each block's per-group int32 partials in its shared memory,
//      and folds them in group order through distributed shared memory.
//      Nothing of the partials reaches device memory.

// K4L, the same function from 64 rows of x, is qgemm_grouped_large.cu.
//
// The ags form (the reference's act_group_size, a template instance of its
// own in each kernel, so that the ags = 0 code is unchanged): the
// prologue quantizes per activation group of ags columns (ags 16 or a
// multiple of 32, dividing gs) into xs (N, Ga = Kp / ags) and adds each weight
// group's gs / ags dequantized code sums into xsum (N, G) in the order the
// reference compiles its reshape-sum to on each route; K4's decode matmul
// splits K by activation groups and folds one partial an activation group
// (decode_matmul.cuh); K4L accumulates one activation group at a time
// (KT = 32 at ags 32), folds it with xs[a] * scale[a / (gs / ags)], each
// activation group's slot holding its row factors and its weight group's
// column factors; at ags 16, as at gs 16, two fold units a KT = 32 step.
//
// f32 scales and zero points (GGUF's block scales, which bf16 would
// round): the decode matmul, K4L and their launches take SC = float in a
// template instance of their own (scale_f32 in the C interfaces), so the
// bf16 instances are unchanged; the factors are read as stored.
//
// The native form (k4_native_kernel: the reference's act="native", bf16 x
// below 64 rows and f32 x at any N, kept as it is (XT, an instance each), a
// float dot a fold chunk, pinned to
// the chunk path; any scale rows, the per-tensor ones too): a block of 256
// threads takes 64 output columns (16 words of 4 packed columns) and NT
// token rows, 16 k lanes a column word.  It walks the fold chunks in k
// order: chunk c is field j = c * chunk / Kb of chunk-many packed rows, so
// each packed byte is read once a field, from L2 after the first; a lane
// multiplies each of its rows' 4 codes (exact as floats) by the x of that k
// in f32 with an fma (a bf16 x's products exact; an f32 x's rounded once in
// the fma's sum, as an f32 dot), the 16 lanes' sums meet through a
// shuffle and shared memory in a fixed order, and the owner of an output
// folds the chunk with the reference's chain (acc = fma(p_0, s_0, p_1 *
// s_1), then fma(p_c, s_c, acc); p_0 * s_0 alone for one chunk).  Then
// z = fma(xsum_g, sub_g, z) over the groups and out = acc - z (+ residual).
// Only the sum order inside a chunk differs from the reference's.  What
// bounds it: two barriers a fold chunk and a block's 64 columns; a simple
// form that is right, not yet a fast one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"
#include "decode_matmul.cuh"

namespace {

constexpr int kQuantThreads = 512;
// the reference's large-N route starts here (ops.qgemm.LARGE_N): its
// prologue runs in XLA, whose order of the ags form's xsum differs
constexpr int kLargeN = 64;

// LONG: a row past 32 values a thread (act_prologue.cuh), read an element a
// load; AGS: one scale per activation group of ags columns, xsum per
// weight group the sum of its activation groups'
template <bool LONG, bool AGS>
__global__ void __launch_bounds__(kQuantThreads) act_quant_grouped_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int gs,
    int ags, int glu, const __nv_bfloat16* __restrict__ norm_w, float eps,
    float inv_norm_k, int vec, int8_t* __restrict__ codes,
    float* __restrict__ xs, float* __restrict__ xsum) {
  // launched programmatically: wait for the kernels before, then let the
  // matmul after start
  tmac::pdl_wait();
  tmac::pdl_trigger();
  extern __shared__ __align__(16) float vals[];  // the row, staged (act_prologue.cuh)
  __shared__ float scratch[tmac::staged_floats(LONG ? tmac::kMaxWindows : kQuantThreads)];
  const int n = blockIdx.x;
  tmac::stage_row(x + (size_t)n * x_cols, K, Kp, glu, vec, vals);
  if (norm_w != nullptr)
    tmac::norm_row<LONG>(vals, K, Kp, norm_w, eps, inv_norm_k, vec, scratch);

  // one warp per group at a time: absmax, codes, code sum
  const int G = Kp / gs;
  const int warp = threadIdx.x >> 5;
  int8_t* cr = codes + (size_t)n * Kp;
  if constexpr (AGS) {
    // each activation group's code sum and scale behind the staged row,
    // then each weight group's dequantized code sum in the order the
    // reference compiles it (qgemm_grouped_kernel.weight_group_sums): from
    // kLargeN rows, and at 2 activation groups a weight group, an FMA
    // chain; below, two lanes of products, each added in order, then the
    // lanes
    const int Ga = Kp / ags, per = gs / ags;
    float* qs_s = vals + tmac::staged_floats(Kp);
    float* sc_s = qs_s + Ga;
    for (int c = warp; c < Ga; c += kQuantThreads / 32) {
      int qsum;
      const float sc = tmac::quant_group_core([&](int k) { return vals[tmac::staged(k)]; },
                                              c * ags, ags, cr, qsum);
      if ((threadIdx.x & 31) == 0) {
        xs[(size_t)n * Ga + c] = sc;
        qs_s[c] = (float)qsum;
        sc_s[c] = sc;
      }
    }
    __syncthreads();
    const bool chain = gridDim.x >= kLargeN || per == 2;
    for (int g = threadIdx.x; g < G; g += kQuantThreads) {
      const float* q = qs_s + g * per;
      const float* c = sc_s + g * per;
      float s;
      if (chain) {
        s = __fmul_rn(q[0], c[0]);
        for (int i = 1; i < per; ++i) s = __fmaf_rn(q[i], c[i], s);
      } else {
        float lane[2] = {__fmul_rn(q[0], c[0]), __fmul_rn(q[1], c[1])};
        for (int i = 2; i < per; ++i) lane[i & 1] = __fadd_rn(lane[i & 1], __fmul_rn(q[i], c[i]));
        s = __fadd_rn(lane[0], lane[1]);
      }
      xsum[(size_t)n * G + g] = s;
    }
  } else {
    for (int g = warp; g < G; g += kQuantThreads / 32)
      tmac::quant_group_warp([&](int k) { return vals[tmac::staged(k)]; }, g * gs, gs, cr,
                             xs + (size_t)n * G + g, xsum + (size_t)n * G + g);
  }
}

// the ring's stages: bits 3's stage is three planes of 32 rows (12 KB)
template <int BITS>
__host__ __device__ constexpr int k4_stages() { return BITS == 3 ? 3 : tmac::decode::kStages; }

// SC: the scales' and zero points' type (__nv_bfloat16, or float: GGUF's)
template <int BITS, int NT, bool AGS, typename SC>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k4_decode_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, true, false, k4_stages<BITS>(), AGS, SC>(a);
}

// NT: 1 token row a block, or k4_nt<BITS>() (4; 2 at 8 slots a row, bits 1
// and 3, whose int32 sums take 32 registers a token row)
template <int BITS>
constexpr int k4_nt() { return tmac::decode::fields(BITS) == 8 ? 2 : 4; }

template <int BITS, bool AGS, typename SC>
int launch_decode(const tmac::decode::Args& a, int ksplit, int nt,
                  cudaStream_t stream) {
  constexpr int P = tmac::decode::fields(BITS), S = k4_stages<BITS>();
  constexpr int W = tmac::decode::planes(BITS), NT = k4_nt<BITS>();
  constexpr int SB = (int)sizeof(SC);
  const int acts = AGS ? a.Ga : 0;
  if (nt == 1) {
    const tmac::decode::Layout L(P, 1, true, a.nunits, a.unit_rows, ksplit, a.G, S, W, acts,
                                 SB);
    return tmac::decode::launch(k4_decode_kernel<BITS, 1, AGS, SC>, a, ksplit, 1, L.total,
                                stream);
  }
  const tmac::decode::Layout L(P, NT, true, a.nunits, a.unit_rows, ksplit, a.G, S, W, acts,
                               SB);
  return tmac::decode::launch(k4_decode_kernel<BITS, NT, AGS, SC>, a, ksplit, NT, L.total,
                              stream);
}

template <bool AGS, typename SC>
int launch_decode_bits(const tmac::decode::Args& a, int bits, int ksplit, int nt,
                       cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_decode<1, AGS, SC>(a, ksplit, nt, stream);
    case 2: return launch_decode<2, AGS, SC>(a, ksplit, nt, stream);
    case 3: return launch_decode<3, AGS, SC>(a, ksplit, nt, stream);
    case 4: return launch_decode<4, AGS, SC>(a, ksplit, nt, stream);
    default: return launch_decode<8, AGS, SC>(a, ksplit, nt, stream);
  }
}

// ---------------------------------------------------------------------------
// K4's native form (E3), below 64 rows
// ---------------------------------------------------------------------------

constexpr int kNatCols = 64;                                  // output columns of a block
constexpr int kNatLanes = 16;                                 // k lanes a column word
constexpr int kNatThreads = kNatCols / 4 * kNatLanes;         // 256
constexpr int kNatWarps = kNatThreads / 32;

// the 4 codes of k at packed columns col .. col + 3, as floats: field
// k / Kb of packed row k % Kb (bits 3: + 4 * bit k / Kh of hi row k % Kh;
// bits 8: the signed byte of row k)
template <int BITS>
__device__ __forceinline__ void native_codes(const uint8_t* __restrict__ packed,
                                             const uint8_t* __restrict__ packed_hi, int k,
                                             int Kb, int Kh, int Mp, int col, float w[4]) {
  const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)(k % Kb) * Mp + col));
  if (BITS == 8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = (float)(int8_t)(word >> (8 * e));
    return;
  }
  constexpr int LB = BITS == 3 ? 2 : BITS;
  constexpr uint32_t kMask = LB == 1 ? 0x01010101u : LB == 2 ? 0x03030303u : 0x0F0F0F0Fu;
  uint32_t v = (word >> (LB * (k / Kb))) & kMask;
  if (BITS == 3) {
    const uint32_t h =
        __ldg(reinterpret_cast<const uint32_t*>(packed_hi + (size_t)(k % Kh) * Mp + col));
    v |= ((h >> (k / Kh)) & 0x01010101u) << 2;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = (float)((v >> (8 * e)) & 0xFF);
}

__device__ __forceinline__ float x_value(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float x_value(float v) { return v; }

// Block: columns [64 * blockIdx.x, +64), token rows [NT * blockIdx.y, +NT).
// Thread: column word cw = lane % 16 (columns 4 cw .. +3 of the block), k
// lane 2 * warp + lane / 16; after a chunk's sums meet, thread t < NT * 64
// owns output (row t / 64, column t % 64).  XT: x's type, __nv_bfloat16 or
// float.
template <int BITS, int NT, typename SC, typename XT>
__global__ void __launch_bounds__(kNatThreads) k4_native_kernel(
    const XT* __restrict__ x, const float* __restrict__ xsum, int N, int Kp, int gs,
    int chunk, const uint8_t* __restrict__ packed, const uint8_t* __restrict__ packed_hi,
    int Mp, const SC* __restrict__ scales, const SC* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  __shared__ float red[kNatWarps][NT * kNatCols];
  constexpr int P = BITS == 8 ? 1 : BITS == 3 ? 4 : 8 / BITS;  // fields of a (lo plane) byte
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = lane & 15, kl = 2 * warp + (lane >> 4);
  const int m0 = blockIdx.x * kNatCols, n0 = blockIdx.y * NT;
  const int nrows = min(NT, N - n0);
  const int Kb = Kp / P, Kh = Kp / 8, C = Kp / chunk;
  const bool owner = tid < NT * kNatCols;
  const int on = tid / kNatCols, om = tid % kNatCols;
  float acc = 0.f, p0 = 0.f, s0 = 0.f;
  for (int c = 0; c < C; ++c) {
    const int k0 = c * chunk;
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    for (int i = kl; i < chunk; i += kNatLanes) {
      const int k = k0 + i;
      float w[4];
      native_codes<BITS>(packed, packed_hi, k, Kb, Kh, Mp, m0 + 4 * cw, w);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float xv = n < nrows ? x_value(x[(size_t)(n0 + n) * Kp + k]) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = __fmaf_rn(xv, w[e], part[n][e]);
      }
    }
    // k lane 2w + 1 (lanes 16-31) into 2w (lanes 0-15), then the warps in order
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[n][e] = __fadd_rn(part[n][e], __shfl_down_sync(0xffffffffu, part[n][e], 16));
    if (lane < 16) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][n * kNatCols + 4 * cw + e] = part[n][e];
    }
    __syncthreads();
    if (owner) {
      float p = red[0][tid];
#pragma unroll
      for (int w = 1; w < kNatWarps; ++w) p = __fadd_rn(p, red[w][tid]);
      const float sc = tmac::decode::factor(scales[(size_t)(k0 / gs) * Mp + m0 + om]);
      if (c == 0) {
        p0 = p;
        s0 = sc;
        acc = __fmul_rn(p, sc);
      } else if (c == 1) {
        acc = __fmaf_rn(p0, s0, __fmul_rn(p, sc));
      } else {
        acc = __fmaf_rn(p, sc, acc);
      }
    }
    __syncthreads();  // red is read before the next chunk's sums land
  }
  if (owner && on < nrows) {
    const int n = n0 + on, m = m0 + om, G = Kp / gs;
    float z = 0.f;
    for (int g = 0; g < G; ++g)
      z = __fmaf_rn(xsum[(size_t)n * G + g], tmac::decode::factor(sub[(size_t)g * Mp + m]), z);
    float o = __fsub_rn(acc, z);
    if (residual != nullptr) o = __fadd_rn(o, __bfloat162float(residual[(size_t)n * Mp + m]));
    out[(size_t)n * Mp + m] = o;
  }
}

template <int BITS, typename SC, typename XT>
int launch_native(const XT* x, const float* xsum, int N, int Kp, int gs, int chunk,
                  const uint8_t* packed, const uint8_t* packed_hi, int Mp, const void* scales,
                  const void* sub, const __nv_bfloat16* residual, float* out,
                  cudaStream_t stream) {
  const SC* sc = static_cast<const SC*>(scales);
  const SC* sb = static_cast<const SC*>(sub);
  if (N == 1) {
    k4_native_kernel<BITS, 1, SC, XT><<<dim3(Mp / kNatCols, 1), kNatThreads, 0, stream>>>(
        x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp, sc, sb, residual, out);
  } else {
    k4_native_kernel<BITS, 4, SC, XT>
        <<<dim3(Mp / kNatCols, (N + 3) / 4), kNatThreads, 0, stream>>>(
            x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp, sc, sb, residual, out);
  }
  return (int)cudaGetLastError();
}

template <typename SC, typename XT>
int launch_native_bits(int bits, const XT* x, const float* xsum, int N, int Kp,
                       int gs, int chunk, const uint8_t* packed, const uint8_t* packed_hi,
                       int Mp, const void* scales, const void* sub,
                       const __nv_bfloat16* residual, float* out, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_native<1, SC, XT>(x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp,
                                        scales, sub, residual, out, stream);
    case 2: return launch_native<2, SC, XT>(x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp,
                                        scales, sub, residual, out, stream);
    case 3: return launch_native<3, SC, XT>(x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp,
                                        scales, sub, residual, out, stream);
    case 4: return launch_native<4, SC, XT>(x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp,
                                        scales, sub, residual, out, stream);
    default: return launch_native<8, SC, XT>(x, xsum, N, Kp, gs, chunk, packed, packed_hi, Mp,
                                         scales, sub, residual, out, stream);
  }
}

}  // namespace

// Prologue: x (N, x_cols) bf16 -> codes (N, Kp) int8 in natural k order,
// xs (N, Ga) and xsum (N, G) f32, G = Kp / gs, Ga = Kp / ags (ags > 0: 16
// or a multiple of 32, below and dividing gs) or G (ags 0).  norm_w (K,) bf16 or
// null.  Returns the CUDA error of the launch (0 on success).
extern "C" int tmac_act_quant_grouped(const void* x, int N, int x_cols, int K,
                                      int Kp, int gs, int ags, int glu,
                                      const void* norm_w, float eps,
                                      float inv_norm_k, void* codes,
                                      float* xs, float* xsum, void* stream) {
  if (N <= 0 || !tmac::decode::unit_size_ok(gs) || Kp % gs != 0 || Kp > tmac::kMaxRowK ||
      (ags != 0 && (!tmac::decode::unit_size_ok(ags) || gs % ags != 0 || ags >= gs)))
    return (int)cudaErrorInvalidValue;
  const bool long_row = Kp > tmac::kSumWindow * kQuantThreads;
  auto kernel = long_row ? (ags ? &act_quant_grouped_kernel<true, true>
                                : &act_quant_grouped_kernel<true, false>)
                         : (ags ? &act_quant_grouped_kernel<false, true>
                                : &act_quant_grouped_kernel<false, false>);
  const int smem = (tmac::staged_floats(Kp) + (ags ? 2 * (Kp / ags) : 0)) * 4;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return tmac::decode::launch_programmatic(
      kernel, dim3(N), dim3(kQuantThreads), smem, (cudaStream_t)stream,
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, gs, ags, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k,
      long_row ? 0 : tmac::row_loads_vec(x, x_cols, K, norm_w), static_cast<int8_t*>(codes),
      xs, xsum);
}

// K4's matmul: codes (N, Kp) int8 in natural order, xs (N, Ga) and xsum
// (N, G) f32 from the prologue (Ga = Kp / ags, or G when ags is 0), packed
// (Kp * bits / 8, Mp) uint8 (bits 3: the lo plane (Kp / 4, Mp) and
// packed_hi, the hi plane (Kp / 8, Mp); else packed_hi null), scales and
// sub (G, Mp) bf16 (scale_f32 0) or f32 (scale_f32 1), residual (N, Mp)
// bf16 or null -> out (N, Mp) f32, the fold on chip.  1 <= N < 64; bits 1
// to 4 or 8 (signed codes); gs 16 or a multiple of 32, ags 0 or 16 or a
// multiple of 32, below and dividing gs; Kp a multiple of gs * P (P = 8 at
// bits 1 and 3, 1 at bits 8, 8 / bits else); Mp of 128; G >= 2; a cluster
// of ksplit (1-8) blocks along K, nt (1, or 4; 2 at bits 1 and 3) token
// rows a block.  Launched programmatically after the prologue.  Returns the CUDA
// error (cudaErrorInvalidConfiguration for a cluster the card cannot
// place).
extern "C" int tmac_decode_group_gemm(const void* codes, const float* xs,
                                      const float* xsum, int N, int Kp, int gs,
                                      int ags, int bits, const void* packed,
                                      const void* packed_hi,
                                      int Mp, const void* scales, const void* sub,
                                      int scale_f32, const void* residual, float* out,
                                      int ksplit, int nt, void* stream) {
  if (bits < 1 || (bits > 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  const int P = tmac::decode::fields(bits), nt_max = P == 8 ? 2 : 4;
  if (N <= 0 || N >= 64 || !tmac::decode::unit_size_ok(gs) ||
      Mp % tmac::decode::kStrip != 0 || (bits == 3) != (packed_hi != nullptr) ||
      Kp % (gs * P) != 0 || Kp / gs < 2 || ksplit < 1 ||
      ksplit > tmac::decode::kMaxSplit || (nt != 1 && nt != nt_max) ||
      (ags != 0 && (!tmac::decode::unit_size_ok(ags) || gs % ags != 0 || ags >= gs)))
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
  a.G = Kp / gs;
  a.unit_rows = ags ? ags : gs;
  a.nunits = a.Kb / a.unit_rows;
  a.Ga = ags ? Kp / ags : a.G;
  cudaStream_t s = (cudaStream_t)stream;
  if (scale_f32)
    return ags ? launch_decode_bits<true, float>(a, bits, ksplit, nt, s)
               : launch_decode_bits<false, float>(a, bits, ksplit, nt, s);
  return ags ? launch_decode_bits<true, __nv_bfloat16>(a, bits, ksplit, nt, s)
             : launch_decode_bits<false, __nv_bfloat16>(a, bits, ksplit, nt, s);
}

// K4's native form (E3): x (N, Kp) bf16 (x_f32 0) or f32
// (x_f32 1) (the caller's, its K padding zero), xsum (N, G) f32 (its f32
// sums a scale group of gs k;
// G = Kp / gs, 1 for one scale row), packed as tmac_decode_group_gemm's,
// scales and sub (G, Mp) bf16 (scale_f32 0) or f32 (1), residual (N, Mp)
// bf16 or null -> out (N, Mp) f32.  chunk: the fold's chunk (a multiple of
// 16 dividing gs and Kp / P; the reference's min(gs, Kp / P), at bits 3
// also at most Kp / 8).  1 <= N, below 64 on bf16 x (K4L's native instance
// takes bf16 x from there; the tensor cores have no f32 x bf16 product, so
// f32 x stays here at any N); Mp a multiple of 64.
extern "C" int tmac_decode_native(const void* x, int x_f32, const float* xsum, int N, int Kp,
                                  int gs, int chunk, int bits, const void* packed,
                                  const void* packed_hi, int Mp, const void* scales,
                                  const void* sub, int scale_f32, const void* residual,
                                  float* out, void* stream) {
  const int P = bits == 8 ? 1 : bits == 3 ? 4 : (bits >= 1 && bits <= 4 ? 8 / bits : 0);
  if (N <= 0 || (N >= kLargeN && !x_f32) || P == 0 || (bits == 3) != (packed_hi != nullptr) ||
      Mp % kNatCols != 0 || gs <= 0 || Kp % gs != 0 || chunk < 16 || chunk % 16 != 0 ||
      (Kp / P) % chunk != 0 || (gs % chunk != 0 && chunk % gs != 0) ||
      (bits == 3 && (Kp / 8) % chunk != 0))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* ph = static_cast<const uint8_t*>(packed_hi);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return scale_f32 ? launch_native_bits<float>(bits, xf, xsum, N, Kp, gs, chunk, pk, ph, Mp,
                                                 scales, sub, res, out, s)
                     : launch_native_bits<__nv_bfloat16>(bits, xf, xsum, N, Kp, gs, chunk, pk,
                                                         ph, Mp, scales, sub, res, out, s);
  return scale_f32 ? launch_native_bits<float>(bits, xb, xsum, N, Kp, gs, chunk, pk, ph, Mp,
                                               scales, sub, res, out, s)
                   : launch_native_bits<__nv_bfloat16>(bits, xb, xsum, N, Kp, gs, chunk, pk,
                                                       ph, Mp, scales, sub, res, out, s);
}
