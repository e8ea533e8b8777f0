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
// What bounds it: at decode (N = 1) each packed weight byte feeds 4
// (bits 2) or 2 (bits 4) multiply-adds, far below the card's
// operations-per-byte balance, so device-memory bytes bound it.  The work
// is split in three kernels:
//   1. the prologue, one block per row (blocks share nothing, so the TPU
//      kernel's step-0 scratch becomes a kernel of its own): codes in
//      natural k order, xs (N, G) and xsum (N, G);
//   2. the per-group integer dots, written as int32 partials (G, N, Mp).
//      Integer sums are exact in any order, so this kernel is free to
//      split the work for the memory system: a block takes a 128-column
//      strip, one chunk of gs packed rows and up to kRowsMany tokens; a
//      thread loads the 4 adjacent columns of a packed row as one 32-bit
//      word, 4 rows at a time, turns them into per-column words with byte
//      permutes and masks out field j, whose 4 bytes are 4 consecutive k
//      of one group (field j of packed row r holds k = r + j * Kp / p, and
//      Kp / p is a multiple of gs), so one dp4a meets 4 consecutive codes;
//      the 8 warps of a block add their partials in shared memory with
//      integer atomics;
//   3. the f32 fold above, one thread per output, in group order, the
//      loads of 16 groups issued ahead of the chain.
// The partials cost 8 bytes per output and group of extra traffic (about
// a fifth of the packed bytes at decode, most of it in L2); a fold inside
// the matmul that keeps the group order is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

namespace {

constexpr int kQuantThreads = 512;
constexpr int kWarps = 8;
constexpr int kStrip = 128;     // output columns of a matmul block
constexpr int kRowsMany = 4;    // token rows of a matmul block when N > 1
constexpr int kFoldThreads = 32;   // the fold is a per-thread chain: small blocks spread it
constexpr int kFoldAhead = 16;   // groups whose loads the fold issues together
constexpr int kMaxGroups = 512;  // the fold keeps a row's xs and xsum in shared memory

__global__ void __launch_bounds__(kQuantThreads) act_quant_grouped_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int gs,
    int glu, const __nv_bfloat16* __restrict__ norm_w, float eps,
    float inv_norm_k, int8_t* __restrict__ codes, float* __restrict__ xs,
    float* __restrict__ xsum) {
  __shared__ float scratch[kQuantThreads];
  const int n = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)n * x_cols;
  float rs = 1.f;
  if (norm_w != nullptr)
    rs = tmac::rms_factor(tmac::sumsq_xla_order(xr, K, Kp, glu, scratch),
                          inv_norm_k, eps);

  // one warp per group at a time: absmax, codes, code sum
  const int G = Kp / gs;
  const int warp = threadIdx.x >> 5;
  int8_t* cr = codes + (size_t)n * Kp;
  for (int g = warp; g < G; g += kQuantThreads / 32)
    tmac::quant_group_warp(
        [&](int k) { return tmac::prologue_value(xr, k, K, glu, norm_w, rs); }, g * gs,
        gs, cr, xs + (size_t)n * G + g, xsum + (size_t)n * G + g);
}

// Block: columns [128 * blockIdx.x, +128) (lane l: 4 columns from 4 * l),
// chunk c = blockIdx.y (packed rows [c * gs, +gs), the groups
// g = j * nchunks + c of the P fields), token rows from NT * blockIdx.z.
// Warp w takes packed rows [c * gs + w * gs / 8, +gs / 8).
template <int BITS, int NT>
__global__ void __launch_bounds__(kWarps * 32) group_dot_kernel(
    const int32_t* __restrict__ codes4, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, int Mp, int32_t* __restrict__ parts) {
  constexpr int P = 8 / BITS;
  constexpr uint32_t kMask = BITS == 2 ? 0x03030303u : 0x0F0F0F0Fu;
  __shared__ int acc_s[NT * P * kStrip];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kStrip + 4 * lane;
  const int c = blockIdx.y;
  const int n0 = blockIdx.z * NT;
  const int nrows = min(NT, N - n0);
  const int nq = Kp / 4;          // 32-bit words of codes per row
  const int Kb = Kp / P;          // packed rows
  const int rpw = gs / kWarps;    // packed rows of a warp
  for (int i = threadIdx.x; i < NT * P * kStrip; i += blockDim.x) acc_s[i] = 0;
  __syncthreads();

  int part[NT][P][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) part[n][j][cc] = 0;

  const int r0 = c * gs + warp * rpw;
  for (int r = r0; r < r0 + rpw; r += 4) {
    const uint8_t* p = packed + (size_t)r * Mp + m0;
    uint32_t col[4];  // col[cc]: column m0 + cc's bytes of rows r .. r+3
    tmac::transpose4(__ldg(reinterpret_cast<const uint32_t*>(p)),
               __ldg(reinterpret_cast<const uint32_t*>(p + Mp)),
               __ldg(reinterpret_cast<const uint32_t*>(p + 2 * (size_t)Mp)),
               __ldg(reinterpret_cast<const uint32_t*>(p + 3 * (size_t)Mp)),
               col);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int q = (j * Kb + r) / 4;  // codes of k = j*Kb + r .. +3
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nrows) {
          const int xv = __ldg(codes4 + (size_t)(n0 + n) * nq + q);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            part[n][j][cc] = __dp4a((int)((col[cc] >> (BITS * j)) & kMask), xv,
                                    part[n][j][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (n < nrows) atomicAdd(&acc_s[(n * P + j) * kStrip + 4 * lane + cc], part[n][j][cc]);
  __syncthreads();

  const int nchunks = Kb / gs;
  for (int i = threadIdx.x; i < NT * P * kStrip; i += blockDim.x) {
    const int n = i / (P * kStrip), j = (i / kStrip) % P, m = i % kStrip;
    if (n < nrows) {
      const size_t g = (size_t)j * nchunks + c;
      parts[(g * N + n0 + n) * Mp + blockIdx.x * kStrip + m] = acc_s[i];
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const int32_t* __restrict__ parts, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int G, int Mp,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  __shared__ float xsn[kMaxGroups], xsumn[kMaxGroups];
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    xsn[g] = xs[(size_t)n * G + g];
    xsumn[g] = xsum[(size_t)n * G + g];
  }
  __syncthreads();
  if (m >= Mp) return;
  const size_t stride = (size_t)N * Mp;
  const int32_t* pp = parts + (size_t)n * Mp + m;
  // The two chains run in group order; the loads of kFoldAhead groups are
  // issued together ahead of them, so the thread waits on device memory
  // once per kFoldAhead groups and not once per group (the row's xs and
  // xsum sit in shared memory).
  tmac::GroupFold fold;
  for (int g0 = 0; g0 < G; g0 += kFoldAhead) {
    float p[kFoldAhead], sc[kFoldAhead], sb[kFoldAhead];
#pragma unroll
    for (int i = 0; i < kFoldAhead; ++i) {
      const int g = g0 + i;
      if (g < G) {
        p[i] = (float)pp[g * stride];
        sc[i] = __bfloat162float(scales[(size_t)g * Mp + m]);
        sb[i] = __bfloat162float(sub[(size_t)g * Mp + m]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFoldAhead; ++i) {
      const int g = g0 + i;
      if (g < G) fold.step(g, p[i], xsn[g], sc[i], xsumn[g], sb[i]);
    }
  }
  float o = fold.result();
  if (residual != nullptr)
    o = __fadd_rn(o, __bfloat162float(residual[(size_t)n * Mp + m]));
  out[(size_t)n * Mp + m] = o;
}

template <int BITS>
void launch_dots(const int32_t* codes4, int N, int Kp, int gs,
                 const uint8_t* packed, int Mp, int32_t* parts,
                 cudaStream_t stream) {
  const int nchunks = Kp / (8 / BITS) / gs;
  const dim3 block(kWarps * 32);
  if (N == 1) {
    group_dot_kernel<BITS, 1><<<dim3(Mp / kStrip, nchunks, 1), block, 0, stream>>>(
        codes4, N, Kp, gs, packed, Mp, parts);
  } else {
    const int nz = (N + kRowsMany - 1) / kRowsMany;
    group_dot_kernel<BITS, kRowsMany>
        <<<dim3(Mp / kStrip, nchunks, nz), block, 0, stream>>>(
            codes4, N, Kp, gs, packed, Mp, parts);
  }
}

}  // namespace

// Prologue: x (N, x_cols) bf16 -> codes (N, Kp) int8 in natural k order,
// xs (N, G) and xsum (N, G) f32, G = Kp / gs.  norm_w (K,) bf16 or null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int tmac_act_quant_grouped(const void* x, int N, int x_cols, int K,
                                      int Kp, int gs, int glu,
                                      const void* norm_w, float eps,
                                      float inv_norm_k, void* codes,
                                      float* xs, float* xsum, void* stream) {
  if (N <= 0 || gs <= 0 || Kp % gs != 0 ||
      Kp > tmac::kSumWindow * kQuantThreads)
    return (int)cudaErrorInvalidValue;
  act_quant_grouped_kernel<<<N, kQuantThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, gs, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k,
      static_cast<int8_t*>(codes), xs, xsum);
  return (int)cudaGetLastError();
}

// Per-group int32 dots: codes (N, Kp) from the prologue, packed
// (Kp * bits / 8, Mp) uint8 -> parts (G, N, Mp) int32.  bits 2 or 4; gs a
// multiple of 32; Kp a multiple of gs * 8 / bits; Mp a multiple of 128.
extern "C" int tmac_group_dots(const void* codes, int N, int Kp, int gs,
                               int bits, const void* packed, int Mp,
                               void* parts, void* stream) {
  if (N <= 0 || gs <= 0 || gs % 32 != 0 || Mp % kStrip != 0 ||
      (bits != 2 && bits != 4) || Kp % (gs * (8 / bits)) != 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* c4 = static_cast<const int32_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  int32_t* pt = static_cast<int32_t*>(parts);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2) launch_dots<2>(c4, N, Kp, gs, pk, Mp, pt, s);
  else launch_dots<4>(c4, N, Kp, gs, pk, Mp, pt, s);
  return (int)cudaGetLastError();
}

// The f32 fold: parts (G, N, Mp), xs and xsum (N, G), scales and sub
// (G, Mp) bf16, residual (N, Mp) bf16 or null -> out (N, Mp) f32.
// 2 <= G <= 512.
extern "C" int tmac_group_fold(const void* parts, const float* xs,
                               const float* xsum, int N, int G, int Mp,
                               const void* scales, const void* sub,
                               const void* residual, float* out,
                               void* stream) {
  if (N <= 0 || G < 2 || G > kMaxGroups || Mp <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Mp + kFoldThreads - 1) / kFoldThreads, N);
  fold_kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(parts), xs, xsum, N, G, Mp,
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(sub),
      static_cast<const __nv_bfloat16*>(residual), out);
  return (int)cudaGetLastError();
}
