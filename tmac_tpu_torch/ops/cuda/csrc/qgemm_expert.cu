// K7: decode qgemm against the routed experts of a stacked MoE weight, for
// Hopper: every routed expert of a token in one launch of the shared decode
// matmul (decode_matmul.cuh), after one prologue.
//
// Replaces tmac_tpu/ops/pallas/expert_kernel.py::_expert_kernel (reached
// through qgemm_expert_pallas), the select form of models/moe.py's MoE MLP,
// for the k experts of a top-k route at once:
//
//   idx (k,) int32, read from device memory (the router's top-k indices), so
//     that no host sync and no copy of an expert is needed and a decode step
//     can be captured in a CUDA graph;
//   x (N, K) [or (N, 2K) for the SwiGLU prologue], shared by the k experts,
//     or (k, N, K) [(k, N, 2K)], a block of rows each; bf16, or f32 rounded
//     to bf16 as it is read (round to nearest even, as .to(bfloat16)), so
//     that down reads gate_up's f32 output with no cast between;
//     -> optional silu(g) * u
//     -> per (row n, group g of gs columns): xs = max(amax, 1e-20) * (1/127),
//        int8 codes rint(x / xs) clamped to +-127, xsum = (code sum) * xs
//     -> per group: exact int32 dot of the codes with expert idx[j]'s weight
//        codes (packed (E, K / p, Mp), field f of packed row r holds
//        k = r + f*K/p)
//     -> the f32 fold of K4 (act_prologue.cuh, GroupFold): acc over the
//        groups in order with the reference's FMA pairing, minus xsum @ sub
//        (scales and sub (E, G, Mp) bf16, or f32: GGUF's block scales, their
//        own template instance)
//     -> out (k, N, Mp) f32; an index outside [0, E) gives NaN outputs.
//
// and its per-tensor branch (G = 1: scales and sub f32 (E, 1, Mp), the
// w_a8 experts), which is K1's function on the expert:
//     -> per row n: xs = max(amax, 1e-20) * (1/127) over the whole row,
//        int8 codes as above, xsum = (code sum) * xs
//     -> the exact int32 dot of the codes with the expert's weight codes
//     -> fma(acc * scale, xs, -(xsum * sub)), as K1's epilogue.
// Bits 1, 2 and 4, both forms (the reference's scope); grouped at any gs
// the decode matmul takes, 16 (GGUF's Q2_K experts: two 16-row units a
// ring stage, the prologue's warp a group of 16 with half its lanes idle)
// or a multiple of 32.
//
// What bounds it: at decode (N = 1) each packed weight byte feeds 8 (bits 1),
// 4 (bits 2) or 2 (bits 4) multiply-adds, so device-memory bytes bound it, and only the
// routed experts' bytes may move (a top-2 of 8 reads a quarter of the
// stack): 29.4 MB of gate_up and 14.7 MB of down for Mixtral's two experts
// a layer.  The design:
//   * two launches for the k experts, not two an expert: the prologue
//     quantizes x once (gate_up: one x for every expert; down: each
//     expert's own row block), a warp per (row block, group) (per-tensor:
//     a block per row, its values staged in shared memory once), launched
//     programmatically; the matmul is K4's decode matmul (per-tensor: K1's)
//     with the expert as grid.z, launched programmatically after it;
//   * the matmul's blocks (strip, K range, row tile, expert) read idx[j]
//     before they wait for the prologue, offset their weights, scales and
//     zero points to expert idx[j], and issue their first weight copies
//     while the prologue runs; the ring of cp.async stages, the K split
//     over a cluster and the group fold in distributed shared memory are
//     decode_matmul.cuh's (decode_plan counts k times the blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"
#include "decode_matmul.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRows = 4;  // token rows the kernel takes

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// an f32 value rounded to bf16 first, as .to(torch.bfloat16) rounds it
__device__ __forceinline__ float load_value(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(*p));
}

// The prologue: warp w of block (b, r) quantizes group kWarps * b + w of
// row r of x (rows: N, or k * N with a block of rows an expert), glu: the
// row holds g in [0, K) and u in [K, 2K).  The group's values are staged in
// the warp's gs floats of shared memory, silu(g) * u once a value.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) expert_quant_kernel(
    const T* __restrict__ x, int x_cols, int K, int gs, int glu,
    int8_t* __restrict__ codes, float* __restrict__ xs, float* __restrict__ xsum) {
  // launched programmatically: wait for the kernels before, then let the
  // matmul after start
  tmac::pdl_wait();
  tmac::pdl_trigger();
  extern __shared__ float vals[];  // kWarps x gs
  const int G = K / gs, r = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= G) return;
  const T* xr = x + (size_t)r * x_cols + (size_t)g * gs;
  float* v = vals + warp * gs;
#pragma unroll 4
  for (int i = lane; i < gs; i += 32) {
    float a = load_value(xr + i);
    if (glu) a = tmac::silu_mul(a, load_value(xr + K + i));
    v[i] = a;
  }
  __syncwarp();
  tmac::quant_group_warp([&](int k) { return v[k - g * gs]; }, g * gs, gs,
                         codes + (size_t)r * K, xs + (size_t)r * G + g,
                         xsum + (size_t)r * G + g);
}

constexpr int kTokenThreads = 512;

// The per-tensor prologue: block r quantizes row r of x (rows: N, or k * N)
// over its K values (silu(g) * u with glu), staged once in shared memory:
// absmax, codes in natural k order (4 a 32-bit store), the code sum; the
// row's scale and dequantized code sum.  Max and integer sums: any order
// is exact.
template <typename T>
__global__ void __launch_bounds__(kTokenThreads) expert_quant_token_kernel(
    const T* __restrict__ x, int x_cols, int K, int glu, int8_t* __restrict__ codes,
    float* __restrict__ xs, float* __restrict__ xsum) {
  tmac::pdl_wait();
  tmac::pdl_trigger();
  extern __shared__ float row[];  // K values
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int r = blockIdx.x;
  const T* xr = x + (size_t)r * x_cols;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kTokenThreads) {
    float v = load_value(xr + k);
    if (glu) v = tmac::silu_mul(v, load_value(xr + K + k));
    row[k] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, redf);
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  int qsum = 0;
  uint32_t* cr = reinterpret_cast<uint32_t*>(codes + (size_t)r * K);
  for (int w = threadIdx.x; w < K / 4; w += kTokenThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (int)fminf(fmaxf(rintf(row[4 * w + e] / sc), -127.f), 127.f);
      qsum += q;
      word |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
    }
    cr[w] = word;
  }
  qsum = tmac::block_allreduce(qsum, tmac::SumOp(), 0, redi);
  if (threadIdx.x == 0) {
    xs[r] = sc;
    xsum[r] = __fmul_rn((float)qsum, sc);
  }
}

template <int BITS, int NT, int STAGES, typename SC>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k7_decode_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, true, true, STAGES, false, SC>(a);
}

// the per-tensor branch: K1's body on the routed experts
template <int BITS, int NT, int STAGES>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k7_token_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, false, true, STAGES>(a);
}

// SC: the grouped scales' type (bf16 or float; the per-tensor branch's are
// f32 and SC is unused)
template <int BITS, int NT, int STAGES, bool GROUPED, typename SC>
int launch_shape(const tmac::decode::Args& a, int ksplit, int experts, cudaStream_t stream) {
  const tmac::decode::Layout L(8 / BITS, NT, GROUPED, a.nunits, a.unit_rows, ksplit, a.G,
                               STAGES, 1, 0, (int)sizeof(SC));
  if constexpr (GROUPED)
    return tmac::decode::launch(k7_decode_kernel<BITS, NT, STAGES, SC>, a, ksplit, NT,
                                L.total, stream, experts);
  else
    return tmac::decode::launch(k7_token_kernel<BITS, NT, STAGES>, a, ksplit, NT, L.total,
                                stream, experts);
}

// token rows a block: 1, or 4 (2 at bits 1, whose 8 slots a row take 32
// int32 sums a token row)
template <int BITS>
constexpr int k7_nt() { return BITS == 1 ? 2 : 4; }

template <int BITS, bool GROUPED, typename SC>
int launch_matmul(const tmac::decode::Args& a, int ksplit, int nt, int stages, int experts,
                  cudaStream_t stream) {
  constexpr int NT = k7_nt<BITS>();
  if (nt == 1)
    return stages == 6 ? launch_shape<BITS, 1, 6, GROUPED, SC>(a, ksplit, experts, stream)
                       : launch_shape<BITS, 1, 8, GROUPED, SC>(a, ksplit, experts, stream);
  return stages == 6 ? launch_shape<BITS, NT, 6, GROUPED, SC>(a, ksplit, experts, stream)
                     : launch_shape<BITS, NT, 8, GROUPED, SC>(a, ksplit, experts, stream);
}

template <bool GROUPED, typename SC = __nv_bfloat16>
int launch_bits(const tmac::decode::Args& a, int bits, int ksplit, int nt, int stages,
                int experts, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_matmul<1, GROUPED, SC>(a, ksplit, nt, stages, experts, stream);
    case 2: return launch_matmul<2, GROUPED, SC>(a, ksplit, nt, stages, experts, stream);
    default: return launch_matmul<4, GROUPED, SC>(a, ksplit, nt, stages, experts, stream);
  }
}

}  // namespace

// x: (rows, x_cols) bf16 (x_f32 0) or f32 (x_f32 1), rows = N when every
// expert shares it (x_per_expert 0), k * N otherwise; x_cols = K, or 2K with
// glu.  idx: k int32 expert indices on the device (outside [0, E): NaN
// outputs); packed (E, K*bits/8, Mp) uint8, scales and sub (E, G, Mp), G =
// K/gs: grouped (G >= 2, gs 16 or a multiple of 32, K of gs * 8 / bits) bf16
// (scale_f32 0) or f32 (scale_f32 1), or per-tensor (gs = K, G = 1, K a
// multiple of 4 * 8 / bits) f32 (scale_f32 1) -> out (k,
// N, Mp) f32; codes (rows, K) int8, xs and xsum (rows,
// G) f32: the prologue's scratch.  1 <= N <= 4; bits 1, 2 or 4; Mp a
// multiple of 128; a cluster of ksplit (1-8) blocks along K, nt (1, or 4; 2
// at bits 1) token rows a block, a ring of `stages` (6 or 8) stages
// (qgemm_kernel.decode_plan with the expert count).  Two launches, both
// programmatic.  Returns the CUDA error (0 on success).
extern "C" int tmac_qgemm_experts(const void* x, int x_f32, int x_per_expert, int N,
                                  int x_cols, int K, int gs, int glu, const void* idx,
                                  int k, int E, const void* packed, const void* scales,
                                  const void* sub, int scale_f32, int Mp, int bits, float* out,
                                  void* codes, float* xs, float* xsum, int ksplit,
                                  int nt, int stages, void* stream) {
  const int P = 8 / bits;
  const bool grouped = gs > 0 && gs < K;
  if (N < 1 || N > kMaxRows || gs <= 0 || (bits != 1 && bits != 2 && bits != 4) ||
      (grouped ? !tmac::decode::unit_size_ok(gs) || K % (gs * P) != 0 : gs != K || K % (4 * P) != 0) ||
      K > tmac::kMaxRowK || Mp % tmac::decode::kStrip != 0 || x_cols != (glu ? 2 * K : K) ||
      E < 1 || k < 1 || ksplit < 1 || ksplit > tmac::decode::kMaxSplit ||
      (nt != 1 && nt != (bits == 1 ? 2 : 4)) || (stages != 6 && stages != 8) ||
      (!grouped && !scale_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = K / gs, rows = x_per_expert ? k * N : N;
  auto* cd = static_cast<int8_t*>(codes);
  int err;
  if (grouped) {
    const dim3 grid((G + kWarps - 1) / kWarps, rows);
    const int smem = kWarps * gs * (int)sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          x_f32 ? (const void*)expert_quant_kernel<float>
                : (const void*)expert_quant_kernel<__nv_bfloat16>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    err = x_f32 ? tmac::decode::launch_programmatic(expert_quant_kernel<float>, grid,
                                                    dim3(kWarps * 32), smem, s,
                                                    static_cast<const float*>(x), x_cols, K,
                                                    gs, glu, cd, xs, xsum)
                : tmac::decode::launch_programmatic(expert_quant_kernel<__nv_bfloat16>, grid,
                                                    dim3(kWarps * 32), smem, s,
                                                    static_cast<const __nv_bfloat16*>(x),
                                                    x_cols, K, gs, glu, cd, xs, xsum);
  } else {
    const int smem = K * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        x_f32 ? (const void*)expert_quant_token_kernel<float>
              : (const void*)expert_quant_token_kernel<__nv_bfloat16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    err = x_f32 ? tmac::decode::launch_programmatic(
                      expert_quant_token_kernel<float>, dim3(rows), dim3(kTokenThreads),
                      smem, s, static_cast<const float*>(x), x_cols, K, glu, cd, xs, xsum)
                : tmac::decode::launch_programmatic(
                      expert_quant_token_kernel<__nv_bfloat16>, dim3(rows),
                      dim3(kTokenThreads), smem, s, static_cast<const __nv_bfloat16*>(x),
                      x_cols, K, glu, cd, xs, xsum);
  }
  if (err != 0) return err;
  tmac::decode::Args a{};
  a.codes = cd;
  a.xs = xs;
  a.xsum = xsum;
  a.packed = static_cast<const uint8_t*>(packed);
  a.scales = scales;
  a.sub = sub;
  a.residual = nullptr;
  a.out = out;
  a.N = N;
  a.Kp = K;
  a.Kb = K / P;
  a.Mp = Mp;
  a.G = G;
  // grouped: K's split by chunks of gs packed rows (K4's); per-tensor by
  // ring stages of 32 (K1's)
  a.unit_rows = grouped ? gs : tmac::decode::kStageRows;
  a.nunits = (a.Kb + a.unit_rows - 1) / a.unit_rows;
  a.idx = static_cast<const int*>(idx);
  a.E = E;
  a.x_per_expert = x_per_expert;
  a.Ga = G;
  if (!grouped) return launch_bits<false>(a, bits, ksplit, nt, stages, k, s);
  return scale_f32 ? launch_bits<true, float>(a, bits, ksplit, nt, stages, k, s)
                   : launch_bits<true, __nv_bfloat16>(a, bits, ksplit, nt, stages, k, s);
}
