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
//        (scales and sub (E, G, Mp) bf16)
//     -> out (k, N, Mp) f32; an index outside [0, E) gives NaN outputs.
//
// What bounds it: at decode (N = 1) each packed weight byte feeds 4 (bits 2)
// or 2 (bits 4) multiply-adds, so device-memory bytes bound it, and only the
// routed experts' bytes may move (a top-2 of 8 reads a quarter of the
// stack): 29.4 MB of gate_up and 14.7 MB of down for Mixtral's two experts
// a layer.  The design:
//   * two launches for the k experts, not two an expert: the prologue
//     quantizes x once (gate_up: one x for every expert; down: each
//     expert's own row block), a warp per (row block, group), launched
//     programmatically; the matmul is K4's decode matmul with the expert as
//     grid.z, launched programmatically after it;
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

template <int BITS, int NT, int STAGES>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k7_decode_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, true, true, STAGES>(a);
}

template <int BITS, int NT, int STAGES>
int launch_shape(const tmac::decode::Args& a, int ksplit, int experts, cudaStream_t stream) {
  const tmac::decode::Layout L(8 / BITS, NT, true, a.nunits, a.unit_rows, ksplit, a.G, STAGES);
  return tmac::decode::launch(k7_decode_kernel<BITS, NT, STAGES>, a, ksplit, NT, L.total,
                              stream, experts);
}

template <int BITS>
int launch_matmul(const tmac::decode::Args& a, int ksplit, int nt, int stages, int experts,
                  cudaStream_t stream) {
  if (nt == 1)
    return stages == 6 ? launch_shape<BITS, 1, 6>(a, ksplit, experts, stream)
                       : launch_shape<BITS, 1, 8>(a, ksplit, experts, stream);
  return stages == 6 ? launch_shape<BITS, 4, 6>(a, ksplit, experts, stream)
                     : launch_shape<BITS, 4, 8>(a, ksplit, experts, stream);
}

}  // namespace

// x: (rows, x_cols) bf16 (x_f32 0) or f32 (x_f32 1), rows = N when every
// expert shares it (x_per_expert 0), k * N otherwise; x_cols = K, or 2K with
// glu.  idx: k int32 expert indices on the device (outside [0, E): NaN
// outputs); packed (E, K*bits/8, Mp) uint8, scales and sub (E, K/gs, Mp)
// bf16 -> out (k, N, Mp) f32; codes (rows, K) int8, xs and xsum (rows, K/gs)
// f32: the prologue's scratch.  1 <= N <= 4; bits 2 or 4; gs a multiple of
// 32 with G = K/gs >= 2; K a multiple of gs * 8 / bits; Mp a
// multiple of 128; a cluster of ksplit (1-8) blocks along K, nt (1 or 4)
// token rows a block, a ring of `stages` (6 or 8) stages (qgemm_kernel.decode_plan
// with the expert count).  Two launches, both programmatic.  Returns the
// CUDA error (0 on success).
extern "C" int tmac_qgemm_experts(const void* x, int x_f32, int x_per_expert, int N,
                                  int x_cols, int K, int gs, int glu, const void* idx,
                                  int k, int E, const void* packed, const void* scales,
                                  const void* sub, int Mp, int bits, float* out,
                                  void* codes, float* xs, float* xsum, int ksplit,
                                  int nt, int stages, void* stream) {
  if (N < 1 || N > kMaxRows || gs <= 0 || gs % 32 != 0 || K / gs < 2 ||
      (bits != 2 && bits != 4) || K % (gs * (8 / bits)) != 0 ||
      Mp % tmac::decode::kStrip != 0 || x_cols != (glu ? 2 * K : K) || E < 1 || k < 1 ||
      ksplit < 1 || ksplit > tmac::decode::kMaxSplit || (nt != 1 && nt != 4) ||
      (stages != 6 && stages != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = K / gs, rows = x_per_expert ? k * N : N;
  auto* cd = static_cast<int8_t*>(codes);
  const dim3 grid((G + kWarps - 1) / kWarps, rows);
  const int smem = kWarps * gs * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        x_f32 ? (const void*)expert_quant_kernel<float>
              : (const void*)expert_quant_kernel<__nv_bfloat16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int err =
      x_f32 ? tmac::decode::launch_programmatic(expert_quant_kernel<float>, grid,
                                                dim3(kWarps * 32), smem, s,
                                                static_cast<const float*>(x), x_cols, K,
                                                gs, glu, cd, xs, xsum)
            : tmac::decode::launch_programmatic(expert_quant_kernel<__nv_bfloat16>, grid,
                                                dim3(kWarps * 32), smem, s,
                                                static_cast<const __nv_bfloat16*>(x),
                                                x_cols, K, gs, glu, cd, xs, xsum);
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
  a.Kb = K / (8 / bits);
  a.Mp = Mp;
  a.G = G;
  a.unit_rows = gs;
  a.nunits = a.Kb / gs;
  a.idx = static_cast<const int*>(idx);
  a.E = E;
  a.x_per_expert = x_per_expert;
  return bits == 2 ? launch_matmul<2>(a, ksplit, nt, stages, k, s)
                   : launch_matmul<4>(a, ksplit, nt, stages, k, s);
}
