// K2: single-token (decode) attention over one layer of the stacked KV
// cache, for Hopper.
//
// Replaces tmac_tpu/ops/pallas/attention_kernel.py::_kernel as reached
// through flash_decode_stacked (append, quant, window and write all off):
//
//   q (B, KV, rep, Dl); k, v (L, B, KV, S, Dp); kv_lens (B,); layer (1,)
//   out[b, h, r] = softmax(q . k[layer, b, h, :len] * scale) @ v[...]
//
// with q zero-extended from Dl to Dp and the output cut back to Dl inside
// the kernel, scale = 1/sqrt(Dl) from the caller, an f32 online softmax,
// and the final acc / max(l, 1e-30).  The layer index and the lengths are
// read from device memory, so the host never waits on them.
//
// What bounds it: each valid cache row of k and v is read once and used
// for 2*rep multiply-adds per element, so device-memory bytes bound it.
// The TPU grid is (B,), a single program at B=1; here one block serves
// one (kv head, batch row) pair, 32 blocks for BitNet-3B.  Inside a block
// 16 half-warps each stream every 16th position: a half-warp reads one
// 256-byte row (Dp=128 bf16) as 16-byte loads, reduces its dot product
// with 4 shuffles and keeps its own online-softmax state in registers.
// The 16 partial states are merged through shared memory at the end, in a
// fixed order.  Every sum and product is rounded on its own (no FMA), in an
// order the plain version in attention_kernel.py repeats, so the two agree
// bit for bit.  A position-split across blocks (flash-decoding) is later
// work: at the main path's lengths (<= 80 rows) a block makes <= 5 passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDp = 128;      // cache head_dim this kernel serves
constexpr int kGroups = 16;   // half-warps of a block
constexpr int kPer = kDp / 16;  // elements of a row per lane

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T, int MAXREP>
__global__ void __launch_bounds__(kGroups * 16) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lens, const int* __restrict__ layer,
    T* __restrict__ out, int L, int B, int KV, int rep, int Dl, int S,
    float scale) {
  __shared__ float sm_m[kGroups][MAXREP];
  __shared__ float sm_l[kGroups][MAXREP];
  __shared__ float sm_acc[kGroups][kDp];

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int d0 = lane * kPer;
  const unsigned hmask = 0xffffu << (threadIdx.x & 16);
  const int li = min(max(layer[0], 0), L - 1);
  const int len = min(max(lens[b], 0), S);

  float qf[MAXREP][kPer];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + i;
      qf[r][i] = (r < rep && d < Dl)
          ? to_float(q[((size_t)(b * KV + h) * rep + r) * Dl + d]) * scale
          : 0.f;
    }

  float m[MAXREP], l[MAXREP], acc[MAXREP][kPer];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0.f;
  }

  const size_t base = (((size_t)li * B + b) * KV + h) * (size_t)S * kDp + d0;
  for (int s = g; s < len; s += kGroups) {
    float kf[kPer], vf[kPer];
    load8(k + base + (size_t)s * kDp, kf);
    load8(v + base + (size_t)s * kDp, vf);
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) sc = __fadd_rn(sc, __fmul_rn(qf[r][i], kf[i]));
        for (int o = 8; o > 0; o >>= 1) sc = __fadd_rn(sc, __shfl_xor_sync(hmask, sc, o));
        // sc is finite (a valid row), so m_new is and exp(-inf) = 0 needs
        // no guard here
        const float m_new = fmaxf(m[r], sc);
        const float corr = expf(m[r] - m_new);
        const float p = expf(sc - m_new);
        l[r] = __fadd_rn(__fmul_rn(l[r], corr), p);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[r][i] = __fadd_rn(__fmul_rn(acc[r][i], corr), __fmul_rn(p, vf[i]));
        m[r] = m_new;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      sm_m[g][r] = m[r];
      sm_l[g][r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= rep) break;
    float mx = -INFINITY;
    for (int gg = 0; gg < kGroups; ++gg) mx = fmaxf(mx, sm_m[gg][r]);
    // -inf guards: a group that saw no row (or a block with len == 0)
    // contributes zeros, not NaN
    const float cg = isinf(m[r]) ? 0.f : expf(m[r] - mx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) sm_acc[g][d0 + i] = __fmul_rn(acc[r][i], cg);
    __syncthreads();
    if (threadIdx.x < kDp) {
      const int d = threadIdx.x;
      float a = 0.f, lt = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) {
        a = __fadd_rn(a, sm_acc[gg][d]);
        const float mg = sm_m[gg][r];
        lt = __fadd_rn(lt, isinf(mg) ? 0.f : __fmul_rn(sm_l[gg][r], expf(mg - mx)));
      }
      if (d < Dl) store(out + ((size_t)(b * KV + h) * rep + r) * Dl + d, a / fmaxf(lt, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens,
           const int* layer, void* out, int L, int B, int KV, int rep, int Dl,
           int S, float scale, cudaStream_t stream) {
  const dim3 grid(KV, B), block(kGroups * 16);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (rep == 1) {
    flash_decode_kernel<T, 1><<<grid, block, 0, stream>>>(
        qt, kt, vt, lens, layer, ot, L, B, KV, rep, Dl, S, scale);
  } else {
    flash_decode_kernel<T, 8><<<grid, block, 0, stream>>>(
        qt, kt, vt, lens, layer, ot, L, B, KV, rep, Dl, S, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, rep, Dl), k/v (L, B, KV, S, Dp), out (B, KV, rep, Dl), all of
// one type (bf16 when is_bf16, else f32); lens (B,) and layer (1,) int32 on
// the device.  Dp must be 128 and rep at most 8.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int tmac_flash_decode(const void* q, const void* k, const void* v,
                                 const int* lens, const int* layer, void* out,
                                 int L, int B, int KV, int rep, int Dl, int Dp,
                                 int S, float scale, int is_bf16,
                                 void* stream) {
  if (Dp != kDp || rep < 1 || rep > 8 || Dl < 1 || Dl > Dp || L < 1 || B < 1 ||
      KV < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lens, layer, out, L, B, KV, rep, Dl, S, scale, s);
  return launch<float>(q, k, v, lens, layer, out, L, B, KV, rep, Dl, S, scale, s);
}
