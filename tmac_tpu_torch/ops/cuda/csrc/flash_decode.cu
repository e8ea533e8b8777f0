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
//
// K6, K8, K9: the same _kernel with its other flags, as reached through
// flash_decode_stacked with k_scale/v_scale and/or window (K6),
// flash_decode_stacked_append (K8) and flash_decode_stacked_append_write
// (K9):
//
//   quant   an int8 cache with one f32 scale per row vector, (L, B, KV, S):
//           the k scale multiplies a row's score after the dot, the v scale
//           its probability before the PV product; no dequantized copy
//   window  rows below win_lo = max(len - window + append, 0) are never read
//   append  len counts the rows already cached; the current token's k/v
//           (B, KV, Dl) come as operands and are folded in as a last
//           online-softmax step
//   write   (K9) the current row is also stored at row len, quantized the
//           _quantize_kv way on an int8 cache (absmax/127 over Dl, rint,
//           +-127), zero-padded to Dp; at len >= S at row S - 1, where
//           the reference's store lands in interpret mode
//
// These run split over the rows (flash-decoding), because at Phi-3-mini's
// 2047-row window one block per head would stream ~2047 rows on 32 of the
// 132 SMs.  A first kernel (flash_partial_kernel) gives each (chunk of
// `chunk` rows, kv head, batch row) a block; its chunks start at win_lo, so
// the window's edge never falls inside a chunk or a group.  Inside a chunk
// the 16 half-warps stream rows as K2's do (an int8 row is 128 bytes, 8 a
// lane), four rows ahead in registers, and merge in group order into one
// partial state (m, l, acc[Dp]) per chunk and query head.  A second kernel
// (flash_combine_kernel, one block per (kv head, batch row)) merges the
// chunks in chunk order, adds the current token (append), divides, and
// stores the current row (write).  The store comes after every read of
// the cache because the two kernels run in stream order; the partial
// kernel reads only rows below len.  Bytes still bound it: each windowed
// row of k and v once, and its two scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kDp = 128;      // cache head_dim this kernel serves
constexpr int kGroups = 16;   // half-warps of a block
constexpr int kPer = kDp / 16;  // elements of a row per lane

// 8 consecutive elements of a cache row as loaded (one 16-byte load for
// bf16, two for f32, one 8-byte load for int8), turned into floats at use
template <typename T> struct Raw8;

template <> struct Raw8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <> struct Raw8<int8_t> {
  int2 r;
  __device__ __forceinline__ void load(const int8_t* p) {
    r = *reinterpret_cast<const int2*>(p);
  }
  __device__ __forceinline__ void get(float* f) const {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)c[i];
  }
};

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
    Raw8<T> kr, vr;
    kr.load(k + base + (size_t)s * kDp);
    vr.load(v + base + (size_t)s * kDp);
    float kf[kPer], vf[kPer];
    kr.get(kf);
    vr.get(vf);
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

// ---------------------------------------------------------------------------
// K6, K8, K9: split over the rows
// ---------------------------------------------------------------------------

// The weight of a partial online-softmax state in a merge whose maximum is
// mx: 0 for a state that saw no row (m = -inf), else exp(m - mx).
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return isinf(m) ? 0.f : expf(m - mx);
}

template <typename QT, typename CT, int MAXREP>
__global__ void __launch_bounds__(kGroups * 16) flash_partial_kernel(
    const QT* __restrict__ q, const CT* __restrict__ k,
    const CT* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ lens,
    const int* __restrict__ layer, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int L, int B,
    int KV, int rep, int Dl, int S, int window, int append, int chunk,
    float scale) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  __shared__ float sm_m[kGroups][MAXREP];
  __shared__ float sm_l[kGroups][MAXREP];
  __shared__ float sm_acc[kGroups][kDp];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nchunk = gridDim.x;
  const int g = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int d0 = lane * kPer;
  const unsigned hmask = 0xffffu << (threadIdx.x & 16);
  const int li = min(max(layer[0], 0), L - 1);
  // the window's edge from the length as given, the rows read below S:
  // past S (a slot held at pos == S) the reference masks the same rows
  const int raw = max(lens[b], 0);
  const int len = min(raw, S);
  const int lo = window > 0 ? max(raw - window + append, 0) : 0;
  const int r0 = lo + c * chunk;
  const int r1 = min(len, r0 + chunk);

  float qf[MAXREP][kPer];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + i;
      qf[r][i] = (r < rep && d < Dl)
          ? __fmul_rn(to_float(q[((size_t)(b * KV + h) * rep + r) * Dl + d]), scale)
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

  const size_t head = ((size_t)li * B + b) * KV + h;
  const CT* kh = k + head * S * kDp + d0;
  const CT* vh = v + head * S * kDp + d0;
  const float* ksh = kQuant ? ks + head * S : nullptr;
  const float* vsh = kQuant ? vs + head * S : nullptr;
  // a group keeps kAhead of its rows in flight: the row of pass j + kAhead
  // is requested as soon as the row of pass j is in registers
  constexpr int kAhead = sizeof(CT) == 4 ? 2 : 4;
  Raw8<CT> kr[kAhead], vr[kAhead];
  float ksr[kAhead], vsr[kAhead];
  auto fetch = [&](int j, int s) {
    kr[j].load(kh + (size_t)s * kDp);
    vr[j].load(vh + (size_t)s * kDp);
    if (kQuant) {
      ksr[j] = ksh[s];
      vsr[j] = vsh[s];
    }
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (r0 + g + j * kGroups < r1) fetch(j, r0 + g + j * kGroups);
  for (int s0 = r0 + g; s0 < r1; s0 += kAhead * kGroups) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = s0 + j * kGroups;
      if (s >= r1) break;
      float kf[kPer], vf[kPer];
      kr[j].get(kf);
      vr[j].get(vf);
      const float ksc = kQuant ? ksr[j] : 1.f, vsc = kQuant ? vsr[j] : 1.f;
      if (s + kAhead * kGroups < r1) fetch(j, s + kAhead * kGroups);
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r < rep) {
          float sc = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) sc = __fadd_rn(sc, __fmul_rn(qf[r][i], kf[i]));
          for (int o = 8; o > 0; o >>= 1) sc = __fadd_rn(sc, __shfl_xor_sync(hmask, sc, o));
          if (kQuant) sc = __fmul_rn(sc, ksc);
          const float m_new = fmaxf(m[r], sc);
          const float corr = expf(m[r] - m_new);
          const float p = expf(sc - m_new);
          l[r] = __fadd_rn(__fmul_rn(l[r], corr), p);
          const float pv = kQuant ? __fmul_rn(p, vsc) : p;
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            acc[r][i] = __fadd_rn(__fmul_rn(acc[r][i], corr), __fmul_rn(pv, vf[i]));
          m[r] = m_new;
        }
      }
    }
  }

  // the 16 groups' states, merged in group order into the chunk's
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
    const float e = merge_weight(m[r], mx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) sm_acc[g][d0 + i] = __fmul_rn(acc[r][i], e);
    __syncthreads();
    if (threadIdx.x < kDp) {
      const int d = threadIdx.x;
      float a = 0.f, lt = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) {
        a = __fadd_rn(a, sm_acc[gg][d]);
        lt = __fadd_rn(lt, __fmul_rn(sm_l[gg][r], merge_weight(sm_m[gg][r], mx)));
      }
      const size_t st = ((size_t)(b * KV + h) * rep + r) * nchunk + c;
      part_acc[st * kDp + d] = a;
      if (d == 0) {
        part_m[st] = mx;
        part_l[st] = lt;
      }
    }
    __syncthreads();
  }
}

// Stores the current row x[0, Dp) (zero past Dl) at `row`: as is for a
// float cache; for an int8 one as codes rint(x / sc) clamped to +-127, with
// sc = max(absmax over Dl, 1e-20) times the f32 reciprocal of 127 (how XLA
// compiles _quantize_kv's `/ 127.0`) stored at *scale.  Thread d stores
// column d.
template <typename CT>
__device__ __forceinline__ void store_row(CT* row, float* scale,
                                          const float* x, int Dl, int d) {
  if constexpr (std::is_same<CT, int8_t>::value) {
    float amax = 0.f;
    for (int i = 0; i < Dl; ++i) amax = fmaxf(amax, fabsf(x[i]));
    const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
    row[d] = d < Dl ? (int8_t)fminf(fmaxf(rintf(x[d] / sc), -127.f), 127.f) : 0;
    if (d == 0) *scale = sc;
  } else {
    store(row + d, d < Dl ? x[d] : 0.f);
  }
}

template <typename QT, typename CT, int MAXREP>
__global__ void __launch_bounds__(kDp) flash_combine_kernel(
    const QT* __restrict__ q, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const float* __restrict__ part_acc,
    const QT* __restrict__ cur_k, const QT* __restrict__ cur_v,
    CT* __restrict__ k, CT* __restrict__ v, float* __restrict__ ks,
    float* __restrict__ vs, const int* __restrict__ lens,
    const int* __restrict__ layer, QT* __restrict__ out, int L, int B, int KV,
    int rep, int Dl, int S, int nchunk, float scale, int append, int write) {
  __shared__ float sm_q[MAXREP][kDp];
  __shared__ float sm_cur[2][kDp];
  __shared__ float sm_sc[MAXREP];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = (size_t)b * KV + h;
  if (append) {
    // the current token's score per query head, in a row's order: lane
    // sums of 8 columns, then a butterfly over the 16 lanes of half-warp r
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      if (r < rep)
        sm_q[r][d] = d < Dl ? __fmul_rn(to_float(q[(bh * rep + r) * Dl + d]), scale) : 0.f;
    sm_cur[0][d] = d < Dl ? to_float(cur_k[bh * Dl + d]) : 0.f;
    sm_cur[1][d] = d < Dl ? to_float(cur_v[bh * Dl + d]) : 0.f;
    __syncthreads();
    const int r = d >> 4, lane = d & 15;
    if (r < rep) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        sc = __fadd_rn(sc, __fmul_rn(sm_q[r][lane * kPer + i], sm_cur[0][lane * kPer + i]));
      for (int o = 8; o > 0; o >>= 1)
        sc = __fadd_rn(sc, __shfl_xor_sync(0xffffu << (d & 16), sc, o));
      if (lane == 0) sm_sc[r] = sc;
    }
    __syncthreads();
  }
  for (int r = 0; r < rep && r < MAXREP; ++r) {
    // the chunks, merged in chunk order
    const size_t st = (bh * rep + r) * nchunk;
    float mx = -INFINITY;
    for (int c = 0; c < nchunk; ++c) mx = fmaxf(mx, part_m[st + c]);
    float a = 0.f, lt = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const float e = merge_weight(part_m[st + c], mx);
      a = __fadd_rn(a, __fmul_rn(part_acc[(st + c) * kDp + d], e));
      lt = __fadd_rn(lt, __fmul_rn(part_l[st + c], e));
    }
    if (append) {
      // the current token, a last online-softmax step (always valid)
      const float s_c = sm_sc[r];
      const float m_new = fmaxf(mx, s_c);
      const float p = expf(s_c - m_new);
      const float corr = expf(mx - m_new);
      lt = __fadd_rn(__fmul_rn(lt, corr), p);
      a = __fadd_rn(__fmul_rn(a, corr), __fmul_rn(p, sm_cur[1][d]));
    }
    if (d < Dl) store(out + (bh * rep + r) * Dl + d, a / fmaxf(lt, 1e-30f));
  }
  if (write) {
    const int row = min(max(lens[b], 0), S - 1);
    const int li = min(max(layer[0], 0), L - 1);
    const size_t off = (((size_t)li * B + b) * KV + h) * S + row;
    store_row(k + off * kDp, ks + off, sm_cur[0], Dl, d);
    store_row(v + off * kDp, vs + off, sm_cur[1], Dl, d);
  }
}

struct SplitArgs {
  const void *q, *cur_k, *cur_v;
  void *k, *v, *out;
  float *ks, *vs, *part_m, *part_l, *part_acc;
  const int *lens, *layer;
  int L, B, KV, rep, Dl, S, window, append, write, chunk, nchunk;
  float scale;
};

template <typename QT, typename CT, int MAXREP>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  const QT* q = static_cast<const QT*>(a.q);
  CT* k = static_cast<CT*>(a.k);
  CT* v = static_cast<CT*>(a.v);
  flash_partial_kernel<QT, CT, MAXREP>
      <<<dim3(a.nchunk, a.KV, a.B), kGroups * 16, 0, stream>>>(
          q, k, v, a.ks, a.vs, a.lens, a.layer, a.part_m, a.part_l,
          a.part_acc, a.L, a.B, a.KV, a.rep, a.Dl, a.S, a.window, a.append,
          a.chunk, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_combine_kernel<QT, CT, MAXREP><<<dim3(a.KV, a.B), kDp, 0, stream>>>(
      q, a.part_m, a.part_l, a.part_acc, static_cast<const QT*>(a.cur_k),
      static_cast<const QT*>(a.cur_v), k, v, a.ks, a.vs, a.lens, a.layer,
      static_cast<QT*>(a.out), a.L, a.B, a.KV, a.rep, a.Dl, a.S, a.nchunk,
      a.scale, a.append, a.write);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int launch_split_rep(const SplitArgs& a, cudaStream_t stream) {
  return a.rep == 1 ? launch_split<QT, CT, 1>(a, stream)
                    : launch_split<QT, CT, 8>(a, stream);
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

// K6 (append = write = 0), K8 (append = 1) and K9 (append = write = 1).
// q, cur_k, cur_v (B, KV, Dl) and out of one type (bf16 when q_bf16, else
// f32); k/v (L, B, KV, S, Dp) of that type, or int8 when quant, with ks/vs
// (L, B, KV, S) f32; lens (B,) and layer (1,) int32 on the device (lens
// counts the valid rows, or the cached rows in append mode); part_m and
// part_l (B, KV, rep, nchunk) and part_acc (B, KV, rep, nchunk, Dp) f32
// scratch, with nchunk * chunk at least the rows a window (or S) can hold.
// Returns the CUDA error of the launches (0 on success).
extern "C" int tmac_flash_decode_split(
    const void* q, void* k, void* v, float* ks, float* vs, const int* lens,
    const int* layer, const void* cur_k, const void* cur_v, void* out,
    float* part_m, float* part_l, float* part_acc, int L, int B, int KV,
    int rep, int Dl, int Dp, int S, int window, int append, int write,
    int chunk, int nchunk, float scale, int q_bf16, int quant, void* stream) {
  if (Dp != kDp || rep < 1 || rep > 8 || Dl < 1 || Dl > Dp || L < 1 || B < 1 ||
      KV < 1 || S < 1 || window < 0 || chunk < 1 || nchunk < 1 ||
      (write && !append) || (append && (!cur_k || !cur_v)) ||
      (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{q, cur_k, cur_v, k, v, out, ks, vs, part_m, part_l,
                    part_acc, lens, layer, L, B, KV, rep, Dl, S, window,
                    append, write, chunk, nchunk, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return quant ? launch_split_rep<__nv_bfloat16, int8_t>(a, s)
                 : launch_split_rep<__nv_bfloat16, __nv_bfloat16>(a, s);
  return quant ? launch_split_rep<float, int8_t>(a, s)
               : launch_split_rep<float, float>(a, s);
}
