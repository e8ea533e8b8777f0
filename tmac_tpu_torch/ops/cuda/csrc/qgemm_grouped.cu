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
// a fifth of the packed bytes at decode, most of it in L2).
//
// K4L, the same function from 64 rows of x (a prefill chunk below
// 3 * group_size rows), is bound by operations, not bytes: at 256 rows each
// packed byte feeds 256 * 4 multiply-adds (bits 2), above the card's ~590
// int8 operations per byte of device memory.  The dp4a split above would
// write (G, N, Mp) int32 partials (403 MB for Llama's wqkv at 256 rows) and
// leave the tensor cores idle, so K4L is one kernel (group_mma_kernel):
//   - int8 tensor cores through mma.sync m16n8k32, as K3.  wgmma is the
//     way to the card's full rate, but the fold below reads the int32
//     accumulator back every gs / 32 k-steps, and mma.sync keeps it in
//     ordinary registers whose owner is known; an s8 wgmma form, whose B
//     must be K-major in shared memory, is later work;
//   - a block computes 64 token rows x 128 columns, its 4 warps 64 x 32
//     each (64 int32 and 64 f32 accumulators a thread, ~255 registers, so
//     two blocks an SM, whose folds and products overlap: faster on the
//     card than one block of 128 rows); a depth step of KT = 64 (32 when
//     gs is not a multiple of 64) codes and packed rows comes through a
//     ring of kLStages stages in shared memory, filled by cp.async while
//     the warps multiply the step loaded before it;
//   - the steps run in natural k order: step t covers k = t * KT .. +KT,
//     which is field j = k / Kb of packed rows k % Kb .. +KT (Kb = Kp / p
//     packed rows; Kb is a multiple of gs, so a step never straddles a
//     field), and so the groups g = j * nchunks + c come in g order, the
//     order of the f32 chain (each packed chunk is read p times, once per
//     field, from L2);
//   - B fragments: a thread reads one 32-bit word (4 adjacent columns) of
//     4 consecutive packed rows, turns them into per-column words with
//     byte permutes (tmac::transpose4) and masks out field j: 4
//     consecutive k of one column, which is one B register of m16n8k32
//     (its n8 tile c takes columns 4 * (wn / 4 + lane / 4) + c, put back
//     in the epilogue).  The packed tile's 16-byte chunks are XOR-swizzled
//     by packed row (chunk ^ 2 * ((row / 4) % 4)), so these reads hit 32
//     distinct banks;
//   - an int32 accumulator per group: after a group's last step each
//     thread folds its 64 outputs into f32 registers, in g order, with the
//     chain above (x_g = xs * scale rounded, fma(p_0, x_0, p_1 * x_1),
//     then fma(p_g, x_g, acc)), and clears them.  No partials leave the
//     registers.  The fold's factors of every group (xs of the block's 64
//     rows, scale of its 128 columns) are staged in shared memory once a
//     block, so no fold waits on a load; its int-to-float conversions are
//     two full-rate instructions (exact_float); groups 0 and 1, whose
//     folds differ, are peeled off the loop so that the steady loop's code
//     stays small.  The z chain (xsum @ sub in g order) runs in the
//     epilogue from xsum and sub staged the same way, then out = acc - z
//     (+ residual).  So K4L equals the plain
//     version bit for bit, as the dp4a route does.  What still bounds it
//     (PERF.md): the per-group fold and the B fragments' byte permutes,
//     which the two blocks of an SM overlap with the products only in
//     part.

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

// ---------------------------------------------------------------------------
// K4L
// ---------------------------------------------------------------------------

constexpr int kLBN = 64;        // token rows of a block
constexpr int kLBM = 128;       // output columns of a block
constexpr int kLThreads = 128;  // 4 warps of 64 rows x 32 columns
constexpr int kLStages = 4;

// KT codes (and packed rows) a depth step
template <int KT>
struct K4LTile {
  static constexpr int kAStride = KT + 16;  // bytes a codes row: conflict-free fragment reads
  static constexpr int kABytes = kLBN * kAStride;
  static constexpr int kBBytes = KT * kLBM;  // KT packed rows of 128 swizzled bytes
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kSmem = kLStages * kStage;
};

// the 16-byte chunk of packed row r that holds logical chunk q
__device__ __forceinline__ int b_chunk(int r, int q) { return q ^ (((r >> 2) & 3) << 1); }

__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// (float)p for |p| < 2^22, exactly, in two full-rate instructions (the
// int-to-float conversion runs at a quarter of the rate): 1.5 * 2^23 + p
// is a float whose low mantissa bits are p
__device__ __forceinline__ float exact_float(int p) {
  return __fsub_rn(__int_as_float(0x4B400000 + p), 12582912.0f);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block: columns [128 * blockIdx.x, +128), token rows [64 * blockIdx.y,
// +64).  Warp w: the 64 rows (4 m16 tiles), columns wn = 32 w .. +32 (4 n8
// tiles, column 4 * (wn / 4 + lane / 4) + c in tile c).  Accumulator
// (mt, c, 2h + e) is row 16 mt + lane / 4 + 8 h and column
// wn + 4 (2 (lane % 4) + e) + c.
// The loop over groups peels groups 0 and 1, whose folds differ, so that
// the steady loop's code (a group's steps and one fold) stays small.
template <int BITS, int KT>
__global__ void __launch_bounds__(kLThreads) group_mma_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, int Mp,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  using T = K4LTile<KT>;
  constexpr int P = 8 / BITS;
  constexpr uint32_t kMask = BITS == 2 ? 0x03030303u : 0x0F0F0F0Fu;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp * 32;
  const int m0 = blockIdx.x * kLBM, n0 = blockIdx.y * kLBN;
  const int Kb = Kp / P, G = Kp / gs, steps_g = gs / KT, ntiles = Kp / KT;

  auto load = [&](int t, int slot) {
    uint8_t* As = smem + slot * T::kStage;
    uint8_t* Bs = As + T::kABytes;
    for (int i = tid; i < kLBN * KT / 16; i += kLThreads) {
      const int row = i / (KT / 16), q = i % (KT / 16);
      const bool ok = n0 + row < N;
      cp_async16(As + row * T::kAStride + q * 16,
                 codes + (size_t)(ok ? n0 + row : 0) * Kp + t * KT + q * 16, ok);
    }
    const int rbase = (t * KT) % Kb;
    for (int i = tid; i < KT * (kLBM / 16); i += kLThreads) {
      const int r = i >> 3, q = i & 7;
      cp_async16(Bs + r * kLBM + b_chunk(r, q) * 16,
                 packed + (size_t)(rbase + r) * Mp + m0 + q * 16, true);
    }
  };

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][c][e] = 0;

  // one depth step t: wait for its stage, start the load of step
  // t + kLStages - 1, add its products into acc
  auto step = [&](int t) {
    cp_async_wait<kLStages - 2>();
    __syncthreads();
    if (t + kLStages - 1 < ntiles) load(t + kLStages - 1, (t + kLStages - 1) % kLStages);
    cp_async_commit();
    const uint8_t* As = smem + (t % kLStages) * T::kStage;
    const uint8_t* Bs = As + T::kABytes;
    const int shift = BITS * ((t * KT) / Kb);  // field j of the packed bytes
#pragma unroll
    for (int ks = 0; ks < KT / 32; ++ks) {
      // A: one ldmatrix.x4 a m16 tile (its four 8 x 16-byte blocks are the
      // m16n8k32 A registers: rows +0 / +8, k bytes +0 / +16)
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], As + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kAStride +
                               ks * 32 + (lane >> 4) * 16);
      // b[h][c]: B register h (k + 16 h) of n8 tile c
      uint32_t b[2][4];
      const int word = (wn >> 2) + gq;  // columns 4 * word .. +3
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ks * 32 + h * 16 + tq * 4;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(
              Bs + (r + i) * kLBM + b_chunk(r + i, word >> 2) * 16 + (word & 3) * 4);
        uint32_t col[4];
        tmac::transpose4(w[0], w[1], w[2], w[3], col);
#pragma unroll
        for (int c = 0; c < 4; ++c) b[h][c] = (col[c] >> shift) & kMask;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(acc[mt][c], a[mt], b[0][c], b[1][c]);
    }
  };

  // The fold's per-row and per-column factors of every group, staged in
  // shared memory behind the ring once a block: rows[g * 65 + r] (f32, r
  // < 64) and cols[g * 128 + m] (bf16): xs and scale for the main loop,
  // then xsum and sub for the epilogue.
  float* rows_s = reinterpret_cast<float*>(smem + kLStages * T::kStage);
  __nv_bfloat16* cols_s = reinterpret_cast<__nv_bfloat16*>(rows_s + G * 65);
  auto stage = [&](const float* rsrc, const __nv_bfloat16* csrc) {
    for (int i = tid; i < kLBN * G; i += kLThreads) {
      const int r = i / G, g = i % G;
      rows_s[g * 65 + r] = rsrc[(size_t)min(n0 + r, N - 1) * G + g];
    }
    for (int i = tid; i < G * (kLBM / 2); i += kLThreads) {
      const int g = i / (kLBM / 2), w = i % (kLBM / 2);
      reinterpret_cast<uint32_t*>(cols_s)[g * (kLBM / 2) + w] =
          reinterpret_cast<const uint32_t*>(csrc + (size_t)g * Mp + m0)[w];
    }
    __syncthreads();
  };
  // the thread's 8 rows' and 8 columns' factors of group g
  auto row_f = [&](int g, int mt, int h) { return rows_s[g * 65 + mt * 16 + gq + 8 * h]; };
  auto col_f = [&](int g, int c, int e) {
    return __bfloat162float(cols_s[g * kLBM + wn + 4 * (2 * tq + e) + c]);
  };

  for (int s = 0; s < kLStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  stage(xs, scales);
  // group 0: keep p_0 (as f32) for group 1's fma(p_0, x_0, p_1 * x_1)
  int t = 0;
  for (; t < steps_g; ++t) step(t);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        facc[mt][c][e] = exact_float(acc[mt][c][e]);
        acc[mt][c][e] = 0;
      }
  // group 1
  for (; t < 2 * steps_g; ++t) step(t);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = __fmul_rn(row_f(0, mt, e >> 1), col_f(0, c, e & 1));
        const float x1 = __fmul_rn(row_f(1, mt, e >> 1), col_f(1, c, e & 1));
        facc[mt][c][e] = __fmaf_rn(facc[mt][c][e], x0, __fmul_rn(exact_float(acc[mt][c][e]), x1));
        acc[mt][c][e] = 0;
      }
  // groups 2, 3, ...: acc = fma(p_g, x_g, acc)
  for (int g = 2; g < G; ++g) {
    for (int i = 0; i < steps_g; ++i, ++t) step(t);
    float xr[4][2], sc[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[c][e] = col_f(g, c, e);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          facc[mt][c][e] = __fmaf_rn(exact_float(acc[mt][c][e]),
                                     __fmul_rn(xr[mt][e >> 1], sc[c][e & 1]), facc[mt][c][e]);
          acc[mt][c][e] = 0;
        }
  }

  // epilogue: z = fma(xsum_g, sub_g, z) in g order from the staged xsum
  // and sub; out = acc - z (+ residual), the 4 tiles' adjacent columns as
  // one float4
  __syncthreads();  // every warp is done with xs and scale
  stage(xsum, sub);
  float z[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[mt][c][e] = 0.f;
  for (int g = 0; g < G; ++g) {
    float xq[4][2], sb[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) xq[mt][h] = row_f(g, mt, h);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) sb[c][e] = col_f(g, c, e);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          z[mt][c][e] = __fmaf_rn(xq[mt][e >> 1], sb[c][e & 1], z[mt][c][e]);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + mt * 16 + gq + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wn + 4 * (2 * tq + e);
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[c] = __fsub_rn(facc[mt][c][2 * h + e], z[mt][c][2 * h + e]);
          if (residual != nullptr)
            o[c] = __fadd_rn(o[c], __bfloat162float(residual[(size_t)n * Mp + m + c]));
        }
        *reinterpret_cast<float4*>(out + (size_t)n * Mp + m) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
}

template <int BITS, int KT>
int launch_group_mma(const int8_t* codes, const float* xs, const float* xsum,
                     int N, int Kp, int gs, const uint8_t* packed, int Mp,
                     const __nv_bfloat16* scales, const __nv_bfloat16* sub,
                     const __nv_bfloat16* residual, float* out,
                     cudaStream_t stream) {
  auto kernel = group_mma_kernel<BITS, KT>;
  // the ring, then the staged per-group factors (65 rows f32 + 128 columns
  // bf16 a group)
  const int smem = K4LTile<KT>::kSmem + (Kp / gs) * (65 * 4 + kLBM * 2);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Mp / kLBM, (N + kLBN - 1) / kLBN);
  kernel<<<grid, kLThreads, smem, stream>>>(codes, xs, xsum, N, Kp, gs, packed, Mp,
                                         scales, sub, residual, out);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_group_mma_kt(const int8_t* codes, const float* xs, const float* xsum,
                        int N, int Kp, int gs, const uint8_t* packed, int Mp,
                        const __nv_bfloat16* scales, const __nv_bfloat16* sub,
                        const __nv_bfloat16* residual, float* out,
                        cudaStream_t stream) {
  if (gs % 64 == 0)
    return launch_group_mma<BITS, 64>(codes, xs, xsum, N, Kp, gs, packed, Mp,
                                          scales, sub, residual, out, stream);
  return launch_group_mma<BITS, 32>(codes, xs, xsum, N, Kp, gs, packed, Mp,
                                        scales, sub, residual, out, stream);
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

// K4L: codes (N, Kp) int8, xs and xsum (N, G) f32 from the prologue, packed
// (Kp * bits / 8, Mp) uint8, scales and sub (G, Mp) bf16, residual (N, Mp)
// bf16 or null -> out (N, Mp) f32, the fold in registers.  bits 2 or 4; gs
// a multiple of 32; Kp a multiple of gs * 8 / bits; Mp of 128; G >= 2.
extern "C" int tmac_group_gemm(const void* codes, const float* xs,
                               const float* xsum, int N, int Kp, int gs,
                               int bits, const void* packed, int Mp,
                               const void* scales, const void* sub,
                               const void* residual, float* out, void* stream) {
  if (N <= 0 || gs <= 0 || gs % 32 != 0 || Mp % kLBM != 0 ||
      (bits != 2 && bits != 4) || Kp % (gs * (8 / bits)) != 0 || Kp / gs < 2)
    return (int)cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(sub);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2)
    return launch_group_mma_kt<2>(c, xs, xsum, N, Kp, gs, pk, Mp, sc, sb, res, out, s);
  return launch_group_mma_kt<4>(c, xs, xsum, N, Kp, gs, pk, Mp, sc, sb, res, out, s);
}
