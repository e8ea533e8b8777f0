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
// Bits 1 to 4; bits 3 is a 2-bit lo plane (Kp / 4 rows) and a 1-bit hi
// plane (Kp / 8 rows), code = lo + 4 * hi (ops/packing.py).  Kp is a
// multiple of gs * 8 at bits 1 and 3 (the packing's padding), so the
// reference's fold chunk is the group, which these kernels require.
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
//     field, from L2).  Bits 3 adds a second B tile a stage, the hi plane's
//     KT rows (k % (Kp / 8) ..), whose bit k / (Kp / 8) is put at bit 2 of
//     each lo field's byte, and takes KT = 32 where two blocks of KT = 64
//     would not fit an SM's shared memory (K = 14336 at g128);
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
//
// The ags form (the reference's act_group_size, a template instance of its
// own in all three kernels, so that the ags = 0 code is unchanged): the
// prologue quantizes per activation group of ags columns (ags a multiple
// of 32 dividing gs) into xs (N, Ga = Kp / ags) and adds each weight
// group's gs / ags dequantized code sums into xsum (N, G) in the order the
// reference compiles its reshape-sum to on each route; K4's decode matmul
// splits K by activation groups and folds one partial an activation group
// (decode_matmul.cuh); K4L accumulates one activation group at a time
// (KT = 32 at ags 32), folds it with xs[a] * scale[a / (gs / ags)], and
// stages the Ga row factors beside the G column factors: 65 * 4 + 128 * 2
// * ags / gs bytes an activation group, so a block holds 628 activation
// groups at ags 32, g128 (Kp 20096), and the launch raises past that.

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

template <int BITS, int NT, bool AGS>
__global__ void __launch_bounds__(tmac::decode::kThreads, 2)
    k4_decode_kernel(const tmac::decode::Args a) {
  tmac::decode::decode_matmul<BITS, NT, true, false, k4_stages<BITS>(), AGS>(a);
}

// NT: 1 token row a block, or k4_nt<BITS>() (4; 2 at 8 slots a row, bits 1
// and 3, whose int32 sums take 32 registers a token row)
template <int BITS>
constexpr int k4_nt() { return tmac::decode::fields(BITS) == 8 ? 2 : 4; }

template <int BITS, bool AGS>
int launch_decode(const tmac::decode::Args& a, int ksplit, int nt,
                  cudaStream_t stream) {
  constexpr int P = tmac::decode::fields(BITS), S = k4_stages<BITS>();
  constexpr int W = tmac::decode::planes(BITS), NT = k4_nt<BITS>();
  const int acts = AGS ? a.Ga : 0;
  if (nt == 1) {
    const tmac::decode::Layout L(P, 1, true, a.nunits, a.unit_rows, ksplit, a.G, S, W, acts);
    return tmac::decode::launch(k4_decode_kernel<BITS, 1, AGS>, a, ksplit, 1, L.total,
                                stream);
  }
  const tmac::decode::Layout L(P, NT, true, a.nunits, a.unit_rows, ksplit, a.G, S, W, acts);
  return tmac::decode::launch(k4_decode_kernel<BITS, NT, AGS>, a, ksplit, NT, L.total,
                              stream);
}

// ---------------------------------------------------------------------------
// K4L
// ---------------------------------------------------------------------------

constexpr int kLBN = 64;        // token rows of a block
constexpr int kLBM = 128;       // output columns of a block
constexpr int kLThreads = 128;  // 4 warps of 64 rows x 32 columns
constexpr int kLStages = 4;

// KT codes (and packed rows) a depth step; at bits 3 a second B tile, of
// KT hi plane rows, follows the lo plane's
template <int KT, int BITS>
struct K4LTile {
  static constexpr int kAStride = KT + 16;  // bytes a codes row: conflict-free fragment reads
  static constexpr int kABytes = kLBN * kAStride;
  static constexpr int kBBytes = KT * kLBM;  // KT packed rows of 128 swizzled bytes
  static constexpr int kStage = kABytes + kBBytes * (BITS == 3 ? 2 : 1);
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
// AGS: the fold's unit is an activation group of ags k (xs (N, Ga)), each
// scaled by its weight group's column factors.
template <int BITS, int KT, bool AGS>
__global__ void __launch_bounds__(kLThreads) group_mma_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ packed_hi, int Mp,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out, int ags) {
  using T = K4LTile<KT, BITS>;
  constexpr int P = BITS == 3 ? 4 : 8 / BITS;  // fields of a (lo plane) byte
  constexpr uint32_t kMask =
      BITS == 1 ? 0x01010101u : BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp * 32;
  const int m0 = blockIdx.x * kLBM, n0 = blockIdx.y * kLBN;
  // G weight groups; Gf fold units (the activation groups with AGS), each
  // steps_g depth steps; fold unit f takes weight group f / per
  const int Kb = Kp / P, G = Kp / gs, ntiles = Kp / KT;
  const int Gf = AGS ? Kp / ags : G, per = AGS ? gs / ags : 1;
  const int steps_g = (AGS ? ags : gs) / KT;
  const int Kh = Kp / 8;  // bits 3: hi plane rows; bit k / Kh of row k % Kh

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
      if (BITS == 3)  // the hi plane's rows of the same k, the same layout
        cp_async16(Bs + T::kBBytes + r * kLBM + b_chunk(r, q) * 16,
                   packed_hi + (size_t)((t * KT) % Kh + r) * Mp + m0 + q * 16, true);
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
    const int shift = (BITS == 3 ? 2 : BITS) * ((t * KT) / Kb);  // field j of the packed bytes
    const int hbit = (t * KT) / Kh;  // bits 3: the hi plane's bit
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
        if (BITS == 3) {  // + 4 * the hi bit: the 3-bit codes
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint32_t*>(Bs + T::kBBytes + (r + i) * kLBM +
                                                      b_chunk(r + i, word >> 2) * 16 +
                                                      (word & 3) * 4);
          tmac::transpose4(w[0], w[1], w[2], w[3], col);
#pragma unroll
          for (int c = 0; c < 4; ++c) b[h][c] |= ((col[c] >> hbit) & 0x01010101u) << 2;
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(acc[mt][c], a[mt], b[0][c], b[1][c]);
    }
  };

  // The fold's per-row and per-column factors of every group, staged in
  // shared memory behind the ring once a block: rows[g * 65 + r] (f32, r
  // < 64; Gf fold units) and cols[g * 128 + m] (bf16; G weight groups): xs
  // and scale for the main loop, then xsum and sub for the epilogue.
  float* rows_s = reinterpret_cast<float*>(smem + kLStages * T::kStage);
  __nv_bfloat16* cols_s = reinterpret_cast<__nv_bfloat16*>(rows_s + Gf * 65);
  auto stage = [&](const float* rsrc, int rg, const __nv_bfloat16* csrc) {
    for (int i = tid; i < kLBN * rg; i += kLThreads) {
      const int r = i / rg, g = i % rg;
      rows_s[g * 65 + r] = rsrc[(size_t)min(n0 + r, N - 1) * rg + g];
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
  stage(xs, Gf, scales);
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
        const float x1 = __fmul_rn(row_f(1, mt, e >> 1), col_f(1 / per, c, e & 1));
        facc[mt][c][e] = __fmaf_rn(facc[mt][c][e], x0, __fmul_rn(exact_float(acc[mt][c][e]), x1));
        acc[mt][c][e] = 0;
      }
  // groups 2, 3, ...: acc = fma(p_g, x_g, acc)
  for (int g = 2; g < Gf; ++g) {
    for (int i = 0; i < steps_g; ++i, ++t) step(t);
    float xr[4][2], sc[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[c][e] = col_f(AGS ? g / per : g, c, e);
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
  stage(xsum, G, sub);
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

// the ring, then the staged factors (65 rows f32 a fold unit: Gf of them,
// the activation groups with ags, else G; 128 columns bf16 a weight group)
template <int BITS, int KT>
int k4l_smem(int G, int Gf) { return K4LTile<KT, BITS>::kSmem + Gf * 65 * 4 + G * kLBM * 2; }

template <int BITS, int KT, bool AGS>
int launch_group_mma(const int8_t* codes, const float* xs, const float* xsum,
                     int N, int Kp, int gs, int ags, const uint8_t* packed,
                     const uint8_t* packed_hi, int Mp,
                     const __nv_bfloat16* scales, const __nv_bfloat16* sub,
                     const __nv_bfloat16* residual, float* out,
                     cudaStream_t stream) {
  auto kernel = group_mma_kernel<BITS, KT, AGS>;
  const int smem = k4l_smem<BITS, KT>(Kp / gs, Kp / (AGS ? ags : gs));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Mp / kLBM, (N + kLBN - 1) / kLBN);
  kernel<<<grid, kLThreads, smem, stream>>>(codes, xs, xsum, N, Kp, gs, packed, packed_hi,
                                         Mp, scales, sub, residual, out, ags);
  return (int)cudaGetLastError();
}

// KT = 64 where the fold's unit (gs, or ags) allows, but at bits 3 (two B
// tiles a stage) only where two blocks still fit an SM's shared memory
// (else 32: K = 14336 at g128)
constexpr int kTwoBlockSmem = 113 * 1024;

template <int BITS, bool AGS>
int launch_group_mma_kt(const int8_t* codes, const float* xs, const float* xsum,
                        int N, int Kp, int gs, int ags, const uint8_t* packed,
                        const uint8_t* packed_hi, int Mp,
                        const __nv_bfloat16* scales, const __nv_bfloat16* sub,
                        const __nv_bfloat16* residual, float* out,
                        cudaStream_t stream) {
  const int unit = AGS ? ags : gs;
  if (unit % 64 == 0 &&
      (BITS != 3 || k4l_smem<BITS, 64>(Kp / gs, Kp / unit) <= kTwoBlockSmem))
    return launch_group_mma<BITS, 64, AGS>(codes, xs, xsum, N, Kp, gs, ags, packed,
                                           packed_hi, Mp, scales, sub, residual, out, stream);
  return launch_group_mma<BITS, 32, AGS>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
}

template <int BITS>
int launch_group_mma_ags(const int8_t* codes, const float* xs, const float* xsum,
                         int N, int Kp, int gs, int ags, const uint8_t* packed,
                         const uint8_t* packed_hi, int Mp,
                         const __nv_bfloat16* scales, const __nv_bfloat16* sub,
                         const __nv_bfloat16* residual, float* out,
                         cudaStream_t stream) {
  if (ags)
    return launch_group_mma_kt<BITS, true>(codes, xs, xsum, N, Kp, gs, ags, packed,
                                           packed_hi, Mp, scales, sub, residual, out, stream);
  return launch_group_mma_kt<BITS, false>(codes, xs, xsum, N, Kp, gs, 0, packed, packed_hi,
                                          Mp, scales, sub, residual, out, stream);
}

}  // namespace

// Prologue: x (N, x_cols) bf16 -> codes (N, Kp) int8 in natural k order,
// xs (N, Ga) and xsum (N, G) f32, G = Kp / gs, Ga = Kp / ags (ags > 0: a
// multiple of 32 below and dividing gs) or G (ags 0).  norm_w (K,) bf16 or
// null.  Returns the CUDA error of the launch (0 on success).
extern "C" int tmac_act_quant_grouped(const void* x, int N, int x_cols, int K,
                                      int Kp, int gs, int ags, int glu,
                                      const void* norm_w, float eps,
                                      float inv_norm_k, void* codes,
                                      float* xs, float* xsum, void* stream) {
  if (N <= 0 || gs <= 0 || Kp % gs != 0 || Kp > tmac::kMaxRowK ||
      (ags != 0 && (ags < 0 || ags % 32 != 0 || gs % ags != 0 || ags >= gs)))
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
// sub (G, Mp) bf16, residual (N, Mp) bf16 or null -> out (N, Mp) f32, the
// fold on chip.  1 <= N < 64; bits 1 to 4; gs a multiple of 32, ags 0 or a
// multiple of 32 below and dividing gs; Kp a multiple of gs * P (P = 8 at
// bits 1 and 3, 8 / bits else); Mp of 128; G >= 2; a cluster of ksplit
// (1-8) blocks along K, nt (1, or 4; 2 at bits 1 and 3) token rows a
// block.  Launched programmatically after the prologue.  Returns the CUDA
// error (cudaErrorInvalidConfiguration for a cluster the card cannot
// place).
extern "C" int tmac_decode_group_gemm(const void* codes, const float* xs,
                                      const float* xsum, int N, int Kp, int gs,
                                      int ags, int bits, const void* packed,
                                      const void* packed_hi,
                                      int Mp, const void* scales, const void* sub,
                                      const void* residual, float* out,
                                      int ksplit, int nt, void* stream) {
  if (bits < 1 || bits > 4) return (int)cudaErrorInvalidValue;
  const int P = tmac::decode::fields(bits), nt_max = P == 8 ? 2 : 4;
  if (N <= 0 || N >= 64 || gs <= 0 || gs % 32 != 0 ||
      Mp % tmac::decode::kStrip != 0 || (bits == 3) != (packed_hi != nullptr) ||
      Kp % (gs * P) != 0 || Kp / gs < 2 || ksplit < 1 ||
      ksplit > tmac::decode::kMaxSplit || (nt != 1 && nt != nt_max) ||
      (ags != 0 && (ags < 0 || ags % 32 != 0 || gs % ags != 0 || ags >= gs)))
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
  if (ags) {
    switch (bits) {
      case 1: return launch_decode<1, true>(a, ksplit, nt, s);
      case 2: return launch_decode<2, true>(a, ksplit, nt, s);
      case 3: return launch_decode<3, true>(a, ksplit, nt, s);
      default: return launch_decode<4, true>(a, ksplit, nt, s);
    }
  }
  switch (bits) {
    case 1: return launch_decode<1, false>(a, ksplit, nt, s);
    case 2: return launch_decode<2, false>(a, ksplit, nt, s);
    case 3: return launch_decode<3, false>(a, ksplit, nt, s);
    default: return launch_decode<4, false>(a, ksplit, nt, s);
  }
}

// K4L: codes (N, Kp) int8, xs (N, Ga) and xsum (N, G) f32 from the
// prologue (Ga as K4's), packed (Kp * bits / 8, Mp) uint8 (bits 3: the lo
// plane and packed_hi, as K4's), scales and sub (G, Mp) bf16, residual
// (N, Mp) bf16 or null -> out (N, Mp) f32, the fold in registers.  bits 1
// to 4; gs a multiple of 32, ags as K4's; Kp a multiple of gs * 8 / bits
// (gs * 8 at bits 3); Mp of 128; G >= 2.
extern "C" int tmac_group_gemm(const void* codes, const float* xs,
                               const float* xsum, int N, int Kp, int gs, int ags,
                               int bits, const void* packed, const void* packed_hi,
                               int Mp, const void* scales, const void* sub,
                               const void* residual, float* out, void* stream) {
  if (N <= 0 || gs <= 0 || gs % 32 != 0 || Mp % kLBM != 0 || bits < 1 || bits > 4 ||
      (bits == 3) != (packed_hi != nullptr) ||
      Kp % (gs * tmac::decode::fields(bits)) != 0 || Kp / gs < 2 ||
      (ags != 0 && (ags < 0 || ags % 32 != 0 || gs % ags != 0 || ags >= gs)))
    return (int)cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* ph = static_cast<const uint8_t*>(packed_hi);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(sub);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 1:
      return launch_group_mma_ags<1>(c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp, sc, sb, res, out, s);
    case 2:
      return launch_group_mma_ags<2>(c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp, sc, sb, res, out, s);
    case 3:
      return launch_group_mma_ags<3>(c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp, sc, sb, res, out, s);
    default:
      return launch_group_mma_ags<4>(c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp, sc, sb, res, out, s);
  }
}
