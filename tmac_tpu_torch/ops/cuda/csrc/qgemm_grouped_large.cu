// K4L: K4's function (qgemm_grouped.cu: per-group int8 activations, exact
// int32 group dots, the f32 fold in the reference's order) from 64 rows of
// x, for Hopper; its prologue is K4's (tmac_act_quant_grouped).
//
// Replaces the external-int8 form of
// tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel (grouped_int=True,
// which qgemm_pallas takes from 64 rows after an XLA prologue, below
// 3 * group_size rows or with dispatch "chunk").
//
// What bounds it: from 64 rows of x (a prefill chunk below 3 *
// group_size rows) it is bound by operations, not bytes: at 256 rows each
// packed byte feeds 256 * 4 multiply-adds (bits 2), above the card's ~590
// int8 operations per byte of device memory.  K4's dp4a split would
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
//     each lo field's byte, and takes KT = 32 only where two blocks of
//     KT = 64 would not fit an SM's shared memory;
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
//     registers.  The fold's factors stream: every 4 groups' (xs of the
//     block's 64 rows, scale of its 128 columns) are copied by cp.async
//     with the first group's first depth step into one of kBlockSlots
//     small slots, kLStages - 1 steps ahead of its folds, so no fold waits on a
//     load and shared memory does not grow with K (staging every group's
//     factors at once outgrew a block at K 14336 and gs 32); a group's
//     factors are read into registers during its first step, so that
//     those reads overlap the products (without it the ags form, a fold a
//     step, ran 13% slower than with the factors staged once); its
//     int-to-float conversions are two full-rate instructions
//     (exact_float); groups 0 and 1, whose folds differ, are peeled off
//     the loop so that the steady loop's code stays small.  The z chain
//     (xsum @ sub in g order) runs in the epilogue from xsum and sub
//     passed through the idle ring in passes of groups, then out = acc -
//     z (+ residual).  So K4L equals the plain
//     version bit for bit, as the dp4a route does.  What still bounds it
//     (PERF.md): the per-group fold and the B fragments' byte permutes,
//     which the two blocks of an SM overlap with the products only in
//     part.
//
// The ags form (the reference's act_group_size, its own template
// instance): K4L accumulates one activation group at a time (KT = 32 at
// ags 32), folds it with xs[a] * scale[a / (gs / ags)], each activation
// group's slot holding its row factors and its weight group's column
// factors.
//
// f32 scales and zero points (GGUF's block scales, which bf16 would
// round): SC = float, a template instance of its own (scale_f32 in the C
// interface), so the bf16 instances are unchanged; the factors are read
// as stored.
//
// 16-k fold units (gs 16: GGUF's Q2_K and Q3_K; or ags 16), U16, a template
// instance of its own at KT = 32: a step holds two units, k 0-15 and 16-31
// of it, which are the two halves of m16n8k32's operands (A registers 0, 1
// and 2, 3; B register 0 and 1), so each half is one m16n8k16 into the
// int32 accumulators, folded (and cleared) after it: twice the folds and
// mma instructions a step of the gs 32 form, with the same bytes.  The
// route sends gs 16 to K5 from 64 rows (3 * 16 < 64), so this form runs
// only with dispatch "chunk".
//
// Bits 8 (GGUF's Q8_0, P = 1): the packed bytes are the signed codes, the
// B registers as read, with no field to mask.
//
// The native form (NATIVE: the reference's act="native", float x kept in
// its dtype, a float dot a fold chunk, pinned to the chunk path): the A
// tile holds the caller's bf16 x (2 bytes a k), each 16 k one
// mma.sync m16n8k16 bf16 with f32 accumulators.  Every code is an integer
// below 256 in magnitude, so its bf16 is exact, and so is every product;
// only the sums' order differs from the reference's.  The B words are the
// int8 form's (4 consecutive k of a column, tmac::transpose4); the 16 k of
// an m16n8k16 are permuted so that thread tq's hardware k {2tq, 2tq + 1,
// 2tq + 8, 2tq + 9} are the logical k 4tq .. 4tq + 3, whose 4 bf16 of x are
// 8 consecutive bytes of its A row.  The fold's unit is a weight group with
// no activation scale (x_g = scale_g), xsum (N, G) is the caller's f32 sums
// of x per group.  A third library (qgemm_grouped_large_native.cu: this
// source with TMAC_K4L_NATIVE set) holds these instances, both scale
// dtypes, behind tmac_group_gemm_native (f32 x takes K4's native kernel
// at any N, qgemm_grouped.cu).
//
// One fold unit (G = 1: one scale row at bits 8, whose reference chunk is
// the whole Kp): the reference folds it once, p * x_0 for the native form,
// fma(p, x_0, -(xsum * sub)) for the external-int8 one (XLA fuses its one
// zero-point term), so the kernel keeps p as f32 and its epilogue applies
// that.
//
// This source builds two libraries: the bf16-scale instances here, and,
// compiled again with TMAC_K4L_F32 set (qgemm_grouped_large_f32.cu), the
// f32 ones, so that the two halves of K4L's 60 template instances compile
// in parallel (as one source they took 93 s of nvcc, the build's longest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act_prologue.cuh"
#include "decode_matmul.cuh"

// 1: this library's instances take f32 scales and zero points; 0: bf16
#ifndef TMAC_K4L_F32
#define TMAC_K4L_F32 0
#endif
// 1: this library holds the native (bf16 x) instances, both scale dtypes
#ifndef TMAC_K4L_NATIVE
#define TMAC_K4L_NATIVE 0
#endif

namespace {

// ---------------------------------------------------------------------------
// K4L
// ---------------------------------------------------------------------------

constexpr int kLBN = 64;        // token rows of a block
constexpr int kLBM = 128;       // output columns of a block
constexpr int kLThreads = 128;  // 4 warps of 64 rows x 32 columns
constexpr int kLStages = 4;

// KT codes (and packed rows) a depth step; at bits 3 a second B tile, of
// KT hi plane rows, follows the lo plane's.  NATIVE: bf16 x, 2 bytes a k
template <int KT, int BITS, bool NATIVE = false>
struct K4LTile {
  static constexpr int kEB = NATIVE ? 2 : 1;  // bytes of A a k
  static constexpr int kAStride = KT * kEB + 16;  // bytes an A row: conflict-free fragment reads
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

// the same on 16 k: k 0-15 of the m16n8k32 operands (A registers a0, a1;
// one B register)
__device__ __forceinline__ void mma_s8_k16(int acc[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// m16n8k16 bf16 x bf16 + f32 (the native form)
__device__ __forceinline__ void mma_bf16(float acc[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two codes (bytes i, i + 1 of a B word; s8 at bits 8, else unsigned) as
// a bf16x2 register, exactly: 1.5 * 2^23 + v carries v in its low
// mantissa bits, and every |v| < 256 has an exact bf16
template <bool SIGNED>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int i) {
  const int v0 = SIGNED ? (int)(int8_t)(w >> (8 * i)) : (int)((w >> (8 * i)) & 0xFF);
  const int v1 = SIGNED ? (int)(int8_t)(w >> (8 * i + 8)) : (int)((w >> (8 * i + 8)) & 0xFF);
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      __fsub_rn(__int_as_float(0x4B400000 + v0), 12582912.0f),
      __fsub_rn(__int_as_float(0x4B400000 + v1), 12582912.0f));
  return *reinterpret_cast<const uint32_t*>(&h);
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
__device__ __forceinline__ float exact_float(float p) { return p; }  // the native form's sums

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

// 4 bytes global -> shared, asynchronously (a fold factor of a column of xs)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ float factor(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float factor(float v) { return v; }

// 8 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The fold's factors, streamed in blocks of 4 fold units (the last block
// 2 where the fold units are not a multiple of 4): a block's row factors
// are one 16-byte copy (two 8-byte ones where xs's rows are 8-byte aligned
// only) of each of the 64 rows of xs, stored [row][unit], and its column
// factors each unit's weight group's 128 scales (SC).  Block b sits in
// slot b % kBlockSlots, loaded with the first depth step of its first
// unit, at most kLStages - 1 steps ahead; a unit's factors are read into
// registers once its first step's barrier has passed, under that step's
// products (unit 1's fold also reads unit 0's), before the block's slot
// comes round again.  The epilogue's xsum and sub pass through the idle
// ring, a group a kZSlot.  So shared memory no longer grows with K.
constexpr int kBlockSlots = 4;
constexpr int kMaxFU = 4;
constexpr int kBlockRows = kLBN * kMaxFU * 4;  // [64][fu] f32 row factors
template <typename SC>
__host__ __device__ constexpr int factor_block_bytes() {
  return kBlockRows + kMaxFU * kLBM * (int)sizeof(SC);
}
constexpr int kRowBytes = 272;  // a z pass's 64 f32 xsum, padded to 16 bytes
template <typename SC>
__host__ __device__ constexpr int z_slot_bytes() { return kRowBytes + kLBM * (int)sizeof(SC); }

// Block: columns [128 * blockIdx.x, +128), token rows [64 * blockIdx.y,
// +64).  Warp w: the 64 rows (4 m16 tiles), columns wn = 32 w .. +32 (4 n8
// tiles, column 4 * (wn / 4 + lane / 4) + c in tile c).  Accumulator
// (mt, c, 2h + e) is row 16 mt + lane / 4 + 8 h and column
// wn + 4 (2 (lane % 4) + e) + c.
// The loop over groups peels groups 0 and 1, whose folds differ, so that
// the steady loop's code (a group's steps and one fold) stays small.
// AGS: the fold's unit is an activation group of ags k (xs (N, Ga)), each
// scaled by its weight group's column factors.  SC: the scales' and zero
// points' type (__nv_bfloat16, or float: GGUF's block scales).  U16 (KT =
// 32): fold units of 16 k, two a step.  NATIVE: codes is the caller's bf16
// x (N, Kp), xs is not read (no activation scale), the sums are f32.
template <int BITS, int KT, bool AGS, typename SC, bool U16 = false, bool NATIVE = false>
__global__ void __launch_bounds__(kLThreads) group_mma_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ packed_hi, int Mp,
    const SC* __restrict__ scales, const SC* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out, int ags) {
  using T = K4LTile<KT, BITS, NATIVE>;
  using Acc = typename std::conditional<NATIVE, float, int>::type;
  static_assert(!U16 || KT == 32, "16-k fold units take KT = 32");
  static_assert(!(NATIVE && AGS), "the native form has no activation groups");
  constexpr int P = BITS == 8 ? 1 : BITS == 3 ? 4 : 8 / BITS;  // fields of a (lo plane) byte
  constexpr uint32_t kMask = BITS == 8   ? 0xFFFFFFFFu
                             : BITS == 1 ? 0x01010101u
                             : BITS == 4 ? 0x0F0F0F0Fu
                                         : 0x03030303u;
  constexpr int kBlock = factor_block_bytes<SC>();
  constexpr int kZSlot = z_slot_bytes<SC>();
  constexpr int kColChunks = kLBM * (int)sizeof(SC) / 16;  // 16-byte copies of a column row
  constexpr int kPer16 = 16 / (int)sizeof(SC);
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp * 32;
  const int m0 = blockIdx.x * kLBM, n0 = blockIdx.y * kLBN;
  // G weight groups; Gf fold units (the activation groups with AGS), each
  // steps_g depth steps (U16: half a step); fold unit f takes weight group
  // f / per
  const int Kb = Kp / P, G = Kp / gs, ntiles = Kp / KT;
  const int Gf = AGS ? Kp / ags : G, per = AGS ? gs / ags : 1;
  const int steps_g = U16 ? 1 : (AGS ? ags : gs) / KT;
  const int Kh = Kp / 8;  // bits 3: hi plane rows; bit k / Kh of row k % Kh
  uint8_t* fac = smem + T::kSmem;  // the factor blocks, behind the ring
  // fold units a factor block: 4, the last block's fewer where Gf % 4 != 0
  // (Gf is even but at bits 8, whose Kp need only be a multiple of gs); a
  // compile-time 4 keeps the fold's slot addressing in immediates (17
  // registers fewer)
  constexpr int fu = kMaxFU, fu_shift = 2;
  const bool rows16 = Gf % 4 == 0;  // xs's rows 16-byte aligned
  const bool rows8 = Gf % 2 == 0;   // 8-byte aligned
  const int steps_b = U16 ? fu / 2 : steps_g * fu;
  int fac_next = 0, fac_block = 0;  // the next block's first step, and its index

  // factor block b into its slot: the xs of the block's 64 rows for units
  // fu * b .. +fu (rows past N repeat row N - 1), and each unit's weight
  // group's scales of the block's 128 columns
  auto load_factors = [&](int b) {
    uint8_t* blk = fac + (b % kBlockSlots) * kBlock;
    const int f0 = b * fu, nu = min(fu, Gf - f0);
    if (!NATIVE && tid < kLBN) {
      const float* src = xs + (size_t)min(n0 + tid, N - 1) * Gf + f0;
      if (rows16) {
        cp_async16(blk + 16 * tid, src, true);
      } else if (rows8) {
        cp_async8(blk + 16 * tid, src);
        if (nu == fu) cp_async8(blk + 16 * tid + 8, src + 2);
      } else {
        for (int i = 0; i < nu; ++i) cp_async4(blk + 16 * tid + 4 * i, src + i);
      }
    }
    for (int i = tid - kLBN; i >= 0 && i < nu * kColChunks; i += kLThreads - kLBN) {
      const int j = i / kColChunks, q = i % kColChunks;
      cp_async16(blk + kBlockRows + j * kLBM * (int)sizeof(SC) + 16 * q,
                 scales + (size_t)((f0 + j) / per) * Mp + m0 + q * kPer16, true);
    }
  };

  auto load = [&](int t, int slot) {
    uint8_t* As = smem + slot * T::kStage;
    uint8_t* Bs = As + T::kABytes;
    const uint8_t* a_src = reinterpret_cast<const uint8_t*>(codes);
    constexpr int kAChunks = KT * T::kEB / 16;  // 16-byte copies of an A row's step
    for (int i = tid; i < kLBN * kAChunks; i += kLThreads) {
      const int row = i / kAChunks, q = i % kAChunks;
      const bool ok = n0 + row < N;
      cp_async16(As + row * T::kAStride + q * 16,
                 a_src + ((size_t)(ok ? n0 + row : 0) * Kp + t * KT) * T::kEB + q * 16, ok);
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
    // the first step of a factor block's first unit brings the block
    if (t == fac_next) {
      load_factors(fac_block++);
      fac_next += steps_b;
    }
  };

  Acc acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][c][e] = 0;

  // the A and B registers of k-slice ks (32 k) of step t's stage
  auto fragments = [&](int t, int ks, uint32_t (&a)[4][4], uint32_t (&b)[2][4]) {
    const uint8_t* As = smem + (t % kLStages) * T::kStage;
    const uint8_t* Bs = As + T::kABytes;
    const int shift = (BITS == 3 ? 2 : BITS) * ((t * KT) / Kb);  // field j of the packed bytes
    const int hbit = (t * KT) / Kh;  // bits 3: the hi plane's bit
    {
      // A: one ldmatrix.x4 a m16 tile (its four 8 x 16-byte blocks are the
      // m16n8k32 A registers: rows +0 / +8, k bytes +0 / +16); the native
      // form reads its A per 16 k (native_a)
      if (!NATIVE) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(a[mt], As + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kAStride +
                                 ks * 32 + (lane >> 4) * 16);
      }
      // b[h][c]: B register h (k + 16 h) of n8 tile c
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
    }
  };

  // the native form's A registers of the 16 k (16 hh .. +16) of k-slice ks
  // of step t for m16 tile mt: rows gq and gq + 8, logical k 4 tq .. +3 (8
  // bytes of bf16 x), which are thread tq's hardware k 2 tq, 2 tq + 1 (a0,
  // a1) and 2 tq + 8, 2 tq + 9 (a2, a3)
  auto native_a = [&](int t, int ks, int hh, int mt, uint32_t (&a)[4]) {
    const uint8_t* As = smem + (t % kLStages) * T::kStage;
    const int kb = (ks * 32 + hh * 16 + 4 * tq) * 2;
    const uint2 lo = *reinterpret_cast<const uint2*>(As + (mt * 16 + gq) * T::kAStride + kb);
    const uint2 hi = *reinterpret_cast<const uint2*>(As + (mt * 16 + gq + 8) * T::kAStride + kb);
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  };
  // the products of 16 k (half hh of a k-slice's B registers) into acc
  auto native_mma = [&](int t, int ks, int hh, const uint32_t (&b)[2][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      native_a(t, ks, hh, mt, a);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mma_bf16(reinterpret_cast<float*>(acc[mt][c]), a[0], a[1], a[2], a[3],
                 codes_bf16x2<BITS == 8>(b[hh][c], 0), codes_bf16x2<BITS == 8>(b[hh][c], 2));
    }
  };

  // one depth step t: wait for its stage, start the load of step
  // t + kLStages - 1, run before() (reads of shared memory that the
  // barrier has made safe), add its products into acc
  auto step = [&](int t, auto&& before) {
    cp_async_wait<kLStages - 2>();
    __syncthreads();
    if (t + kLStages - 1 < ntiles) load(t + kLStages - 1, (t + kLStages - 1) % kLStages);
    cp_async_commit();
    before();
#pragma unroll
    for (int ks = 0; ks < KT / 32; ++ks) {
      uint32_t a[4][4], b[2][4];
      fragments(t, ks, a, b);
      if constexpr (NATIVE) {
        native_mma(t, ks, 0, b);
        native_mma(t, ks, 1, b);
      } else {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_s8(reinterpret_cast<int*>(acc[mt][c]), a[mt], b[0][c], b[1][c]);
      }
    }
  };
  // U16: step t's two fold units, k 0-15 then 16-31, each one m16n8k16
  // into acc and then after(half) (its fold)
  auto step16 = [&](int t, auto&& after) {
    cp_async_wait<kLStages - 2>();
    __syncthreads();
    if (t + kLStages - 1 < ntiles) load(t + kLStages - 1, (t + kLStages - 1) % kLStages);
    cp_async_commit();
    uint32_t a[4][4], b[2][4];
    fragments(t, 0, a, b);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if constexpr (NATIVE) {
        native_mma(t, 0, hh, b);
      } else {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_s8_k16(reinterpret_cast<int*>(acc[mt][c]), a[mt][2 * hh], a[mt][2 * hh + 1],
                       b[hh][c]);
      }
      after(hh);
    }
  };

  // the thread's 8 rows' and 8 columns' factors of fold unit f, from its
  // block: xs and scale in the main loop
  auto row_f = [&](int f, int mt, int h) {
    if (NATIVE) return 1.f;  // no activation scale: x_f = 1 * scale, exactly
    const float* rows = reinterpret_cast<const float*>(
        fac + ((f >> fu_shift) % kBlockSlots) * kBlock);
    return rows[(mt * 16 + gq + 8 * h) * fu + (f & (fu - 1))];
  };
  auto col_f = [&](int f, int c, int e) {
    const SC* cols = reinterpret_cast<const SC*>(
        fac + ((f >> fu_shift) % kBlockSlots) * kBlock + kBlockRows);
    return factor(cols[(f & (fu - 1)) * kLBM + wn + 4 * (2 * tq + e) + c]);
  };
  // the same of group gi of an epilogue pass: xsum and sub
  auto zrow = [&](const uint8_t* slot, int mt, int h) {
    return reinterpret_cast<const float*>(slot)[mt * 16 + gq + 8 * h];
  };
  auto zcol = [&](const uint8_t* slot, int c, int e) {
    return factor(reinterpret_cast<const SC*>(slot + kRowBytes)[wn + 4 * (2 * tq + e) + c]);
  };

  for (int s = 0; s < kLStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  if constexpr (U16) {
    // step 0: units 0 (keep p_0 as f32) and 1 (fma(p_0, x_0, p_1 * x_1));
    // steps 1, ...: units 2 t and 2 t + 1, acc = fma(p_f, x_f, acc), the
    // factors read at the fold
    step16(0, [&](int hh) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (hh == 0) {
              facc[mt][c][e] = exact_float(acc[mt][c][e]);
            } else {
              const float x0 = __fmul_rn(row_f(0, mt, e >> 1), col_f(0, c, e & 1));
              const float x1 = __fmul_rn(row_f(1, mt, e >> 1), col_f(1, c, e & 1));
              facc[mt][c][e] =
                  __fmaf_rn(facc[mt][c][e], x0, __fmul_rn(exact_float(acc[mt][c][e]), x1));
            }
            acc[mt][c][e] = 0;
          }
    });
    for (int t = 1; t < ntiles; ++t)
      step16(t, [&](int hh) {
        const int f = 2 * t + hh;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              facc[mt][c][e] = __fmaf_rn(
                  exact_float(acc[mt][c][e]),
                  __fmul_rn(row_f(f, mt, e >> 1), col_f(f, c, e & 1)), facc[mt][c][e]);
              acc[mt][c][e] = 0;
            }
      });
  } else {
    // group 0: keep p_0 (as f32) for group 1's fma(p_0, x_0, p_1 * x_1),
    // or, the one unit, for the epilogue's fold
    int t = 0;
    for (; t < steps_g; ++t) step(t, [] {});
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
    if (Gf > 1) {
      for (; t < 2 * steps_g; ++t) step(t, [] {});
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = __fmul_rn(row_f(0, mt, e >> 1), col_f(0, c, e & 1));
            const float x1 = __fmul_rn(row_f(1, mt, e >> 1), col_f(1, c, e & 1));
            facc[mt][c][e] =
                __fmaf_rn(facc[mt][c][e], x0, __fmul_rn(exact_float(acc[mt][c][e]), x1));
            acc[mt][c][e] = 0;
          }
      // groups 2, 3, ...: acc = fma(p_g, x_g, acc), the factors of g read
      // during its first step
      for (int g = 2; g < Gf; ++g) {
        float xr[4][2], sc[4][2];
        step(t++, [&] {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) xr[mt][h] = row_f(g, mt, h);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) sc[c][e] = col_f(g, c, e);
        });
        for (int i = 1; i < steps_g; ++i, ++t) step(t, [] {});
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              facc[mt][c][e] =
                  __fmaf_rn(exact_float(acc[mt][c][e]), __fmul_rn(xr[mt][e >> 1], sc[c][e & 1]),
                            facc[mt][c][e]);
              acc[mt][c][e] = 0;
            }
      }
    }
  }

  // epilogue: z = fma(xsum_g, sub_g, z) in g order, xsum and sub passing
  // through the idle ring in passes of `pass` groups (the factor slots'
  // layout); out = acc - z (+ residual), the 4 tiles' adjacent columns as
  // one float4
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp left the ring
  float z[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[mt][c][e] = 0.f;
  constexpr int kPass = T::kSmem / kZSlot;
  for (int g0 = 0; g0 < G; g0 += kPass) {
    const int ng = min(kPass, G - g0);
    for (int i = tid; i < kLBN * ng; i += kLThreads) {  // along xsum's rows
      const int r = i / ng, gi = i % ng;
      reinterpret_cast<float*>(smem + gi * kZSlot)[r] =
          xsum[(size_t)min(n0 + r, N - 1) * G + g0 + gi];
    }
    for (int i = tid; i < kColChunks * ng; i += kLThreads) {
      const int gi = i / kColChunks, q = i % kColChunks;
      *reinterpret_cast<uint4*>(smem + gi * kZSlot + kRowBytes + 16 * q) =
          *reinterpret_cast<const uint4*>(sub + (size_t)(g0 + gi) * Mp + m0 +
                                          q * (16 / (int)sizeof(SC)));
    }
    __syncthreads();
    for (int gi = 0; gi < ng; ++gi) {
      const uint8_t* sg = smem + gi * kZSlot;
      float xq[4][2], sb[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) xq[mt][h] = zrow(sg, mt, h);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) sb[c][e] = zcol(sg, c, e);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            z[mt][c][e] = __fmaf_rn(xq[mt][e >> 1], sb[c][e & 1], z[mt][c][e]);
    }
    __syncthreads();  // the pass is read before the next one lands
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
          const float f = facc[mt][c][2 * h + e], zz = z[mt][c][2 * h + e];
          if (Gf == 1) {
            // the one unit's fold: the factor block of unit 0 is still in
            // its slot (the z passes use the ring only)
            const float x0 = __fmul_rn(row_f(0, mt, h), col_f(0, c, e));
            o[c] = NATIVE ? __fsub_rn(__fmul_rn(f, x0), zz) : __fmaf_rn(f, x0, -zz);
          } else {
            o[c] = __fsub_rn(f, zz);
          }
          if (residual != nullptr)
            o[c] = __fadd_rn(o[c], __bfloat162float(residual[(size_t)n * Mp + m + c]));
        }
        *reinterpret_cast<float4*>(out + (size_t)n * Mp + m) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
}

// the ring, then the factor slots: the same for every K
template <int BITS, int KT, typename SC, bool NATIVE = false>
constexpr int k4l_smem() {
  return K4LTile<KT, BITS, NATIVE>::kSmem + kBlockSlots * factor_block_bytes<SC>();
}

template <int BITS, int KT, bool AGS, typename SC, bool U16 = false, bool NATIVE = false>
int launch_group_mma(const int8_t* codes, const float* xs, const float* xsum,
                     int N, int Kp, int gs, int ags, const uint8_t* packed,
                     const uint8_t* packed_hi, int Mp, const void* scales, const void* sub,
                     const __nv_bfloat16* residual, float* out, cudaStream_t stream) {
  auto kernel = group_mma_kernel<BITS, KT, AGS, SC, U16, NATIVE>;
  constexpr int smem = k4l_smem<BITS, KT, SC, NATIVE>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Mp / kLBM, (N + kLBN - 1) / kLBN);
  kernel<<<grid, kLThreads, smem, stream>>>(codes, xs, xsum, N, Kp, gs, packed, packed_hi,
                                         Mp, static_cast<const SC*>(scales),
                                         static_cast<const SC*>(sub), residual, out, ags);
  return (int)cudaGetLastError();
}

// KT = 64 where the fold's unit (gs, or ags) allows, but at bits 3 (two B
// tiles a stage) only where two blocks still fit an SM's shared memory; a
// unit of 16 takes the U16 instance (KT = 32, two units a step)
constexpr int kTwoBlockSmem = 113 * 1024;

template <int BITS, bool AGS, typename SC, bool NATIVE = false>
int launch_group_mma_kt(const int8_t* codes, const float* xs, const float* xsum,
                        int N, int Kp, int gs, int ags, const uint8_t* packed,
                        const uint8_t* packed_hi, int Mp, const void* scales, const void* sub,
                        const __nv_bfloat16* residual, float* out, cudaStream_t stream) {
  const int unit = AGS ? ags : gs;
  if (unit == 16)
    return launch_group_mma<BITS, 32, AGS, SC, true, NATIVE>(codes, xs, xsum, N, Kp, gs, ags,
                                                             packed, packed_hi, Mp, scales, sub,
                                                             residual, out, stream);
  if (unit % 64 == 0 && (BITS != 3 || k4l_smem<BITS, 64, SC, NATIVE>() <= kTwoBlockSmem))
    return launch_group_mma<BITS, 64, AGS, SC, false, NATIVE>(codes, xs, xsum, N, Kp, gs, ags,
                                                              packed, packed_hi, Mp, scales,
                                                              sub, residual, out, stream);
  return launch_group_mma<BITS, 32, AGS, SC, false, NATIVE>(codes, xs, xsum, N, Kp, gs, ags,
                                                            packed, packed_hi, Mp, scales, sub,
                                                            residual, out, stream);
}

#if TMAC_K4L_NATIVE
template <typename SC>
int launch_native_bits(int bits, const int8_t* x, const float* xsum, int N, int Kp, int gs,
                       const uint8_t* packed, const uint8_t* packed_hi, int Mp,
                       const void* scales, const void* sub, const __nv_bfloat16* residual,
                       float* out, cudaStream_t stream) {
  switch (bits) {
    case 1:
      return launch_group_mma_kt<1, false, SC, true>(x, nullptr, xsum, N, Kp, gs, 0, packed,
                                                     packed_hi, Mp, scales, sub, residual, out,
                                                     stream);
    case 2:
      return launch_group_mma_kt<2, false, SC, true>(x, nullptr, xsum, N, Kp, gs, 0, packed,
                                                     packed_hi, Mp, scales, sub, residual, out,
                                                     stream);
    case 3:
      return launch_group_mma_kt<3, false, SC, true>(x, nullptr, xsum, N, Kp, gs, 0, packed,
                                                     packed_hi, Mp, scales, sub, residual, out,
                                                     stream);
    case 4:
      return launch_group_mma_kt<4, false, SC, true>(x, nullptr, xsum, N, Kp, gs, 0, packed,
                                                     packed_hi, Mp, scales, sub, residual, out,
                                                     stream);
    default:
      return launch_group_mma_kt<8, false, SC, true>(x, nullptr, xsum, N, Kp, gs, 0, packed,
                                                     packed_hi, Mp, scales, sub, residual, out,
                                                     stream);
  }
}
#else
template <int BITS, typename SC>
int launch_group_mma_ags(const int8_t* codes, const float* xs, const float* xsum,
                         int N, int Kp, int gs, int ags, const uint8_t* packed,
                         const uint8_t* packed_hi, int Mp, const void* scales, const void* sub,
                         const __nv_bfloat16* residual, float* out, cudaStream_t stream) {
  if (ags)
    return launch_group_mma_kt<BITS, true, SC>(codes, xs, xsum, N, Kp, gs, ags, packed,
                                               packed_hi, Mp, scales, sub, residual, out,
                                               stream);
  return launch_group_mma_kt<BITS, false, SC>(codes, xs, xsum, N, Kp, gs, 0, packed,
                                              packed_hi, Mp, scales, sub, residual, out, stream);
}

template <typename SC>
int launch_group_mma_bits(int bits, const int8_t* codes, const float* xs, const float* xsum,
                          int N, int Kp, int gs, int ags, const uint8_t* packed,
                          const uint8_t* packed_hi, int Mp, const void* scales,
                          const void* sub, const __nv_bfloat16* residual, float* out,
                          cudaStream_t stream) {
  switch (bits) {
    case 1:
      return launch_group_mma_ags<1, SC>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
    case 2:
      return launch_group_mma_ags<2, SC>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
    case 3:
      return launch_group_mma_ags<3, SC>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
    case 4:
      return launch_group_mma_ags<4, SC>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
    default:
      return launch_group_mma_ags<8, SC>(codes, xs, xsum, N, Kp, gs, ags, packed, packed_hi,
                                         Mp, scales, sub, residual, out, stream);
  }
}
#endif

}  // namespace

// K4L: codes (N, Kp) int8, xs (N, Ga) and xsum (N, G) f32 from the
// prologue (Ga as K4's), packed (Kp * bits / 8, Mp) uint8 (bits 3: the lo
// plane and packed_hi, as K4's), scales and sub (G, Mp) bf16 (scale_f32 0)
// or f32 (scale_f32 1: the library built with TMAC_K4L_F32; each library
// refuses the other), residual (N, Mp) bf16 or null -> out (N, Mp) f32,
// the fold in registers.  bits 1 to 4 or 8; gs 16 or a multiple of 32, ags
// as K4's; Kp a multiple of gs * 8 / bits (gs * 8 at bits 3, gs at bits 8);
// Mp of 128; G >= 2, or G = 1 (one fold unit: bits 8 at one scale row) at
// gs a multiple of 32 and ags 0.
#if !TMAC_K4L_NATIVE
extern "C" int tmac_group_gemm(const void* codes, const float* xs,
                               const float* xsum, int N, int Kp, int gs, int ags,
                               int bits, const void* packed, const void* packed_hi,
                               int Mp, const void* scales, const void* sub, int scale_f32,
                               const void* residual, float* out, void* stream) {
  if (N <= 0 || !tmac::decode::unit_size_ok(gs) || Mp % kLBM != 0 || bits < 1 ||
      (bits > 4 && bits != 8) || (bits == 3) != (packed_hi != nullptr) ||
      Kp % (gs * tmac::decode::fields(bits)) != 0 ||
      (Kp / gs < 2 && (gs % 32 != 0 || ags != 0)) ||
      (ags != 0 && (!tmac::decode::unit_size_ok(ags) || gs % ags != 0 || ags >= gs)) ||
      (scale_f32 != 0) != (TMAC_K4L_F32 != 0))
    return (int)cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* ph = static_cast<const uint8_t*>(packed_hi);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
#if TMAC_K4L_F32
  return launch_group_mma_bits<float>(bits, c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp, scales,
                                      sub, res, out, s);
#else
  return launch_group_mma_bits<__nv_bfloat16>(bits, c, xs, xsum, N, Kp, gs, ags, pk, ph, Mp,
                                              scales, sub, res, out, s);
#endif
}
#else
// K4L's native form (E3): x (N, Kp) bf16, the caller's (its K padding
// zero), xsum (N, G) f32 (its f32 sums a weight group), packed, scales, sub
// and residual as tmac_group_gemm's (scale_f32 0: bf16, 1: f32; this
// library holds both) -> out (N, Mp) f32: per group a bf16 tensor-core
// dot with f32 sums, folded in g order with the group's scale, minus
// xsum @ sub.  The same shapes as tmac_group_gemm's, with no ags; G = 1
// (one fold unit) at gs a multiple of 32.
extern "C" int tmac_group_gemm_native(const void* x, const float* xsum, int N, int Kp, int gs,
                                      int bits, const void* packed, const void* packed_hi,
                                      int Mp, const void* scales, const void* sub,
                                      int scale_f32, const void* residual, float* out,
                                      void* stream) {
  if (N <= 0 || !tmac::decode::unit_size_ok(gs) || Mp % kLBM != 0 || bits < 1 ||
      (bits > 4 && bits != 8) || (bits == 3) != (packed_hi != nullptr) ||
      Kp % (gs * tmac::decode::fields(bits)) != 0 || (Kp / gs < 2 && gs % 32 != 0))
    return (int)cudaErrorInvalidValue;
  const int8_t* xb = static_cast<const int8_t*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* ph = static_cast<const uint8_t*>(packed_hi);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (scale_f32)
    return launch_native_bits<float>(bits, xb, xsum, N, Kp, gs, pk, ph, Mp, scales, sub, res,
                                     out, s);
  return launch_native_bits<__nv_bfloat16>(bits, xb, xsum, N, Kp, gs, pk, ph, Mp, scales, sub,
                                           res, out, s);
}
#endif
