// The decode-time matmul of K1 (qgemm_fused.cu, one f32 scale row: per
// tensor or per column, bits 1 to 4 and 8), K4
// (qgemm_grouped.cu, grouped scales) and K7 (qgemm_expert.cu: K4 on the
// routed experts of a stack, the expert a grid dimension): N < 64 rows of
// int8 activation codes from the prologue against packed low-bit weights,
// for Hopper.
//
// What bounds it: at decode each packed weight byte feeds 8 (bits 1), 4
// (bits 2), 8/3 (bits 3), 2 (bits 4) or 1 (bits 8) multiply-adds a row, far
// below the card's
// operations-per-byte balance, so device-memory bytes bound it; a call
// moves 0.8-25 MB, a few microseconds at 3.35 TB/s, so the call's fixed
// costs (launches, the prologue, barriers) matter as much.  The design:
//
// - One launch after the prologue, with programmatic dependent launch: the
//   prologue lets this kernel start at once (pdl_trigger), and each block
//   first issues the copies of its packed weights (and, for K4, of the
//   group scales and zero points its fold reads) into a ring of kStages
//   stages in shared memory, and only then waits for the prologue's codes
//   (pdl_wait).  So up to kStages - 1 stages of weights a block are in
//   flight while the prologue runs.
// - A block takes a 128-column strip and a range of the packed rows: the
//   grid is (strips * ksplit, row tiles of NT token rows), with clusters of
//   ksplit blocks along the packed rows (K).  The rows are split in units
//   (K4: a chunk of gs packed rows, whose field j holds group
//   j * nchunks + c; K1: 32 rows), block `rank` of a cluster taking units
//   [rank * nunits / ksplit, (rank + 1) * nunits / ksplit).  The host picks
//   ksplit and NT from shapes only (decode_plan), so a CUDA graph can
//   capture the call.
// - The ring: stage t is 32 packed rows of the strip (4 KB), one 16-byte
//   cp.async a thread, its 16-byte chunks XOR-swizzled by row group.
//   Bits 3 (a 2-bit lo plane of Kp / 4 rows and a 1-bit hi plane of Kp / 8
//   rows, code = lo + 4 * hi) takes row r (Kb = Kp / 8 rows) as lo rows r
//   and r + Kb and hi row r, whose 8 codes a column are k = e * Kb + r
//   (slot e: field e / 2 of lo row r + (e % 2) * Kb, bit e of hi row r):
//   a stage is those three planes' 32 rows (12 KB, three copies a
//   thread), so each hi byte is read once, with both lo bytes that share
//   it, and the slots' partials lay out as bits 1's (P = 8).  Warp
//   w takes columns 16w .. 16w+15 of every row, so warps never add into the
//   same sums; lane (rg, cw) rows 4rg .. 4rg+3 of the stage and columns
//   16w + 4cw .. +3: one 32-bit word of each of the 4 rows, turned into
//   per-column words (tmac::transpose4: byte i of word c is column c of row
//   i), then field j masked in place: 4 consecutive k of field j, k = j * Kb
//   + row, which meet one 32-bit word of natural-order codes in a dp4a
//   (unsigned weight bytes, signed codes; the field's factor 2^(bits * j)
//   is shifted out, exactly, when the sum is flushed).  That is 4 shared
//   loads, 6 byte permutes, P masks and P dp4a per 16 bytes and token row.
//   At bits 3 each slot's 3-bit code is assembled in place (b3_slot: the
//   lo field and the hi bit moved next to each other at bit t = min(2 *
//   (e / 2), 4) of the byte by shifts and masks), and its factor 2^t
//   shifted out at the flush.
// - The partials: the 8 row groups of a warp add their sums with shuffles
//   (integers: any order is exact) into the block's int32 partials in
//   shared memory, K1 per (row, column) at the end, K4 per (chunk, field,
//   row, column) after each chunk: no shared-memory atomics (measured on
//   an H100, atomics from the 8 warps into the same sums took up to half
//   of the kernel's time).  Block `rank` finishes a slice of the strip's
//   columns.  After cluster.sync() every block stores its partials into the
//   (then idle) ring of the block that finishes their columns, through
//   distributed shared memory (stores, which nothing waits on), and after a
//   second cluster.sync() each block works from its own shared memory only
//   (a cluster of one skips both: its flush lays its partials out as the
//   fold reads them):
//   K1 adds the ksplit partials of an output in rank order and runs the f32
//   epilogue; K4 folds an output's partials over g = 0 .. G - 1 in order
//   (tmac::GroupFold, the reference's f32 chain; partial g comes from the
//   block that owns chunk g % nchunks).  No partial reaches device memory.
// - The epilogue's operands (K1's scales and zero points before the wait;
//   xs, xsum and the residual after it) are loaded into registers before
//   the main loop, so no load waits at the end.
// - K7 (EXPERTS): block (x, y, j) reads the index of routed expert j before
//   it waits for the prologue (written two kernels back, complete when the
//   prologue, which waited for it, let this grid start), offsets the
//   weights, scales and zero points to that expert (and its codes, xs and
//   xsum to row block j when each expert has its own rows) and writes to
//   output slice j; the ring's depth (STAGES) is K7's plan's, 6 or 8.
//   Grouped (bf16 scales and zero points (E, G, Mp)) it is K4's body;
//   per-tensor (G = 1, f32 (E, 1, Mp)) K1's, the reference's exact int32
//   sum and one epilogue.
// - K4's ags form (AGS): activation scales per group of ags = unit_rows
//   packed rows, finer than the weight groups.  The unit of the split is
//   an activation group, so the partials, their exchange and the f32
//   chain run over the Ga = Kp / ags activation groups (x_a = xs[a] *
//   scale[a / (Ga / G)]), the zero-point chain over the G weight groups;
//   its own template instance, so the ags = 0 instances are unchanged.
// - f32 group factors (SC = float: GGUF's block scales, which bf16 would
//   round): the scales and zero points of the slice are staged as read, 4
//   columns a 16-byte copy instead of 8, so the fold's staging takes twice
//   the bytes (Layout's scale_bytes; decode_plan counts them) and the f32
//   chain reads them unrounded; its own template instance, so the bf16
//   instances are unchanged.
// - 16-row units (GGUF's Q2_K and Q3_K at gs 16, an ags of 16, K7 at gs
//   16): a ring stage of 32 rows holds two units, rows 0-15 in the lanes of
//   row groups 0-3 and rows 16-31 in those of 4-7, so each stage is flushed
//   as two units, each summed over the 4 row groups of its half (flush's
//   `half`); the fold is unchanged (a partial a group, in group order).  At
//   gs 16 the fold, not the codes, bounds the kernel: with f32 factors a
//   group's scale and zero point are 4 bits a weight against 2 bits of
//   code (Q2_K), and an output's chain has Kp / 16 steps.
// - K1's external-int8 form (EXT: int8 x from the caller, the reference's
//   qgemm_pallas with int8 x and one scale row): no activation scale, and
//   the epilogue fma(acc, scale, -(xsum * sub)) (+ residual), as the
//   reference compiles its non-fused int32 route at any N; its own template
//   instance, so the fused instances are unchanged.
// - Grouped bits 8 (GGUF's Q8_0: signed codes, one a byte, P = 1): the
//   bytes are the codes, an s8 x s8 dp4a; the flush's 4 values a token row
//   are added by the lanes of row groups 0-3.
// - Streamed factors: where staging every group's factors would pass a
//   block's shared memory (gs 16 with f32 factors at K 14336: 115 KB of
//   them a block at a cluster of 8), they come in windows of fwin groups
//   through two slots (Layout): windows 0 and 1 with the weights, window w
//   + 2 issued once the fold of window w has left its slot.  Where they
//   fit (every earlier form) there is one window, the same bytes, and the
//   fold is the one-window code.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "act_prologue.cuh"

namespace tmac {
namespace decode {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kStrip = 128;                       // columns of a block
constexpr int kStageRows = 32;                    // packed rows of a stage
constexpr int kStageBytes = kStageRows * kStrip;  // one 16-byte copy a thread
constexpr int kStages = 8;                        // K1's and K4's; K7 takes 6 or 8
constexpr int kMaxSplit = 8;                      // portable cluster size
constexpr int kSliceUnits = kStrip / 8;           // the fold's slices: 8 columns
constexpr int kXStride = 20;  // ints a lane in K4's exchange buffer (4 slots a pass)
constexpr int kXBytes = (kThreads / 32) * 32 * kXStride * 4;

struct Args {
  const int8_t* codes;   // (N, Kp), natural k order
  const float* xs;       // (N,) or (N, G)
  const float* xsum;
  const uint8_t* packed; // (Kb, Mp); at bits 3 the lo plane (2 Kb, Mp)
  const uint8_t* packed_hi;  // bits 3: the hi plane (Kb, Mp); else null
  const void* scales;    // (1, Mp) f32 or (G, Mp) bf16 or f32 (SC)
  const void* sub;
  const __nv_bfloat16* residual;  // (N, Mp) or null
  float* out;            // (N, Mp)
  int N, Kp, Kb, Mp, G, nunits, unit_rows;
  // K7 (EXPERTS): grid.z = the routed experts j, expert idx[j] of a stack
  // of E (packed (E, Kb, Mp), scales and sub (E, G, Mp)); codes, xs and
  // xsum shared by all of them (x_per_expert 0) or a block of N rows each;
  // out (experts, N, Mp)
  const int* idx;
  int E, x_per_expert;
  // K4's ags form: the activation groups (xs (N, Ga)), unit_rows = Kp / Ga
  int Ga;
};

__host__ __device__ inline int align16(int b) { return (b + 15) / 16 * 16; }

// A group size (or activation group size) the grouped kernels take: 16 (a
// half stage, flush's `half`) or a multiple of 32 (whole stages)
__host__ __device__ inline bool unit_size_ok(int gs) { return gs == 16 || (gs > 0 && gs % 32 == 0); }

// Shared memory of a block (the host sizes the launch with the same
// numbers, qgemm_kernel.decode_smem): the ring, which after the main loop
// receives the partials of the block's slice of columns from the cluster
// (K4: group, row, column; K1: rank, row, column), the codes of the block's
// rows, its own int32 partials, and for the grouped fold the slice's scales
// and zero points (bf16, or f32: scale_bytes) and the tile's xs and xsum.
// acts: K4's ags form's activation groups (a partial and an xs each), or
// 0 (one a weight group).
// A block's shared memory on Hopper
constexpr int kSmemLimit = 227 * 1024;

// fwin: the groups of a factor window (G: every group's factors staged at
// once; fewer where that would pass kSmemLimit: windows through two slots
// of fslot bytes, [scale, zero point][group of the window][slice]).
struct Layout {
  int span, units, slice, codes, parts, fsc, fwin, fslot, fxs, xbuf, total;
  __host__ __device__ Layout(int P, int NT, bool grouped, int nunits,
                             int unit_rows, int ksplit, int G, int stages = kStages,
                             int planes = 1, int acts = 0, int scale_bytes = 2) {
    const int ring = stages * kStageBytes * planes;
    const int Gx = acts ? acts : G;
    units = (nunits + ksplit - 1) / ksplit;
    span = (units * unit_rows + kStageRows - 1) / kStageRows * kStageRows;
    slice = (kSliceUnits + ksplit - 1) / ksplit * 8;
    const int recv = (grouped ? Gx : ksplit) * NT * slice * 4;
    codes = align16(recv > ring ? recv : ring);
    parts = codes + align16(NT * P * span);
    fsc = parts + (grouped ? units * P : 1) * NT * kStrip * 4;
    const int per_group = 2 * slice * scale_bytes;  // a multiple of 16
    const int rest = grouped ? align16(NT * (Gx + G) * 4) + kXBytes : 0;
    fwin = G;
    fslot = grouped ? G * per_group : 0;
    int slots = 1;
    if (grouped && fsc + fslot + rest > kSmemLimit) {
      const int per_slot = (kSmemLimit - fsc - rest) / 2 / per_group;
      if (per_slot >= 1) {
        const int nwin = (G + per_slot - 1) / per_slot;
        fwin = (G + nwin - 1) / nwin;
        fslot = fwin * per_group;
        slots = 2;
      }
    }
    fxs = fsc + slots * fslot;
    xbuf = align16(fxs + (grouped ? NT * (Gx + G) * 4 : 0));
    total = xbuf + (grouped ? kXBytes : 0);
  }
};

// The block of a cluster of ksplit whose slice of the strip's columns
// holds column m, and where that slice starts
__device__ __forceinline__ int slice_owner(int m, int ksplit) {
  return ((m / 8 + 1) * ksplit - 1) / kSliceUnits;
}
__device__ __forceinline__ int slice_start(int rank, int ksplit) {
  return rank * kSliceUnits / ksplit * 8;
}

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

// The slots of a row (qgemm_kernel.decode_fields): its fields, and 8 at
// bits 3 (two lo rows and a hi row); the planes a stage holds; and the
// factor of slot j's in-place weights, 2^field_shift, shifted out at the
// flush
__host__ __device__ constexpr int fields(int bits) {
  return bits == 8 ? 1 : bits == 3 ? 8 : 8 / bits;
}
__host__ __device__ constexpr int planes(int bits) { return bits == 3 ? 3 : 1; }
template <int BITS>
__device__ __forceinline__ constexpr int field_shift(int j) {
  return BITS == 8 ? 0 : BITS == 3 ? (j >> 1 < 2 ? 2 * (j >> 1) : 4) : BITS * j;
}

// Bits 3, slot e of 4 columns' bytes: the code lo + 4 * hi of k = e * Kb + r
// at bit t = min(2 * (e / 2), 4) of each byte (at most 7 << 4, an unsigned
// byte): field e / 2 of lo (lo row r for even e, r + Kb for odd e) shifted
// right by 2 * (e / 2) - t, and bit e of hi moved to bit t + 2; the shifts
// that cross a byte only move bits the masks drop (qgemm_kernel.
// decode_slot_weights is its plain model)
__device__ __forceinline__ uint32_t b3_slot(int e, uint32_t lo1, uint32_t lo2, uint32_t hi) {
  const int j = e >> 1, t = j < 2 ? 2 * j : 4, hs = t + 2 - e;
  const uint32_t lo = (e & 1) ? lo2 : lo1;
  const uint32_t h = hs >= 0 ? hi << hs : hi >> -hs;
  return ((lo >> (2 * j - t)) & (0x03030303u << t)) | (h & (0x04040404u << t));
}

// The thread's sums into partial block `blk` of part_s (K4: chunk, field,
// row, column, or, for a cluster of one (nchunks > 0), group j * nchunks +
// blk, row, column: the layout the fold reads; K1: row, column), then
// cleared.  The 8 row groups of a warp
// hold sums of the same columns: K4 adds them through a per-warp exchange
// buffer in shared memory (a third of the instructions of a shuffle
// reduce-scatter, measured twice as fast on an H100); K1, which flushes
// once, adds its fields first, then all-reduces its NT * 4 sums with
// shuffles and lets row group 0 store them.  Integer sums: any order is
// exact.  (A function, not a lambda: acc must stay in registers.)
// HALF (16-row units): the lanes of row groups 0-3 hold unit blk's sums,
// those of 4-7 unit blk + 1's, stored if it is one of the block's nblk; a
// template parameter, chosen at the call, so that whole units' flush is
// the code it was (a run-time branch here cost K4 8-18% a call at gs 32 to
// 128 on an H100).
template <int BITS, int NT, int P, bool GROUPED, bool HALF = false>
__device__ __forceinline__ void flush(int (&acc)[NT][P][4], int* part_s, int* xbuf, int blk,
                                      int nchunks, int rg, int cw, int lane, int col0,
                                      int nrows, int nblk = 0) {
  if (GROUPED) {
    // per token row n and pass of PH slots: each lane's PH * 4 sums into
    // the warp's exchange buffer (kXStride ints a lane: conflict-free
    // 16-byte stores), then lane (rg, cw) adds values e = rg * PH/2 ..
    // +PH/2 (e = j * 4 + c) over the 8 lanes of column word cw and stores
    // them (bits 8: E = 4 values, row groups 0-3 a value each); with half,
    // lane (rg, cw) adds values e = (rg % 4) * PH .. +PH of unit blk + rg / 4
    // over the 4 lanes of its half
    constexpr int PH = P > 4 ? 4 : P;
    constexpr int E = PH * 4, H = E >= 8 ? E / 8 : 1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nrows) break;
#pragma unroll
      for (int pass = 0; pass < P / PH; ++pass) {
#pragma unroll
        for (int q = 0; q < E / 4; ++q)
          *reinterpret_cast<int4*>(xbuf + lane * kXStride + 4 * q) =
              make_int4(acc[n][pass * PH + q][0], acc[n][pass * PH + q][1],
                        acc[n][pass * PH + q][2], acc[n][pass * PH + q][3]);
        __syncwarp();
        if constexpr (HALF) {
          const int u = rg >> 2, q = rg & 3;
          int sum[PH];
#pragma unroll
          for (int i = 0; i < PH; ++i) sum[i] = 0;
#pragma unroll
          for (int src = 0; src < 4; ++src)
#pragma unroll
            for (int i = 0; i < PH; ++i)
              sum[i] += xbuf[((4 * u + src) * 4 + cw) * kXStride + q * PH + i];
          if (blk + u < nblk) {
#pragma unroll
            for (int i = 0; i < PH; ++i) {
              const int e = q * PH + i, j = pass * PH + e / 4, c = e % 4;
              const int slot = nchunks ? j * nchunks + blk + u : (blk + u) * P + j;
              part_s[(slot * NT + n) * kStrip + col0 + c] = sum[i] >> field_shift<BITS>(j);
            }
          }
        } else if (E >= 8 || rg * H < E) {
          int sum[H];
#pragma unroll
          for (int i = 0; i < H; ++i) sum[i] = 0;
#pragma unroll
          for (int src = 0; src < 8; ++src)
#pragma unroll
            for (int i = 0; i < H; ++i) sum[i] += xbuf[(src * 4 + cw) * kXStride + rg * H + i];
#pragma unroll
          for (int i = 0; i < H; ++i) {
            const int e = rg * H + i, j = pass * PH + e / 4, c = e % 4;
            const int slot = nchunks ? j * nchunks + blk : blk * P + j;
            part_s[(slot * NT + n) * kStrip + col0 + c] = sum[i] >> field_shift<BITS>(j);
          }
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int s = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) s += acc[n][j][c] >> field_shift<BITS>(j);
#pragma unroll
        for (int o = 16; o >= 4; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (rg == 0 && n < nrows) part_s[n * kStrip + col0 + c] = s;
      }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][j][c] = 0;
}

// a group factor as the f32 chain reads it
__device__ __forceinline__ float factor(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float factor(float v) { return v; }

// The kernel body.  BITS 1, 2 or 4 (fields of unsigned codes), 3 (a lo and
// a hi plane) or 8 (signed codes, one a byte); NT token rows a block; GROUPED: K4 (per-group
// partials and the fold) or K1 (one int32 sum and its epilogue); EXPERTS:
// K7, K4 or K1 on the routed experts of a stack, one grid.z slice each;
// STAGES: the ring's stages; AGS (with GROUPED): K4's ags form, a partial
// and a step of the fold per activation group; SC (with GROUPED): the
// group scales' and zero points' type, __nv_bfloat16 or float; EXT (K1):
// the external-int8 epilogue, no activation scale.
template <int BITS, int NT, bool GROUPED, bool EXPERTS = false, int STAGES = kStages,
          bool AGS = false, typename SC = __nv_bfloat16, bool EXT = false>
__device__ __forceinline__ void decode_matmul(const Args& args) {
  constexpr int P = fields(BITS);
  constexpr int kStageAll = kStageBytes * planes(BITS);  // a stage's bytes
  constexpr uint32_t kField = BITS == 1 ? 0x01010101u : BITS == 2 ? 0x03030303u : 0x0F0F0F0Fu;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ksplit = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // warp w: columns 16w .. 16w+15 of the strip (16-byte chunk w of every
  // row); lane: row group rg (rows 4rg .. 4rg+3 of a stage) and column
  // word cw (columns 16w + 4cw .. +3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 2, cw = lane & 3;
  const int col0 = 16 * warp + 4 * cw;
  const int m0 = (blockIdx.x / ksplit) * kStrip;
  const int n0 = blockIdx.y * NT;
  const int nrows = min(NT, args.N - n0);
  const int u0 = rank * args.nunits / ksplit, u1 = (rank + 1) * args.nunits / ksplit;
  const int r0 = u0 * args.unit_rows, r1 = min(u1 * args.unit_rows, args.Kb);
  const int nst = (r1 - r0 + kStageRows - 1) / kStageRows;
  const Layout L(P, NT, GROUPED, args.nunits, args.unit_rows, ksplit, args.G, STAGES,
                 planes(BITS), AGS ? args.Ga : 0, (int)sizeof(SC));
  const int s0 = slice_start(rank, ksplit), s1 = slice_start(rank + 1, ksplit);
  const int w = s1 - s0, nout = NT * w;  // the outputs this block finishes
  Args routed = args;  // K7: the routed expert's operands
  if (EXPERTS) {
    // The routed expert, read before pdl_wait: the index was written two
    // kernels back (the router's cast), and the prologue between waited
    // for that kernel's completion before it let this grid start.  Every
    // block of a cluster reads the same index, so a cluster leaves whole.
    const int j = blockIdx.z;
    const int e = __ldcg(args.idx + j);
    Args& r = routed;
    r.out += (size_t)j * r.N * r.Mp;
    if (e < 0 || e >= r.E) {  // no expert to read: the outputs say so
      pdl_wait();
      for (int o = tid; o < nout; o += kThreads)
        if (o / w < nrows)
          r.out[(size_t)(n0 + o / w) * r.Mp + m0 + s0 + o % w] = __int_as_float(0x7fc00000);
      return;
    }
    r.packed += (size_t)e * r.Kb * r.Mp;
    if (GROUPED) {
      r.scales = static_cast<const SC*>(r.scales) + (size_t)e * r.G * r.Mp;
      r.sub = static_cast<const SC*>(r.sub) + (size_t)e * r.G * r.Mp;
    } else {  // per-tensor: f32 (1, Mp) an expert
      r.scales = static_cast<const float*>(r.scales) + (size_t)e * r.Mp;
      r.sub = static_cast<const float*>(r.sub) + (size_t)e * r.Mp;
    }
    if (r.x_per_expert) {
      r.codes += (size_t)j * r.N * r.Kp;
      r.xs += (size_t)j * r.N * r.G;
      r.xsum += (size_t)j * r.N * r.G;
    }
  }
  const Args& a = EXPERTS ? routed : args;
  int8_t* codes_s = reinterpret_cast<int8_t*>(smem + L.codes);
  int* part_s = reinterpret_cast<int*>(smem + L.parts);
  int* xbuf = reinterpret_cast<int*>(smem + L.xbuf) + warp * 32 * kXStride;

  auto load_stage = [&](int t, int slot) {
    const int r = r0 + t * kStageRows + (tid >> 3), q = tid & 7;
    const bool ok = r < r1;
    // 16-byte chunk q of stage row i at chunk q ^ ((i / 4) % 8): the 8 row
    // groups a warp reads at once fall on distinct banks
    const int i = tid >> 3;
    const size_t src = (size_t)(ok ? r : r0) * a.Mp + m0 + q * 16;
    uint8_t* dst = smem + slot * kStageAll + i * kStrip + ((q ^ (i >> 2)) & 7) * 16;
    cp_async16(dst, a.packed + src, ok);
    if (BITS == 3) {  // lo row r + Kb, then hi row r
      cp_async16(dst + kStageBytes, a.packed + src + (size_t)a.Kb * a.Mp, ok);
      cp_async16(dst + 2 * kStageBytes, a.packed_hi + src, ok);
    }
  };

  // the factors of window wi (fwin groups from wi * fwin) of the slice's
  // columns into slot wi % 2 (a single window: every group, slot 0)
  auto load_factors = [&](int wi) {
    constexpr int kPer = 16 / (int)sizeof(SC);  // factors a 16-byte copy
    const int su = w / kPer, g0 = wi * L.fwin, ng = min(L.fwin, a.G - g0);
    SC* dst = reinterpret_cast<SC*>(smem + L.fsc + (wi & 1) * L.fslot);
    const SC* sc = static_cast<const SC*>(a.scales);
    const SC* sb = static_cast<const SC*>(a.sub);
    for (int i = tid; i < 2 * ng * su; i += kThreads) {
      const int which = i / (ng * su), g = (i / su) % ng, u = i % su;
      cp_async16(dst + ((size_t)which * L.fwin + g) * L.slice + kPer * u,
                 (which ? sb : sc) + (size_t)(g0 + g) * a.Mp + m0 + s0 + kPer * u, true);
    }
  };
  const int nwin = GROUPED ? (a.G + L.fwin - 1) / L.fwin : 0;

  // before the prologue's results exist: the weights (and the fold's
  // scales and zero points, with stage 0: windows 0 and 1) and the
  // epilogue's weights
  if (GROUPED) {
    load_factors(0);
    if (nwin > 1) load_factors(1);
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  // the thread's outputs o = tid + h * kThreads < nout: row o / w, column
  // s0 + o % w of the strip; their epilogue operands, loaded ahead
  float e_sc[2] = {0.f, 0.f}, e_sb[2] = {0.f, 0.f}, e_xs[2] = {0.f, 0.f},
        e_xq[2] = {0.f, 0.f}, e_res[2] = {0.f, 0.f};
  if (!GROUPED) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tid + h * kThreads;
      if (o < nout) {
        e_sc[h] = __ldg(static_cast<const float*>(a.scales) + m0 + s0 + o % w);
        e_sb[h] = __ldg(static_cast<const float*>(a.sub) + m0 + s0 + o % w);
      }
    }
  }

  pdl_wait();  // the prologue's codes, xs and xsum are complete

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = tid + h * kThreads, n = o / w;
    if (o < nout && n < nrows) {
      const size_t row = (size_t)(n0 + n);
      if (!GROUPED) {
        if (!EXT) e_xs[h] = __ldcg(a.xs + row);
        e_xq[h] = __ldcg(a.xsum + row);
      }
      if (a.residual != nullptr)
        e_res[h] = __bfloat162float(__ldcg(a.residual + row * a.Mp + m0 + s0 + o % w));
    }
  }
  // the codes of the block's rows, k = j * Kb + r for r in [r0, r0 + span):
  // codes_s[(n * P + j) * span + r - r0], zero past r1 and past N
  const int words = L.span / 4;
#pragma unroll 4
  for (int i = tid; i < NT * P * words; i += kThreads) {
    const int nj = i / words, n = nj / P, j = nj % P, r = r0 + 4 * (i % words);
    int v = 0;
    if (n < nrows && r < r1)
      v = __ldcg(reinterpret_cast<const int*>(a.codes + (size_t)(n0 + n) * a.Kp +
                                              (size_t)j * a.Kb + r));
    reinterpret_cast<int*>(codes_s)[i] = v;
  }
  float* fxs = reinterpret_cast<float*>(smem + L.fxs);
  if constexpr (AGS) {
    // xs of the Ga activation groups, then xsum of the G weight groups
    for (int i = tid; i < NT * a.Ga; i += kThreads) {
      const int n = i / a.Ga;
      fxs[i] = n < nrows ? __ldcg(a.xs + (size_t)(n0 + n) * a.Ga + i % a.Ga) : 0.f;
    }
    for (int i = tid; i < NT * a.G; i += kThreads) {
      const int n = i / a.G;
      fxs[NT * a.Ga + i] = n < nrows ? __ldcg(a.xsum + (size_t)(n0 + n) * a.G + i % a.G)
                                     : 0.f;
    }
  } else if (GROUPED) {
    for (int i = tid; i < NT * a.G; i += kThreads) {
      const int n = i / a.G, g = i % a.G;
      const bool ok = n < nrows;
      fxs[i] = ok ? __ldcg(a.xs + (size_t)(n0 + n) * a.G + g) : 0.f;
      fxs[NT * a.G + i] = ok ? __ldcg(a.xsum + (size_t)(n0 + n) * a.G + g) : 0.f;
    }
  }

  int acc[NT][P][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][j][c] = 0;

  // K4: the stages of one chunk, then its flush; K1: every stage, then one
  // flush.  No flush inside the stage loop: with it there, ptxas wanted
  // ~180 registers at 4 token rows and spilled at the cap of 128 (measured
  // on an H100: K4 at N = 4 up to 1.2x slower)
  // stages a flush (units of 32 rows or more), or units a stage (2 at 16 rows)
  const int spu = GROUPED ? max(a.unit_rows / kStageRows, 1) : max(nst, 1);
  const int upf = GROUPED && a.unit_rows < kStageRows ? 2 : 1;
#pragma unroll 1
  for (int t0 = 0; t0 < nst; t0 += spu) {
#pragma unroll 1
    for (int t = t0; t < min(t0 + spu, nst); ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (t + STAGES - 1 < nst) load_stage(t + STAGES - 1, (t + STAGES - 1) % STAGES);
      cp_async_commit();
      const uint8_t* st = smem + (t % STAGES) * kStageAll + 4 * rg * kStrip +
                          ((warp ^ rg) & 7) * 16 + 4 * cw;
      uint32_t col[4];
      transpose4(*reinterpret_cast<const uint32_t*>(st),
                 *reinterpret_cast<const uint32_t*>(st + kStrip),
                 *reinterpret_cast<const uint32_t*>(st + 2 * kStrip),
                 *reinterpret_cast<const uint32_t*>(st + 3 * kStrip), col);
      const int rl = t * kStageRows + 4 * rg;
      if constexpr (BITS == 3) {
        uint32_t col2[4], colh[4];
        const uint8_t* s2 = st + kStageBytes;
        const uint8_t* sh = st + 2 * kStageBytes;
        transpose4(*reinterpret_cast<const uint32_t*>(s2),
                   *reinterpret_cast<const uint32_t*>(s2 + kStrip),
                   *reinterpret_cast<const uint32_t*>(s2 + 2 * kStrip),
                   *reinterpret_cast<const uint32_t*>(s2 + 3 * kStrip), col2);
        transpose4(*reinterpret_cast<const uint32_t*>(sh),
                   *reinterpret_cast<const uint32_t*>(sh + kStrip),
                   *reinterpret_cast<const uint32_t*>(sh + 2 * kStrip),
                   *reinterpret_cast<const uint32_t*>(sh + 3 * kStrip), colh);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          uint32_t w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = b3_slot(e, col[c], col2[c], colh[c]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int xv = *reinterpret_cast<const int*>(codes_s + (n * P + e) * L.span + rl);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[n][e][c] = dp4a_us(w[c], xv, acc[n][e][c]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int xv = *reinterpret_cast<const int*>(codes_s + (n * P + j) * L.span + rl);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (BITS == 8)
                acc[n][j][c] = __dp4a((int)col[c], xv, acc[n][j][c]);
              else
                acc[n][j][c] = dp4a_us(col[c] & (kField << (BITS * j)), xv, acc[n][j][c]);
            }
          }
        }
      }
    }
    if (GROUPED && upf == 2)
      flush<BITS, NT, P, true, true>(acc, part_s, xbuf, 2 * t0, ksplit == 1 ? a.nunits : 0,
                                     rg, cw, lane, col0, nrows, u1 - u0);
    else if (GROUPED)
      flush<BITS, NT, P, true>(acc, part_s, xbuf, t0 / spu, ksplit == 1 ? a.nunits : 0, rg,
                               cw, lane, col0, nrows);
  }
  if (!GROUPED) flush<BITS, NT, P, false>(acc, part_s, xbuf, 0, 0, rg, cw, lane, col0, nrows);
  cp_async_wait<0>();
  __syncthreads();
  // partial (group g, or rank g for K1; row n; column mm of the slice) at
  // part0[(g * NT + n) * width + mm]: a cluster of one folds from its own
  // partials, which its flush laid out so
  const int* part0 = part_s;
  int width = kStrip;
  if (ksplit > 1) {
    cluster.sync();  // every block's partials are complete and its ring idle

    // each block's partials into the receive area (the ring) of the block
    // that finishes their columns: plain stores, into distributed shared
    // memory for another block's, which nothing waits on until the
    // barrier below
    int* recv = reinterpret_cast<int*>(smem);
    if (GROUPED) {
      const int nchunks = a.nunits;
      for (int i = tid; i < (u1 - u0) * P * NT * kStrip; i += kThreads) {
        const int m = i % kStrip, n = (i / kStrip) % NT, lj = i / (kStrip * NT);
        if (n >= nrows) continue;
        const int g = (lj % P) * nchunks + u0 + lj / P;
        const int o = slice_owner(m, ksplit);
        int* dst = o == rank ? recv : cluster.map_shared_rank(recv, o);
        dst[(g * NT + n) * L.slice + m - slice_start(o, ksplit)] = part_s[i];
      }
    } else {
      for (int i = tid; i < NT * kStrip; i += kThreads) {
        const int m = i % kStrip, n = i / kStrip;
        if (n >= nrows) continue;
        const int o = slice_owner(m, ksplit);
        int* dst = o == rank ? recv : cluster.map_shared_rank(recv, o);
        dst[(rank * NT + n) * L.slice + m - slice_start(o, ksplit)] = part_s[i];
      }
    }
    cluster.sync();  // every partial has landed; nothing crosses blocks after
    part0 = recv;
    width = L.slice;
  }
  pdl_trigger();  // a programmatically launched successor may start

  if (!GROUPED) {
    // K1: the ksplit partials of each output in rank order, then the f32
    // epilogue as the reference compiles it for N < 64:
    // fma(acc * scale, xs, -(xsum * sub)) (+ residual)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tid + h * kThreads, n = o / w, mm = o % w;
      if (o >= nout || n >= nrows) continue;
      int s = 0;
      for (int b = 0; b < ksplit; ++b) s += part0[(b * NT + n) * width + mm];
      const float zero_fold = -__fmul_rn(e_xq[h], e_sb[h]);
      float v = EXT ? __fmaf_rn((float)s, e_sc[h], zero_fold)
                    : __fmaf_rn(__fmul_rn((float)s, e_sc[h]), e_xs[h], zero_fold);
      if (a.residual != nullptr) v = __fadd_rn(v, e_res[h]);
      a.out[(size_t)(n0 + n) * a.Mp + m0 + s0 + mm] = v;
    }
  } else if (nwin == 1 && AGS) {
    // K4's ags form: the chain over the activation groups in order, each
    // partial's factor its own xs times its weight group's scale, and the
    // zero-point chain over the weight groups
    const SC* fsc = reinterpret_cast<const SC*>(smem + L.fsc);
    const SC* fsb = fsc + (size_t)a.G * L.slice;
    const int per = a.Ga / a.G;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tid + h * kThreads, n = o / w, mm = o % w;
      if (o >= nout || n >= nrows) continue;
      GroupFold fold;
#pragma unroll 4
      for (int c = 0; c < a.Ga; ++c)
        fold.term(c, (float)part0[(c * NT + n) * width + mm], fxs[n * a.Ga + c],
                  factor(fsc[(c / per) * L.slice + mm]));
#pragma unroll 4
      for (int g = 0; g < a.G; ++g)
        fold.zero(fxs[NT * a.Ga + n * a.G + g], factor(fsb[g * L.slice + mm]));
      float v = fold.result();
      if (a.residual != nullptr) v = __fadd_rn(v, e_res[h]);
      a.out[(size_t)(n0 + n) * a.Mp + m0 + s0 + mm] = v;
    }
  } else if (nwin == 1) {
    // K4: the fold of each output over the groups in order (the
    // reference's f32 chain), from the partials
    const SC* fsc = reinterpret_cast<const SC*>(smem + L.fsc);
    const SC* fsb = fsc + (size_t)a.G * L.slice;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tid + h * kThreads, n = o / w, mm = o % w;
      if (o >= nout || n >= nrows) continue;
      GroupFold fold;
#pragma unroll 4
      for (int g = 0; g < a.G; ++g)
        fold.step(g, (float)part0[(g * NT + n) * width + mm], fxs[n * a.G + g],
                  factor(fsc[g * L.slice + mm]), fxs[(NT + n) * a.G + g],
                  factor(fsb[g * L.slice + mm]));
      float v = fold.result();
      if (a.residual != nullptr) v = __fadd_rn(v, e_res[h]);
      a.out[(size_t)(n0 + n) * a.Mp + m0 + s0 + mm] = v;
    }
  } else {
    // the same two folds with the factors streamed: a window of groups'
    // factors at a time, window wi + 2 issued once every thread has left
    // window wi's slot.  (Kept apart from the one-window folds above: one
    // loop for both took the earlier forms' K4 and K7 8-19% longer a call
    // on an H100, gs 32 f32 the most.)
    const int per = AGS ? a.Ga / a.G : 1;
    GroupFold fold[2];
    for (int wi = 0; wi < nwin; ++wi) {
      if (wi >= 2) {
        cp_async_wait<1>();
        __syncthreads();
      }
      const SC* wsc = reinterpret_cast<const SC*>(smem + L.fsc + (wi & 1) * L.fslot);
      const SC* wsb = wsc + (size_t)L.fwin * L.slice;
      const int g0 = wi * L.fwin, g1 = min(a.G, g0 + L.fwin);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + h * kThreads, n = o / w, mm = o % w;
        if (o >= nout || n >= nrows) continue;
        if constexpr (AGS) {
#pragma unroll 4
          for (int c = g0 * per; c < g1 * per; ++c)
            fold[h].term(c, (float)part0[(c * NT + n) * width + mm], fxs[n * a.Ga + c],
                         factor(wsc[(c / per - g0) * L.slice + mm]));
#pragma unroll 4
          for (int g = g0; g < g1; ++g)
            fold[h].zero(fxs[NT * a.Ga + n * a.G + g], factor(wsb[(g - g0) * L.slice + mm]));
        } else {
#pragma unroll 4
          for (int g = g0; g < g1; ++g)
            fold[h].step(g, (float)part0[(g * NT + n) * width + mm], fxs[n * a.G + g],
                         factor(wsc[(g - g0) * L.slice + mm]), fxs[(NT + n) * a.G + g],
                         factor(wsb[(g - g0) * L.slice + mm]));
        }
      }
      if (nwin > 2) {
        __syncthreads();
        if (wi + 2 < nwin) load_factors(wi + 2);
        cp_async_commit();
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = tid + h * kThreads, n = o / w, mm = o % w;
      if (o >= nout || n >= nrows) continue;
      float v = fold[h].result();
      if (a.residual != nullptr) v = __fadd_rn(v, e_res[h]);
      a.out[(size_t)(n0 + n) * a.Mp + m0 + s0 + mm] = v;
    }
  }
}

// Launch a prologue kernel with programmatic stream serialization: its
// blocks may start while the kernel before it finishes, and must call
// pdl_wait() before they read anything that kernel (or one before it)
// wrote, and write nothing before.  Nothing falls back.
template <typename... Params, typename... Args_>
int launch_programmatic(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
                        cudaStream_t stream, Args_&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args_>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch `kernel` (one of the decode_matmul instances) on a grid of
// (Mp / 128) * ksplit x cdiv(N, NT) x experts blocks in clusters of ksplit
// along x,
// with programmatic stream serialization (it starts while the prologue
// before it runs).  A cluster the card cannot place is refused with
// cudaErrorInvalidConfiguration; nothing falls back.
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int ksplit, int NT, int smem,
           cudaStream_t stream, int experts = 1) {
  // (kernel, ksplit, shared memory) triples already admitted
  static const void* admitted[64];
  static int admitted_key[64], n_admitted = 0;
  const int key = ksplit * 1000000 + smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Mp / kStrip) * ksplit, (a.N + NT - 1) / NT, experts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bool known = false;
  for (int i = 0; i < n_admitted; ++i)
    known |= admitted[i] == (const void*)kernel && admitted_key[i] == key;
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (n_admitted < 64) {
      admitted[n_admitted] = (const void*)kernel;
      admitted_key[n_admitted++] = key;
    }
  }
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace tmac
