// K3 and K5: the large-N matmuls of a prefill, for Hopper.
//
// Both replace tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel in the two
// forms that qgemm_pallas(act="fused") takes from N >= 64 rows of x: one
// dot over the whole unpacked depth instead of per-field or per-group dots.
//
// K3 (one scale row, G == 1: BitNet's per-tensor scale, w_fp's per-column
// scales and zero points at group_size -1, the int8 head; bits 1 to 4 or 8;
// the reference runs its single_dot form at bits 1, 2, 4 and 8 and its
// chunk loop with int32 sums at bits 3, both after an XLA prologue, and
// both the same function) takes the int8 codes, row scales xs and bare
// code sums q of K1's prologue (qgemm_fused.cu, large_n) and computes
//   acc = codes (N, Kp) @ weight codes (Kp, Mp), an exact int32 dot
//   out = fma(acc, scale, -q * sub) * xs, or
//         fma(fma(acc, scale, -q * sub), xs, residual)
// which is the f32 epilogue XLA compiles the reference's to.  Integer sums
// are exact in any order, so K3 equals its plain version bit for bit.
//
// K5 (dequant_dot=True: grouped scales, bits 1 to 4; the reference takes
// it when N >= 3 * group_size, or with dispatch "dequant") computes
//   xa = bf16(prologue values): SwiGLU or rms_norm as K4's prologue, with
//        no quantization (one small kernel, one block per row, writes xa)
//   W  = bf16(code * scale[g] - sub[g])      (code * scale is exact)
//   out = xa @ W summed in f32, plus the f32 residual.
// xa and W are exact functions of the inputs; the order of the f32 sum is
// the tensor cores', so K5 and its plain version (an f32 matmul of the same
// bf16 operands) agree to f32 rounding, not bit for bit.
//
// What bounds them: at 256 to 512 rows each packed weight byte feeds
// 256 * 4 (K3, bits 2) or 512 * 4 (K5, bits 2) multiply-adds, far above the
// card's balance of about 590 int8 or 295 bf16 operations per byte of
// device memory, so the tensor cores bound both.
//
// K3 is built around wgmma s8 (k3_wgmma_kernel), the only way to the card's
// full int8 rate:
//   - a block computes bm token rows x bn columns (large_plan's tile: 64,
//     128 or 256 rows x 128 columns, or at bits 2 64 or 128 x 256: the
//     wide tiles were fitted to bits 2 alone, and each instance adds to the
//     build): CWG
//     warpgroups of MT m64 tiles run wgmma.m64n{bn}k32 s8 x s8 -> s32 with
//     both operands in shared memory;
//   - a step is 128 k' (the order of the prologue's codes, below): the
//     codes' bm x 128 tile comes in by TMA (K-major, 128-byte swizzle; rows
//     past N as zeros), the step's packed weights (128 / F packed rows of
//     each plane, below; bits 8: 128 rows; MN-major) by TMA into a packed
//     ring of R stages, and
//     the warps unpack them into the B tile, bn columns of 128 k' bytes,
//     K-major with the 128-byte swizzle (wgmma has no transpose for 8-bit
//     types): column m's 16-byte chunk c at byte m * 128 + ((c ^ (m % 8))
//     << 4).  Each packed byte is unpacked once per bm token rows (once per
//     call at N <= bm);
//   - field j of packed row r holds k = r + j * Kp / p (p fields a byte),
//     and the prologue writes the codes in the order k' = F r + j holding
//     k = r + j * Kp / F (dp4a_order), F the slots of a row: 2 at bits 4,
//     4 at bits 2, 8 at bits 1 and 3, so the F fields of a byte are F
//     consecutive k' of its column.  Bits 3 (a 2-bit lo plane, k = r + j *
//     Kp / 4 in field j, and a 1-bit hi plane, k = r + j * Kp / 8, code lo
//     + 4 hi) takes row r (Kh = Kp / 8) as lo rows r and r + Kh and hi row
//     r, the slots of k = r + e Kh: slot e is field e / 2 of lo row r + (e
//     % 2) Kh and bit e of hi row r.  No one order of the codes lines up a
//     byte of each plane with consecutive k' otherwise (their field strides
//     differ), so a step takes 16 lo rows from each of the two halves of
//     the lo plane and 16 hi rows: three TMA boxes into one packed stage.
//     A thread takes 4 columns and the packed rows of 16 k' (4 words at
//     bits 2), byte-transposes them into one word a column
//     (tmac::transpose4), and each column's word into its 16 k' bytes
//     (masks, shifts, byte permutes and transposes): one 16-byte store a
//     column.  At bits 8 (the int8 head, k' = k) 16 rows of 4 columns take
//     four 4 x 4 byte transposes.  Each thread's columns are rotated by its
//     lane (a byte permute of its input words), so the 8 lanes of a
//     quarter-warp store to 8 distinct 16-byte bank groups;
//   - every warp multiplies and unpacks: after issuing step t's wgmma it
//     unpacks step t + D's B tile (D = 2, or 1 with 3 stages) while that
//     wgmma runs.  Two loader threads (a warp each) issue the TMAs: the
//     packed ring, which does not depend on the prologue, and the codes.
//     The steps go round S stages (A and B) with mbarriers: `full` (the
//     codes' bytes and one arrival a warp for the B tile), `empty` (one
//     arrival a warp once the wgmma that read the stage is done), and for
//     the packed ring `raw_full` (TMA) and `raw_empty`.  No __syncthreads
//     in the main loop;
//   - it is launched programmatically after the prologue (act_quant_kernel
//     lets it start at once): the packed ring fills and the first B tiles
//     are unpacked before griddepcontrol.wait, the codes' TMAs follow it;
//   - the blocks of a wave start their steps at different depths (column
//     tile mod steps), so the codes they read from L2 at once are not the
//     same lines;
//   - K is split over a cluster of ksplit (1-8) blocks, block `rank` taking
//     steps [rank * nsteps / ksplit, (rank + 1) * nsteps / ksplit), to fill
//     132 SMs when Mp / 128 column tiles are too few (BitNet's wo and down
//     at Mp = 3200: 25 tiles).  Each block pushes its int32 partials into
//     the (then idle) ring of the block that finishes their rows, through
//     distributed shared memory, and after a cluster barrier every block
//     adds its slice's ksplit partials and runs the epilogue.  The sums are
//     of integers, exact in any order and any split, so K3 stays equal to
//     its plain version bit for bit whatever the tile, split and step order;
//   - the epilogue's scales and zero points are staged in shared memory at
//     the start; unsplit, the tile goes out through the idle ring as whole
//     rows with 16-byte stores.
//   large_plan (qgemm_kernel.py) picks the tile and ksplit from shapes
//   alone, from a cost model fitted to every configuration's time.
//   What bounds it: the wgmma alone runs at the card's int8 rate (a step of
//   256 x 128 x 128 in ~0.52 us at 1.98 GHz), but a step moves ~150 KB
//   through shared memory (A once, B once per m64 tile, the TMA and unpack
//   writes), ~0.6 us of its bandwidth, and the whole step takes longer.
// Tried on the card and not kept: one producer warpgroup unpacking for two
// consumers (four warps could not unpack a step in the tensor cores' time);
// the loader thread inside a consumer warpgroup (its TMA waits lengthened
// that warpgroup's step); an epilogue stored from the fragments (2 columns
// of 8 rows a store: slower than the main loop's last steps); the weights
// as wgmma's A operand unpacked into registers (faster at 128 rows, but a
// block with a loader warp is held to 168 registers and spills at 256).

// K5 is built around wgmma, the only way to the card's full bf16 rate
// (dequant_wgmma_kernel):
//   - a block computes 256 token rows x 128 columns: each weight tile is
//     dequantized once per 256 rows of x.  Its 2 warpgroups take 128 rows
//     each as two wgmma.m64n128k16 a k16 step (128 f32 accumulators a
//     thread);
//   - a step is 64 k of one field: k = j * Kb + r0 .. +64 of packed rows
//     r0 .. r0 + 63 (Kb = Kp / p), so xa's 64 columns of the step are one
//     128-byte TMA box of 256 rows (K-major, 128-byte swizzle; rows past N
//     come as zeros), and the weights are field j of 64 packed rows,
//     dequantized into a 64 x 128 bf16 tile written MN-major in the packed
//     layout's own column order, with the 128-byte swizzle that wgmma's
//     (transposed) B descriptor names (tmac::b_tile_offset);
//   - the steps go round a ring of k5Stages in shared memory (48 KB each)
//     with an mbarrier `full` per stage, which the TMA's bytes and every
//     thread's dequantized chunks complete, and `empty`, which every thread
//     completes once the wgmma that read the stage is done.  Every thread
//     dequantizes: after issuing the wgmma of step t each warpgroup
//     dequantizes its share of step t + 2 while that wgmma runs (one wgmma
//     group in flight a warpgroup), from packed bytes loaded a depth block
//     ahead and scales two steps ahead.
// Tried on the card and not kept: one producer warpgroup feeding two
// consumers (slower: four warps could not dequantize a stage in the time
// the tensor cores took for it), four warpgroups of 64 rows (no faster),
// blocks of 128 rows x 256 columns (slower: twice the dequantization).
// What bounds it: the dequantizing pipeline alone (TMA, dequantization,
// barriers, no wgmma) takes longer than the wgmma alone, and the two
// overlap only in part.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

// Hopper building blocks of K3 and K5: mbarriers, a 2-D TMA load, the
// wgmma shared-memory descriptor with the 128-byte swizzle,
// wgmma.m64n128k16 (bf16 in, f32 accumulators) and wgmma.m64n128k32 (s8 in,
// s32 accumulators), and the TMA tensor maps.
namespace tmac {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the barriers' initialisation, visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's shared-memory stores, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a 2-D TMA box (columns from k, rows from n) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int k,
                                            int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// a wgmma shared-memory descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The B operand written with ordinary stores: a tile of 64 k rows x 128
// columns of bf16, MN-major, as two 64-column halves of 64 rows of 128
// bytes, each row's 16-byte chunks XOR-swizzled by k % 8 (the 128-byte
// swizzle).  Its descriptor: the halves kBLbo bytes apart (the leading byte
// offset), groups of 8 k rows kBSbo apart (the stride byte offset); a k16
// step starts 16 rows (2048 bytes) on.
constexpr uint32_t kBLbo = 64 * 128, kBSbo = 1024;

// the byte offset of columns 8q .. 8q + 7 of k row r in that tile
__device__ __forceinline__ int b_tile_offset(int r, int q) {
  return (q >> 3) * 8192 + r * 128 + (((q & 7) ^ (r & 7)) << 4);
}

// d (64 x 128 f32, this thread's 64) += A (64 x 16, K-major) * B (16 x 128,
// MN-major), both read from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128 s32, this thread's 64) += A (64 x 32, K-major) * B (32 x 128,
// K-major), s8 x s8, both read from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n128k32_s8(int d[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// the same with B 32 x 256 (this thread's 128 of d)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int d[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null if the driver has none
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
#endif
      return nullptr;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return encode;
}

// The TMA map of a row-major matrix (rows, cols) of 1- or 2-byte elements,
// in boxes of box_cols x box_rows; elements past the end read as zeros.
// Returns a CUDA error (0 on success).
inline int box_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                   const void* base, int rows, int cols, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The TMA map of a bf16 matrix (rows, cols), row-major, in boxes of 64
// columns (128 bytes, the 128-byte swizzle) x box_rows rows; rows past the
// end read as zeros.  Returns a CUDA error (0 on success).
inline int bf16_box_map(CUtensorMap* map, const void* base, int rows, int cols,
                        int box_rows) {
  return box_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, 64, box_rows,
                 CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tmac

namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

namespace k3 {

constexpr int kStepK = 128;              // k' of a step: one 128-byte row of A and of B
constexpr int kMaxSplit = 8;             // portable cluster size
constexpr int kSmemLimit = 227 * 1024;   // a block's shared memory on Hopper
constexpr int kMaxStages = 8;

// the slots F of a packed row (k' = F r + j): its fields, 8 at bits 3 (two
// lo rows and a hi row); the planes a step reads (bits 3: lo rows r and r +
// Kh, hi rows r); the packed rows of a plane a step reads
__host__ __device__ constexpr int slots(int bits) {
  return bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 8;
}
__host__ __device__ constexpr int planes(int bits) { return bits == 3 ? 3 : 1; }
__host__ __device__ constexpr int raw_rows(int bits) { return kStepK / slots(bits); }
// the packed ring's stages: as many as 32 KB holds, 4 to 8
__host__ __device__ constexpr int raw_stages(int bits, int bn) {
  const int n = 32768 / (raw_rows(bits) * planes(bits) * bn);
  return n < 4 ? 4 : n > 8 ? 8 : n;
}

// A block's shared memory at bm token rows and bn columns
// (qgemm_kernel.large_smem mirrors it): 1024 bytes of alignment slack, the
// ring of `stages` stages (A, bm x 128 bytes, then B, bn x 128), the packed
// ring of `raws` stages (raw_stages: 32 KB at bits 2, 64 KB at bits 8, 16
// KB at bits 1, 30 KB at bits 3, 32 KB at bits 4, at 128 columns), the
// barriers, the epilogue's scales and zero points of the bn columns; as
// many stages as fit, at most kMaxStages.  After the main loop the ring
// and the packed ring hold the epilogue's tile, or receive the cluster's
// partials.
struct Layout {
  int stages, raws, a_bytes, stage, raw_bytes, raw, bars, ep, total;
  __host__ __device__ constexpr Layout(int bits, int bm, int bn)
      : stages(0), raws(raw_stages(bits, bn)),
        a_bytes(bm * kStepK), stage((bm + bn) * kStepK),
        raw_bytes(raw_rows(bits) * planes(bits) * bn),
        raw(0), bars(0), ep(0), total(0) {
    stages = kMaxStages;
    while (stages > 2 && 1024 + stages * stage + raws * raw_bytes + 16 * (stages + raws) +
                                 8 * bn > kSmemLimit)
      --stages;
    raw = stages * stage;
    bars = raw + raws * raw_bytes;
    ep = bars + 16 * (stages + raws);
    total = 1024 + ep + 8 * bn;
  }
};

// the row groups of 8 token rows whose sums block `rank` finishes
__host__ __device__ constexpr int slice_groups(int bm, int ksplit) {
  return (bm / 8 + ksplit - 1) / ksplit;
}

struct Args {
  CUtensorMap codes_map;   // codes (N, Kp) int8: boxes of 128 k' x bm rows, 128-byte swizzle
  CUtensorMap packed_map;  // packed (Kb, Mp) uint8: boxes of bn columns x raw_rows rows
  CUtensorMap hi_map;      // bits 3: packed_hi (Kh, Mp), boxes as packed_map's
  const float* xs;         // (N,)
  const float* xsum;       // (N,), the bare code sums
  const float* scales;     // (Mp,)
  const float* sub;        // (Mp,)
  const __nv_bfloat16* residual;  // (N, Mp) or null
  float* out;              // (N, Mp)
  int N, Mp, nsteps;
  int kh;                  // bits 3: Kp / 8, the lo plane's second half
};

// The epilogue of one output is the f32 steps XLA compiles the
// reference's N >= 64 route to: v = fma(acc, scale, -q * sub) (this
// function), then v * xs, or fma(v, xs, residual)
__device__ __forceinline__ float scaled(int acc, float scale, float sub, float q) {
  return __fmaf_rn((float)acc, scale, -__fmul_rn(q, sub));
}

// a named barrier of `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 32-bit load and 16-byte store at a shared-memory address
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// bit e of each byte of a hi plane word, moved to bit 2: 4 times the hi
// bit of slot e (bits 3)
__device__ __forceinline__ uint32_t hi4(uint32_t h, int e) {
  return ((h >> e) & 0x01010101u) << 2;
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 128)
    tmac::wgmma_m64n128k32_s8(d, a, b);
  else
    tmac::wgmma_m64n256k32_s8(d, a, b);
}

}  // namespace k3

// Block (x, y): columns [bn * (x / ksplit), +bn), token rows [bm * y, +bm)
// with bm = 64 * CWG * MT, and the steps of rank x % ksplit of its cluster.
// CWG warpgroups of MT m64 tiles each, whose every warp both multiplies and
// unpacks, and two loader warps that issue the TMAs.  Stage s of the ring: A (bm rows
// x 128 bytes, as TMA swizzles it), then B (bn columns x 128 bytes,
// swizzled alike); stage r of the packed ring: the step's packed rows x bn
// columns, as stored.
template <int BITS, int BN, int CWG, int MT>
__global__ void __launch_bounds__(128 * CWG + 64, 1)
    k3_wgmma_kernel(const __grid_constant__ k3::Args a) {
  constexpr int BM = 64 * CWG * MT, kThreads = 128 * CWG, kWarps = kThreads / 32;
  constexpr int kRawRows = k3::raw_rows(BITS);
  // packed rows of a plane a unit of 16 k' reads, and its words
  constexpr int kRpc = kRawRows / 8, kWords = kRpc * k3::planes(BITS);
  constexpr k3::Layout L(BITS, BM, BN);
  constexpr int S = L.stages, R = L.raws;
  // the B tile of step t is unpacked D steps ahead, while the wgmma of the
  // step before it runs, into the stage step t - S freed
  constexpr int D = S >= 4 ? 2 : 1;
  // 16-byte chunks of B a thread unpacks a step: unit u = tid + kThreads k
  // is column quad u % (bn / 4) and chunk u / (bn / 4)
  constexpr int U = 8 * (BN / 4) / kThreads;
  static_assert(U >= 1 && R >= 4, "K3's tile leaves a thread no unit, or too few packed stages");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  uint64_t* raw_full = empty + S;
  uint64_t* raw_empty = raw_full + R;
  cg::cluster_group cluster = cg::this_cluster();
  const int ksplit = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / ksplit;
  const int m0 = tile * BN, n0 = blockIdx.y * BM;
  const int t0 = rank * a.nsteps / ksplit, nb = (rank + 1) * a.nsteps / ksplit - t0;
  // the blocks start their steps at different depths (integer sums are
  // exact in any order), so that the codes each step reads from L2 are not
  // the same lines for every block at once
  const int rot_steps = nb > 0 ? tile % nb : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tmac::mbar_init(&full[s], kWarps + 1);  // the warps' B tiles, the codes' expect_tx
      tmac::mbar_init(&empty[s], kWarps);
    }
    for (int r = 0; r < R; ++r) {
      tmac::mbar_init(&raw_full[r], 1);
      tmac::mbar_init(&raw_empty[r], kWarps);
    }
    tmac::fence_barrier_init();
  }
  // the epilogue's scales and zero points of the block's columns, staged
  // once (an epilogue loading them from L2 would wait on each in turn)
  float* ep = reinterpret_cast<float*>(smem + L.ep);
  for (int i = tid; i < 2 * BN; i += blockDim.x) {
    const int m = m0 + i % BN;
    ep[i] = m < a.Mp ? __ldg((i < BN ? a.scales : a.sub) + m) : 0.f;
  }
  __syncthreads();

  auto step_of = [&](int t) { return t0 + (t + rot_steps) % nb; };
  auto issue_raw = [&](int t) {
    const int r = t % R;
    uint8_t* dst = smem + L.raw + r * L.raw_bytes;
    tmac::mbar_arrive_expect_tx(&raw_full[r], L.raw_bytes);
    tmac::tma_load_2d(dst, &a.packed_map, m0, step_of(t) * kRawRows, &raw_full[r]);
    if constexpr (BITS == 3) {  // lo rows r + Kh, then hi rows r
      tmac::tma_load_2d(dst + kRawRows * BN, &a.packed_map, m0, a.kh + step_of(t) * kRawRows,
                        &raw_full[r]);
      tmac::tma_load_2d(dst + 2 * kRawRows * BN, &a.hi_map, m0, step_of(t) * kRawRows,
                        &raw_full[r]);
    }
  };
  auto issue_codes = [&](int t) {
    tmac::mbar_arrive_expect_tx(&full[t % S], L.a_bytes);
    tmac::tma_load_2d(smem + (t % S) * L.stage, &a.codes_map, step_of(t) * k3::kStepK, n0,
                      &full[t % S]);
  };
  // This thread's columns are rotated by rot: column 4 q + ((t4 + rot) & 3)
  // is the t4-th it stores, so the 8 lanes of a quarter-warp store to 8
  // distinct 16-byte bank groups
  const uint32_t rot = (lane >> 1) & 3;
  const uint32_t sel = (rot & 3) | (((rot + 1) & 3) << 4) | (((rot + 2) & 3) << 8) |
                       (((rot + 3) & 3) << 12);
  // the B tile of step t from its packed stage, then one arrival a warp on
  // `full` and on `raw_empty`
  auto unpack = [&](int t) {
    const int s = t % S, r = t % R;
    if (t >= S) tmac::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
    tmac::mbar_wait(&raw_full[r], (t / R) & 1);
    const uint32_t B = tmac::smem_u32(smem + s * L.stage + L.a_bytes);
    const uint32_t raw = tmac::smem_u32(smem + L.raw + r * L.raw_bytes);
    // every unit's words first (packed rows kRpc c .. kRpc c + kRpc - 1 of
    // each plane: bits 2, 4 rows; bits 4, 8; bits 1, 2; bits 3, 2 of each
    // of its 3 planes; bits 8, code rows 16c .. 16c + 15), each rotated
    uint32_t w[U][kWords];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = tid + kThreads * k, q = u % (BN / 4), c = u / (BN / 4);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[k][i] = __byte_perm(
            k3::lds32(raw + ((i / kRpc) * kRawRows + kRpc * c + i % kRpc) * BN + 4 * q), 0, sel);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = tid + kThreads * k, q = u % (BN / 4), c = u / (BN / 4);
      uint32_t o[4][4];  // [column t4][word of the 16-byte chunk]
      if constexpr (BITS == 1) {
        // packed rows 2c + i: bit e of a byte is k' = 16c + 8i + e, so bits
        // 0-3 are word 2i of its column's chunk and bits 4-7 word 2i + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t x = w[k][i];
          uint32_t lo[4], hi[4];
          tmac::transpose4(x & 0x01010101u, (x >> 1) & 0x01010101u, (x >> 2) & 0x01010101u,
                           (x >> 3) & 0x01010101u, lo);
          tmac::transpose4((x >> 4) & 0x01010101u, (x >> 5) & 0x01010101u,
                           (x >> 6) & 0x01010101u, (x >> 7) & 0x01010101u, hi);
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            o[t4][2 * i] = lo[t4];
            o[t4][2 * i + 1] = hi[t4];
          }
        }
      } else if constexpr (BITS == 3) {
        // row 2c + i: lo row words x0 (r) and x1 (r + Kh), hi row word h;
        // slot e (k' = 16c + 8i + e) is field e / 2 of x(e % 2) plus 4 times
        // bit e of h, slots 0-3 word 2i of the chunk, 4-7 word 2i + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t x0 = w[k][i], x1 = w[k][2 + i], h = w[k][4 + i];
          uint32_t lo[4], hi[4];
          tmac::transpose4((x0 & 0x03030303u) | k3::hi4(h, 0), (x1 & 0x03030303u) | k3::hi4(h, 1),
                           ((x0 >> 2) & 0x03030303u) | k3::hi4(h, 2),
                           ((x1 >> 2) & 0x03030303u) | k3::hi4(h, 3), lo);
          tmac::transpose4(((x0 >> 4) & 0x03030303u) | k3::hi4(h, 4),
                           ((x1 >> 4) & 0x03030303u) | k3::hi4(h, 5),
                           ((x0 >> 6) & 0x03030303u) | k3::hi4(h, 6),
                           ((x1 >> 6) & 0x03030303u) | k3::hi4(h, 7), hi);
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            o[t4][2 * i] = lo[t4];
            o[t4][2 * i + 1] = hi[t4];
          }
        }
      } else if constexpr (BITS == 4) {
        // packed rows 8c + 4g .. +3, one word a column (byte i: row 8c + 4g
        // + i); fields 0 and 1 of row 8c + r are k' = 16c + 2r and + 1, so
        // words 2g and 2g + 1 of the chunk interleave the low and the high
        // nibbles
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          uint32_t col[4];
          tmac::transpose4(w[k][4 * g], w[k][4 * g + 1], w[k][4 * g + 2], w[k][4 * g + 3], col);
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            const uint32_t lo = col[t4] & 0x0F0F0F0Fu, hi = (col[t4] >> 4) & 0x0F0F0F0Fu;
            o[t4][2 * g] = __byte_perm(lo, hi, 0x5140);
            o[t4][2 * g + 1] = __byte_perm(lo, hi, 0x7362);
          }
        }
      } else if constexpr (BITS == 2) {
        // one word a column (byte i: packed row 4c + i), then its 16
        // fields in k' order (byte j of word i: k' = 16c + 4i + j)
        uint32_t col[4];
        tmac::transpose4(w[k][0], w[k][1], w[k][2], w[k][3], col);
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
          tmac::transpose4(col[t4] & 0x03030303u, (col[t4] >> 2) & 0x03030303u,
                           (col[t4] >> 4) & 0x03030303u, (col[t4] >> 6) & 0x03030303u, o[t4]);
      } else {
        // code rows 16c + 4g .. +3: word g of each column's chunk
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          uint32_t col[4];
          tmac::transpose4(w[k][4 * g], w[k][4 * g + 1], w[k][4 * g + 2], w[k][4 * g + 3], col);
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) o[t4][g] = col[t4];
        }
      }
#pragma unroll
      for (int t4 = 0; t4 < 4; ++t4) {
        const int m = 4 * q + ((t4 + rot) & 3);
        k3::sts128(B + m * 128 + ((c ^ (m & 7)) << 4), o[t4][0], o[t4][1], o[t4][2], o[t4][3]);
      }
    }
    // the tile's generic-proxy stores, visible to wgmma's async proxy
    tmac::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tmac::mbar_arrive(&full[s]);
      tmac::mbar_arrive(&raw_empty[r]);
    }
  };

  int acc[MT][BN / 2];
  const int wg = tid >> 7;
  if (warp >= kWarps) {
    // The loaders, one thread each: the packed ring (it does not depend on
    // the prologue), each step as its stage frees; the codes after
    // griddepcontrol.wait, each step as its stage frees
    if (lane == 0) {
      if (warp == kWarps) {
        for (int t = 0; t < nb; ++t) {
          if (t >= R) tmac::mbar_wait(&raw_empty[t % R], ((t / R) & 1) ^ 1);
          issue_raw(t);
        }
      } else {
        tmac::pdl_wait();  // the prologue's codes are complete
        for (int t = 0; t < nb; ++t) {
          if (t >= S) tmac::mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
          issue_codes(t);
        }
      }
    }
    __syncwarp();
    tmac::pdl_wait();  // (the split's epilogue reads xs and xsum)
  } else {
    // The first D B tiles before the prologue's codes exist (their weights
    // do not depend on it)
    for (int t = 0; t < min(D, nb); ++t) unpack(t);
    tmac::pdl_wait();  // the prologue's xs and xsum are complete
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0;
    for (int t = 0; t < nb; ++t) {
      const int s = t % S;
      tmac::mbar_wait(&full[s], (t / S) & 1);
      const uint32_t a_base = tmac::smem_u32(smem + s * L.stage) + wg * MT * 64 * 128;
      const uint32_t b_base = tmac::smem_u32(smem + s * L.stage + L.a_bytes);
      tmac::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < k3::kStepK / 32; ++ks) {
        const uint64_t bd = tmac::smem_desc(b_base + ks * 32, 16, 1024);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          k3::wgmma_s8<BN>(acc[i], tmac::smem_desc(a_base + i * 8192 + ks * 32, 16, 1024), bd);
      }
      tmac::wgmma_commit();
      // the stage before this one is free once its wgmma group is done:
      // one arrival a warp
      tmac::wgmma_wait<1>();
      if (t > 0 && lane == 0) tmac::mbar_arrive(&empty[(t - 1) % S]);
      // the B tile D steps ahead, while this step's wgmma runs
      if (t + D < nb) unpack(t + D);
    }
    tmac::wgmma_wait<0>();
  }
  tmac::pdl_trigger();  // a programmatically launched successor may start

  // accumulator (i, 4 c + e) of a consumer thread: tile row 64 (wg MT + i)
  // + 16 (warp % 4) + lane / 4 + 8 (e / 2), column 8 c + 2 (lane % 4) + e % 2
  const int w4 = warp & 3;
  if (ksplit == 1) {
    if (warp >= kWarps) return;
    // Through the (then idle) ring, as whole rows: each thread's sums
    // scaled (fma(acc, scale, -q * sub)) into a tile of rows padded by 8
    // floats (a warp's stores take two wavefronts) and its rows' xs beside
    // it, then every row out with 16-byte stores (the residual read so),
    // times xs or fma'd with the residual: stores of 2 columns straight from
    // the fragments touch 8 rows each, and take longer than the main loop's
    // last steps.
    constexpr int kPitch = BN + 8;
    float* tile_s = reinterpret_cast<float*>(smem);
    float* xs_s = tile_s + BM * kPitch;
    k3::bar_sync(1, kThreads);  // every warpgroup's last wgmma has read its stage
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = (wg * MT + i) * 64 + 16 * w4 + (lane >> 2) + 8 * h;
        const bool live = n0 + rl < a.N;
        const float q = live ? __ldcg(a.xsum + n0 + rl) : 0.f;
        if ((lane & 3) == 0) xs_s[rl] = live ? __ldcg(a.xs + n0 + rl) : 0.f;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const int mm = 8 * c + 2 * (lane & 3);
          *reinterpret_cast<float2*>(tile_s + rl * kPitch + mm) =
              make_float2(k3::scaled(acc[i][4 * c + 2 * h], ep[mm], ep[BN + mm], q),
                          k3::scaled(acc[i][4 * c + 2 * h + 1], ep[mm + 1], ep[BN + mm + 1], q));
        }
      }
    k3::bar_sync(1, kThreads);
    const int rows = min(BM, a.N - n0), cols = min(BN, a.Mp - m0);
#pragma unroll
    for (int k = 0; k < BM * BN / 4 / kThreads; ++k) {
      const int idx = tid + kThreads * k, rl = idx / (BN / 4), mm = 4 * (idx % (BN / 4));
      if (rl >= rows || mm >= cols) continue;
      const float x_s = xs_s[rl];
      const float4 v = *reinterpret_cast<const float4*>(tile_s + rl * kPitch + mm);
      const size_t o = (size_t)(n0 + rl) * a.Mp + m0 + mm;
      float4 r;
      if (a.residual != nullptr) {
        const uint2 rb = __ldg(reinterpret_cast<const uint2*>(a.residual + o));
        const __nv_bfloat162 r01 = *reinterpret_cast<const __nv_bfloat162*>(&rb.x);
        const __nv_bfloat162 r23 = *reinterpret_cast<const __nv_bfloat162*>(&rb.y);
        r = make_float4(__fmaf_rn(v.x, x_s, __low2float(r01)),
                        __fmaf_rn(v.y, x_s, __high2float(r01)),
                        __fmaf_rn(v.z, x_s, __low2float(r23)),
                        __fmaf_rn(v.w, x_s, __high2float(r23)));
      } else {
        r = make_float4(__fmul_rn(v.x, x_s), __fmul_rn(v.y, x_s), __fmul_rn(v.z, x_s),
                        __fmul_rn(v.w, x_s));
      }
      *reinterpret_cast<float4*>(a.out + o) = r;
    }
    return;
  }

  // The split: block `rank` finishes tile rows [rank * sg * 8, +sg * 8).
  // Every block's partials go into the ring of the block that finishes
  // their rows (recv[source rank][row of the slice][column]), through
  // distributed shared memory; the cluster barriers order it.
  const int sg = k3::slice_groups(BM, ksplit), srows = 8 * sg;
  int* recv = reinterpret_cast<int*>(smem);
  cluster.sync();  // every block's main loop is done and its ring idle
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2 && warp < kWarps; ++h) {
      const int rl = (wg * MT + i) * 64 + 16 * w4 + (lane >> 2) + 8 * h;
      const int owner = (rl >> 3) / sg;
      int* row = cluster.map_shared_rank(recv, owner) +
                 (rank * srows + rl - owner * srows) * BN + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
        *reinterpret_cast<int2*>(row + 8 * c) =
            make_int2(acc[i][4 * c + 2 * h], acc[i][4 * c + 2 * h + 1]);
    }
  cluster.sync();  // every partial has landed; nothing crosses blocks after
  // a warp a row of the slice, 16 bytes a lane: the ksplit partials in
  // rank order, then the epilogue
  const int r0 = rank * srows, rows = max(0, min(min(srows, BM - r0), a.N - n0 - r0));
#pragma unroll 4
  for (int rr = warp; rr < rows; rr += blockDim.x / 32) {
    const int n = n0 + r0 + rr;
    const float x_s = __ldcg(a.xs + n), q = __ldcg(a.xsum + n);
#pragma unroll
    for (int h = 0; h < BN / 128; ++h) {
      const int mm = 4 * (lane + 32 * h), m = m0 + mm;
      if (m >= a.Mp) continue;
      int4 sum = make_int4(0, 0, 0, 0);
      for (int b = 0; b < ksplit; ++b) {
        const int4 v = *reinterpret_cast<const int4*>(recv + (b * srows + rr) * BN + mm);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const size_t o = (size_t)n * a.Mp + m;
      const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = k3::scaled(s4[e], ep[mm + e], ep[BN + mm + e], q);
        v[e] = a.residual != nullptr
                   ? __fmaf_rn(v[e], x_s, __bfloat162float(a.residual[o + e]))
                   : __fmul_rn(v[e], x_s);
      }
      *reinterpret_cast<float4*>(a.out + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Launch one instance of K3 on cdiv(Mp, bn) * ksplit x cdiv(N, bm) blocks in
// clusters of ksplit along x, with programmatic stream serialization (it
// starts while the prologue before it runs).  A cluster the card cannot
// place is refused with cudaErrorInvalidConfiguration; nothing falls back.
template <int BITS, int BN, int CWG, int MT>
int launch_k3(const k3::Args& a, int ksplit, cudaStream_t stream) {
  constexpr int BM = 64 * CWG * MT;
  constexpr k3::Layout L(BITS, BM, BN);
  static_assert(L.total <= k3::kSmemLimit, "K3's ring outgrows a block's shared memory");
  static bool admitted[k3::kMaxSplit + 1] = {};
  auto kernel = k3_wgmma_kernel<BITS, BN, CWG, MT>;
  if (ksplit * k3::slice_groups(BM, ksplit) * 8 * BN * 4 > L.bars)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Mp + BN - 1) / BN * ksplit, (a.N + BM - 1) / BM);
  cfg.blockDim = dim3(128 * CWG + 64);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!admitted[ksplit]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    admitted[ksplit] = true;
  }
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

constexpr int kPrologueThreads = 512;
constexpr int k5BN = 256;        // token rows of a block
constexpr int k5BM = 128;        // output columns of a block
constexpr int k5Stages = 4;
constexpr int k5Groups = 2;                  // warpgroups, each dequantizes and multiplies
constexpr int k5Threads = 128 * k5Groups;
constexpr int k5MT = k5BN / 64 / k5Groups;   // m64 tiles of a warpgroup
constexpr int k5Chunks = 64 * 16 / k5Threads;  // 16-byte chunks of B a thread a step
constexpr int k5ABytes = k5BN * 128;        // 256 rows x 64 bf16
constexpr int k5BBytes = 64 * k5BM * 2;     // 64 k x 128 columns bf16
constexpr int k5Stage = k5ABytes + k5BBytes;
constexpr int k5Smem = k5Stages * k5Stage + 1024 + 2 * k5Stages * 8;  // + alignment, barriers

// xa (N, Kp) bf16: the prologue values rounded to bf16, one block a row
// (LONG: a row past 32 values a thread, act_prologue.cuh).
template <bool LONG>
__global__ void __launch_bounds__(kPrologueThreads) act_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int glu,
    const __nv_bfloat16* __restrict__ norm_w, float eps, float inv_norm_k,
    __nv_bfloat16* __restrict__ xa) {
  __shared__ float scratch[LONG ? tmac::kMaxWindows : kPrologueThreads];
  const int n = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)n * x_cols;
  float rs = 1.f;
  if (norm_w != nullptr)
    rs = tmac::rms_factor(tmac::sumsq_xla_order<LONG>(xr, K, Kp, glu, scratch),
                          inv_norm_k, eps);
  for (int k = threadIdx.x; k < Kp; k += blockDim.x)
    xa[(size_t)n * Kp + k] =
        __float2bfloat16_rn(tmac::prologue_value(xr, k, K, glu, norm_w, rs));
}

// Block: columns [128 * blockIdx.x, +128), token rows [256 * blockIdx.y,
// +256), k5Groups warpgroups of k5MT * 64 rows.  Stage s of the ring: A
// (256 rows x 128 bytes, TMA-swizzled), then B (tmac::b_tile_offset's
// layout).  Step
// t = rb * p + j is stage t % k5Stages: field j of packed rows 64 rb .. +64,
// k = j * Kb + 64 rb .. +64.  Every warpgroup dequantizes: while the wgmma
// of step t runs, each thread dequantizes its k5Chunks chunks of 8 columns
// (packed rows rlo + (k5Threads / 16) i) of step t + 2, into the stage the
// wgmma of step t - 2 read.
// Bits 3: packed is the 2-bit lo plane (Kp / 4 rows) and packed_hi the
// 1-bit hi plane (Kh = Kp / 8 rows), code = lo + 4 * hi; lo row r holds k
// = j * Kb + r in field j, whose hi bit is bit 2 j + (r >= Kh) of hi row
// r % Kh.  A depth block of 64 lo rows (Kh a multiple of 64) thus reads 64
// hi rows at one offset, loaded with its lo bytes.
// SC: the scales' and zero points' type: __nv_bfloat16 (8 columns a 16-byte
// load), or float (GGUF's block scales: two 16-byte loads for 8 columns),
// its own template instance; code * scale is then not exact, and the fma
// below is the one rounding the plain version repeats.
// Group size 16 (GGUF's Q2_K and Q3_K): a thread's rows rlo + 16 i of a
// 64-row step change group every chunk, so each chunk loads its group's
// scale and zero point rows (the `g != g_cur` branch, from L2: the step's
// prefetch holds only row rlo's); the 8 columns' loads stay 16-byte
// aligned, the column offset 8 q being one of the row's.
// Bits 8 (GGUF's Q8_0, P = 1): the packed bytes are signed codes, taken as
// floats through the same exact add (code + 128 biased, less 2^23 + 128).
template <typename SC>
struct ScaleRow {  // 8 columns' scales (or zero points), as loaded
  uint4 v[sizeof(SC) / 2];
  __device__ __forceinline__ void load(const SC* p) {
#pragma unroll
    for (int h = 0; h < (int)(sizeof(SC) / 2); ++h) v[h] = __ldg(reinterpret_cast<const uint4*>(p) + h);
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(SC) == 2)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(v)[e]);
    else
      return reinterpret_cast<const float*>(v)[e];
  }
};

template <int BITS, typename SC>
__global__ void __launch_bounds__(k5Threads, 1) dequant_wgmma_kernel(
    const __grid_constant__ CUtensorMap xa_map, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ packed_hi, int Mp,
    const SC* __restrict__ scales, const SC* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  constexpr int P = BITS == 8 ? 1 : BITS == 3 ? 4 : 8 / BITS;  // fields of a (lo plane) byte
  constexpr uint32_t kMask = BITS == 3 ? 3u : (1u << BITS) - 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + k5Stages * k5Stage);
  uint64_t* empty = full + k5Stages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * k5BM, n0 = blockIdx.y * k5BN;
  const int Kb = Kp / P, nsteps = Kp / 64, Kh = Kp / 8;
  const int q = tid & 15, rlo = tid >> 4;  // rows rlo + (k5Threads / 16) i
  const size_t col = (size_t)m0 + 8 * q;

  if (tid == 0) {
    for (int s = 0; s < k5Stages; ++s) {
      tmac::mbar_init(&full[s], k5Threads);
      tmac::mbar_init(&empty[s], k5Threads);
    }
    tmac::fence_barrier_init();
  }
  __syncthreads();

  // Loaded well ahead of their dequantization, so that it never waits on
  // device memory: the packed bytes of depth block rb at the first step of
  // block rb - 1 (p steps ahead), the scale and sub rows two steps ahead.
  uint2 pk[k5Chunks], pk_next[k5Chunks];
  uint2 ph[BITS == 3 ? k5Chunks : 1], ph_next[BITS == 3 ? k5Chunks : 1];  // bits 3: hi rows
  ScaleRow<SC> sv[2], zv[2];  // [0]: the next step to dequantize, [1]: the one after
  auto load_packed = [&](int rb, uint2 (&dst)[k5Chunks], uint2 (&dst_hi)[BITS == 3 ? k5Chunks : 1]) {
#pragma unroll
    for (int i = 0; i < k5Chunks; ++i) {
      const int r = rb * 64 + rlo + (k5Threads / 16) * i;
      dst[i] = __ldg(reinterpret_cast<const uint2*>(packed + (size_t)r * Mp + col));
      if constexpr (BITS == 3)
        dst_hi[i] = __ldg(reinterpret_cast<const uint2*>(packed_hi + (size_t)(r % Kh) * Mp + col));
    }
  };
  auto load_scales = [&](int step, ScaleRow<SC>& s4, ScaleRow<SC>& z4) {
    const int g = ((step % P) * Kb + (step / P) * 64 + rlo) / gs;
    s4.load(scales + (size_t)g * Mp + col);
    z4.load(sub + (size_t)g * Mp + col);
  };
  auto produce = [&](int step) {
    const int s = step % k5Stages, r0 = (step / P) * 64, j = step % P;
    tmac::mbar_wait(&empty[s], ((step / k5Stages) & 1) ^ 1);
    uint8_t* As = smem + s * k5Stage;
    uint8_t* Bs = As + k5ABytes;
    if (tid == 0) {
      tmac::mbar_expect_tx(&full[s], k5ABytes);
      tmac::tma_load_2d(As, &xa_map, j * Kb + r0, n0, &full[s]);
    }
    // scale and -sub of the thread's 8 columns in the group of row rlo
    float sf[8], zf[8];
    auto convert = [&](const ScaleRow<SC>& s4, const ScaleRow<SC>& z4) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sf[e] = s4.get(e);
        zf[e] = -z4.get(e);
      }
    };
    if (j == 0 && step > 0) {
#pragma unroll
      for (int i = 0; i < k5Chunks; ++i) {
        pk[i] = pk_next[i];
        if constexpr (BITS == 3) ph[i] = ph_next[i];
      }
      if (step / P + 1 < Kb / 64) load_packed(step / P + 1, pk_next, ph_next);
    }
    convert(sv[0], zv[0]);
    sv[0] = sv[1];
    zv[0] = zv[1];
    if (step + 2 < nsteps) load_scales(step + 2, sv[1], zv[1]);
    int g_cur = (j * Kb + r0 + rlo) / gs;
#pragma unroll
    for (int i = 0; i < k5Chunks; ++i) {
      const int rr = rlo + (k5Threads / 16) * i;
      const int g = (j * Kb + r0 + rr) / gs;
      if (g != g_cur) {  // only when gs < 64
        g_cur = g;
        ScaleRow<SC> s4, z4;
        s4.load(scales + (size_t)g * Mp + col);
        z4.load(sub + (size_t)g * Mp + col);
        convert(s4, z4);
      }
      // field j of the 8 columns' bytes at bit 8 e (bits 3: and the hi bit)
      const int shift = (BITS == 3 ? 2 : BITS) * j;
      const uint32_t lo = pk[i].x >> shift, hi = pk[i].y >> shift;
      uint32_t hlo = 0, hhi = 0;  // bits 3: 4 * the hi bits, at bit 2 of each byte
      if constexpr (BITS == 3) {
        const int hbit = 2 * j + (r0 >= Kh);
        hlo = ((ph[i].x >> hbit) & 0x01010101u) << 2;
        hhi = ((ph[i].y >> hbit) & 0x01010101u) << 2;
      }
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t code;
          if constexpr (BITS == 3)
            code = ((((e + u) < 4 ? lo : hi) & 0x03030303u) | ((e + u) < 4 ? hlo : hhi)) >>
                       (8 * ((e + u) & 3)) & 0xFFu;
          else
            code = (((e + u) < 4 ? lo : hi) >> (8 * ((e + u) & 3))) & kMask;
          // 2^23 + code, less 2^23: the code as a float, exactly, without
          // the quarter-rate int-to-float conversion (bits 8: the signed
          // byte biased by 128, less 2^23 + 128); then code * scale - sub
          // with one rounding (bf16 scales: code * scale is exact, so it is
          // the reference's one rounding)
          const float cf =
              BITS == 8 ? __fsub_rn(__uint_as_float(0x4B000000u | (code ^ 0x80u)), 8388736.0f)
                        : __fsub_rn(__uint_as_float(0x4B000000u | code), 8388608.0f);
          v[u] = __fmaf_rn(cf, sf[e + u], zf[e + u]);
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
        w[e / 2] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      *reinterpret_cast<uint4*>(Bs + tmac::b_tile_offset(rr, q)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    // the tile's generic-proxy stores, visible to wgmma's async proxy
    tmac::fence_proxy_async();
    tmac::mbar_arrive(&full[s]);
  };

  float acc[k5MT][64];
#pragma unroll
  for (int i = 0; i < k5MT; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
  const int row0 = wg * 64 * k5MT;
  load_packed(0, pk, ph);
  if (Kb / 64 > 1) load_packed(1, pk_next, ph_next);
  load_scales(0, sv[0], zv[0]);
  if (nsteps > 1) load_scales(1, sv[1], zv[1]);
  produce(0);
  if (nsteps > 1) produce(1);
  for (int step = 0; step < nsteps; ++step) {
    const int s = step % k5Stages;
    tmac::mbar_wait(&full[s], (step / k5Stages) & 1);
    const uint32_t a_base = tmac::smem_u32(smem + s * k5Stage) + row0 * 128;
    const uint32_t b_base = tmac::smem_u32(smem + s * k5Stage + k5ABytes);
    tmac::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t bd = tmac::smem_desc(b_base + ks * 2048, tmac::kBLbo, tmac::kBSbo);
#pragma unroll
      for (int i = 0; i < k5MT; ++i)
        tmac::wgmma_m64n128k16(
            acc[i], tmac::smem_desc(a_base + i * 64 * 128 + ks * 32, 16, 1024), bd);
    }
    tmac::wgmma_commit();
    // the stage before this one is free once its wgmma group is done
    tmac::wgmma_wait<1>();
    if (step > 0) tmac::mbar_arrive(&empty[(step - 1) % k5Stages]);
    if (step + 2 < nsteps) produce(step + 2);
  }
  tmac::wgmma_wait<0>();

  // accumulator (i, 4 c + e) is row 64 i + 16 (warp % 4) + lane / 4
  // + 8 (e / 2) and column 8 c + 2 (lane % 4) + e % 2 of the warpgroup's
  const int lane = tid & 31, w4 = (tid >> 5) & 3;
#pragma unroll
  for (int i = 0; i < k5MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row0 + 64 * i + 16 * w4 + (lane >> 2) + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int m = m0 + 8 * c + 2 * (lane & 3);
        float o0 = acc[i][4 * c + 2 * h], o1 = acc[i][4 * c + 2 * h + 1];
        if (residual != nullptr) {
          o0 = __fadd_rn(o0, __bfloat162float(residual[(size_t)n * Mp + m]));
          o1 = __fadd_rn(o1, __bfloat162float(residual[(size_t)n * Mp + m + 1]));
        }
        *reinterpret_cast<float2*>(out + (size_t)n * Mp + m) = make_float2(o0, o1);
      }
    }
}

template <int BITS, typename SC>
int launch_dequant_wgmma(const CUtensorMap& map, int N, int Kp, int gs,
                         const uint8_t* packed, const uint8_t* packed_hi, int Mp,
                         const void* scales_, const void* sub_,
                         const __nv_bfloat16* residual, float* out, cudaStream_t stream) {
  auto kernel = dequant_wgmma_kernel<BITS, SC>;
  const SC* scales = static_cast<const SC*>(scales_);
  const SC* sub = static_cast<const SC*>(sub_);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k5Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Mp / k5BM, (N + k5BN - 1) / k5BN);
  kernel<<<grid, k5Threads, k5Smem, stream>>>(map, N, Kp, gs, packed, packed_hi, Mp, scales,
                                              sub, residual, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: codes (N, Kp) int8 from tmac_act_quant with large_n (K3's grouping),
// xs and xsum (N,) f32, packed (Kp * bits / 8, Mp) uint8 (bits 3: the lo
// plane (Kp / 4, Mp) and packed_hi, the hi plane (Kp / 8, Mp); else
// packed_hi null), scales/sub (Mp,) f32 (per column), residual (N, Mp) bf16
// or null -> out (N, Mp) f32.  bits 1 to 4 or 8; Kp a multiple of 16 (of
// 32 at bits 1 and 3), Mp of 128; codes and packed 16-byte aligned; a
// block of bm token rows (64, 128 or 256) x bn columns (128; or, at bits 2,
// 256 at bm 64 or 128), a cluster of ksplit (1-8, at most the 128-k' steps of Kp)
// blocks along K.  Launched programmatically after the prologue.  Returns
// the launch's CUDA error (cudaErrorInvalidConfiguration for a cluster the
// card cannot place).
extern "C" int tmac_large_int_wgmma(const void* codes, const float* xs,
                                    const float* xsum, int N, int Kp, int bits,
                                    const void* packed, const void* packed_hi,
                                    const float* scales, const float* sub, int Mp,
                                    const void* residual, float* out, int bm, int bn,
                                    int ksplit, void* stream) {
  const int nsteps = (Kp + k3::kStepK - 1) / k3::kStepK;
  if (N <= 0 || Kp <= 0 || Kp % 16 != 0 || Mp % 128 != 0 || bits < 1 ||
      (bits > 4 && bits != 8) || Kp % (4 * k3::slots(bits)) != 0 ||
      (bits == 3) != (packed_hi != nullptr) ||
      (bm != 64 && bm != 128 && bm != 256) || (bn != 128 && bn != 256) ||
      (bn == 256 && (bm == 256 || bits != 2)) || ksplit < 1 || ksplit > k3::kMaxSplit || ksplit > nsteps ||
      reinterpret_cast<uintptr_t>(codes) % 16 || reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(packed_hi) % 16)
    return (int)cudaErrorInvalidValue;
  k3::Args a{};
  int err = tmac::box_map(&a.codes_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, N, Kp,
                          k3::kStepK, bm, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // the packed rows of the (lo) plane: Kp / p, p fields a byte
  const int rows = bits == 3 ? Kp / 4 : Kp * bits / 8;
  err = tmac::box_map(&a.packed_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, rows, Mp, bn,
                      k3::raw_rows(bits), CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  if (bits == 3) {
    err = tmac::box_map(&a.hi_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed_hi, Kp / 8, Mp,
                        bn, k3::raw_rows(bits), CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  a.kh = Kp / 8;
  a.xs = xs;
  a.xsum = xsum;
  a.scales = scales;
  a.sub = sub;
  a.residual = static_cast<const __nv_bfloat16*>(residual);
  a.out = out;
  a.N = N;
  a.Mp = Mp;
  a.nsteps = nsteps;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits * 10000 + bn * 10 + bm / 64) {
    case 11281: return launch_k3<1, 128, 1, 1>(a, ksplit, s);
    case 11282: return launch_k3<1, 128, 2, 1>(a, ksplit, s);
    case 11284: return launch_k3<1, 128, 2, 2>(a, ksplit, s);
    case 31281: return launch_k3<3, 128, 1, 1>(a, ksplit, s);
    case 31282: return launch_k3<3, 128, 2, 1>(a, ksplit, s);
    case 31284: return launch_k3<3, 128, 2, 2>(a, ksplit, s);
    case 41281: return launch_k3<4, 128, 1, 1>(a, ksplit, s);
    case 41282: return launch_k3<4, 128, 2, 1>(a, ksplit, s);
    case 41284: return launch_k3<4, 128, 2, 2>(a, ksplit, s);
    case 21281: return launch_k3<2, 128, 1, 1>(a, ksplit, s);
    case 21282: return launch_k3<2, 128, 2, 1>(a, ksplit, s);
    case 21284: return launch_k3<2, 128, 2, 2>(a, ksplit, s);
    case 22561: return launch_k3<2, 256, 1, 1>(a, ksplit, s);
    case 22562: return launch_k3<2, 256, 2, 1>(a, ksplit, s);
    case 81281: return launch_k3<8, 128, 1, 1>(a, ksplit, s);
    case 81282: return launch_k3<8, 128, 2, 1>(a, ksplit, s);
    default: return launch_k3<8, 128, 2, 2>(a, ksplit, s);
  }
}

// K5's prologue: x (N, x_cols) bf16 -> xa (N, Kp) bf16.  norm_w (K,) bf16 or
// null.  Returns the launch's CUDA error.
extern "C" int tmac_act_bf16(const void* x, int N, int x_cols, int K, int Kp,
                             int glu, const void* norm_w, float eps,
                             float inv_norm_k, void* xa, void* stream) {
  if (N <= 0 || Kp > tmac::kMaxRowK)
    return (int)cudaErrorInvalidValue;
  auto kernel = Kp > tmac::kSumWindow * kPrologueThreads ? &act_bf16_kernel<true>
                                                         : &act_bf16_kernel<false>;
  kernel<<<N, kPrologueThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k,
      static_cast<__nv_bfloat16*>(xa));
  return (int)cudaGetLastError();
}

// K5: xa (N, Kp) bf16, packed (Kp * bits / 8, Mp) uint8 (bits 3: the lo
// plane (Kp / 4, Mp) and packed_hi, the hi plane (Kp / 8, Mp); else
// packed_hi null), scales/sub (G, Mp) bf16 (scale_f32 0) or f32
// (scale_f32 1), residual (N, Mp) bf16 or null -> out (N, Mp) f32.  bits 1
// to 4 or 8 (signed codes); gs 16 or a multiple of 32; Kp a multiple of gs;
// every plane's rows a multiple of 64; Mp of 128; xa 16-byte aligned.
extern "C" int tmac_qgemm_dequant(const void* xa, int N, int Kp, int gs,
                                  int bits, const void* packed, const void* packed_hi,
                                  int Mp, const void* scales, const void* sub,
                                  int scale_f32, const void* residual, float* out,
                                  void* stream) {
  const int p = bits == 8 ? 1 : bits == 3 ? 4 : bits >= 1 && bits <= 4 ? 8 / bits : 0;
  if (N <= 0 || !(gs == 16 || (gs > 0 && gs % 32 == 0)) || Mp % k5BM != 0 || p == 0 ||
      (bits == 3) != (packed_hi != nullptr) || Kp % gs != 0 || Kp % p != 0 ||
      (Kp / p) % 64 != 0 || (bits == 3 && (Kp / 8) % 64 != 0))
    return (int)cudaErrorInvalidValue;
  // xa as a 2-D tensor (Kp columns innermost, N rows), boxes of 64 x 256
  // with the 128-byte swizzle; rows past N read as zeros
  CUtensorMap map;
  const int err = tmac::bf16_box_map(&map, xa, N, Kp, k5BN);
  if (err != 0) return err;
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* ph = static_cast<const uint8_t*>(packed_hi);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (scale_f32) {
    switch (bits) {
      case 1: return launch_dequant_wgmma<1, float>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
      case 2: return launch_dequant_wgmma<2, float>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
      case 3: return launch_dequant_wgmma<3, float>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
      case 4: return launch_dequant_wgmma<4, float>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
      default: return launch_dequant_wgmma<8, float>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
    }
  }
  switch (bits) {
    case 1: return launch_dequant_wgmma<1, __nv_bfloat16>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
    case 2: return launch_dequant_wgmma<2, __nv_bfloat16>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
    case 3: return launch_dequant_wgmma<3, __nv_bfloat16>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
    case 4: return launch_dequant_wgmma<4, __nv_bfloat16>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
    default: return launch_dequant_wgmma<8, __nv_bfloat16>(map, N, Kp, gs, pk, ph, Mp, scales, sub, res, out, s);
  }
}
