// K3 and K5: the large-N matmuls of a prefill, for Hopper.
//
// Both replace tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel in the two
// forms that qgemm_pallas(act="fused") takes from N >= 64 rows of x: one
// dot over the whole unpacked depth instead of per-field or per-group dots.
//
// K3 (single_dot=True: per-tensor scales, bits 2 or 8; the reference runs
// it after an XLA prologue) takes the int8 codes, row scales xs and bare
// code sums q of K1's prologue (qgemm_fused.cu, large_n) and computes
//   acc = codes (N, Kp) @ weight codes (Kp, Mp), an exact int32 dot
//   out = fma(acc, scale, -q * sub) * xs, or
//         fma(fma(acc, scale, -q * sub), xs, residual)
// which is the f32 epilogue XLA compiles the reference's to.  Integer sums
// are exact in any order, so K3 equals its plain version bit for bit.
//
// K5 (dequant_dot=True: grouped scales, bits 2 or 4; the reference takes
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
// K3 feeds them from shared memory with mma.sync m16n8k32 s8: a block
// computes a 64 x 128 tile of outputs, its warps 32 x 64 each; each depth
// step the block's threads load the next tile of activations and packed
// weights into registers while the warps multiply the current one out of
// shared memory, then store it there, so the loads overlap the products.
// Each weight tile is unpacked once per block, so the packed bytes are read
// once per 64 rows of x.  Field j of packed row r holds the weight of
// k = r + j * Kp / p (p fields a byte).  K3 at bits 2 multiplies in the
// order k' = 4r + j, the order in which K1's prologue writes the codes
// (byte j of word r): four consecutive k' are then the four fields of one
// packed byte, which is what one register of an m16n8k32 B fragment holds,
// so a thread turns one 32-bit word of 4 columns into the B registers of 4
// n8 tiles with byte permutes (its n8 tile t takes columns 4c + t, put back
// in the epilogue).  At bits 8 (the int8 head) k' = k.
//
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

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

// Hopper building blocks of K5: mbarriers, a 2-D TMA load, the wgmma
// shared-memory descriptor with the 128-byte swizzle, wgmma.m64n128k16
// (bf16 in, f32 accumulators), and the TMA tensor map of a bf16 matrix.
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

// The TMA map of a bf16 matrix (rows, cols), row-major, in boxes of 64
// columns (128 bytes, the 128-byte swizzle) x box_rows rows; rows past the
// end read as zeros.  cuTensorMapEncodeTiled comes from the driver through
// the runtime (no link against libcuda).  Returns a CUDA error (0 on
// success).
inline int bf16_box_map(CUtensorMap* map, const void* base, int rows, int cols,
                        int box_rows) {
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
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace tmac

namespace {

__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int k3BM = 64, k3BN = 128, k3KT = 128, k3Threads = 128;
constexpr int k3AStride = k3KT + 16;  // bytes a row of the A tile
// the B tile: bits 2, k3KT / 4 packed rows of 160 bytes; bits 8, k3KT code
// rows of 136 bytes (strides that spread a warp's fragment reads over the
// 32 banks)
template <int BITS>
struct K3B {
  static constexpr int kRows = BITS == 2 ? k3KT / 4 : k3KT;
  static constexpr int kStride = BITS == 2 ? 160 : 136;
  static constexpr int kChunks = kRows * k3BN / 16 / k3Threads;  // 16-byte loads a thread
};

template <int BITS>
__global__ void __launch_bounds__(k3Threads) large_int_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ xs,
    const float* __restrict__ xsum, int N, int Kp,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const float* __restrict__ sub, int Mp,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  using B = K3B<BITS>;
  __shared__ __align__(16) uint8_t As[k3BM * k3AStride];
  __shared__ __align__(16) uint8_t Bs[B::kRows * B::kStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 64;
  const int m0 = blockIdx.x * k3BN, n0 = blockIdx.y * k3BM;
  const int brows = BITS == 2 ? Kp / 4 : Kp;  // packed rows in all
  const int ntiles = (Kp + k3KT - 1) / k3KT;

  uint4 ra[k3BM * k3KT / 16 / k3Threads], rb[B::kChunks];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < k3BM * k3KT / 16 / k3Threads; ++i) {
      const int c = tid + i * k3Threads, row = c >> 3, k = t * k3KT + (c & 7) * 16;
      ra[i] = (n0 + row < N && k < Kp)
                  ? __ldg(reinterpret_cast<const uint4*>(codes + (size_t)(n0 + row) * Kp + k))
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < B::kChunks; ++i) {
      const int c = tid + i * k3Threads, row = t * B::kRows + (c >> 3);
      rb[i] = row < brows
                  ? __ldg(reinterpret_cast<const uint4*>(packed + (size_t)row * Mp + m0 + (c & 7) * 16))
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < k3BM * k3KT / 16 / k3Threads; ++i) {
      const int c = tid + i * k3Threads;
      *reinterpret_cast<uint4*>(As + (c >> 3) * k3AStride + (c & 7) * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B::kChunks; ++i) {
      const int c = tid + i * k3Threads;
      uint32_t* d = reinterpret_cast<uint32_t*>(Bs + (c >> 3) * B::kStride + (c & 7) * 16);
      d[0] = rb[i].x;  // 4-byte stores: the bits-8 stride is not 16-aligned
      d[1] = rb[i].y;
      d[2] = rb[i].z;
      d[3] = rb[i].w;
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  load(0);
  store();
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
#pragma unroll
    for (int ks = 0; ks < k3KT / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* p = As + (wm + mt * 16 + g) * k3AStride + ks * 32 + tq * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * k3AStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * k3AStride + 16);
      }
      // b[h][t]: B register h (k' + 16 h) of n8 tile t; tile t < 4 takes
      // columns wn + 4c + t, tile t >= 4 columns wn + 32 + 4c + t - 4
      uint32_t b[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int word = (wn >> 2) + half * 8 + g;
          uint32_t col[4];
          if (BITS == 2) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                Bs + (ks * 8 + h * 4 + tq) * B::kStride + 4 * word);
            tmac::transpose4(w & 0x03030303u, (w >> 2) & 0x03030303u,
                             (w >> 4) & 0x03030303u, (w >> 6) & 0x03030303u, col);
          } else {
            const uint8_t* p = Bs + (ks * 32 + h * 16 + tq * 4) * B::kStride + 4 * word;
            tmac::transpose4(*reinterpret_cast<const uint32_t*>(p),
                             *reinterpret_cast<const uint32_t*>(p + B::kStride),
                             *reinterpret_cast<const uint32_t*>(p + 2 * B::kStride),
                             *reinterpret_cast<const uint32_t*>(p + 3 * B::kStride), col);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) b[h][half * 4 + c] = col[c];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], a[mt], b[0][nt], b[1][nt]);
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      store();
      __syncthreads();
    }
  }

  // the epilogue: accumulator (mt, nt, 2 h + e) is row wm + 16 mt + g + 8 h
  // and column 4 (2 tq + e) + nt of the tile's columns wn (+ 32 for nt >= 4),
  // so tiles 0..3 (and 4..7) give 4 adjacent columns: one float4 store
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm + mt * 16 + g + 8 * h;
      if (n >= N) continue;
      const float x_s = xs[n], q = xsum[n];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wn + half * 32 + 4 * (2 * tq + e);
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float zero_fold = -__fmul_rn(q, sub[m + c]);
            const float v = __fmaf_rn((float)acc[mt][half * 4 + c][2 * h + e],
                                      scales[m + c], zero_fold);
            o[c] = residual != nullptr
                       ? __fmaf_rn(v, x_s, __bfloat162float(residual[(size_t)n * Mp + m + c]))
                       : __fmul_rn(v, x_s);
          }
          *reinterpret_cast<float4*>(out + (size_t)n * Mp + m) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
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

// xa (N, Kp) bf16: the prologue values rounded to bf16, one block a row.
__global__ void __launch_bounds__(kPrologueThreads) act_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, int x_cols, int K, int Kp, int glu,
    const __nv_bfloat16* __restrict__ norm_w, float eps, float inv_norm_k,
    __nv_bfloat16* __restrict__ xa) {
  __shared__ float scratch[kPrologueThreads];
  const int n = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)n * x_cols;
  float rs = 1.f;
  if (norm_w != nullptr)
    rs = tmac::rms_factor(tmac::sumsq_xla_order(xr, K, Kp, glu, scratch),
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
template <int BITS>
__global__ void __launch_bounds__(k5Threads, 1) dequant_wgmma_kernel(
    const __grid_constant__ CUtensorMap xa_map, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, int Mp,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  constexpr int P = 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + k5Stages * k5Stage);
  uint64_t* empty = full + k5Stages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * k5BM, n0 = blockIdx.y * k5BN;
  const int Kb = Kp / P, nsteps = Kp / 64;
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
  uint4 sv[2], zv[2];  // [0]: the next step to dequantize, [1]: the one after
  auto load_packed = [&](int rb, uint2 (&dst)[k5Chunks]) {
#pragma unroll
    for (int i = 0; i < k5Chunks; ++i)
      dst[i] = __ldg(reinterpret_cast<const uint2*>(
          packed + (size_t)(rb * 64 + rlo + (k5Threads / 16) * i) * Mp + col));
  };
  auto load_scales = [&](int step, uint4& s4, uint4& z4) {
    const int g = ((step % P) * Kb + (step / P) * 64 + rlo) / gs;
    s4 = __ldg(reinterpret_cast<const uint4*>(scales + (size_t)g * Mp + col));
    z4 = __ldg(reinterpret_cast<const uint4*>(sub + (size_t)g * Mp + col));
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
    auto convert = [&](uint4 s4, uint4 z4) {
      const __nv_bfloat16* s8 = reinterpret_cast<const __nv_bfloat16*>(&s4);
      const __nv_bfloat16* z8 = reinterpret_cast<const __nv_bfloat16*>(&z4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sf[e] = __bfloat162float(s8[e]);
        zf[e] = -__bfloat162float(z8[e]);
      }
    };
    if (j == 0 && step > 0) {
#pragma unroll
      for (int i = 0; i < k5Chunks; ++i) pk[i] = pk_next[i];
      if (step / P + 1 < Kb / 64) load_packed(step / P + 1, pk_next);
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
        convert(__ldg(reinterpret_cast<const uint4*>(scales + (size_t)g * Mp + col)),
                __ldg(reinterpret_cast<const uint4*>(sub + (size_t)g * Mp + col)));
      }
      // field j of the 8 columns' bytes at bit 8 e
      const uint32_t lo = pk[i].x >> (BITS * j), hi = pk[i].y >> (BITS * j);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t code = (((e + u) < 4 ? lo : hi) >> (8 * ((e + u) & 3))) & kMask;
          // 2^23 + code, less 2^23: the code as a float, exactly, without
          // the quarter-rate int-to-float conversion; code * scale is
          // exact, so the fma is the reference's one rounding
          const float cf = __fsub_rn(__uint_as_float(0x4B000000u | code), 8388608.0f);
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
  load_packed(0, pk);
  if (Kb / 64 > 1) load_packed(1, pk_next);
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

template <int BITS>
int launch_dequant_wgmma(const CUtensorMap& map, int N, int Kp, int gs,
                         const uint8_t* packed, int Mp, const __nv_bfloat16* scales,
                         const __nv_bfloat16* sub, const __nv_bfloat16* residual,
                         float* out, cudaStream_t stream) {
  auto kernel = dequant_wgmma_kernel<BITS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k5Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Mp / k5BM, (N + k5BN - 1) / k5BN);
  kernel<<<grid, k5Threads, k5Smem, stream>>>(map, N, Kp, gs, packed, Mp, scales, sub,
                                              residual, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: codes (N, Kp) int8 from tmac_act_quant with large_n (dp4a grouping),
// xs and xsum (N,) f32, packed (Kp/4, Mp) (bits=2) or (Kp, Mp) (bits=8)
// uint8, scales/sub (Mp,) f32, residual (N, Mp) bf16 or null -> out (N, Mp)
// f32.  Kp a multiple of 16, Mp of 128.  Returns the launch's CUDA error.
extern "C" int tmac_qgemm_large_int(const void* codes, const float* xs,
                                    const float* xsum, int N, int Kp, int bits,
                                    const void* packed, const float* scales,
                                    const float* sub, int Mp,
                                    const void* residual, float* out,
                                    void* stream) {
  if (N <= 0 || Kp <= 0 || Kp % 16 != 0 || Mp % k3BN != 0 ||
      (bits != 2 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Mp / k3BN, (N + k3BM - 1) / k3BM);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2)
    large_int_kernel<2><<<grid, k3Threads, 0, s>>>(c, xs, xsum, N, Kp, pk, scales,
                                                   sub, Mp, res, out);
  else
    large_int_kernel<8><<<grid, k3Threads, 0, s>>>(c, xs, xsum, N, Kp, pk, scales,
                                                   sub, Mp, res, out);
  return (int)cudaGetLastError();
}

// K5's prologue: x (N, x_cols) bf16 -> xa (N, Kp) bf16.  norm_w (K,) bf16 or
// null.  Returns the launch's CUDA error.
extern "C" int tmac_act_bf16(const void* x, int N, int x_cols, int K, int Kp,
                             int glu, const void* norm_w, float eps,
                             float inv_norm_k, void* xa, void* stream) {
  if (N <= 0 || Kp > tmac::kSumWindow * kPrologueThreads)
    return (int)cudaErrorInvalidValue;
  act_bf16_kernel<<<N, kPrologueThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_cols, K, Kp, glu,
      static_cast<const __nv_bfloat16*>(norm_w), eps, inv_norm_k,
      static_cast<__nv_bfloat16*>(xa));
  return (int)cudaGetLastError();
}

// K5: xa (N, Kp) bf16, packed (Kp * bits / 8, Mp) uint8, scales/sub (G, Mp)
// bf16, residual (N, Mp) bf16 or null -> out (N, Mp) f32.  bits 2 or 4; gs
// a multiple of 32; Kp a multiple of gs * 8 / bits and Kp * bits / 8 of 64;
// Mp of 128; xa 16-byte aligned.
extern "C" int tmac_qgemm_dequant(const void* xa, int N, int Kp, int gs,
                                  int bits, const void* packed, int Mp,
                                  const void* scales, const void* sub,
                                  const void* residual, float* out,
                                  void* stream) {
  if (N <= 0 || gs <= 0 || gs % 32 != 0 || Mp % k5BM != 0 ||
      (bits != 2 && bits != 4) || Kp % (gs * (8 / bits)) != 0 ||
      (Kp / (8 / bits)) % 64 != 0)
    return (int)cudaErrorInvalidValue;
  // xa as a 2-D tensor (Kp columns innermost, N rows), boxes of 64 x 256
  // with the 128-byte swizzle; rows past N read as zeros
  CUtensorMap map;
  const int err = tmac::bf16_box_map(&map, xa, N, Kp, k5BN);
  if (err != 0) return err;
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(sub);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2)
    return launch_dequant_wgmma<2>(map, N, Kp, gs, pk, Mp, sc, sb, res, out, s);
  return launch_dequant_wgmma<4>(map, N, Kp, gs, pk, Mp, sc, sb, res, out, s);
}
