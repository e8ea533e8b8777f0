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
// device memory, so the tensor cores bound both.  The design feeds them
// from shared memory with mma.sync (m16n8k32 s8 for K3, m16n8k16 bf16 for
// K5): a block computes a 64 x 128 (K3) or 128 x 128 (K5) tile of outputs,
// its warps 32 x 64 each; each depth step the block's threads load the next
// tile of activations and packed weights into registers while the warps
// multiply the current one out of shared memory, then store it there, so
// the loads overlap the products.  Each weight tile is unpacked once per
// block (K5: dequantized to bf16 then), so the packed bytes are read once
// per 64 or 128 rows of x.
//
// Layouts.  Field j of packed row r holds the weight of k = r + j * Kp / p
// (p fields a byte).  K3 at bits 2 multiplies in the order k' = 4r + j,
// the order in which K1's prologue writes the codes (byte j of word r):
// four consecutive k' are then the four fields of one packed byte, which is
// what one register of an m16n8k32 B fragment holds, so a thread turns one
// 32-bit word of 4 columns into the B registers of 4 n8 tiles with byte
// permutes (its n8 tile t takes columns 4c + t, put back in the epilogue).
// At bits 8 (the int8 head) k' = k.  K5 multiplies in natural k order: a
// depth step takes R = 64 / p packed rows and yields p runs of R
// consecutive k, one scale group each, which the A tile gathers from the
// same p column runs of xa.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

namespace {

__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float acc[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
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
constexpr int k5BM = 128, k5BN = 128, k5KT = 64, k5Threads = 256;
constexpr int k5AStride = k5KT + 8;  // bf16 a row of the A tile (144 bytes)
constexpr int k5BStride = k5BN + 8;  // bf16 a row of the B tile (272 bytes)

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

template <int BITS>
__global__ void __launch_bounds__(k5Threads) dequant_gemm_kernel(
    const __nv_bfloat16* __restrict__ xa, int N, int Kp, int gs,
    const uint8_t* __restrict__ packed, int Mp,
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ sub,
    const __nv_bfloat16* __restrict__ residual, float* __restrict__ out) {
  constexpr int P = 8 / BITS;
  constexpr int R = k5KT / P;  // packed rows a depth step
  constexpr uint32_t kMask = (1u << BITS) - 1;
  constexpr int kAChunks = k5BM * k5KT / 8 / k5Threads;  // 16-byte loads a thread
  constexpr int kBTasks = R * k5BN / 8 / k5Threads;      // 8 packed bytes each
  __shared__ __align__(16) __nv_bfloat16 As[k5BM * k5AStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[k5KT * k5BStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int m0 = blockIdx.x * k5BN, n0 = blockIdx.y * k5BM;
  const int Kb = Kp / P, nchunks = Kb / gs, ntiles = Kb / R;

  // tile column kk = j * R + i holds k = j * Kb + r0 + i (r0 = t * R)
  uint4 ra[kAChunks];
  uint2 rb[kBTasks];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * k5Threads, row = c >> 3, kk = (c & 7) * 8;
      const int k = (kk / R) * Kb + t * R + kk % R;
      ra[i] = n0 + row < N
                  ? __ldg(reinterpret_cast<const uint4*>(xa + (size_t)(n0 + row) * Kp + k))
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBTasks; ++i) {
      const int c = tid + i * k5Threads;
      rb[i] = __ldg(reinterpret_cast<const uint2*>(
          packed + (size_t)(t * R + (c >> 4)) * Mp + m0 + (c & 15) * 8));
    }
  };
  auto store = [&](int t) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * k5Threads;
      *reinterpret_cast<uint4*>(As + (c >> 3) * k5AStride + (c & 7) * 8) = ra[i];
    }
    const int chunk = t * R / gs;
#pragma unroll
    for (int i = 0; i < kBTasks; ++i) {
      const int c = tid + i * k5Threads, row = c >> 4, col = (c & 15) * 8;
      const uint32_t lo = rb[i].x, hi = rb[i].y;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const size_t gofs = (size_t)(j * nchunks + chunk) * Mp + m0 + col;
        const uint4 sv = __ldg(reinterpret_cast<const uint4*>(scales + gofs));
        const uint4 zv = __ldg(reinterpret_cast<const uint4*>(sub + gofs));
        const __nv_bfloat16* s8 = reinterpret_cast<const __nv_bfloat16*>(&sv);
        const __nv_bfloat16* z8 = reinterpret_cast<const __nv_bfloat16*>(&zv);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t byte = (((e + u) < 4 ? lo : hi) >> (8 * ((e + u) & 3))) & 0xFFu;
            const float code = (float)((byte >> (BITS * j)) & kMask);
            // code * scale is exact, so this is the reference's one rounding
            v[u] = __fmaf_rn(code, __bfloat162float(s8[e + u]),
                             -__bfloat162float(z8[e + u]));
          }
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
          w[e / 2] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(Bs + (j * R + row) * k5BStride + col) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
#pragma unroll
    for (int ks = 0; ks < k5KT / 16; ++ks) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], As + (wm + mt * 16 + (lane & 15)) * k5AStride + ks * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * k5BStride +
                                 wn + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      store(t + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm + mt * 16 + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int m = m0 + wn + nt * 8 + 2 * tq;
        float o0 = acc[mt][nt][2 * h], o1 = acc[mt][nt][2 * h + 1];
        if (residual != nullptr) {
          o0 = __fadd_rn(o0, __bfloat162float(residual[(size_t)n * Mp + m]));
          o1 = __fadd_rn(o1, __bfloat162float(residual[(size_t)n * Mp + m + 1]));
        }
        *reinterpret_cast<float2*>(out + (size_t)n * Mp + m) = make_float2(o0, o1);
      }
    }
  }
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
// a multiple of 32; Kp a multiple of gs * 8 / bits; Mp of 128.
extern "C" int tmac_qgemm_dequant(const void* xa, int N, int Kp, int gs,
                                  int bits, const void* packed, int Mp,
                                  const void* scales, const void* sub,
                                  const void* residual, float* out,
                                  void* stream) {
  if (N <= 0 || gs <= 0 || gs % 32 != 0 || Mp % k5BN != 0 ||
      (bits != 2 && bits != 4) || Kp % (gs * (8 / bits)) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Mp / k5BN, (N + k5BM - 1) / k5BM);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(xa);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(sub);
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(residual);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 2)
    dequant_gemm_kernel<2><<<grid, k5Threads, 0, s>>>(a, N, Kp, gs, pk, Mp, sc, sb,
                                                      res, out);
  else
    dequant_gemm_kernel<4><<<grid, k5Threads, 0, s>>>(a, N, Kp, gs, pk, Mp, sc, sb,
                                                      res, out);
  return (int)cudaGetLastError();
}
