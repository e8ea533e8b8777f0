// K10: a decode step's residual block in one program, for Hopper.
//
// Replaces tmac_tpu/ops/pallas/block_kernel.py::wo_mlp_block
// (_make_block_kernel), which the JAX package runs for each BitNet layer at
// one token when TMAC_BLOCK_KERNEL=1.  For one row (N = 1) and per-tensor
// bits-2 weights it computes, every f32 step as XLA compiles the reference
// (the reference's interpret-mode kernel, read from its optimized HLO):
//   1. q1, s1 = quantize(f32(attn))            (absmax int8 codes, scale
//                                               max(amax, 1e-20) * (1/127))
//   2. x2 = fma(acc * scale, s1, -(Q1 * s1) * sub) + resid   (wo; Q = code sum)
//   3. q2, s2 = quantize((x2 * r) * norm_w),  r = 1 / sqrt(sum(x2^2) / H + eps)
//   4. gu = fma(acc * scale, s2, -(Q2 * s2) * sub)            (gate_up, f32)
//   5. q3, s3 = quantize(g * (1 / (1 + exp(-g))) * u)  over the Ip columns
//   6. out = fma(acc * scale, s3, -(Q3 * s3) * sub) + x2       (down)
// with the sum of squares in XLA's window order (act_prologue.cuh), so it
// equals its plain version bit for bit.
//
// What bounds it: the three matmuls read 23.4 MB of packed weights a BitNet
// layer for 1 row, 4 multiply-adds a byte, so device-memory bytes bound it
// (about 7 us a layer at 3.35 TB/s).  One program saves two launches a layer
// and lets a phase start as soon as the one before has ended everywhere.
//
// Each phase needs the whole of the one before (a row's absmax, its norm),
// which the TPU kernel gets from its sequential grid.  Here the blocks stay
// resident for the whole block (one a multiprocessor) and meet at a
// grid-wide barrier after the wo and after the gate_up phase.  Each block
// redoes the short row work of a phase boundary itself (quantize attn; norm
// and quantize x2; SwiGLU and quantize gu, at most a few thousand values,
// into its shared memory), which costs less than another barrier.  The
// matmul phases are K1's N = 1 loop (act_prologue.cuh's unpack_cols and
// dp4a): a block takes a strip of 32 columns at a time, its 512 threads as
// 8 column groups x 64 slices of the packed rows, and adds the 64 slices'
// exact int32 partials in shared memory.
//
// The barrier: a cooperative launch (cudaLaunchCooperativeKernel) and
// grid.sync().  A barrier on a device counter was the other candidate; on
// the H100 (CUDA 12.8) both equalled the plain version bit for bit and both
// were captured and replayed by a CUDA graph, at 40.9 and 40.0 us a
// BitNet-3B layer.  The cooperative launch is kept: it refuses a grid that
// cannot be resident at once instead of hanging, and keeps no state across
// launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kTX = 8;           // column groups of 4 in a strip
constexpr int kTY = 64;          // packed-row slices
constexpr int kCols = 4 * kTX;   // columns of a strip

struct Linear {
  const uint8_t* packed;  // (K / 4, M) bits-2 fields
  const float* scales;    // (M,)
  const float* sub;       // (M,)
};

struct Args {
  const __nv_bfloat16* attn;    // (H,)
  const __nv_bfloat16* resid;   // (H,)
  const __nv_bfloat16* norm_w;  // (H,)
  float eps, inv_h;
  int H, I2, Ip;
  Linear wo, gu, dn;
  float* x2;      // (H,) scratch
  float* gu_out;  // (I2,) scratch
  float* out;     // (H,)
};

struct Smem {
  float* vals;     // a phase's f32 row, max(H, Ip)
  int8_t* codes;   // its int8 codes in dp4a grouping
  int* red;        // kTY x kCols partial sums
  float* scratch;  // kThreads floats: window sums and reductions
};

// The row vals[0, K) -> codes (byte j of word q: k = q + j * K / 4), and
// (scale, code sum times scale) as the reference rounds them.
__device__ float2 quantize(const Smem& s, int K) {
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(s.vals[k]));
  amax = tmac::block_reduce(amax, tmac::MaxOp(), s.scratch);
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  const int nq = K / 4;
  int qsum = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int q = (int)fminf(fmaxf(rintf(s.vals[k] / sc), -127.f), 127.f);
    qsum += q;
    s.codes[(k % nq) * 4 + k / nq] = (int8_t)q;
  }
  qsum = tmac::block_reduce(qsum, tmac::SumOp(), reinterpret_cast<int*>(s.scratch));
  __syncthreads();  // codes complete
  return make_float2(sc, __fmul_rn((float)qsum, sc));
}

// One matmul phase over the block's strips of 32 columns; store(m, o)
// takes each output o = fma(acc * scale, sc, -(zsc * sub)).
template <typename Store>
__device__ void matmul_phase(const Smem& s, const Linear& w, int K, int M,
                             float2 q, Store store) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int nq = K / 4;
  const int32_t* codes4 = reinterpret_cast<const int32_t*>(s.codes);
  for (int strip = blockIdx.x; strip < M / kCols; strip += gridDim.x) {
    const int m0 = strip * kCols + 4 * tx;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll 8
    for (int r = ty; r < nq; r += kTY) {
      uint32_t col[4];
      tmac::unpack_cols<2>(w.packed, r, M, m0, col);
      const int xv = codes4[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = __dp4a((int)col[c], xv, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s.red[ty * kCols + 4 * tx + c] = acc[c];
    __syncthreads();
    // exact integer sums in two levels: 16 groups of 4 slices, then 16
    const int c = threadIdx.x % kCols, part = threadIdx.x / kCols;
    int v = 0;
#pragma unroll
    for (int t = 0; t < kTY / 16; ++t) v += s.red[(part * (kTY / 16) + t) * kCols + c];
    __syncthreads();
    s.red[part * kCols + c] = v;
    __syncthreads();
    if (threadIdx.x < kCols) {
      int sum = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) sum += s.red[t * kCols + threadIdx.x];
      const int m = strip * kCols + threadIdx.x;
      const float zero_fold = -__fmul_rn(q.y, w.sub[m]);
      store(m, __fmaf_rn(__fmul_rn((float)sum, w.scales[m]), q.x, zero_fold));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kmax = max(a.H, a.Ip);
  Smem s;
  s.vals = reinterpret_cast<float*>(smem);
  s.codes = reinterpret_cast<int8_t*>(s.vals + kmax);
  s.red = reinterpret_cast<int*>(s.codes + ((kmax + 15) / 16) * 16);
  s.scratch = reinterpret_cast<float*>(s.red + kTY * kCols);

  // phases 1-2: quantize attn; wo + resid -> x2
  for (int k = threadIdx.x; k < a.H; k += kThreads) s.vals[k] = __bfloat162float(a.attn[k]);
  __syncthreads();
  float2 q = quantize(s, a.H);
  matmul_phase(s, a.wo, a.H, a.H, q, [&](int m, float o) {
    a.x2[m] = __fadd_rn(o, __bfloat162float(a.resid[m]));
  });
  cg::this_grid().sync();

  // phases 3-4: rms_norm x2 and quantize; gate_up -> gu (f32)
  for (int k = threadIdx.x; k < a.H; k += kThreads) s.vals[k] = __ldcg(a.x2 + k);
  __syncthreads();
  const float sumsq = tmac::sum_xla_order(
      [&](int k) { return __fmul_rn(s.vals[k], s.vals[k]); }, a.H, s.scratch);
  const float rs = tmac::rms_factor(sumsq, a.inv_h, a.eps);
  for (int k = threadIdx.x; k < a.H; k += kThreads)
    s.vals[k] = __fmul_rn(__fmul_rn(s.vals[k], rs), __bfloat162float(a.norm_w[k]));
  __syncthreads();
  q = quantize(s, a.H);
  matmul_phase(s, a.gu, a.H, a.I2, q, [&](int m, float o) { a.gu_out[m] = o; });
  cg::this_grid().sync();

  // phases 5-6: SwiGLU and quantize; down + x2 -> out
  for (int k = threadIdx.x; k < a.Ip; k += kThreads) {
    const float g = __ldcg(a.gu_out + k), u = __ldcg(a.gu_out + a.Ip + k);
    s.vals[k] = __fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), u);
  }
  __syncthreads();
  q = quantize(s, a.Ip);
  matmul_phase(s, a.dn, a.Ip, a.H, q, [&](int m, float o) {
    a.out[m] = __fadd_rn(o, __ldcg(a.x2 + m));
  });
}

size_t smem_bytes(int H, int Ip) {
  const int kmax = H > Ip ? H : Ip;
  return (size_t)kmax * 4 + ((kmax + 15) / 16) * 16 + kTY * kCols * 4 + kThreads * 4;
}

}  // namespace

// attn, resid, norm_w (H,) bf16; wo (H/4, H), gate_up (H/4, I2), down
// (Ip/4, H) packed bits-2 fields with (M,) f32 scales and sub; x2 (H,) and
// gu (I2,) f32 scratch -> out (H,) f32.  H, I2 multiples of 32 and Ip of
// 16, I2 == 2 * Ip, max(H, Ip) <= 16384.  Returns the launch's CUDA
// error.
extern "C" int tmac_wo_mlp_block(
    const void* attn, const void* resid, const void* norm_w, float eps,
    float inv_h, int H, int I2, int Ip, const void* wo_p, const float* wo_s,
    const float* wo_z, const void* gu_p, const float* gu_s, const float* gu_z,
    const void* dn_p, const float* dn_s, const float* dn_z, float* x2,
    float* gu, float* out, void* stream) {
  if (H % kCols != 0 || I2 % kCols != 0 || Ip % 16 != 0 || I2 != 2 * Ip ||
      (H > Ip ? H : Ip) > tmac::kSumWindow * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, Ip);
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_kernel,
                                                            kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  auto lin = [](const void* p, const float* sc, const float* z) {
    return Linear{static_cast<const uint8_t*>(p), sc, z};
  };
  Args a{static_cast<const __nv_bfloat16*>(attn),
         static_cast<const __nv_bfloat16*>(resid),
         static_cast<const __nv_bfloat16*>(norm_w), eps, inv_h, H, I2, Ip,
         lin(wo_p, wo_s, wo_z), lin(gu_p, gu_s, gu_z), lin(dn_p, dn_s, dn_z),
         x2, gu, out};
  // one block a multiprocessor, every block resident at once
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)block_kernel, dim3(sms),
                                          dim3(kThreads), args, smem,
                                          (cudaStream_t)stream);
}
