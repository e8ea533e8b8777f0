// K10: a decode step's residual block in one program, for Hopper.
//
// Replaces tmac_tpu/ops/pallas/block_kernel.py::wo_mlp_block
// (_make_block_kernel), which the JAX package runs for each BitNet layer at
// one token when TMAC_BLOCK_KERNEL=1.  For one row (N = 1) and per-tensor
// weights at bits 1, 2 or 4 (BITS, a template instance each; the model
// runs bits 2, BitNet's) it computes, every f32 step as XLA compiles the reference
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
// What bounds it: the three matmuls read 23.3 MB of packed weights a BitNet
// layer for 1 row, 4 multiply-adds a byte, so device-memory bytes bound it
// (7.0 us a layer at 3.35 TB/s).  Each phase needs the whole of the one
// before (a row's absmax, its norm), which the TPU kernel gets from its
// sequential grid; here the blocks stay resident (a cooperative launch, one
// block an SM) and meet at grid-wide barriers.  On the card what costs is
// latency, not bytes: every round trip to memory behind the weight stream
// takes 1-2 us.  The design keeps the weights streaming across the
// barriers and spends as few round trips as it can:
//
// - One stream of weight stages a block, over all three phases.  A phase's
//   work is cut into units: (strip of 128 columns, stage of 64 packed rows),
//   numbered strip-major; a static plan, from shapes only, gives block b of
//   B the units [b * T / B, (b + 1) * T / B) of each phase (T its unit
//   count).  The block's units of wo, then of gate_up, then of down form
//   one sequence, fed through a ring of kStages stages in shared memory by
//   cp.async (8 KB a stage, one 16-byte copy a thread, the 16-byte chunks
//   XOR-swizzled by row group as in decode_matmul.cuh).  The ring is kept
//   kStages - 1 stages ahead whatever the phase: the weights do not depend
//   on the activations, so before a block reaches a barrier, and before it
//   does the row work behind it, the first stages of the next phase are
//   already in flight.
// - The codes stay in natural k order: field j of packed row r holds k =
//   j * K / P + r (P = 8 / BITS fields a byte: 4 at bits 2, 2 at bits 4, 8
//   at bits 1, the reference's unpack), so 4 rows' field j meet one 32-bit
//   word of codes in a dp4a (K1's arithmetic: the field masked in place,
//   shifted out exactly by BITS * j when the sums are flushed).  A stage's
//   64 packed rows carry 64 P codes: bits 4 halves, and bits 1 doubles, the
//   fields a thread walks per byte against bits 2.  A warp owns 16 columns of half the stage's
//   rows; its 8 row groups add with shuffles, the two halves in shared
//   memory, and at the end of a strip's units the block adds its exact
//   int32 sums into device memory with integer atomics (exact in any
//   order).  No block waits for them: each matmul's epilogue runs after the
//   next barrier, from the complete sums.
// - The barriers and the row work between them:
//     1. wo; the row work before it (attn's absmax, the codes of the block's
//        own rows, its slice's share of the code sum, added across blocks)
//        overlaps the first stages;
//     barrier; every block computes all of x2 (wo's epilogue + resid, kept
//        in shared memory for down's), the norm and all gate_up's codes;
//     2. gate_up;
//     barrier; block b computes gate_up's epilogue and the SwiGLU on its
//        slice of down's row only, into h, and its absmax;
//     barrier; every block takes the absmax of all, its slice's share of the
//        code sum, and the codes of its own rows of h;
//     3. down;
//     barrier; block b writes down's epilogue + x2 on its slice of the
//        output columns.
//   wo's epilogue operands and the norm weight are copied into shared
//   memory with the first stage.  The sums and counters are left at zero
//   for the next launch by the blocks that read them last.  The rows are
//   staged with a float of padding every 32 values, so that the window sums
//   read distinct banks.
//
// The barrier: cudaLaunchCooperativeKernel and grid.sync(); the launch
// refuses a grid that cannot be resident at once instead of hanging.  The
// grid: as many blocks as the occupancy calculator says fit (one an SM).
// (Measured on an H100, PERF.md's K10 findings: adding each strip's sums
// with an arrival counter, the last block to arrive running the strip's
// epilogue, stalls every block at every flush for a round trip; the
// epilogues after the barriers are faster.)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_prologue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHalves = kWarps / 8;             // warps that share a 16-column chunk
constexpr int kStrip = 128;                     // columns of a unit
constexpr int kStageRows = kThreads / 8;        // packed rows of a unit (and a stage)
constexpr int kStageBytes = kStageRows * kStrip;
constexpr int kStages = 6;
constexpr int kCodePad = 64;                    // codes read past K by a ragged last stage
constexpr int kRowRegs = 8;                     // a row's values a thread loads at once

struct Linear {
  const uint8_t* packed;  // (K / P, M) packed fields
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
  float* h;       // (Ip,) down's input before quantization
  float* amax;    // (gridDim.x,) the blocks' absmax of their slices of h
  float* out;     // (H,)
  int* sums;      // (H + I2 + H,) int32: wo's, gate_up's and down's; zero on
                  // entry and on exit
  int* counts;    // (4,): kQsum1, kQsum3, kRead3; zero on entry and on exit
};

__host__ __device__ constexpr int pad16(int b) { return (b + 15) / 16 * 16; }

// One phase's matmul as the plan cuts it: block b's units [u0, u1)
struct Phase {
  Linear w;
  int K, M, Kb, per_strip, total, u0, u1, sum0;
};

// P: the fields of a packed byte (8 / BITS)
template <int P>
__device__ __forceinline__ Phase make_phase(const Linear& w, int K, int M, int sum0) {
  Phase p;
  p.w = w;
  p.K = K;
  p.M = M;
  p.Kb = K / P;
  p.per_strip = (p.Kb + kStageRows - 1) / kStageRows;
  p.total = (M / kStrip) * p.per_strip;
  p.u0 = (int)blockIdx.x * p.total / (int)gridDim.x;
  p.u1 = ((int)blockIdx.x + 1) * p.total / (int)gridDim.x;
  p.sum0 = sum0;
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the int8 code of v at scale sc, as the reference rounds it (a true
// division)
__device__ __forceinline__ int quant(float v, float sc) {
  return (int)fminf(fmaxf(rintf(v / sc), -127.f), 127.f);
}

// the f32 epilogue of an output column m on its exact int32 sum:
// fma(acc * scale, sc, -(xsum * sub))
__device__ __forceinline__ float epilogue(int acc, const Linear& w, int m, float sc,
                                          float xsum) {
  return __fmaf_rn(__fmul_rn((float)acc, __ldg(w.scales + m)), sc,
                   -__fmul_rn(xsum, __ldg(w.sub + m)));
}

// the counters: the code sums of wo's and down's rows, added across blocks,
// and the blocks that have read down's
constexpr int kQsum1 = 0, kQsum3 = 1, kRead3 = 2;

// Shared memory, byte offsets (16-byte aligned): the ring; the staged row;
// x2; wo's scales and sub (f32), resid and norm_w (bf16); the codes; the
// halves' sums; reduction scratch
struct Layout {
  int vals, x2, ops, codes, xch, scratch, total;
  __host__ __device__ Layout(int H, int Ip) {
    const int kmax = H > Ip ? H : Ip;
    vals = kStages * kStageBytes;
    x2 = vals + pad16(4 * tmac::staged_floats(kmax));
    ops = x2 + pad16(4 * H);
    codes = ops + pad16(12 * H);
    xch = codes + pad16(kmax + kCodePad);
    scratch = xch + 4 * kHalves * kStrip;
    total = scratch + 4 * kThreads;
  }
};

struct Smem {
  uint8_t* ring;
  float* vals;     // a phase's f32 row, staged (tmac::staged)
  float* x2;       // (H,) wo's output plus the residual
  int8_t* codes;   // the phase's int8 codes, natural k order
  float* wsc;      // (H,) wo's scales, then its sub, then resid and norm_w
  float* wsb;      //   (bf16), copied in with the first stage
  __nv_bfloat16* res;
  __nv_bfloat16* nw;
  int* xch;        // kHalves x kStrip: the halves' column sums
  float* scratch;  // kThreads floats: window sums and reductions
};

// The staged row vals[staged(k)], k < K -> codes[k], and (scale, code sum
// times scale) as the reference rounds them.  Max and integer sums do not
// depend on the order.
__device__ float2 quantize(const Smem& s, int K) {
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads)
    amax = fmaxf(amax, fabsf(s.vals[tmac::staged(k)]));
  amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, s.scratch);
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  int qsum = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int q = quant(s.vals[tmac::staged(k)], sc);
    qsum += q;
    s.codes[k] = (int8_t)q;
  }
  qsum = tmac::block_allreduce(qsum, tmac::SumOp(), 0, reinterpret_cast<int*>(s.scratch));
  __syncthreads();  // codes complete
  return make_float2(sc, __fmul_rn((float)qsum, sc));
}

// The codes of the rows the block's units of phase f read, k = j * Kb + r
// for the 64 rows r of each unit: val(k) quantized at sc, into codes[k]
// (items i from `from` on, i = (u - u0) * 64 P + j * 64 + row of the unit)
template <int P, typename Val>
__device__ void unit_codes(const Phase& f, float sc, Val val, int8_t* codes, int from = 0) {
  constexpr int kPer = P * kStageRows;
#pragma unroll 4
  for (int i = from + threadIdx.x; i < (f.u1 - f.u0) * kPer; i += kThreads) {
    const int u = f.u0 + i / kPer, j = (i % kPer) / kStageRows;
    const int r = (u % f.per_strip) * kStageRows + i % kStageRows;
    if (r < f.Kb) codes[j * f.Kb + r] = (int8_t)quant(val(j * f.Kb + r), sc);
  }
}

// the sum over a block's slice [k0, k1) of the codes of val(k) at sc, added
// into *total across blocks
template <typename Val>
__device__ void slice_code_sum(int k0, int k1, float sc, Val val, const Smem& s,
                               int* total) {
  int qs = 0;
  for (int k = k0 + threadIdx.x; k < k1; k += kThreads) qs += quant(val(k), sc);
  qs = tmac::block_allreduce(qs, tmac::SumOp(), 0, reinterpret_cast<int*>(s.scratch));
  if (threadIdx.x == 0) atomicAdd(total, qs);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, 1) block_kernel(Args a) {
  constexpr int P = 8 / BITS;  // fields of a packed byte
  // a field's bits in each of a word's 4 bytes
  constexpr uint32_t kMask = BITS == 1 ? 0x01010101u : BITS == 2 ? 0x03030303u : 0x0F0F0F0Fu;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(a.H, a.Ip);
  Smem s;
  s.ring = smem;
  s.vals = reinterpret_cast<float*>(smem + L.vals);
  s.x2 = reinterpret_cast<float*>(smem + L.x2);
  s.wsc = reinterpret_cast<float*>(smem + L.ops);
  s.wsb = s.wsc + a.H;
  s.res = reinterpret_cast<__nv_bfloat16*>(s.wsb + a.H);
  s.nw = s.res + a.H;
  s.codes = reinterpret_cast<int8_t*>(smem + L.codes);
  s.xch = reinterpret_cast<int*>(smem + L.xch);
  s.scratch = reinterpret_cast<float*>(smem + L.scratch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 2, cw = lane & 3, half = warp / 8, chunk = warp % 8;
  const int B = gridDim.x, b = blockIdx.x;
  cg::grid_group grid = cg::this_grid();
  const Phase ph0 = make_phase<P>(a.wo, a.H, a.H, 0),
              ph1 = make_phase<P>(a.gu, a.H, a.I2, a.H),
              ph2 = make_phase<P>(a.dn, a.Ip, a.H, a.H + a.I2);
  const int n0 = ph0.u1 - ph0.u0, n1 = ph1.u1 - ph1.u0;
  const int total = n0 + n1 + ph2.u1 - ph2.u0;

  // The next stage to load: phase lp, its unit (lstrip, lrs), the phase's
  // units still to load; loads come in sequence, so the cursor only steps
  int lp = 0, lleft = n0, lstrip = ph0.u0 / ph0.per_strip, lrs = ph0.u0 % ph0.per_strip;
  auto next_phase = [&]() {
    while (lleft == 0 && lp < 2) {
      ++lp;
      const Phase& f = lp == 1 ? ph1 : ph2;
      lleft = f.u1 - f.u0;
      lstrip = f.u0 / f.per_strip;
      lrs = f.u0 % f.per_strip;
    }
  };
  next_phase();
  // stage t: 16-byte chunk q of its row i at chunk q ^ ((i / 4) % 8), zero
  // past the packed rows
  auto load = [&](int t) {
    const uint8_t* packed = lp == 0 ? ph0.w.packed : lp == 1 ? ph1.w.packed : ph2.w.packed;
    const int Kb = lp == 0 ? ph0.Kb : lp == 1 ? ph1.Kb : ph2.Kb;
    const int M = lp == 0 ? ph0.M : lp == 1 ? ph1.M : ph2.M;
    const int per_strip = lp == 0 ? ph0.per_strip : lp == 1 ? ph1.per_strip : ph2.per_strip;
    const int i = tid >> 3, q = tid & 7, r = lrs * kStageRows + i;
    const bool ok = r < Kb;
    cp_async16(s.ring + (t % kStages) * kStageBytes + i * kStrip + ((q ^ (i >> 2)) & 7) * 16,
               packed + (size_t)(ok ? r : 0) * M + lstrip * kStrip + q * 16, ok);
    --lleft;
    if (++lrs == per_strip) {
      lrs = 0;
      ++lstrip;
    }
    next_phase();
  };
  // attn first (phase 0's row work waits on it), then the first stages of
  // every phase's weights (they need no activation), with the first of them
  // wo's scales and sub, resid and norm_w for x2 and the norm
  float av[kRowRegs];
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    const int k = tid + i * kThreads;
    av[i] = k < a.H ? __bfloat162float(a.attn[k]) : 0.f;
  }
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) load(t);
    if (t == 0) {
      const int n4 = a.H / 4, n8 = a.H / 8;
      for (int i = tid; i < 2 * n4 + 2 * n8; i += kThreads) {
        if (i < n4)
          cp_async16(s.wsc + 4 * i, a.wo.scales + 4 * i, true);
        else if (i < 2 * n4)
          cp_async16(s.wsb + 4 * (i - n4), a.wo.sub + 4 * (i - n4), true);
        else if (i < 2 * n4 + n8)
          cp_async16(s.res + 8 * (i - 2 * n4), a.resid + 8 * (i - 2 * n4), true);
        else
          cp_async16(s.nw + 8 * (i - 2 * n4 - n8), a.norm_w + 8 * (i - 2 * n4 - n8), true);
      }
    }
    cp_async_commit();
  }

  int t = 0;
  float2 q0 = make_float2(0.f, 0.f);  // wo's activation scale and scaled code sum
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const Phase& f = p == 0 ? ph0 : p == 1 ? ph1 : ph2;
    // the row work of the phase boundary, while the ring's stages stream in
    float2 q;
    if (p == 0) {
      // attn's scale from its absmax; the codes of this block's rows; its
      // slice's share of the code sum, added across blocks
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i)
        if (tid + i * kThreads < a.H) s.vals[tmac::staged(tid + i * kThreads)] = av[i];
      for (int k = tid + kRowRegs * kThreads; k < a.H; k += kThreads)
        s.vals[tmac::staged(k)] = __bfloat162float(a.attn[k]);
      __syncthreads();
      float amax = 0.f;
      for (int k = tid; k < a.H; k += kThreads)
        amax = fmaxf(amax, fabsf(s.vals[tmac::staged(k)]));
      amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, s.scratch);
      q.x = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
      auto attn_val = [&](int k) { return s.vals[tmac::staged(k)]; };
      slice_code_sum(b * a.H / B, (b + 1) * a.H / B, q.x, attn_val, s, a.counts + kQsum1);
      unit_codes<P>(f, q.x, attn_val, s.codes);
      q0 = q;  // (its code sum is complete after the barrier)
    } else if (p == 1) {
      grid.sync();
      // x2 = wo's epilogue + resid, from wo's complete sums (every block
      // reads them all), kept in shared memory for down's epilogue; then
      // rms_norm and the codes of the whole row
      // the first group, with the operands: waited for by wo's first unit
      if (n0 == 0) cp_async_wait<kStages - 2>();
      // every load of the sums in flight at once (one round trip)
      int sacc[kRowRegs];
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i)
        sacc[i] = tid + i * kThreads < a.H ? __ldcg(a.sums + tid + i * kThreads) : 0;
      q0.y = __fmul_rn((float)__ldcg(a.counts + kQsum1), q0.x);
      __syncthreads();
      auto x2_at = [&](int m, int acc) {
        const float o =
            __fmaf_rn(__fmul_rn((float)acc, s.wsc[m]), q0.x, -__fmul_rn(q0.y, s.wsb[m]));
        const float x = __fadd_rn(o, __bfloat162float(s.res[m]));
        s.x2[m] = x;
        s.vals[tmac::staged(m)] = x;
      };
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i)
        if (tid + i * kThreads < a.H) x2_at(tid + i * kThreads, sacc[i]);
      for (int m = tid + kRowRegs * kThreads; m < a.H; m += kThreads)
        x2_at(m, __ldcg(a.sums + m));
      __syncthreads();
      const float rs =
          tmac::rms_factor(tmac::sum_staged(s.vals, a.H, true, s.scratch), a.inv_h, a.eps);
      for (int k = tid; k < a.H; k += kThreads)
        s.vals[tmac::staged(k)] =
            __fmul_rn(__fmul_rn(s.vals[tmac::staged(k)], rs),
                      __bfloat162float(s.nw[k]));
      __syncthreads();
      q = quantize(s, f.K);
    } else {
      grid.sync();
      // wo's sums and code sum were read by every block before the barrier
      // above: back to zero for the next launch
      for (int m = b * kThreads + tid; m < a.H; m += B * kThreads) a.sums[m] = 0;
      if (b == 0 && tid == 0) a.counts[kQsum1] = 0;
      // gate_up's epilogue and SwiGLU on this block's slice of down's row,
      // into h and shared memory (gate_up's sums there back to zero), and
      // its absmax; after a barrier the scale from every block's absmax,
      // the slice's share of the code sum, the codes of this block's rows
      const int k0 = b * a.Ip / B, k1 = (b + 1) * a.Ip / B;
      float amax = 0.f;
      for (int k = k0 + tid; k < k1; k += kThreads) {
        int* gs = a.sums + a.H + k;
        const float g = epilogue(__ldcg(gs), a.gu, k, q0.x, q0.y);
        const float u = epilogue(__ldcg(gs + a.Ip), a.gu, a.Ip + k, q0.x, q0.y);
        gs[0] = 0;
        gs[a.Ip] = 0;
        const float v = tmac::silu_mul(g, u);
        s.vals[k - k0] = v;
        a.h[k] = v;
        amax = fmaxf(amax, fabsf(v));
      }
      amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, s.scratch);
      if (tid == 0) a.amax[b] = amax;
      grid.sync();
      // every block's absmax and h at this block's rows, loaded together
      float hv[kRowRegs];
      constexpr int kPer = P * kStageRows;
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i) {
        const int w = tid + i * kThreads, u = f.u0 + w / kPer;
        const int r = (u % f.per_strip) * kStageRows + w % kStageRows;
        hv[i] = u < f.u1 && r < f.Kb ? __ldcg(a.h + (w % kPer) / kStageRows * f.Kb + r) : 0.f;
      }
      amax = 0.f;
      for (int i = tid; i < B; i += kThreads) amax = fmaxf(amax, __ldcg(a.amax + i));
      amax = tmac::block_allreduce(amax, tmac::MaxOp(), 0.f, s.scratch);
      q.x = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
      slice_code_sum(k0, k1, q.x, [&](int k) { return s.vals[k - k0]; }, s,
                     a.counts + kQsum3);
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i) {
        const int w = tid + i * kThreads, u = f.u0 + w / kPer;
        const int r = (u % f.per_strip) * kStageRows + w % kStageRows;
        if (u < f.u1 && r < f.Kb)
          s.codes[(w % kPer) / kStageRows * f.Kb + r] = (int8_t)quant(hv[i], q.x);
      }
      unit_codes<P>(f, q.x, [&](int k) { return __ldcg(a.h + k); }, s.codes,
                    kRowRegs * kThreads);
    }
    if (p == 1) q0 = q;  // gate_up's, for its epilogue after the barrier
    __syncthreads();     // the codes are complete

    int acc[P][4];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;
    // the unit's strip and its stage of rows there, stepped, not divided
    int strip = f.u0 / f.per_strip, rs = f.u0 % f.per_strip;
#pragma unroll 1
    for (int u = f.u0; u < f.u1; ++u, ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (t + kStages - 1 < total) load(t + kStages - 1);
      cp_async_commit();
      // rows 32 half + 4 rg .. +3 of the stage, columns 16 chunk + 4 cw .. +3
      const int r = rs * kStageRows + 32 * half + 4 * rg;
      const uint8_t* st = s.ring + (t % kStages) * kStageBytes + (32 * half + 4 * rg) * kStrip +
                          ((chunk ^ rg) & 7) * 16 + 4 * cw;
      uint32_t col[4];
      tmac::transpose4(*reinterpret_cast<const uint32_t*>(st),
                       *reinterpret_cast<const uint32_t*>(st + kStrip),
                       *reinterpret_cast<const uint32_t*>(st + 2 * kStrip),
                       *reinterpret_cast<const uint32_t*>(st + 3 * kStrip), col);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int xv = *reinterpret_cast<const int*>(s.codes + j * f.Kb + r);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[j][c] = tmac::dp4a_us(col[c] & (kMask << (BITS * j)), xv, acc[j][c]);
      }
      const int cur = strip;
      if (++rs == f.per_strip) {
        rs = 0;
        ++strip;
      }
      if (u + 1 < f.u1 && rs != 0) continue;

      // the end of the block's units of a strip: its exact sums into device
      // memory, with atomics (the strip's epilogue runs after the next
      // barrier, from the complete sums); the next flush's barrier orders
      // the reuse of xch
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          v += acc[j][c] >> (BITS * j);
          acc[j][c] = 0;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (rg == 0) s.xch[half * kStrip + 16 * chunk + 4 * cw + c] = v;
      }
      __syncthreads();
      if (tid < kStrip) {
        int v = 0;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) v += s.xch[h * kStrip + tid];
        atomicAdd(a.sums + f.sum0 + cur * kStrip + tid, v);
      }
    }
    if (p == 2) q0 = q;
  }

  // down's epilogue on this block's slice of the output columns, from the
  // complete sums and code sum (then both back to zero: the sums here, the
  // code sum by the last block to read it)
  grid.sync();
  const float xsum3 = __fmul_rn((float)__ldcg(a.counts + kQsum3), q0.x);
  for (int m = b * a.H / B + tid; m < (b + 1) * a.H / B; m += kThreads) {
    int* cell = a.sums + a.H + a.I2 + m;
    a.out[m] = __fadd_rn(epilogue(__ldcg(cell), a.dn, m, q0.x, xsum3), s.x2[m]);
    *cell = 0;
  }
  if (tid == 0 && atomicAdd(a.counts + kRead3, 1) == B - 1) {
    a.counts[kQsum3] = 0;
    a.counts[kRead3] = 0;
  }
  cp_async_wait<0>();
}

// the cooperative launch of the BITS instance: a grid of `blocks`, or of
// as many as are resident at once
template <int BITS>
int launch_block(const Args& a0, int blocks, cudaStream_t stream) {
  Args a = a0;
  const size_t smem = Layout(a.H, a.Ip).total;
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_kernel<BITS>,
                                                            kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int grid = blocks ? blocks : sms * per_sm;
  if (per_sm < 1 || grid > sms * per_sm || grid > 1024)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)block_kernel<BITS>, dim3(grid),
                                          dim3(kThreads), args, smem, stream);
}

}  // namespace

// attn, resid, norm_w (H,) bf16; wo (H/P, H), gate_up (H/P, I2), down
// (Ip/P, H) packed fields of `bits` (1, 2 or 4; P = 8 / bits) with (M,)
// f32 scales and sub (every
// array 16-byte aligned, each copied 16 bytes at a time); work (Ip +
// 1024,) f32 scratch -> out (H,) f32.  sums (2H + I2,) and counts (4,)
// int32: zero on entry, left zero (the wrapper keeps them per card; one
// launch at a time uses them).  blocks: the grid, 0 for as many as are
// resident at once (one an SM), else at most that, and at most 1024.  H, I2
// multiples of 128, Ip of 4 P (a row of codes 4-byte aligned in every
// field), I2 == 2 * Ip, max(H, Ip) <= 16384.  Returns the launch's CUDA
// error.
extern "C" int tmac_wo_mlp_block(
    const void* attn, const void* resid, const void* norm_w, float eps,
    float inv_h, int H, int I2, int Ip, int bits, const void* wo_p, const float* wo_s,
    const float* wo_z, const void* gu_p, const float* gu_s, const float* gu_z,
    const void* dn_p, const float* dn_s, const float* dn_z, float* work, float* out,
    int* sums, int* counts, int blocks, void* stream) {
  if ((bits != 1 && bits != 2 && bits != 4) || H % kStrip != 0 || I2 % kStrip != 0 ||
      Ip % (32 / bits) != 0 || I2 != 2 * Ip ||
      (H > Ip ? H : Ip) > tmac::kSumWindow * kThreads || blocks < 0 || blocks > 1024)
    return (int)cudaErrorInvalidValue;
  auto lin = [](const void* p, const float* sc, const float* z) {
    return Linear{static_cast<const uint8_t*>(p), sc, z};
  };
  Args a{static_cast<const __nv_bfloat16*>(attn),
         static_cast<const __nv_bfloat16*>(resid),
         static_cast<const __nv_bfloat16*>(norm_w), eps, inv_h, H, I2, Ip,
         lin(wo_p, wo_s, wo_z), lin(gu_p, gu_s, gu_z), lin(dn_p, dn_s, dn_z),
         work, work + Ip, out, sums, counts};
  cudaStream_t st = (cudaStream_t)stream;
  return bits == 1 ? launch_block<1>(a, blocks, st)
       : bits == 4 ? launch_block<4>(a, blocks, st)
                   : launch_block<2>(a, blocks, st);
}
