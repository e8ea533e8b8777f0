// K2, K6, K8, K9: single-token (decode) attention over one layer of the
// stacked KV cache, for Hopper: one kernel, one launch a call.
//
// Replaces tmac_tpu/ops/pallas/attention_kernel.py::_kernel, as reached
// through flash_decode_stacked (K2: a bf16 or f32 cache, every flag off;
// K6: an int8 cache and/or a window), flash_decode_stacked_append (K8) and
// flash_decode_stacked_append_write (K9):
//
//   q (B, KV, rep, Dl); k, v (L, B, KV, S, Dp); lens (B,); layer (1,)
//   out[b, h, r] = softmax(q . k[layer, b, h, rows] * scale) @ v[...]
//
// at a cache head_dim Dp of 128, 256, 384 or 512 (a template parameter:
// every multiple of 128 up to 512; the reference asserts only Dl <= Dp and
// Dp % 128 == 0) and any number of query heads rep per kv head (split into
// tiles of at most kRepMax(Dp) heads, a grid axis)
//
// with q zero-extended from Dl to Dp, scale from the caller, an f32 online
// softmax and the final acc / max(l, 1e-30).  The flags:
//
//   quant   an int8 cache with one f32 scale per row vector, (L, B, KV, S):
//           the k scale multiplies a row's score after the dot, the v scale
//           its probability before the PV product; no dequantized copy
//   window  rows below lo = max(len - window + append, 0) are never read
//   append  len counts the rows already cached; the current token's k/v
//           (B, KV, Dl) come as operands and are folded in as a last
//           online-softmax step
//   write   (K9) the current row is also stored at row len, quantized the
//           _quantize_kv way on an int8 cache (absmax/127 over Dl, rint,
//           +-127), zero-padded to Dp; at len >= S at row S - 1, where the
//           reference's store lands in interpret mode
//
// The layer index and the lengths are read from device memory, so the host
// never waits on them and a CUDA graph can capture a call.
//
// What bounds it: each valid row's Dl columns of k and v are read once and
// used for 2 * rep multiply-adds per element (~2 * rep flops a cache byte,
// against the card's ridge of ~295), so device-memory bytes bound it in
// principle.  Measured on an H100 (PERF.md), the CUDA cores' issue
// rate and the call's fixed cost (cluster barriers, the merges, the
// launch) bound it first; the design is about those and bytes in flight:
//
// - One launch: a thread-block cluster of nsplit blocks per (kv head, rep
//   tile, batch row), grid (nsplit, KV * tiles, B).  The host picks nsplit
//   from static quantities (attention_kernel.split_plan), so a graph can
//   capture it.  A tile holds REP query heads (1, 2, 4 or 8, at most
//   kRepMax: 8 at Dp 128, 4 at 256, 2 at 384, 1 at 512, so that a lane's
//   acc[REP][Dp / 16] and q stay in registers); rep 12 at Dp 128 is two
//   tiles of 8, the second with 4 live heads, and each tile's cluster reads
//   the same rows.  Every query head's sums are the same in any tiling.
// - Block `rank` takes a contiguous span of the rows [lo, len): span =
//   cdiv(len - lo, nsplit) rounded up to the row tile, computed here from
//   the live length, so a 48-row step and a 2047-row one both spread over
//   the whole cluster.  A block whose span is empty still reaches both
//   cluster barriers (no early return).
// - Rows stream through a ring of kStages stages of kStageRows rows in
//   shared memory, filled by cp.async: only the 16-byte pieces that hold
//   the Dl columns (Phi-3: 192 bytes of a bf16 row, 96 of an int8 one;
//   BitNet 208; Llama 256) and each row's two f32 scales (4-byte copies: a
//   window's edge is not 16-byte aligned in the scale array).  A half-warp
//   copies exactly the rows it reads later, so it waits on its own copies
//   only and no block barrier sits in the loop.  Sizing: Little's law wants
//   ~25-40 KB in flight an SM for 3.35 TB/s at ~1 us of latency.  With one
//   to three blocks an SM (split_plan gives ~1.5 an SM; REP 1 fits in 85
//   registers), kStages - 1 stages in flight a block give 32-96 KB an SM
//   for a bf16 row of 256 bytes (2 stages of 32 KB) and 25-77 KB for an
//   int8 row of 96 bytes (3 stages of 12.5 KB).  Measured on an H100,
//   deeper rings, 8-row tiles, 512-thread blocks, per-row bulk (TMA)
//   copies and capped occupancy were all no faster (PERF.md).  A wider row
//   takes fewer half-warps a block (kGroups 16, 8 or 4: a ring of at most
//   128 KB, so that it and rank 0's merge area fit in 227 KB at 16 blocks):
//   Dp 256 bf16 16 (2 stages of 64 KB), 384 and 512 bf16 8, f32 at 256 8
//   and above 4, int8 16 up to 256 and 8 above (3 stages).
// - kGroups half-warps compute on CUDA cores (no tensor cores: the work is
//   far below the ridge).  Half-warp g takes rows 4g .. 4g+3 of each stage,
//   a row tile: a lane holds Dp / 16 columns and sums its products from 0;
//   the 16
//   lanes' sums of the tile's 4 rows are reduced in a transposed xor
//   butterfly (5 shuffles a tile); then the tile's maximum, one rescale of
//   the state for the tile (l * corr, acc * corr), and the tile's rows
//   added in order.  Every sum and product is rounded on its own (no FMA),
//   in an order the plain version in attention_kernel.py repeats, so the
//   two agree bit for bit.
// - The half-warps' states merge in group order into the block's (m, l,
//   acc[Dp]) per query head, which each block stores into rank 0's shared
//   memory (distributed shared memory).  After cluster.sync() rank 0
//   merges them in rank order, folds in the current token (append),
//   divides and stores the output; nothing of a partial state passes
//   through device memory, and there is no second kernel.  A relaxed
//   cluster arrive at the start and its wait before the first store into
//   rank 0 make sure every block has started; rank 0's shared memory, the
//   only one read across the cluster, lives until rank 0 ends.
// - K9's store: rank 0 stores the current row after cluster.sync(), so
//   after every block of the cluster has read its rows.  That matters at
//   len >= S, where the store lands on row S - 1, which lies inside the
//   rows the other blocks read; other clusters read other (kv head, batch
//   row) pairs, whose rows the store does not touch, or, with several rep
//   tiles, the same rows: then the tiles' clusters count themselves off on
//   a per-(batch row, kv head) counter in device memory after their
//   cluster.sync(), and the last one stores the row and sets the counter
//   back to 0 (the host keeps it zeroed: attention_kernel._done).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 16;      // lanes of a half-warp: the columns' split
constexpr int kTile = 4;        // rows of a half-warp's row tile
static_assert(kTile == 4, "the transposed reduction takes 4 rows over 16 lanes");
constexpr int kMaxSplit = 16;   // cluster size (above 8 non-portable)
constexpr int kRingMax = 128 * 1024;  // the ring's most bytes (see the sizing)

// query heads a tile holds at most, by cache head_dim
__host__ __device__ constexpr int kRepMax(int dp) { return dp <= 128 ? 8 : dp <= 256 ? 4 : dp <= 384 ? 2 : 1; }

// The ring and the block by cache element and head_dim (see the sizing
// above; f32, a test type, 2 stages): kStages stages of kStageRows rows,
// kGroups half-warps, the largest of 16, 8 and 4 whose ring fits kRingMax
template <typename CT, int DP> struct Ring {
  static constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  static constexpr int kStages = kQuant ? 3 : 2;
  static constexpr int stage(int g) {
    return 2 * g * kTile * DP * (int)sizeof(CT) + (kQuant ? 2 * g * kTile * 4 : 0);
  }
  static constexpr int kGroups = kStages * stage(16) <= kRingMax ? 16
                               : kStages * stage(8) <= kRingMax ? 8 : 4;
  static constexpr int kStageRows = kGroups * kTile;
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kPer = DP / kLanes;  // columns of a row per lane
};

// Bytes of a row the kernel reads: the 16-byte pieces holding the columns
// of lanes 0 .. cdiv(Dl, per) - 1 (per columns a lane)
__host__ __device__ __forceinline__ int row_bytes(int Dl, int item, int per) {
  const int cols = (Dl + per - 1) / per * per;
  return (cols * item + 15) / 16 * 16;
}

// 8 consecutive elements of a row from shared memory (one 16-byte load for
// bf16, two for f32, one 8-byte load for int8), as floats
__device__ __forceinline__ void get8(const __nv_bfloat16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void get8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
// int8 codes to floats exactly without the quarter-rate conversion: the
// code biased to 0..255 as the low byte of 2^23's mantissa, minus 2^23 + 128
__device__ __forceinline__ void get8(const int8_t* p, float* f) {
  const int2 r = *reinterpret_cast<const int2*>(p);
  const unsigned w[2] = {(unsigned)r.x ^ 0x80808080u, (unsigned)r.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 + i % 4)),
                     8388736.0f);
}
// A lane's N columns (a multiple of 8), as floats
template <int N, typename CT>
__device__ __forceinline__ void get_cols(const CT* p, float* f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) get8(p + 8 * j, f + 8 * j);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The weight of a partial online-softmax state in a merge whose maximum is
// mx: 0 for a state that saw no row (m = -inf), else exp(m - mx).
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return isinf(m) ? 0.f : expf(m - mx);
}

// Stores column d of the current row x[0, Dp) (zero past Dl) at `row`: as
// is for a float cache; for an int8 one as codes rint(x / sc) clamped to
// +-127, with sc = max(absmax over Dl, 1e-20) times the f32 reciprocal of
// 127 (how XLA compiles _quantize_kv's `/ 127.0`) stored at *scale.
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

struct Args {
  const void *q, *cur_k, *cur_v;
  void *k, *v, *out;
  float *ks, *vs;
  const int *lens, *layer;
  int* done;
  int L, B, KV, rep, tiles, Dl, S, window, append, write;
  float scale;
};

// Bytes of dynamic shared memory: the ring (after the stream, the
// half-warps' weighted acc[kGroups][REP][DP]), then rank 0's merge area
// (each block's state: acc[REP][DP], m[REP], l[REP])
template <typename CT, int DP, int REP>
__host__ __device__ __forceinline__ int ring_bytes(int Dl) {
  using R = Ring<CT, DP>;
  const int ring = R::kStages *
      (2 * R::kStageRows * row_bytes(Dl, (int)sizeof(CT), R::kPer) +
       (R::kQuant ? 2 * R::kStageRows * 4 : 0));
  const int accs = R::kGroups * REP * DP * 4;
  return ring > accs ? ring : accs;
}
template <int DP, int REP> constexpr int kStateFloats = REP * (DP + 2);

// A lane's columns of a row, global -> shared: the bytes it reads itself
// (16-byte copies; 8-byte ones where a lane's bytes are not a multiple of
// 16: int8 at Dp 384); on an int8 cache at Dp 128 an even lane copies its
// odd neighbour's 8 bytes too (16-byte copies, half as many)
template <int kLaneBytes>
__device__ __forceinline__ void copy_lane(unsigned char* dst, const unsigned char* src) {
  if constexpr (kLaneBytes % 16 == 0) {
#pragma unroll
    for (int j = 0; j < kLaneBytes / 16; ++j) cp_async16(dst + 16 * j, src + 16 * j);
  } else if constexpr (kLaneBytes == 8) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int j = 0; j < kLaneBytes / 8; ++j) cp_async8(dst + 8 * j, src + 8 * j);
  }
}

// QT: q, cur_k/v and out (bf16 or f32); CT: the cache (QT, or int8 with
// scales); DP: the cache head_dim; REP: query heads of a tile, 1, 2, 4 or
// 8 up to kRepMax(DP).  DP 128 at REP 1 in at most 85 registers: three
// blocks an SM (see the sizing above).
template <typename QT, typename CT, int DP, int REP>
__global__ void __launch_bounds__(Ring<CT, DP>::kThreads, DP == 128 && REP == 1 ? 3 : 1)
decode_attention_kernel(const Args a) {
  using R = Ring<CT, DP>;
  constexpr bool kQuant = R::kQuant;
  constexpr int kStages = R::kStages;
  constexpr int kGroups = R::kGroups;
  constexpr int kThreads = R::kThreads;
  constexpr int kStageRows = R::kStageRows;
  constexpr int kPer = R::kPer;
  constexpr int kLaneBytes = kPer * (int)sizeof(CT);
  // an int8 lane pair at Dp 128: the even lane copies both lanes' 8 bytes
  constexpr bool kPairs = kLaneBytes == 8;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float sm_m[kGroups][REP];
  __shared__ float sm_le[kGroups][REP];
  __shared__ float sm_mx[REP];
  __shared__ float sm_w[kMaxSplit * REP];
  __shared__ float sm_cur[2][DP];
  __shared__ float sm_sc[REP];
  __shared__ int sm_writer;

  // the cluster spans the grid's x dimension: its size and a block's rank
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = gridDim.x, rank = blockIdx.x;
  const int h = blockIdx.y / a.tiles, tile = blockIdx.y - h * a.tiles;
  const int b = blockIdx.z;
  // this tile's query heads: rt0 .. rt0 + nrep - 1
  const int rt0 = tile * REP, nrep = min(REP, a.rep - rt0);
  const int tid = threadIdx.x;
  const int g = tid >> 4, lane = tid & 15;
  const int d0 = lane * kPer;
  const bool live = d0 < a.Dl;  // lanes past Dl hold pad columns: zeros
  const unsigned hmask = 0xffffu << (tid & 16);
  const int li = min(max(a.layer[0], 0), a.L - 1);
  const size_t bh = (size_t)b * a.KV + h;
  // the window's edge from the length as given, the rows read below S:
  // past S (a slot held at pos == S) the reference masks the same rows
  const int raw = max(a.lens[b], 0);
  const int len = min(raw, a.S);
  const int lo = a.window > 0 ? max(raw - a.window + a.append, 0) : 0;
  const int n = max(len - lo, 0);
  const int span = ((n + nsplit - 1) / nsplit + kTile - 1) / kTile * kTile;
  const int r0 = min(lo + rank * span, len);
  const int r1 = min(r0 + span, len);
  const int nst = (r1 - r0 + kStageRows - 1) / kStageRows;
  // every block of the cluster has started before any writes into rank
  // 0's shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const QT* q = static_cast<const QT*>(a.q);
  float qf[REP][kPer];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + i;
      qf[r][i] = (r < nrep && d < a.Dl)
          ? __fmul_rn(to_float(q[(bh * a.rep + rt0 + r) * a.Dl + d]), a.scale)
          : 0.f;
    }
  float m[REP], l[REP], acc[REP][kPer];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0.f;
  }

  // the ring: stage = k rows, v rows (rbytes each), then k and v scales.
  // Half-warp g copies its own tile (rows 4g .. 4g+3 of a stage), each lane
  // the bytes it reads itself (an int8 pair of lanes at Dp 128: the even
  // one); lanes 0-7 the tile's scales.  So a lane waits only on its
  // half-warp's copies; __syncwarp orders those of its neighbours, and the
  // rewrite of a slot after every lane has read it.
  const int rbytes = row_bytes(a.Dl, (int)sizeof(CT), kPer);
  const int stage_bytes = 2 * kStageRows * rbytes + (kQuant ? 2 * kStageRows * 4 : 0);
  const size_t head = (((size_t)li * a.B + b) * a.KV + h) * a.S;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + head * DP * sizeof(CT);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + head * DP * sizeof(CT);
  const float* ksg = kQuant ? a.ks + head : nullptr;
  const float* vsg = kQuant ? a.vs + head : nullptr;

  auto issue = [&](int t) {
    unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes;
    const int row0 = r0 + t * kStageRows + g * kTile;
    const int nv = min(kTile, r1 - row0);
    if (live && (!kPairs || !(lane & 1))) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (i < nv) {
          const size_t off = (size_t)(row0 + i) * DP * sizeof(CT) + lane * kLaneBytes;
          copy_lane<kLaneBytes>(st + (g * kTile + i) * rbytes + lane * kLaneBytes, kg + off);
          copy_lane<kLaneBytes>(st + (kStageRows + g * kTile + i) * rbytes + lane * kLaneBytes,
                                vg + off);
        }
      }
    }
    if (kQuant && lane < 2 * kTile && (lane & (kTile - 1)) < nv) {
      const int i = lane & (kTile - 1), which = lane / kTile;
      float* dst = reinterpret_cast<float*>(st + 2 * kStageRows * rbytes) +
                   which * kStageRows + g * kTile + i;
      cp_async4(dst, (which ? vsg : ksg) + row0 + i);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nst) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    // the slot refilled here was read at t - 1, before the __syncwarp
    if (t + kStages - 1 < nst) issue(t + kStages - 1);
    cp_async_commit();

    const int tr0 = r0 + t * kStageRows + g * kTile;  // this half-warp's tile
    const unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes;
    const CT* kt = reinterpret_cast<const CT*>(st + g * kTile * rbytes) + d0;
    const CT* vt = reinterpret_cast<const CT*>(st + (kStageRows + g * kTile) * rbytes) + d0;
    const float* kst = reinterpret_cast<const float*>(st + 2 * kStageRows * rbytes) + g * kTile;
    const float* vst = kst + kStageRows;
    // the tile's rows: all kTile of them (kFull, every tile but a span's
    // last), so the rows' chains interleave; or the first nv
    auto tile_rows = [&](auto full, int nv) {
      constexpr bool kFull = decltype(full)::value;
      float s[kTile][REP];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        // a row's columns, then its score per query head (each lane's
        // products summed from 0, in column order)
        float kf[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) kf[c] = 0.f;
        if ((kFull || i < nv) && live)
          get_cols<kPer>(reinterpret_cast<const CT*>(reinterpret_cast<const unsigned char*>(kt) + i * rbytes), kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float sc = 0.f;
#pragma unroll
          for (int c = 0; c < kPer; ++c) sc = __fadd_rn(sc, __fmul_rn(qf[r][c], kf[c]));
          s[i][r] = sc;
        }
      }
      // The 16 lanes' sums of the tile's 4 rows, reduced "transposed": the
      // xor-8 step keeps rows 2 * b3 + {0, 1} of a lane (b3, b2: bits 3
      // and 2 of its lane), the xor-4 step row own = 2 * b3 + b2, the
      // xor-2 and xor-1 steps finish it.  Each sum is the butterfly's own
      // (own + partner at every step), so every row's score is the one all
      // 16 lanes of a plain butterfly hold, from 5 shuffles instead of 16;
      // the lane then takes the exponent of its own row only, and the tile's
      // 4 probabilities come back by shuffles.
      const int b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1, own = 2 * b3 + b2;
      float p[kTile][REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float keep = b3 ? s[2 + j][r] : s[j][r];
          const float send = b3 ? s[j][r] : s[2 + j][r];
          y[j] = __fadd_rn(keep, __shfl_xor_sync(hmask, send, 8));
        }
        float x = __fadd_rn(b2 ? y[1] : y[0], __shfl_xor_sync(hmask, b2 ? y[0] : y[1], 4));
        x = __fadd_rn(x, __shfl_xor_sync(hmask, x, 2));
        x = __fadd_rn(x, __shfl_xor_sync(hmask, x, 1));
        if (kQuant) x = __fmul_rn(x, kst[own]);
        // one rescale a tile: its maximum, then the tile's rows in order
        float mt = (kFull || own < nv) ? x : -INFINITY;
        mt = fmaxf(mt, __shfl_xor_sync(hmask, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(hmask, mt, 8));
        const float m_new = fmaxf(m[r], mt);
        const float corr = expf(m[r] - m_new);
        m[r] = m_new;
        const float p_own = expf(x - m_new);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          p[i][r] = __shfl_sync(hmask, p_own, (i >> 1) * 8 + (i & 1) * 4, 16);
        l[r] = __fmul_rn(l[r], corr);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (kFull || i < nv) l[r] = __fadd_rn(l[r], p[i][r]);
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[r][c] = __fmul_rn(acc[r][c], corr);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (kFull || i < nv) {
          float vf[kPer] = {};
          if (live)
            get_cols<kPer>(reinterpret_cast<const CT*>(reinterpret_cast<const unsigned char*>(vt) + i * rbytes), vf);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float pv = kQuant ? __fmul_rn(p[i][r], vst[i]) : p[i][r];
#pragma unroll
            for (int c = 0; c < kPer; ++c)
              acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(pv, vf[c]));
          }
        }
      }
    };
    if (tr0 + kTile <= r1)
      tile_rows(std::true_type{}, kTile);
    else if (tr0 < r1)
      tile_rows(std::false_type{}, r1 - tr0);
  }
  cp_async_wait<0>();

  // rank 0's merge area, where every block of the cluster leaves its state
  float* merge = cluster.map_shared_rank(
      reinterpret_cast<float*>(ring + ring_bytes<CT, DP, REP>(a.Dl)), 0);
  float* mine = merge + rank * kStateFloats<DP, REP>;

  // the half-warps' states, merged in group order into the block's, every
  // query head at once (the ring, read by now, holds the weighted
  // acc[group][head][DP]), and stored into rank 0's shared memory
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) sm_m[g][r] = m[r];
  }
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) mx = fmaxf(mx, sm_m[gg][r]);
    const float e = merge_weight(m[r], mx);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      sm_acc[(g * REP + r) * DP + d0 + c] = __fmul_rn(acc[r][c], e);
    if (lane == 0) sm_le[g][r] = __fmul_rn(l[r], e);
    if (tid == 0) sm_mx[r] = mx;
  }
  __syncthreads();
  for (int i = tid; i < REP * DP; i += kThreads) {
    float sa = 0.f;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) sa = __fadd_rn(sa, sm_acc[gg * REP * DP + i]);
    mine[i] = sa;
  }
  if (tid >= kThreads - REP) {
    const int r = tid - (kThreads - REP);
    float lt = 0.f;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) lt = __fadd_rn(lt, sm_le[gg][r]);
    mine[REP * DP + r] = sm_mx[r];
    mine[REP * DP + REP + r] = lt;
  }

  // rank 0: the current token's row, and its score per query head in a
  // row's order (half-warp 0's lanes, then the butterfly), while the other
  // blocks finish
  if (rank == 0 && a.append) {
    const QT* ck = static_cast<const QT*>(a.cur_k);
    const QT* cv = static_cast<const QT*>(a.cur_v);
    for (int d = tid; d < DP; d += kThreads) {
      sm_cur[0][d] = d < a.Dl ? to_float(ck[bh * a.Dl + d]) : 0.f;
      sm_cur[1][d] = d < a.Dl ? to_float(cv[bh * a.Dl + d]) : 0.f;
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float sc = 0.f;
#pragma unroll
        for (int c = 0; c < kPer; ++c) sc = __fadd_rn(sc, __fmul_rn(qf[r][c], sm_cur[0][d0 + c]));
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sc = __fadd_rn(sc, __shfl_xor_sync(hmask, sc, o));
        if (lane == 0) sm_sc[r] = sc;
      }
    }
    __syncthreads();
  }

  // every block's state is in rank 0's shared memory, and every block has
  // read its rows of the cache; the others may exit (rank 0's shared
  // memory, the only one read across the cluster, lives until rank 0 ends)
  cluster.sync();
  if (rank != 0) return;
  if (tid == 0) {
    // K9 over several rep tiles: the last tile's cluster to get here
    // stores the row, after every tile has read its rows
    int writer = 1;
    if (a.write && a.tiles > 1) {
      __threadfence();
      writer = atomicAdd(a.done + bh, 1) == a.tiles - 1;
      if (writer) atomicExch(a.done + bh, 0);
    }
    sm_writer = writer;
  }
  // the blocks' weights in the merge, one thread a (block, query head)
  for (int t = tid; t < nsplit * REP; t += kThreads) {
    const int j = t / REP, r = t - j * REP;
    float mx = -INFINITY;
    for (int jj = 0; jj < nsplit; ++jj) mx = fmaxf(mx, merge[jj * kStateFloats<DP, REP> + REP * DP + r]);
    sm_w[t] = merge_weight(merge[j * kStateFloats<DP, REP> + REP * DP + r], mx);
    if (j == 0) sm_mx[r] = mx;
  }
  __syncthreads();
  QT* out = static_cast<QT*>(a.out);
  for (int d = tid; d < DP; d += kThreads) {
    for (int r = 0; r < nrep; ++r) {
      // the blocks, merged in rank order
      const float mx = sm_mx[r];
      float sa = 0.f, lt = 0.f;
      for (int j = 0; j < nsplit; ++j) {
        const float* st = merge + j * kStateFloats<DP, REP>;
        const float e = sm_w[j * REP + r];
        sa = __fadd_rn(sa, __fmul_rn(st[r * DP + d], e));
        lt = __fadd_rn(lt, __fmul_rn(st[REP * DP + REP + r], e));
      }
      if (a.append) {
        // the current token, a last online-softmax step (always valid)
        const float s_c = sm_sc[r];
        const float m_new = fmaxf(mx, s_c);
        const float p = expf(s_c - m_new);
        const float corr = expf(mx - m_new);
        lt = __fadd_rn(__fmul_rn(lt, corr), p);
        sa = __fadd_rn(__fmul_rn(sa, corr), __fmul_rn(p, sm_cur[1][d]));
      }
      if (d < a.Dl) store(out + (bh * a.rep + rt0 + r) * a.Dl + d, sa / fmaxf(lt, 1e-30f));
    }
    if (a.write && sm_writer) {
      // after the cluster barrier (and, over several tiles, the others'):
      // no block reads the cache again, though at len >= S row S - 1 lies
      // inside the rows they read
      const int row = min(raw, a.S - 1);
      const size_t off = head + row;
      store_row(static_cast<CT*>(a.k) + off * DP, a.ks + off, sm_cur[0], a.Dl, d);
      store_row(static_cast<CT*>(a.v) + off * DP, a.vs + off, sm_cur[1], a.Dl, d);
    }
  }
}

template <typename QT, typename CT, int DP, int REP>
int launch(const Args& a, int nsplit, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, CT, DP, REP>;
  const int smem = ring_bytes<CT, DP, REP>(a.Dl) + nsplit * kStateFloats<DP, REP> * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nsplit > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, a.KV * a.tiles, a.B);
  cfg.blockDim = dim3(Ring<CT, DP>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be scheduled (its blocks' shared memory on one
  // GPC) is refused here, once per cluster size and ring size
  static int admitted_for = -1;
  if (admitted_for != nsplit * 1000000 + smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    admitted_for = nsplit * 1000000 + smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A tile's REP: rep rounded up to 1, 2, 4 or 8, at most kRepMax(DP)
__host__ __device__ constexpr int tile_rep(int rep, int dp) {
  const int r = rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8;
  return r < kRepMax(dp) ? r : kRepMax(dp);
}

template <typename QT, typename CT, int DP>
int launch_rep(const Args& a, int nsplit, cudaStream_t stream) {
  switch (tile_rep(a.rep, DP)) {
    case 1: return launch<QT, CT, DP, 1>(a, nsplit, stream);
    case 2: if constexpr (kRepMax(DP) >= 2) return launch<QT, CT, DP, 2>(a, nsplit, stream);
            break;
    case 4: if constexpr (kRepMax(DP) >= 4) return launch<QT, CT, DP, 4>(a, nsplit, stream);
            break;
    case 8: if constexpr (kRepMax(DP) >= 8) return launch<QT, CT, DP, 8>(a, nsplit, stream);
            break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename CT>
int launch_dp(const Args& a, int Dp, int nsplit, cudaStream_t stream) {
  switch (Dp) {
    case 128: return launch_rep<QT, CT, 128>(a, nsplit, stream);
    case 256: return launch_rep<QT, CT, 256>(a, nsplit, stream);
    case 384: return launch_rep<QT, CT, 384>(a, nsplit, stream);
    case 512: return launch_rep<QT, CT, 512>(a, nsplit, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2 (quant = window = append = write = 0), K6 (quant and/or window), K8
// (append = 1) and K9 (append = write = 1), one launch.  q, cur_k, cur_v
// (B, KV, Dl) and out (B, KV, rep, Dl) of one type (bf16 when q_bf16, else
// f32); k/v (L, B, KV, S, Dp) of that type, or int8 when quant, with ks/vs
// (L, B, KV, S) f32; lens (B,) and layer (1,) int32 on the device (lens
// counts the valid rows, or the cached rows in append mode); nsplit blocks
// (a cluster) per (kv head, rep tile, batch row), 1 to 16 (above 8 a
// non-portable cluster).  Dp 128, 256, 384 or 512; any rep >= 1, in
// cdiv(rep, tile_rep(rep, Dp)) tiles; done: (B, KV) int32 zeros on the
// device, needed by K9 (write) over more than one tile, left at zero.
// Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidConfiguration for a cluster the card cannot schedule).
extern "C" int tmac_decode_attention(
    const void* q, void* k, void* v, float* ks, float* vs, const int* lens,
    const int* layer, const void* cur_k, const void* cur_v, void* out, int* done,
    int L, int B, int KV, int rep, int Dl, int Dp, int S, int window, int append,
    int write, int nsplit, float scale, int q_bf16, int quant, void* stream) {
  if ((Dp != 128 && Dp != 256 && Dp != 384 && Dp != 512) || rep < 1 || Dl < 1 ||
      Dl > Dp || L < 1 || B < 1 || KV < 1 || S < 1 || window < 0 || nsplit < 1 ||
      nsplit > kMaxSplit || (write && !append) ||
      (append && (!cur_k || !cur_v)) || (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const int tr = tile_rep(rep, Dp), tiles = (rep + tr - 1) / tr;
  if (write && tiles > 1 && !done) return (int)cudaErrorInvalidValue;
  const Args a{q, cur_k, cur_v, k, v, out, ks, vs, lens, layer, done, L, B, KV,
               rep, tiles, Dl, S, window, append, write, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return quant ? launch_dp<__nv_bfloat16, int8_t>(a, Dp, nsplit, s)
                 : launch_dp<__nv_bfloat16, __nv_bfloat16>(a, Dp, nsplit, s);
  return quant ? launch_dp<float, int8_t>(a, Dp, nsplit, s)
               : launch_dp<float, float>(a, Dp, nsplit, s);
}
