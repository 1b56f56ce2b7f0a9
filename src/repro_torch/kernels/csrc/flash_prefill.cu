// Causal, left-pad-masked GQA prefill attention for Hopper (sm_90a), with
// an optional bidirectional prefix.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py
// (flash_prefill, pallas_call at :96) and computes what
// repro/kernels/ref.py:flash_prefill_ref computes: query token i of row b
// and head j attends to key token k of the same row where
//   (pk >= 0) & (pk <= pq) [& (pq - pk < window)]
//   or (pk >= 0) & (pk < prefix_len) & (pq >= 0)   or   i == k,
// pq, pk the tokens' positions (pads < 0).  The prefix term is the JAX
// package's prefix-LM mask (repro/models/transformer.py:_mask_with_prefix:
// a VLM's image tokens see each other both ways, and it overrides the
// window); prefix_len 0 is the causal kernel.  The encoder of an
// encoder-decoder model runs with prefix_len = T: every valid query sees
// every valid key.  The diagonal rule keeps the pad query rows finite:
// each takes exactly its own V.  Scores are
// q . k * scale in float32 with masked scores at the oracle's finite
// NEG_INF; the online softmax and the accumulator are float32; the output
// is written in q's type.
//
// Bound: bytes, then operations.  At llama3.2-1b's prefill shapes (8 rows
// of 512, 32/8 heads, D 64) the causal products are ~7 GFLOP against
// ~42 MB of q, K, V and output: ~170 flop/byte, below the card's bf16
// balance point, so memory bounds it (~12.5 us) with the tensor cores
// close behind (~7 us).  Reaching either needs the tensor cores fed
// without stalls: hence wgmma, TMA and a tile ring below.
//
// Design: the work is cut into q tiles of one row and kv head: BQ = R / G
// query tokens times the G = Hq / Hkv query heads of the kv head, so each
// K/V tile brought into shared memory serves every query head of its kv
// head (R query rows: R = 128 for bf16, 8192 / D for float32; a larger
// group as head blocks, below).  The
// Pallas grid's sequential kv axis becomes a loop over K/V tiles of 64
// keys (32 at D 128 in float32).
//  - bfloat16, FlashAttention-3's shape on Hopper: one persistent block
//    per SM walks the q tiles, those with the most keys first, in snake
//    order over the blocks.  It has
//    three warpgroups.  One warp of the third (the producer, its registers
//    cut by setmaxnreg to give them to the others) loads each q tile's Q
//    by TMA into a double buffer, walks its K/V tiles, classifies each
//    and feeds the needed ones by TMA into a 3-stage ring on mbarriers
//    (at head dim 256 one Q buffer and 2 stages: see Cfg):
//    4-D tensor maps (D, H, T, B) select the heads and write each tile
//    with the 128-byte swizzle (64-byte at D 32) that the wgmma
//    descriptors name.  So the next q tile's Q and first K/V tiles load
//    while the consumers finish the current one.  Two consumer
//    warpgroups of 64 query rows each run wgmma m64nNk16: S = Q K^T with
//    Q and K in shared memory, the online softmax in exp2 with
//    scale * log2(e) folded into one FMA, then O += P V with P taken from
//    the S accumulators straight into the A-operand registers and V read
//    as it lies through wgmma's transpose bit.  Each weight is a bf16
//    pair (high and low part, two products): one bf16 alone was measured
//    a bf16 ulp off the plain version at |o| >= 4, past the 2e-2
//    tolerance.
//  - float32 (exact to 2e-5 of the oracle): a block per q tile on the
//    CUDA cores, D / 32 neighbouring threads per query row (one at D 32),
//    each holding 32 of its dims in interleaved 4-dim chunks; the parts
//    of a score are summed by shuffles.  Bound by one shared-memory
//    operand per multiply-add.  K/V tiles hold 4096 / D keys above D 64
//    (16 at D 256: 32 KB of static shared memory for K and V), so a block
//    of 256 threads has 8192 / D query rows (32 at D 256: head blocks of
//    at most 32 heads).
//
// Head dims and groups: an instance is compiled at a head dim D of {32,
// 64, 128, 256} and serves every call head dim hd <= D that is a multiple
// of 16 (the smallest instance at or above it): rows lie at stride hd;
// bf16's tensor maps have hd as their inner dim, so TMA fills the boxes'
// columns past hd with zeros, and float32's loads past hd are predicated
// off (zeros); zero columns add nothing to q . k, and the output's
// columns past hd are not stored.  A group of more query heads than a
// block holds (64 in bf16; 64 or 8192 / D, the fewer, in float32) runs as
// `rep` head blocks of ceil(G / rep) heads (the last one ragged), each
// its own q tiles: a work item is a q tile of one row and head block.
// The Q box of a ragged block reads the next KV head's heads (or zeros
// past Hq) into rows that are computed and not stored.
//
// Where the trouble lies, and what the kernels do:
//  - Tile skipping: a K/V tile is skipped only when no key in it can be
//    unmasked for any query of the block by position (pk >= 0, pk <= max pq,
//    pk > min valid pq - window; or pk < prefix_len in a block with a valid
//    query: prefix keys above the diagonal are still read by the prefix's
//    queries) AND the tile does not overlap the block's diagonal (by
//    index): the pad rows' diagonal tile is always computed.
//  - Masking only where needed (bf16): a tile whose keys all lie at
//    positions >= 0, <= the block's smallest query position and inside the
//    window of its largest, in a block without pad queries, is unmasked
//    for every pair and takes no per-element mask; the others (the
//    diagonal, pads, window edges) are masked pair by pair as the oracle.
//    The test ignores the prefix: it stays conservative, since a prefix
//    pair that it leaves to the masked path is unmasked there pair by pair.
//  - Fully masked tiles: masked scores are the finite NEG_INF.  In float32
//    a tile met while the running max is still NEG_INF adds weights that
//    the first live key scales by exp(NEG_INF - m) = 0; in bf16 such keys
//    weigh 0 at once.  Every query row has a live key (its diagonal), so
//    nothing of them survives, as in the oracle.
//  - T need not divide the tiles: key slots past T are not loaded (TMA
//    fills them with zeros) and weigh exactly 0; query rows past T are not
//    stored.
#include <climits>

#include <cuda.h>

#include "paged_attention.cuh"

namespace {

using paged::kFull;
using paged::kMinusInf;
using paged::kNegInf;

__device__ __forceinline__ bool pair_live(int pk, int pq, int ki, int qi,
                                          int window, int prefix_len) {
  return (pk >= 0 && ((pk <= pq && (window <= 0 || pq - pk < window)) ||
                      (pk < prefix_len && pq >= 0))) ||
         qi == ki;
}

// Whether key position pk may be unmasked for some query of a block whose
// largest position is q_max and smallest valid one q_min (q_max < 0: the
// block holds pads only).
__device__ __forceinline__ bool key_maybe(int pk, int q_max, int q_min,
                                          int window, int prefix_len) {
  return pk >= 0 &&
         ((pk <= q_max && (window <= 0 || pk > q_min - window)) ||
          (pk < prefix_len && q_max >= 0));
}

// The largest position and the smallest valid (>= 0) one of the block's
// query tokens [q0, q_end), into q_stat by the first warp; the caller
// publishes them with a barrier.
__device__ __forceinline__ void query_span(const int32_t* pos_row, int q0,
                                           int q_end, int* q_stat) {
  if (threadIdx.x >= 32) return;
  int mx = -1, mn = INT_MAX;
  for (int i = q0 + threadIdx.x; i < q_end; i += 32) {
    const int p = pos_row[i];
    mx = max(mx, p);
    if (p >= 0) mn = min(mn, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(kFull, mx, o));
    mn = min(mn, __shfl_xor_sync(kFull, mn, o));
  }
  if (threadIdx.x == 0) {
    q_stat[0] = mx;
    q_stat[1] = mn;
  }
}

// Loads the positions of key tile [k0, k0 + n) into pos_s and returns,
// block-wide (a barrier), whether the tile must be computed: some key may
// be unmasked for a query of the block, or the tile holds the diagonal.
__device__ __forceinline__ bool tile_needed(const int32_t* pos_row, int k0,
                                            int n, int T_len, int q0,
                                            int q_end, int q_max, int q_min,
                                            int window, int prefix_len,
                                            int* pos_s) {
  int maybe = 0;
  if (threadIdx.x < n) {
    const int ki = k0 + threadIdx.x;
    const int pk = ki < T_len ? pos_row[ki] : -1;
    pos_s[threadIdx.x] = pk;
    maybe = key_maybe(pk, q_max, q_min, window, prefix_len);
  }
  const int any = __syncthreads_or(maybe);  // every thread reaches it
  return any || (k0 < q_end && q0 < k0 + n);
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;

template <int D>
struct Tile {
  static constexpr int kTpr = D / 32;              // threads per query row
  static constexpr int kRows = kThreads / kTpr;    // query rows per block
  static constexpr int kBK = D > 64 ? 4096 / D : 64;  // keys per K/V tile
  static constexpr int kChunks = 8;                // 4-dim chunks per thread
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ positions,
    float* __restrict__ out, int T_len, int Hq, int Hkv, int rep, int hd,
    int bq, int n_qt, int window, int prefix_len, float scale) {
  using Cfg = Tile<D>;
  constexpr int kTpr = Cfg::kTpr, kBK = Cfg::kBK;
  constexpr int kPerRow = D / 4;
  __shared__ __align__(16) float k_s[kBK * D];
  __shared__ __align__(16) float v_s[kBK * D];
  __shared__ int pos_s[kBK];
  __shared__ int q_stat[2];

  const int G = Hq / Hkv, gb = (G + rep - 1) / rep;  // heads a block
  const int qt = blockIdx.x % n_qt;
  const int hb = (blockIdx.x / n_qt) % (Hkv * rep);
  const int b = blockIdx.x / (n_qt * Hkv * rep);
  const int h = hb / rep, g0 = (hb % rep) * gb;
  const int tid = threadIdx.x;
  const int r = tid / kTpr, part = tid % kTpr;
  const int q0 = qt * bq;
  const int q_end = min(q0 + bq, T_len);
  const int t = q0 + r / gb;
  const int g = r % gb;
  const bool valid = r < bq * gb && t < T_len && g0 + g < G;
  const int64_t row0 = (int64_t)b * T_len;
  const int32_t* pos_row = positions + row0;
  query_span(pos_row, q0, q_end, q_stat);

  const int pq = valid ? pos_row[t] : -1;
  const int qi = valid ? t : -1;
  const int64_t q_off = ((row0 + t) * Hq + (int64_t)h * G + g0 + g) * hd;
  float qf[4 * Cfg::kChunks], acc[4 * Cfg::kChunks];
#pragma unroll
  for (int i = 0; i < Cfg::kChunks; ++i) {
    const int dim = 4 * (part + kTpr * i);
    const float4 x = valid && dim < hd
                         ? *reinterpret_cast<const float4*>(q + q_off + dim)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    qf[4 * i] = x.x;
    qf[4 * i + 1] = x.y;
    qf[4 * i + 2] = x.z;
    qf[4 * i + 3] = x.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * i + e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  __syncthreads();  // q_stat
  const int q_max = q_stat[0], q_min = q_stat[1];

  const int n_kt = (T_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_needed(pos_row, k0, kBK, T_len, q0, q_end, q_max, q_min,
                     window, prefix_len, pos_s))
      continue;  // uniform

    for (int i = tid; i < kBK * kPerRow; i += kThreads) {
      const int kk = i / kPerRow, c = i % kPerRow;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kk < T_len && 4 * c < hd) {
        const int64_t off = ((row0 + k0 + kk) * Hkv + h) * hd + 4 * c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(k_s + kk * D + 4 * c) = kv;
      *reinterpret_cast<float4*>(v_s + kk * D + 4 * c) = vv;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* kr = k_s + kk * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < Cfg::kChunks; ++i) {
        const float4 kx =
            *reinterpret_cast<const float4*>(kr + 4 * (part + kTpr * i));
        dot += qf[4 * i] * kx.x + qf[4 * i + 1] * kx.y +
               qf[4 * i + 2] * kx.z + qf[4 * i + 3] * kx.w;
      }
      s[kk] = dot;
    }
    float mt = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
      for (int o = 1; o < kTpr; o <<= 1)
        s[kk] += __shfl_xor_sync(kFull, s[kk], o);
      const int ki = k0 + kk;
      s[kk] = ki >= T_len ? kMinusInf
              : (pair_live(pos_s[kk], pq, ki, qi, window, prefix_len)
                     ? s[kk] * scale
                     : kNegInf);
      mt = fmaxf(mt, s[kk]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 4 * Cfg::kChunks; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = expf(s[kk] - m_new);
      l += p;
      const float* vr = v_s + kk * D;
#pragma unroll
      for (int i = 0; i < Cfg::kChunks; ++i) {
        const float4 vx =
            *reinterpret_cast<const float4*>(vr + 4 * (part + kTpr * i));
        acc[4 * i] += p * vx.x;
        acc[4 * i + 1] += p * vx.y;
        acc[4 * i + 2] += p * vx.z;
        acc[4 * i + 3] += p * vx.w;
      }
    }
    m = m_new;
    __syncthreads();  // the tile is read before the next one overwrites it
  }

  if (!valid) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < Cfg::kChunks; ++i) {
    const int dim = 4 * (part + kTpr * i);
    if (dim < hd)
      *reinterpret_cast<float4*>(out + q_off + dim) =
          make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                      acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
  }
}

template <int D>
int launch(int hd, const void* q, const void* k, const void* v,
           const void* positions, void* out, int B, int T_len, int Hq,
           int Hkv, int window, int prefix_len, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int most = Tile<D>::kRows < 64 ? Tile<D>::kRows : 64;
  const int rep = (G + most - 1) / most;   // head blocks a kv head
  const int gb = (G + rep - 1) / rep;      // heads a block
  const int bq = Tile<D>::kRows / gb;      // query tokens per block
  const int n_qt = (T_len + bq - 1) / bq;
  const int64_t blocks = (int64_t)B * Hkv * rep * n_qt;
  if (bq < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_prefill_kernel<D><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(positions),
      static_cast<float*>(out), T_len, Hq, Hkv, rep, hd, bq, n_qt, window,
      prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: warpgroup tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer's
constexpr int kRows = kConsumers * 64;             // query rows per block
constexpr int kMostHeads = 64;                     // query heads a block
constexpr int kBK = 64;                            // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tiles of head dim D: Q (kRows query rows), K and V
// (kBK keys) tiles as they lie in memory, cut along D into boxes one
// swizzle row wide (64 values; 32 at D 32 with the 64-byte swizzle), each
// box written by TMA with the swizzle the wgmma descriptors name.  Two Q
// tiles (the next q tile's loads while this one is computed), then the
// K/V ring of 3 stages, each stage's key positions and header (tile
// index, mask-free), and the barriers.
//
// Head dim 256 does not fit that: two 64 KB Q tiles and three 64 KB K/V
// stages are 320 KB against the 227 KB a block may hold.  Its instance
// takes FlashAttention-3's answer for hdim 256, one Q buffer and 2 stages
// (192 KB): the next q tile's Q waits for this one's last product, its K/V
// tiles still load ahead.  Its consumers hold O as 128 floats a thread
// beside S's 32 and P's 32 words, so setmaxnreg gives them 232 registers
// and the producer 40 (the 168 a thread of the launch, moved between the
// warpgroups); the other head dims keep 224 and 56.
template <int D>
struct Cfg {
  static constexpr int kQBufs = D == 256 ? 1 : 2;      // Q tiles
  static constexpr int kStages = D == 256 ? 2 : 3;     // K/V tiles in flight
  static constexpr int kProducerRegs = D == 256 ? 40 : 56;
  static constexpr int kConsumerRegs = D == 256 ? 232 : 224;
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes per row
  static constexpr int kBoxCols = kSwizzle / 2;        // bf16 per box row
  static constexpr int kBoxes = D / kBoxCols;          // boxes across D
  static constexpr int kQBox = kRows * kSwizzle;       // bytes per Q box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kBox = kBK * kSwizzle;          // bytes per K/V box
  static constexpr int kTile = kBoxes * kBox;          // a K or a V tile
  static constexpr int kStage = 2 * kTile;             // K then V
  static constexpr int kRingOff = kQBufs * kQTile;
  static constexpr int kPosOff = kRingOff + kStages * kStage;  // kBK ints
  static constexpr int kHdrOff = kPosOff + kStages * kBK * 4;  // 2 ints
  static constexpr int kBarOff = kHdrOff + kStages * 8;
  // full[kStages], empty[kStages], q_full[kQBufs], q_empty[kQBufs]
  static constexpr int kBytes =
      kBarOff + (2 * kStages + 2 * kQBufs) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block holds at most 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Waits for the phase of the given parity to complete.  A ring that never
// fills (a fault) traps after ~2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// box (c0, c1, c2, c3) of a 4-D tensor map into shared memory at dst,
// completing bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// 2^x by the SFU's approximation (relative error ~2^-22, below what the
// bf16 pair of a weight keeps; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulators before wgmma_wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with a
// kSwizzle-byte swizzle (1024-byte aligned rows groups): start address,
// leading byte offset (K-major: unused, 16; MN-major: the stride between
// boxes along N), stride byte offset (8 rows), swizzle mode.
template <int kSwizzle>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * kSwizzle >> 4) << 32) |
         (static_cast<uint64_t>(kSwizzle == 128 ? 1 : 2) << 62);
}

// O (64 rows x N, float32) += P (64 x 16 bf16, registers as mma.sync's A
// fragments, one 16-row slice per warp) x V (16 x N, shared memory, read
// N-major: V as it lies, through the transpose bit).
__device__ __forceinline__ void wgmma_pv_n32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_pv_n64(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_pv_n128(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D (64 x 64, float32) (+)= A (64 x 16 bf16) x B (16 x 64 bf16), both
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O += P V over N output columns; N = 256 as two n128 products on the
// halves of V's columns (boxes 0-1 and 2-3, `half` bytes apart), whose
// accumulators are o[0..63] and o[64..127] in the one-instruction layout
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t desc, uint32_t half = 0) {
  if constexpr (N == 32) wgmma_pv_n32(d, a, desc);
  if constexpr (N == 64) wgmma_pv_n64(d, a, desc);
  if constexpr (N == 128) wgmma_pv_n128(d, a, desc);
  if constexpr (N == 256) {
    wgmma_pv_n128(d, a, desc);
    wgmma_pv_n128(d + 64, a, desc + (half >> 4));  // start address field
  }
}

// Work item i (a q tile of one row and head block: query heads g0 ..
// g0 + n - 1 of kv head h, gb = ceil(G / rep) a block): the q tiles with
// the most keys (the last of each row) first.
struct Item {
  int qt, h, b, g0, n;
  __device__ __forceinline__ Item(int i, int B, int Hkv, int rep, int G,
                                  int n_qt) {
    const int HB = Hkv * rep, gb = (G + rep - 1) / rep, hb = i % HB;
    qt = n_qt - 1 - i / (B * HB);
    b = (i / HB) % B;
    h = hb / rep;
    g0 = (hb % rep) * gb;
    n = min(gb, G - g0);
  }
};

// The it-th work item of this block: round it of the items, taken in
// snake order (forward in even rounds, backward in odd ones), so that the
// blocks' sums of the descending item costs stay close.
__device__ __forceinline__ int item_of(int it) {
  const int k = it % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return it * gridDim.x + k;
}

// Persistent: gridDim.x blocks (one per SM) take the work items in turn
// (item_of); producer and consumers walk the same list, so the producer
// loads the next item's Q and first K/V tiles while the consumers finish
// the current one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const int32_t* __restrict__ positions, __nv_bfloat16* __restrict__ out,
    int B, int T_len, int Hq, int Hkv, int rep, int hd, int bq, int n_qt,
    int window, int prefix_len, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // tiles at a 1024-byte boundary: the swizzle repeats every 8 rows
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_tiles = smem_u32(smem);
  const uint32_t tiles = q_tiles + C::kRingOff;
  int* pos_s = reinterpret_cast<int*>(smem + C::kPosOff);
  int* hdr = reinterpret_cast<int*>(smem + C::kHdrOff);
  const uint32_t full_bar = q_tiles + C::kBarOff;
  const uint32_t empty_bar = full_bar + C::kStages * 8;
  const uint32_t q_full = empty_bar + C::kStages * 8;  // kQBufs Q tiles
  const uint32_t q_empty = q_full + 8 * C::kQBufs;

  const int G = Hq / Hkv, gb = (G + rep - 1) / rep;  // heads a block
  const int n_items = B * Hkv * rep * n_qt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);        // the producer warp's lanes
      mbar_init(empty_bar + 8 * s, 4 * kConsumers);  // consumer warps
    }
    for (int s = 0; s < C::kQBufs; ++s) {
      mbar_init(q_full + 8 * s, 1);           // the producer's TMA
      mbar_init(q_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // producer: one warp walks the items' Q and K/V tiles, classifies each
    // K/V tile and feeds the needed ones through the ring, an item's last
    // followed by an end marker
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::kProducerRegs));
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it * gridDim.x < n_items; ++it) {
      const int i = item_of(it);
      if (i >= n_items) break;
      const Item w(i, B, Hkv, rep, G, n_qt);
      const int q0 = w.qt * bq, q_end = min(q0 + bq, T_len);
      const int32_t* pos_row = positions + (int64_t)w.b * T_len;
      // the q tile's largest and smallest valid position, and any pad
      int q_max = -1, q_min = INT_MAX, has_pad = 0;
      for (int t = q0 + lane; t < q_end; t += 32) {
        const int p = pos_row[t];
        q_max = max(q_max, p);
        if (p >= 0)
          q_min = min(q_min, p);
        else
          has_pad = 1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q_max = max(q_max, __shfl_xor_sync(kFull, q_max, o));
        q_min = min(q_min, __shfl_xor_sync(kFull, q_min, o));
        has_pad |= __shfl_xor_sync(kFull, has_pad, o);
      }
      // Q: (D, gb heads, bq tokens) boxes; past T, hd and Hq zero-filled
      const uint32_t qb = it % C::kQBufs;
      mbar_wait(q_empty + 8 * qb, ((it / C::kQBufs) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(q_full + 8 * qb, 2 * D * gb * bq);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(q_tiles + qb * C::kQTile + c * C::kQBox, &q_map,
                   q_full + 8 * qb, c * C::kBoxCols, w.h * G + w.g0, q0,
                   w.b);
      }
      const int n_kt = (T_len + kBK - 1) / kBK;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * kBK;
        int pk[kBK / 32];
        int maybe = 0, live = 1;
#pragma unroll
        for (int j = 0; j < kBK / 32; ++j) {
          const int ki = k0 + 32 * j + lane;
          pk[j] = ki < T_len ? pos_row[ki] : -1;
          maybe |= key_maybe(pk[j], q_max, q_min, window, prefix_len);
          live &= ki < T_len && pk[j] >= 0 && pk[j] <= q_min &&
                  (window <= 0 || pk[j] > q_max - window);
        }
        // skipped: no key can be unmasked for a query of the tile, and
        // the K/V tile misses the tile's diagonal (by index)
        if (!__any_sync(kFull, maybe) && !(k0 < q_end && q0 < k0 + kBK))
          continue;
        // mask-free: every (query, key) pair is unmasked by position
        const int all_live = __all_sync(kFull, live);
        const int mask_free = !has_pad && all_live;
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
#pragma unroll
        for (int j = 0; j < kBK / 32; ++j)
          pos_s[stage * kBK + 32 * j + lane] = pk[j];
        const uint32_t fb = full_bar + 8 * stage;
        if (lane == 0) {
          hdr[2 * stage] = kt;
          hdr[2 * stage + 1] = mask_free;
          mbar_arrive_tx(fb, C::kStage);
          const uint32_t kb = tiles + stage * C::kStage;
#pragma unroll
          for (int c = 0; c < C::kBoxes; ++c) {
            tma_load(kb + c * C::kBox, &k_map, fb, c * C::kBoxCols, w.h, k0,
                     w.b);
            tma_load(kb + C::kTile + c * C::kBox, &v_map, fb,
                     c * C::kBoxCols, w.h, k0, w.b);
          }
        } else {
          mbar_arrive(fb);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
      if (lane == 0) hdr[2 * stage] = -1;  // the item's end
      mbar_arrive(full_bar + 8 * stage);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg holds query rows [64 wg, 64 wg + 64) of a q
  // tile, warp w of it rows 16 w .. 16 w + 15 of those
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      C::kConsumerRegs));
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const float c = scale * kLog2e;   // exp(x * scale) = exp2(x * c)
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it * gridDim.x < n_items; ++it) {
    const int i = item_of(it);
    if (i >= n_items) break;
    const Item w(i, B, Hkv, rep, G, n_qt);
    const int q0 = w.qt * bq;
    const int64_t row0 = (int64_t)w.b * T_len;
    int pq[2], qi[2];
    bool valid[2];
    int64_t q_off[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * wg + 16 * warp + grp + 8 * hh;
      const int t = q0 + r / gb;
      valid[hh] = r < bq * gb && t < T_len && r % gb < w.n;
      pq[hh] = valid[hh] ? positions[row0 + t] : -1;
      qi[hh] = valid[hh] ? t : -1;
      q_off[hh] =
          ((row0 + t) * Hq + (int64_t)w.h * G + w.g0 + r % gb) * hd;
    }
    // o[4 nd + e]: row grp (e < 2) or grp + 8, column 8 nd + 2 tig + e % 2
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums
    const uint32_t qb = it % C::kQBufs;
    const uint32_t qa = q_tiles + qb * C::kQTile + 64 * wg * C::kSwizzle;
    mbar_wait(q_full + 8 * qb, (it / C::kQBufs) & 1);

    for (;;) {
      mbar_wait(full_bar + 8 * stage, phase);
      const int kt = hdr[2 * stage];
      if (kt < 0) {  // the item's end: hand the stage back
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
        break;
      }
      const int mask_free = hdr[2 * stage + 1];
      const uint32_t kb = tiles + stage * C::kStage;

      // S = Q K^T: k-step kk reads dims [16 kk, 16 kk + 16) of Q and K,
      // 32 bytes into box (32 kk) / kSwizzle
      float s[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (32 * kk / C::kSwizzle) * C::kBox +
                             (32 * kk) % C::kSwizzle;
        const uint32_t qoff = (32 * kk / C::kSwizzle) * C::kQBox +
                              (32 * kk) % C::kSwizzle;
        wgmma_ss_n64(s, smem_desc<C::kSwizzle>(qa + qoff, 16),
                     smem_desc<C::kSwizzle>(kb + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<kBK / 2>(s);

      // s[4 j + 2 hh + e] is row hh, key 8 j + 2 tig + e of the tile
      if (!mask_free) {
        const int k0 = kt * kBK;
        const int* pos_t = pos_s + stage * kBK;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * j + 2 * tig + e;
            const int ki = k0 + kc;
            const int pk = pos_t[kc];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float& x = s[4 * j + 2 * hh + e];
              x = ki < T_len &&
                          pair_live(pk, pq[hh], ki, qi[hh], window, prefix_len)
                      ? x
                      : kNegInf;
            }
          }
      }
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mt[hh] = fmaxf(mt[hh],
                         fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      float alpha[2], msc[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(kFull, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(kFull, mt[hh], 2));
        const float m_new = fmaxf(m[hh], mt[hh]);
        alpha[hh] = exp2_approx((m[hh] - m_new) * c);
        m[hh] = m_new;
        // while a row has met only masked keys they weigh 0 (every row
        // has a live key, its diagonal, which the oracle's weights come to)
        msc[hh] = m_new == kNegInf ? 0.f : m_new * c;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[4 * nd] *= alpha[0];
        o[4 * nd + 1] *= alpha[0];
        o[4 * nd + 2] *= alpha[1];
        o[4 * nd + 3] *= alpha[1];
      }
      // P = exp2(S c - m c) as A fragments: score n-tiles 2 jj and 2 jj + 1
      // are the k-step jj of P V.  Each weight is a bf16 pair hi + lo that
      // carries ~16 bits: one bf16 alone moved outputs by a bf16 ulp
      // against the plain version (0.031 at |o| in [4, 8), past the 2e-2
      // tolerance)
      uint32_t pa[kBK / 16][4], pa_lo[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = exp2_approx(fmaf(s[4 * j + 2 * hh], c, -msc[hh]));
          const float p1 =
              exp2_approx(fmaf(s[4 * j + 2 * hh + 1], c, -msc[hh]));
          l[hh] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              p0 - __low2float(hi), p1 - __high2float(hi));
          pa[j / 2][hh + 2 * (j % 2)] =
              *reinterpret_cast<const uint32_t*>(&hi);
          pa_lo[j / 2][hh + 2 * (j % 2)] =
              *reinterpret_cast<const uint32_t*>(&lo);
        }
      // O += P V: k-step jj reads keys [16 jj, 16 jj + 16), V N-major
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) {
        const uint64_t vd = smem_desc<C::kSwizzle>(
            kb + C::kTile + 16 * jj * C::kSwizzle, C::kBox);
        wgmma_pv<D>(o, pa[jj], vd, 2 * C::kBox);
        wgmma_pv<D>(o, pa_lo[jj], vd, 2 * C::kBox);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(o);

      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);  // the tile is read
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * qb);  // Q is read

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
      l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
      if (!valid[hh]) continue;
      const float inv = 1.f / l[hh];
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        if (8 * nd >= hd) break;  // hd is a multiple of 16
        const __nv_bfloat162 x = __floats2bfloat162_rn(
            o[4 * nd + 2 * hh] * inv, o[4 * nd + 2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + q_off[hh] + 8 * nd +
                                           2 * tig) = x;
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, H, T, B) of a (B, T, H, hd) bf16 tensor whose box is
// one swizzle row of dims, `heads` heads and `tokens` tokens of one row:
// box elements past hd, H or T are filled with zeros and not read.
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, int B, int T_len, int H,
                int hd, int heads, int tokens) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * H,
                                 2ull * hd * H * T_len};
  const cuuint32_t box[4] = {C::kBoxCols, static_cast<cuuint32_t>(heads),
                             static_cast<cuuint32_t>(tokens), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int D>
int launch(int hd, const void* q, const void* k, const void* v,
           const void* positions, void* out, int B, int T_len, int Hq,
           int Hkv, int window, int prefix_len, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int rep = (G + kMostHeads - 1) / kMostHeads;  // head blocks
  const int gb = (G + rep - 1) / rep;                 // heads a block
  const int bq = kRows / gb;  // query tokens per q tile
  const int n_qt = (T_len + bq - 1) / bq;
  const int64_t items = (int64_t)B * Hkv * rep * n_qt;
  const int n_sm = sm_count();
  if (bq < 1 || items > INT_MAX || n_sm == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map<D>(&q_map, q, B, T_len, Hq, hd, gb, bq) ||
      !tensor_map<D>(&k_map, k, B, T_len, Hkv, hd, 1, kBK) ||
      !tensor_map<D>(&v_map, v, B, T_len, Hkv, hd, 1, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // per instance: dynamic smem above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<D>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int grid = static_cast<int>(items < n_sm ? items : n_sm);
  flash_prefill_kernel<D><<<grid, kThreads, Cfg<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<const int32_t*>(positions),
      static_cast<__nv_bfloat16*>(out), B, T_len, Hq, Hkv, rep, hd, bq, n_qt,
      window, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch(int dtype, int hd, const void* q, const void* k, const void* v,
           const void* positions, void* out, int B, int T_len, int Hq,
           int Hkv, int window, int prefix_len, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<D>(hd, q, k, v, positions, out, B, T_len, Hq, Hkv,
                           window, prefix_len, scale, stream);
  if (dtype == 1)
    return tc::launch<D>(hd, q, k, v, positions, out, B, T_len, Hq, Hkv,
                         window, prefix_len, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,T,Hq,hd); k/v (B,T,Hkv,hd); positions (B,T) int32 (pads < 0); out
// (B,T,Hq,hd).  dtype 0 is float32, 1 is bfloat16; hd a multiple of 16
// in [16, 256] (on the instance D of {32, 64, 128, 256} at or above it);
// Hq a multiple of Hkv, any group (above 64 query heads a KV head, or
// 8192 / D in float32, as head blocks); any T >= 1; q, k, v and out
// 16-byte aligned; window <= 0 means none; keys at positions [0,
// prefix_len) are seen by every valid query (0: none).  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* positions,
                                    void* out, int B, int T_len, int Hq,
                                    int Hkv, int hd, int window,
                                    int prefix_len, float scale,
                                    void* stream) {
  if (B == 0 || T_len == 0 || Hkv == 0) return 0;
  if (Hkv < 0 || Hq < Hkv || Hq % Hkv || hd < 16 || hd > 256 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch<32>(dtype, hd, q, k, v, positions, out, B, T_len, Hq, Hkv,
                      window, prefix_len, scale, s);
  if (hd <= 64)
    return launch<64>(dtype, hd, q, k, v, positions, out, B, T_len, Hq, Hkv,
                      window, prefix_len, scale, s);
  if (hd <= 128)
    return launch<128>(dtype, hd, q, k, v, positions, out, B, T_len, Hq,
                       Hkv, window, prefix_len, scale, s);
  return launch<256>(dtype, hd, q, k, v, positions, out, B, T_len, Hq, Hkv,
                     window, prefix_len, scale, s);
}
