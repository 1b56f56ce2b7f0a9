// The split-slot decode attention loop shared by the three decode kernels:
// decode_attention.cu (a dense (B, W, Hkv, D) cache), paged_decode_attention
// .cu and fused_rope_decode_append.cu (a (P, pg, Hkv, D) page pool through
// the block table).
//
// Bound: bytes.  A decode step streams every live K/V slot of every row
// once; 4 * G flops per K/V element is far below the card's ~295 flop/byte
// balance point.  The slices decode 1 to 16 rows of 8 KV heads, so one
// block per (row, kv head) left most of the 132 SMs idle while each block
// walked hundreds of slots.  So each kernel runs two passes:
//  - Pass 1, grid (split, head block, row): split s takes the row's slots
//    [s * chunk, (s + 1) * chunk), chunk a multiple of the 16-slot step
//    chosen by the wrapper from shapes alone (decode_attention.split_slots)
//    so that the grid holds at least two blocks per SM.  The block writes
//    its query heads (at most kMaxG) as floats to shared memory, then
//    split_pass stages the range's slot_pos there (one coalesced read
//    that also decides whether the split has a live slot) with, for a
//    page pool, the range's block-table entries, all loads in flight
//    before one barrier, and runs attend_split: its 4 warps take the
//    range's 16-slot steps in turn (64-slot block tiles), each
//    warp with a cp.async ring of its own (2 to 4 steps in flight, by what
//    ~16 KB hold; at head dim 256 see SplitSmem), a running softmax per
//    query head and no block barrier in the loop.  A step's scores and
//    its P V product:
//     - bfloat16, on the tensor cores: mma.sync m16n8k16 with the G query
//       heads as the rows of A (G padded to 16), K's and V's fragments by
//       ldmatrix (.trans for V) from rows padded by 16 bytes, P a bf16
//       pair per weight.  A first version on the CUDA cores was issue-
//       and latency-bound (~680 instructions per step and warp, each
//       score's parts summed by shuffles).
//     - float32, on the CUDA cores: slot s of a step belongs to lanes s and
//       s + 16, each scoring half of K's row against q in shared memory (a
//       broadcast); lane i accumulates output dims [i D / 32, (i + 1) D /
//       32) of every head.
//    The block merges its warps' softmaxes and writes the split's partial
//    (m, l, acc[G][D]) in float32 to the workspace.
//  - Pass 2 (merge_kernel), a warp per (row, query head), folds the row's
//    partials into one softmax with several partials' loads in flight and
//    writes q's type.  It is launched as pass 1's programmatic dependent
//    (launch_merge), so its launch overlaps pass 1.
// What the split must get right:
//  - A row with no live slot weighs every slot alike (the oracle's finite
//    NEG_INF).  A step may be skipped only when the row has a live slot
//    somewhere: a split that finds no live slot in its own range reads the
//    rest of the row's slot_pos.  In a live row it writes an empty partial
//    (m = -inf, l = 0), which pass 2 weighs 0; in a dead row it walks its
//    steps summing V with weight 1 (no K is read), and pass 2 weighs the
//    splits alike: the mean of V.
//  - slot_pos need not be sorted (a ring cache): splits are ranges of slot
//    indices and liveness is read per slot.
//  - W need not divide the split or the step: slots past W are neither
//    loaded (zero-filled copies) nor weighed (score -inf).
//  - Head dims: an instance is compiled at a head dim D (kHeadDims) and
//    serves every call head dim hd <= D that is a multiple of 16 (the
//    smallest instance at or above it, with_head_dim).  Rows lie in
//    memory at stride hd; a row's 16-byte chunks past hd are not loaded
//    (the copies zero-fill them), nor are q's dims past hd (zeros in
//    shared memory), so they add nothing to q . k, and the output's dims
//    past hd are not stored.  The workspace is laid out at D.
//  - Groups: the G query heads of a KV head run as `rep` head blocks of
//    at most kMaxG heads (HeadBlock: ceil(G / rep) heads each, the last
//    ragged), each its own block of the grid reading the KV head's slots,
//    so any G runs (71 as eight blocks of 8 and one of 7).  Each block
//    is one of kMaxG heads or fewer of the same instance: no new
//    registers or shared memory.  The price is that every block of a KV
//    head reads its slots (the others may find them in L2).
//  - Where a slot's K/V row lies comes from a functor (paged_attention.cuh:
//    DenseRows, PagedRows), asked once per 8-slot half of a step where
//    the half's slots are contiguous (a dense cache, or pages of any
//    multiple of 8 slots: a half starts at a multiple of 8, so it lies in
//    one page), and once per slot for any other page size (1, 2, 4, 12,
//    ...).  Nothing needs a page to lie in one split: splits are ranges
//    of slots, a page that straddles two splits has its table entry
//    staged by both, and each block reads only its own slots.  The
//    per-slot loop alone would serve every size, but at pg 16 and 32 it
//    is 4-22 % slower at MHA heads and at rows of many slots (PERF.md),
//    so the per-half loop stays where it applies.
// Everything here has internal linkage: each kernel library holds its own
// instances.
#pragma once

#include <type_traits>

#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int kPage = 16;              // slots per step of a warp
constexpr int kSplitWarps = 4;         // warps of a pass-1 block
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 1024;       // partials a merge warp folds
constexpr int kMaxChunk = 2048;        // slots of a split (slot_pos staged)

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a pass-1 block: per warp a ring of kStages steps (K and
// V rows padded by 16 bytes, so that a quarter-warp's loads and the eight
// rows of an ldmatrix hit distinct banks), the step's weights and each
// stage's live-slot mask; then q (G, D) as floats, the warps' partials for
// the in-block merge, the split's slot_pos and its block-table entries
// (pages of pg slots: at most chunk / pg + 2, a page cut at either end).
//
// Head dim 256 makes a step 16.5 KB in bfloat16 and 32.5 KB in float32.
// The stages are sized by the step, not the warps: 2 stages a warp in
// bfloat16 (134 KB of rings, ~184 KB a block at G 8 and the longest
// split: one block an SM, each warp's next step in flight while it
// computes one), and 1 in float32 at D 192 and 256 (4 x 2 stages would
// be 200 and 266 KB, which with q and the merge pass the 227 KB a block
// may hold; a warp then loads a step and computes it in turn, the 4 warps
// overlapping each other).  Four warps stay, as every other instance has
// them, so that the in-block merge and the grid are those of the other
// head dims.
template <typename T, int D>
struct SplitSmem {
  static constexpr int kRow = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int kPadRow = kRow + 16;
  static constexpr int kPageBytes = 2 * kPage * kPadRow;  // K, then V
  // steps in flight per warp: as many as ~16 KB hold, 2 to 4; one where a
  // step passes 24 KB (float32 at D 192 and 256)
  static constexpr int kStages =
      kPageBytes > 24576 ? 1
      : (16384 / kPageBytes >= 4 ? 4 : (16384 / kPageBytes >= 3 ? 3 : 2));
  static constexpr int kWarpBytes = kStages * kPageBytes +
                                    kMaxG * kPage * 4 +  // weights (G, step)
                                    16;                  // live masks
  static constexpr int kQOff = kSplitWarps * kWarpBytes;
  // then the split's slot_pos values (at most chunk) and right after
  // them its table entries (at most chunk / pg + 2; a dense cache stages
  // none and sizes them as pages of 8)
  __host__ __device__ static constexpr size_t sp_off(int G) {
    return kQOff + sizeof(float) * (G * D + kSplitWarps * G * (D + 2));
  }
  __host__ __device__ static constexpr size_t bytes(int G, int chunk,
                                                    int pg = 8) {
    return sp_off(G) + sizeof(int32_t) * (chunk + chunk / pg + 2);
  }
};

// float32 on the CUDA cores.  Lane i holds output dims [i D / 32,
// (i + 1) D / 32) of every head; slot s of a step belongs to lanes s and
// s + 16, each scoring half of K's row (16-byte chunks) against q_s.
template <typename T, int D>
struct SimtWarp {
  static constexpr int kParts = 32 / kPage;  // lanes per slot
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kMine = kChunks / kParts;
  static constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  static constexpr int kDims = D / 32;
  static_assert(kChunks % kParts == 0, "K halves are whole chunks");
  float m[kMaxG], l[kMaxG], acc[kMaxG][kDims];

  __device__ __forceinline__ void load_q(const float*, int) {}
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = kMinusInf;  // nothing seen: weighs 0 in the merges
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[g][i] = 0.f;
    }
  }
  // one step: K and V rows (row stride kPadRow), mask of its live slots,
  // its first n_in slots in range
  __device__ __forceinline__ void weigh(const char* kb, const char* vb,
                                        const float* q_s, float* p_w,
                                        uint32_t mask, bool uniform, int n_in,
                                        int G, float scale) {
    using S = SplitSmem<T, D>;
    const int lane = threadIdx.x & 31;
    const int s = lane % kPage, half = lane / kPage;
    const bool in = s < n_in;
    const bool live = (mask >> s) & 1u;
    float sc[kMaxG];
    if (uniform) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = in ? kNegInf : kMinusInf;
    } else {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kMine; ++e) {
        const int c = half + kParts * e;
        float kf[kPerChunk];
        load_floats<T, kPerChunk>(
            reinterpret_cast<const T*>(kb + s * S::kPadRow + c * 16), kf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          const float* qg = q_s + g * D + c * kPerChunk;
#pragma unroll
          for (int x = 0; x < kPerChunk; x += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + x);
            sc[g] += qv.x * kf[x] + qv.y * kf[x + 1] + qv.z * kf[x + 2] +
                     qv.w * kf[x + 3];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int o = kPage; o < 32; o <<= 1)
          sc[g] += __shfl_xor_sync(kFull, sc[g], o);  // sum the halves
        sc[g] = live ? sc[g] * scale : (in ? kNegInf : kMinusInf);
      }
    }
    float alpha[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float mx = sc[g];
#pragma unroll
      for (int o = 1; o < kPage; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[g], mx);  // finite: a slot weighs
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      if (half == 0) p_w[g * kPage + s] = expf(sc[g] - m_new);
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      l[g] *= alpha[g];
#pragma unroll
      for (int x = 0; x < kDims; ++x) acc[g][x] *= alpha[g];
    }
#pragma unroll
    for (int t = 0; t < kPage; t += 4) {
      float v[4][kDims];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load_floats<T, kDims>(
            reinterpret_cast<const T*>(vb + (t + u) * S::kPadRow) +
                lane * kDims,
            v[u]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float4 p = *reinterpret_cast<const float4*>(p_w + g * kPage + t);
        l[g] += (p.x + p.y) + (p.z + p.w);
#pragma unroll
        for (int x = 0; x < kDims; ++x)
          acc[g][x] += p.x * v[0][x] + p.y * v[1][x] + p.z * v[2][x] +
                       p.w * v[3][x];
      }
    }
  }
  __device__ __forceinline__ void store(float* mine, int G) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      if (lane == 0) {
        mine[g] = m[g];
        mine[G + g] = l[g];
      }
#pragma unroll
      for (int x = 0; x < kDims; ++x)
        mine[2 * G + g * D + lane * kDims + x] = acc[g][x];
    }
  }
};

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// four 8x8 bf16 tiles from shared memory, row addresses from lanes 8 i ..
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ uint32_t pack(float lo_x, float hi_x) {
  const __nv_bfloat162 w = __floats2bfloat162_rn(lo_x, hi_x);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// bfloat16 on the tensor cores: mma.sync m16n8k16 with the G query heads
// as rows 0..G-1 of A (rows G..15 zero: G is padded to 16).  S = Q K^T
// for a step is two n-tiles of 8 slots, K's B fragments by ldmatrix from
// its (slot, dim) rows; P V takes P from the S fragments and V's B
// fragments by ldmatrix.trans, each weight a bf16 pair (high and low
// part, two products) so that P keeps ~16 bits.  Lane (grp, tig) holds
// head grp: its scores of slots 8 n + 2 tig + {0, 1} and output dims
// 8 n + 2 tig + {0, 1}.  Rows 8..15 of each product are 0 (A's padding
// rows); at head dims 192 and 256 they are not kept between products,
// which saves the 48 or 64 registers that otherwise push the kernel
// toward 255 and into spills; the other head dims keep all four values
// of each fragment.
template <int D>
struct MmaWarp {
  static constexpr int kKept = D > 160 ? 2 : 4;  // values kept a fragment
  uint32_t qa[D / 16][2];  // head grp, dims 16 kk + 2 tig (+ 8)
  float m, l;              // running max; this lane's part of the sum
  float o[D / 8][kKept];   // [2], [3]: rows 8..15, always 0

  // A's fragments from q (G, D) as floats in shared memory: bf16 values
  // (the input's, or the fused kernel's rotated q rounded to bf16), so
  // the conversion back is exact
  __device__ __forceinline__ void load_q(const float* q_s, int G) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x =
            grp < G ? *reinterpret_cast<const float2*>(
                          q_s + grp * D + 16 * kk + 8 * h + 2 * tig)
                    : make_float2(0.f, 0.f);
        qa[kk][h] = pack(x.x, x.y);
      }
  }
  __device__ __forceinline__ void reset() {
    m = kMinusInf;
    l = 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < kKept; ++e) o[nd][e] = 0.f;
  }
  __device__ __forceinline__ void weigh(const char* kb, const char* vb,
                                        const float*, float*, uint32_t mask,
                                        bool uniform, int n_in, int,
                                        float scale) {
    constexpr int kPadRow = SplitSmem<__nv_bfloat16, D>::kPadRow;
    const int lane = threadIdx.x & 31, tig = lane & 3;
    const int mat = lane >> 3, r = lane & 7;  // this lane's ldmatrix row
    float x[2][4] = {};
    if (!uniform) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];  // slots 0-7 / 8-15, dims 16 kk .. / + 8
        ldsm_x4(kb + (r + 8 * (mat >> 1)) * kPadRow +
                    (16 * kk + 8 * (mat & 1)) * 2,
                b);
        mma(x[0], qa[kk][0], qa[kk][1], b[0], b[1]);
        mma(x[1], qa[kk][0], qa[kk][1], b[2], b[3]);
      }
    }
    float mx = kMinusInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * n + 2 * tig + e;
        const bool in = t < n_in;
        const bool live = !uniform && ((mask >> t) & 1u);
        x[n][e] = live ? x[n][e] * scale : (in ? kNegInf : kMinusInf);
        mx = fmaxf(mx, x[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: a slot weighs
    const float alpha = expf(m - m_new);
    m = m_new;
    float p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[n][e] = expf(x[n][e] - m_new);
    l = l * alpha + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    const uint32_t hi0 = pack(p[0][0], p[0][1]), hi2 = pack(p[1][0], p[1][1]);
    const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&hi0);
    const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi2);
    const uint32_t lo0 = pack(p[0][0] - __low2float(h0),
                              p[0][1] - __high2float(h0));
    const uint32_t lo2 = pack(p[1][0] - __low2float(h2),
                              p[1][1] - __high2float(h2));
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t b[4];  // slots 0-7 / 8-15 of dims 8 nd .. / 8 (nd + 1) ..
      ldsm_x4_t(vb + (r + 8 * (mat & 1)) * kPadRow + 8 * (nd + (mat >> 1)) * 2,
                b);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        o[nd + u][0] *= alpha;
        o[nd + u][1] *= alpha;
        if constexpr (kKept == 4) {
          mma(o[nd + u], hi0, hi2, b[2 * u], b[2 * u + 1]);
          mma(o[nd + u], lo0, lo2, b[2 * u], b[2 * u + 1]);
        } else {
          float c[4] = {o[nd + u][0], o[nd + u][1], 0.f, 0.f};
          mma(c, hi0, hi2, b[2 * u], b[2 * u + 1]);
          mma(c, lo0, lo2, b[2 * u], b[2 * u + 1]);
          o[nd + u][0] = c[0];
          o[nd + u][1] = c[1];
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* mine, int G) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    if (grp >= G) return;
    if (tig == 0) {
      mine[grp] = m;
      mine[G + grp] = l;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mine[2 * G + grp * D + 8 * nd + 2 * tig + e] = o[nd][e];
  }
};

template <typename T, int D>
using WarpOf = std::conditional_t<std::is_same_v<T, __nv_bfloat16>,
                                  MmaWarp<D>, SimtWarp<T, D>>;

// Pass 1's work for one split: the slots [lo, hi) of a row (lo a multiple
// of the step) for the G query heads of a head block of kv head h, with q
// (G, D) as floats (zeros past the call's head dim hd <= D, the K/V rows'
// stride) and the range's slot_pos (sp_s[i] for slot lo + i) in shared
// memory, published by the caller; rows(slot) gives a slot's K/V row in
// the (row, Hkv, hd) arrays, asked for the first slot of each 8-slot half, or
// for every slot where Rows::kSlotwise.
// uniform: the row has no live slot, so every slot of the split weighs 1
// (the oracle's finite NEG_INF) and only V is read; otherwise steps
// without a live slot are skipped.  Writes the split's partial (m[G],
// l[G], acc[G][D]) at part.  The K/V arrays are read by cp.async alone
// (not __restrict__: the fused kernel writes them before the call).
template <typename T, int D, typename Rows>
__device__ __forceinline__ void attend_split(
    char* smem, const T* k_pages, const T* v_pages, Rows rows,
    const int32_t* sp_s, int qp, int lo, int hi, int G, int Hkv, int h,
    int hd, int window, float scale, bool uniform, float* __restrict__ part) {
  using S = SplitSmem<T, D>;
  constexpr int kStages = S::kStages;
  constexpr int kChunks = S::kRow / 16;  // 16-byte chunks of a row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kHalf = kPage / 2;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = lane % kPage;  // this lane's slot in a step
  char* base = smem + warp * S::kWarpBytes;
  float* p_w = reinterpret_cast<float*>(base + kStages * S::kPageBytes);
  uint32_t* masks = reinterpret_cast<uint32_t*>(p_w + kMaxG * kPage);
  const float* q_s = reinterpret_cast<const float*>(smem + S::kQOff);
  float* merge_s = reinterpret_cast<float*>(smem + S::kQOff) + G * D;

  // this warp's steps: j0 + warp + i * kSplitWarps for i < n_mine
  const int j0 = lo / kPage, j1 = (hi + kPage - 1) / kPage;
  const int n_mine =
      j1 - j0 > warp ? (j1 - j0 - warp + kSplitWarps - 1) / kSplitWarps : 0;
  auto first_slot = [&](int i) {
    return (j0 + warp + i * kSplitWarps) * kPage;
  };

  WarpOf<T, D> acc;
  acc.load_q(q_s, G);
  acc.reset();
  // copies step i into its stage, with its live-slot mask (0: skipped)
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int first = first_slot(i);
    const int slot = first + s;
    const uint32_t mask =
        uniform ? ~0u
                : __ballot_sync(kFull, slot < hi && slot_live(sp_s[slot - lo],
                                                              qp, window));
    if (lane == 0) masks[st] = mask;
    if constexpr (Rows::kSlotwise) {
      // a half may span pages: each copy asks for its own slot's row
      // (only for a slot of the range: a block table ends at W)
      if (mask) {
        char* kb = base + st * S::kPageBytes;
        char* vb = kb + kPage * S::kPadRow;
        for (int e = lane; e < kPage * kChunks; e += 32) {
          const int t = e / kChunks, c = e % kChunks;
          const bool in = first + t < hi && c * kPerChunk < hd;
          const int64_t off =
              in ? (rows(first + t) * Hkv + h) * hd + c * kPerChunk : 0;
          const int at = t * S::kPadRow + c * 16;
          if (!uniform) cp_async_16(kb + at, k_pages + off, in);
          cp_async_16(vb + at, v_pages + off, in);
        }
      }
    } else if (mask) {
      // the rows of the step's two 8-slot halves (the second asked only
      // where it holds a slot of the range: a block table ends at W)
      const int64_t r0 = rows(first);
      const int64_t r1 = first + kHalf < hi ? rows(first + kHalf) - kHalf
                                            : r0;
      char* kb = base + st * S::kPageBytes;
      char* vb = kb + kPage * S::kPadRow;
      for (int e = lane; e < kPage * kChunks; e += 32) {
        const int t = e / kChunks, c = e % kChunks;
        const bool in = first + t < hi && c * kPerChunk < hd;
        const int64_t off =
            (((t < kHalf ? r0 : r1) + t) * Hkv + h) * hd + c * kPerChunk;
        const int at = t * S::kPadRow + c * 16;
        if (!uniform) cp_async_16(kb + at, k_pages + (in ? off : 0), in);
        cp_async_16(vb + at, v_pages + (in ? off : 0), in);
      }
    }
    cp_async_commit();  // one group per step, empty or not
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine)
      issue(i);
    else
      cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    const int ni = i + kStages - 1;  // refills the stage read last
    if (ni < n_mine)
      issue(ni);
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();  // step i's copies are in
    __syncwarp();
    const int st = i % kStages;
    const uint32_t mask = masks[st];
    if (mask) {
      const char* kb = base + st * S::kPageBytes;
      acc.weigh(kb, kb + kPage * S::kPadRow, q_s, p_w, mask, uniform,
                min(kPage, hi - first_slot(i)), G, scale);
    }
    __syncwarp();  // stage st and p_w are read before they are refilled
  }
  cp_async_wait<0>();
  acc.store(merge_s + warp * G * (D + 2), G);  // for the in-block merge
  __syncthreads();

  // merge the warps' partials into the split's
  for (int i = threadIdx.x; i < G * D; i += kSplitThreads) {
    const int g = i / D;
    float mx = kMinusInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = fmaxf(mx, merge_s[w * G * (D + 2) + g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* pw = merge_s + w * G * (D + 2);
      const float c = expf(pw[g] - mx);  // 0 for a warp that saw nothing
      sum += pw[G + g] * c;
      o += pw[2 * G + i] * c;
    }
    if (i % D == 0) {
      part[g] = mx;
      part[G + g] = sum;
    }
    part[2 * G + i] = o;
  }
}

// Copies what a block needs to find the rows of its slots [lo, hi) into
// shared memory at bt_s by cp.async (the caller waits for the copies), and
// returns the functor that reads it there: the block-table entries of a
// page pool; nothing for a dense cache.
__device__ __forceinline__ DenseRows stage_rows(DenseRows rows, int32_t*,
                                                int, int) {
  return rows;
}
template <bool kPerSlot>
__device__ __forceinline__ StagedRows<kPerSlot> stage_rows(
    PagedRows<kPerSlot> rows, int32_t* bt_s, int lo, int hi) {
  const int j0 = lo / rows.pg, j1 = (hi + rows.pg - 1) / rows.pg;
  for (int j = j0 + static_cast<int>(threadIdx.x); j < j1; j += kSplitThreads)
    cp_async_4(bt_s + (j - j0), rows.bt_row + j);
  return StagedRows<kPerSlot>{bt_s, j0, rows.pg};
}

// The work a pass-1 block does after its first barrier and before its
// page loop: none here; the fused kernel rotates q and appends the new
// token (its functor takes the split's rows and is followed by a barrier).
struct NoPrologue {
  template <typename Rows>
  __device__ __forceinline__ void operator()(const Rows&) const {}
};

// A pass-1 block after it has written its q (G, D) as floats at
// SplitSmem::kQOff (stage_q; or issued the loads of what `post` needs):
// stages the split's slot_pos [lo, hi) of the row's W (sp_row) and the
// rows of its slots by cp.async, all copies in flight at once; after the
// barrier that publishes them, runs post(rows) (then a barrier); decides
// whether the split, or else the row, has a live slot, and runs
// attend_split on the split, or writes an empty partial.
template <typename T, int D, typename Rows, typename Post = NoPrologue>
__device__ __forceinline__ void split_pass(
    char* smem, const T* k_pages, const T* v_pages, Rows rows,
    const int32_t* __restrict__ sp_row, int W, int qp, int lo, int hi, int G,
    int Hkv, int h, int hd, int window, float scale, float* __restrict__ part,
    Post post = Post()) {
  using S = SplitSmem<T, D>;
  static_assert(S::bytes(kMaxG, kMaxChunk, 1) <= 232448,
                "a block holds at most 227 KB (pages of one slot)");
  int32_t* sp_s = reinterpret_cast<int32_t*>(smem + S::sp_off(G));
  for (int i = threadIdx.x; i < hi - lo; i += kSplitThreads)
    cp_async_4(sp_s + i, sp_row + lo + i);
  const auto staged = stage_rows(rows, sp_s + (hi - lo), lo, hi);
  cp_async_commit();
  cp_async_wait<0>();  // this thread's copies
  int any = 0;
  for (int i = threadIdx.x; i < hi - lo; i += kSplitThreads)
    any |= slot_live(sp_s[i], qp, window);
  // publishes q, sp_s, the staged rows and what the caller wrote
  any = __syncthreads_or(any);
  if constexpr (!std::is_same_v<Post, NoPrologue>) {
    post(staged);
    __syncthreads();
  }
  bool uniform = false;
  if (!any) {
    // no live slot in the split: the rest of the row decides
    for (int i = threadIdx.x; i < W; i += kSplitThreads)
      any |= slot_live(sp_row[i], qp, window);
    if (__syncthreads_or(any)) {  // a live row: the split weighs 0
      for (int i = threadIdx.x; i < G * (D + 2); i += kSplitThreads)
        part[i] = i < G ? kMinusInf : 0.f;
      return;
    }
    uniform = true;  // a dead row: every slot weighs 1
  }
  attend_split<T, D>(smem, k_pages, v_pages, staged, sp_s, qp, lo, hi, G,
                     Hkv, h, hd, window, scale, uniform, part);
}

// The head blocks of a call: the G query heads of each KV head as `rep`
// blocks of ceil(G / rep) <= kMaxG heads, the last one ragged.  Block hb
// of the grid holds heads g0 .. g0 + n - 1 of KV head h.
__host__ __device__ __forceinline__ int block_heads(int G, int rep) {
  return (G + rep - 1) / rep;
}
struct HeadBlock {
  int h, g0, n;
  __device__ __forceinline__ HeadBlock(int hb, int G, int rep) {
    const int gb = block_heads(G, rep);
    h = hb / rep;
    g0 = (hb % rep) * gb;
    n = min(gb, G - g0);
  }
};

// Writes a head block's q rows (n heads of hd values at q_row) as floats
// into q_s (n, D), zeros past hd.
template <typename T, int D>
__device__ __forceinline__ void stage_q(float* q_s, const T* q_row, int n,
                                        int hd) {
  for (int i = threadIdx.x; i < n * D; i += kSplitThreads) {
    const int g = i / D, x = i % D;
    q_s[i] = x < hd ? to_float(q_row[g * hd + x]) : 0.f;
  }
}

// The split's partial in the float32 workspace (B, Hkv * rep, n_split,
// gb, D + 2), gb = block_heads(G, rep): a block of n <= gb heads writes
// (m[n], l[n], acc[n][D]) at its start
__device__ __forceinline__ float* partial(float* ws, int b, int hb,
                                          int split, int n_blocks,
                                          int n_split, int gb, int D) {
  return ws + ((static_cast<int64_t>(b) * n_blocks + hb) * n_split + split) *
                  gb * (D + 2);
}

// Pass 2: a warp per (row, query head) folds the row's n_split partials
// of its head into one softmax (lane i holds dims [i D / 32, (i + 1) D /
// 32); several partials' loads in flight) and writes the output's first
// hd dims in T.  Launched as pass 1's programmatic dependent: it starts
// while pass 1 finishes and waits for its writes.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int B, int Hq,
    int Hkv, int rep, int n_split, int hd) {
  constexpr int kDims = D / 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int row_head = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (row_head >= B * Hq) return;
  const int b = row_head / Hq, j = row_head % Hq;
  const int G = Hq / Hkv, h = j / G;
  const int gb = block_heads(G, rep), r = (j % G) / gb, g = (j % G) % gb;
  const int n = min(gb, G - r * gb);  // heads of the block
  const int stride = gb * (D + 2);
  const float* part =
      ws + ((static_cast<int64_t>(b) * Hkv + h) * rep + r) * n_split * stride;
  float m = kMinusInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int x = 0; x < kDims; ++x) acc[x] = 0.f;
#pragma unroll 4
  for (int p = 0; p < n_split; ++p) {
    const float* pp = part + p * stride;
    const float mp = pp[g], lp = pp[n + g];
    float ap[kDims];
#pragma unroll
    for (int x = 0; x < kDims; ++x)
      ap[x] = pp[2 * n + g * D + lane * kDims + x];
    if (mp == kMinusInf) continue;  // an empty partial weighs 0
    const float m_new = fmaxf(m, mp);
    const float c_old = expf(m - m_new), c_p = expf(mp - m_new);
    l = l * c_old + lp * c_p;
#pragma unroll
    for (int x = 0; x < kDims; ++x) acc[x] = acc[x] * c_old + ap[x] * c_p;
    m = m_new;
  }
  T* o = out + static_cast<int64_t>(row_head) * hd + lane * kDims;
#pragma unroll
  for (int x = 0; x < kDims; ++x)
    if (lane * kDims + x < hd) o[x] = from_float<T>(acc[x] / l);
}

// Host side.  Whether a split's shapes are taken: head blocks of at most
// kMaxG heads and none empty, chunk a multiple of the step, at most
// kMaxChunk slots, at most kMaxSplits splits.
inline bool split_shapes_ok(int Hq, int Hkv, int rep, int W, int chunk) {
  if (W < 1 || Hkv < 1 || rep < 1 || Hq % Hkv || Hq < Hkv) return false;
  const int G = Hq / Hkv, gb = block_heads(G, rep);
  return gb <= kMaxG && (rep - 1) * gb < G &&
         static_cast<int64_t>(Hkv) * rep <= 65535 && chunk >= kPage &&
         chunk % kPage == 0 && chunk <= kMaxChunk &&
         (W + chunk - 1) / chunk <= kMaxSplits;
}

// Lets `kernel` take up to `most` bytes of dynamic shared memory where a
// launch needs `need` above 48 KB (which needs this opt-in), once per
// kernel: *done remembers it.
inline cudaError_t allow_smem(const void* kernel, size_t need, size_t most,
                              bool* done) {
  if (*done || need <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most));
  if (e == cudaSuccess) *done = true;
  return e;
}

// Launches pass 2 as the programmatic dependent of the kernel launched
// last on `stream` (pass 1); returns the launch's error.
template <typename T, int D>
int launch_merge(const float* ws, T* out, int B, int Hq, int Hkv, int rep,
                 int n_split, int hd, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * Hq + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, merge_kernel<T, D>, ws, out, B, Hq, Hkv, rep,
                         n_split, hd));
}

}  // namespace
