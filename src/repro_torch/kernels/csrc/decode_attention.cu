// Batched GQA decode attention over a dense KV cache for Hopper (sm_90a),
// with each row's slots split over several blocks (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at :81) and computes what
// repro/kernels/ref.py:decode_attention_ref computes: for row b and query
// head j, softmax over the row's W cache slots (masked by slot_pos >= 0,
// slot_pos <= q_pos and the optional window) of q . k * scale, times V.
// A fully masked row weighs every slot the same (the oracle's finite
// NEG_INF).  Scores, the running softmax and the accumulator are float32;
// the output is written in q's type.
//
// Bound: bytes.  A decode step streams every live K/V slot of every row
// once; 4 * G flops per K/V element is far below the card's ~295
// flop/byte balance point.
//
// Design: two kernels.  The slices decode 1 to 16 rows of 8 KV heads, so
// one block per (row, kv head) left most of the 132 SMs idle while each
// block walked ~1,300 slots.
//  - Pass 1, grid (split, kv head, row): split s takes the row's slots
//    [s * chunk, (s + 1) * chunk), chunk a multiple of the 16-slot page
//    chosen by the wrapper from (B, W, Hkv) alone so that the grid holds
//    at least two blocks per SM.  The block stages the range's slot_pos
//    in shared memory (one coalesced read that also decides whether the
//    split has a live slot), then its 4 warps take the range's pages in
//    turn (64-slot block tiles), each warp with a cp.async ring of its own
//    (2 to 4 pages in flight, by what ~16 KB hold), a running softmax per
//    query head and no block barrier in the loop.  A page's scores and
//    its P V product:
//     - bfloat16, on the tensor cores: mma.sync m16n8k16 with the G query
//       heads as the rows of A (G padded to 16), K's and V's fragments by
//       ldmatrix (.trans for V) from rows padded by 16 bytes, P a bf16
//       pair per weight.  A first version on the CUDA cores was issue-
//       and latency-bound (~680 instructions per page and warp, each
//       score's parts summed by shuffles): the card timed it above SDPA
//       at 2 rows x 1344 slots.
//     - float32, on the CUDA cores (within 2e-5 of the oracle): slot s of
//       a page belongs to lanes s and s + 16, each scoring half of K's row
//       against q in shared memory (a broadcast); lane i accumulates
//       output dims [i D / 32, (i + 1) D / 32) of every head.
//    The block merges its warps' softmaxes and writes the split's partial
//    (m, l, acc[G][D]) in float32 to the workspace.
//  - Pass 2, a warp per (row, query head), folds the row's partials into
//    one softmax with several partials' loads in flight and writes q's
//    type.  It is launched as pass 1's programmatic dependent, so its
//    launch overlaps pass 1.
// What the split must get right:
//  - A row with no live slot weighs every slot alike.  A page may be
//    skipped only when the row has a live slot somewhere: a split that
//    finds no live slot in its own range reads the rest of the row's
//    slot_pos.  In a live row it writes an empty partial (m = -inf,
//    l = 0), which pass 2 weighs 0; in a dead row it walks its pages
//    summing V with weight 1 (no K is read), and pass 2 weighs the splits
//    alike: the mean of V.
//  - slot_pos need not be sorted (a ring cache): splits are ranges of slot
//    indices and liveness is read per slot.
//  - W need not divide the split or the page: slots past W are neither
//    loaded (zero-filled copies) nor weighed (score -inf).
// The page loop takes a "where page j starts" functor (DenseRows here;
// PagedRows for the block-table kernels), so that paged_decode_attention
// and fused_rope_decode_append can take the same split.
#include <type_traits>

#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int kPage = 16;              // slots per page: a warp's step
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a pass-1 block: per warp a ring of kStages pages (K and
// V rows padded by 16 bytes, so that a quarter-warp's loads and the eight
// rows of an ldmatrix hit distinct banks), the page's weights and each
// stage's live-slot mask; then q (G, D) as floats, the warps' partials for
// the in-block merge and the split's slot_pos.
template <typename T, int D>
struct SplitSmem {
  static constexpr int kRow = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int kPadRow = kRow + 16;
  static constexpr int kPageBytes = 2 * kPage * kPadRow;  // K, then V
  // pages in flight per warp: as many as ~16 KB hold, 2 to 4
  static constexpr int kStages =
      16384 / kPageBytes >= 4 ? 4 : (16384 / kPageBytes >= 3 ? 3 : 2);
  static constexpr int kWarpBytes = kStages * kPageBytes +
                                    kMaxG * kPage * 4 +  // weights (G, page)
                                    16;                  // live masks
  static constexpr int kQOff = kSplitWarps * kWarpBytes;
  // then the split's chunk slot_pos values
  __host__ __device__ static constexpr size_t sp_off(int G) {
    return kQOff + sizeof(float) * (G * D + kSplitWarps * G * (D + 2));
  }
  __host__ __device__ static constexpr size_t bytes(int G, int chunk) {
    return sp_off(G) + sizeof(int32_t) * chunk;
  }
};

// float32 on the CUDA cores.  Lane i holds output dims [i D / 32,
// (i + 1) D / 32) of every head; slot s of a page belongs to lanes s and
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

  __device__ __forceinline__ void load_q(const T*, int) {}
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = kMinusInf;  // nothing seen: weighs 0 in the merges
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[g][i] = 0.f;
    }
  }
  // one page: K and V rows (row stride kPadRow), mask of its live slots,
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
// for a page is two n-tiles of 8 slots, K's B fragments by ldmatrix from
// its (slot, dim) rows; P V takes P from the S fragments and V's B
// fragments by ldmatrix.trans, each weight a bf16 pair (high and low
// part, two products) so that P keeps ~16 bits.  Lane (grp, tig) holds
// head grp: its scores of slots 8 n + 2 tig + {0, 1} and output dims
// 8 n + 2 tig + {0, 1}.
template <int D>
struct MmaWarp {
  uint32_t qa[D / 16][2];  // head grp, dims 16 kk + 2 tig (+ 8)
  float m, l;              // running max; this lane's part of the sum
  float o[D / 8][4];       // [2], [3]: rows 8..15, always 0

  __device__ __forceinline__ void load_q(const __nv_bfloat16* q_row, int G) {
    const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qa[kk][h] = grp < G ? *reinterpret_cast<const uint32_t*>(
                                  q_row + grp * D + 16 * kk + 8 * h + 2 * tig)
                            : 0u;
  }
  __device__ __forceinline__ void reset() {
    m = kMinusInf;
    l = 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
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
        mma(o[nd + u], hi0, hi2, b[2 * u], b[2 * u + 1]);
        mma(o[nd + u], lo0, lo2, b[2 * u], b[2 * u + 1]);
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
// of the page) for the G query heads of kv head h (q_row: the G heads'
// q), with q (G, D) as floats and the range's slot_pos (sp_s[i] for slot
// lo + i) in shared memory, published by the caller; rows(j) gives page
// j's first slot row.  uniform: the row has no live slot, so every slot of
// the split weighs 1 (the oracle's finite NEG_INF) and only V is read;
// otherwise pages without a live slot are skipped.  Writes the split's
// partial (m[G], l[G], acc[G][D]) at part.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void attend_split(
    char* smem, const T* __restrict__ q_row, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, Rows rows, const int32_t* sp_s, int qp,
    int lo, int hi, int G, int Hkv, int h, int window, float scale,
    bool uniform, float* __restrict__ part) {
  using S = SplitSmem<T, D>;
  constexpr int kStages = S::kStages;
  constexpr int kChunks = S::kRow / 16;  // 16-byte chunks of a row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = lane % kPage;  // this lane's slot in a page
  char* base = smem + warp * S::kWarpBytes;
  float* p_w = reinterpret_cast<float*>(base + kStages * S::kPageBytes);
  uint32_t* masks = reinterpret_cast<uint32_t*>(p_w + kMaxG * kPage);
  const float* q_s = reinterpret_cast<const float*>(smem + S::kQOff);
  float* merge_s = reinterpret_cast<float*>(smem + S::kQOff) + G * D;

  // this warp's pages: j0 + warp + i * kSplitWarps for i < n_mine
  const int j0 = lo / kPage, j1 = (hi + kPage - 1) / kPage;
  const int n_mine =
      j1 - j0 > warp ? (j1 - j0 - warp + kSplitWarps - 1) / kSplitWarps : 0;
  auto first_slot = [&](int i) {
    return (j0 + warp + i * kSplitWarps) * kPage;
  };

  WarpOf<T, D> acc;
  acc.load_q(q_row, G);
  acc.reset();
  // copies page i into its stage, with its live-slot mask (0: skipped)
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int slot = first_slot(i) + s;
    const uint32_t mask =
        uniform ? ~0u
                : __ballot_sync(kFull, slot < hi && slot_live(sp_s[slot - lo],
                                                              qp, window));
    if (lane == 0) masks[st] = mask;
    if (mask) {
      const int j = j0 + warp + i * kSplitWarps;
      const int64_t first = rows(j);
      char* kb = base + st * S::kPageBytes;
      char* vb = kb + kPage * S::kPadRow;
      for (int e = lane; e < kPage * kChunks; e += 32) {
        const int t = e / kChunks, c = e % kChunks;
        const bool in = j * kPage + t < hi;
        const int64_t off = ((first + t) * Hkv + h) * D + c * kPerChunk;
        const int at = t * S::kPadRow + c * 16;
        if (!uniform) cp_async_16(kb + at, k_pages + (in ? off : 0), in);
        cp_async_16(vb + at, v_pages + (in ? off : 0), in);
      }
    }
    cp_async_commit();  // one group per page, empty or not
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
    cp_async_wait<kStages - 1>();  // page i's copies are in
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

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int32_t* __restrict__ slot_pos,
    const int32_t* __restrict__ q_pos, float* __restrict__ ws, int Hq,
    int Hkv, int W, int chunk, int n_split, int window, float scale) {
  using S = SplitSmem<T, D>;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z, h = blockIdx.y, split = blockIdx.x;
  const int G = Hq / Hkv;
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  float* q_s = reinterpret_cast<float*>(smem + S::kQOff);
  int32_t* sp_s = reinterpret_cast<int32_t*>(smem + S::sp_off(G));
  const T* q_row = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  const int32_t* sp_row = slot_pos + static_cast<int64_t>(b) * W;
  const int qp = q_pos[b];
  for (int i = threadIdx.x; i < G * D; i += kSplitThreads)
    q_s[i] = to_float(q_row[i]);
  int any = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kSplitThreads) {
    const int sp = sp_row[i];
    sp_s[i - lo] = sp;
    any |= slot_live(sp, qp, window);
  }
  float* part = ws + ((static_cast<int64_t>(b) * Hkv + h) * n_split + split) *
                         G * (D + 2);
  bool uniform = false;
  if (!__syncthreads_or(any)) {  // also publishes q_s and sp_s
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
  attend_split<T, D>(smem, q_row, k_cache, v_cache,
                     DenseRows<kPage>{static_cast<int64_t>(b) * W}, sp_s, qp,
                     lo, hi, G, Hkv, h, window, scale, uniform, part);
}

// Pass 2: a warp per (row, query head) folds the row's n_split partials
// of its head into one softmax (lane i holds dims [i D / 32, (i + 1) D /
// 32); several partials' loads in flight) and writes the output in T.
// Launched as pass 1's programmatic dependent: it starts while pass 1
// finishes and waits for its writes.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int B, int Hq,
    int Hkv, int n_split) {
  constexpr int kDims = D / 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int row_head = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (row_head >= B * Hq) return;
  const int b = row_head / Hq, j = row_head % Hq;
  const int G = Hq / Hkv, h = j / G, g = j % G;
  const int stride = G * (D + 2);
  const float* part =
      ws + (static_cast<int64_t>(b) * Hkv + h) * n_split * stride;
  float m = kMinusInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int x = 0; x < kDims; ++x) acc[x] = 0.f;
#pragma unroll 4
  for (int p = 0; p < n_split; ++p) {
    const float* pp = part + p * stride;
    const float mp = pp[g], lp = pp[G + g];
    float ap[kDims];
#pragma unroll
    for (int x = 0; x < kDims; ++x)
      ap[x] = pp[2 * G + g * D + lane * kDims + x];
    if (mp == kMinusInf) continue;  // an empty partial weighs 0
    const float m_new = fmaxf(m, mp);
    const float c_old = expf(m - m_new), c_p = expf(mp - m_new);
    l = l * c_old + lp * c_p;
#pragma unroll
    for (int x = 0; x < kDims; ++x) acc[x] = acc[x] * c_old + ap[x] * c_p;
    m = m_new;
  }
  T* o = out + static_cast<int64_t>(row_head) * D + lane * kDims;
#pragma unroll
  for (int x = 0; x < kDims; ++x) o[x] = from_float<T>(acc[x] / l);
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* slot_pos, const void* q_pos, void* out, void* ws,
           int B, int Hq, int Hkv, int W, int chunk, int window, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_split = (W + chunk - 1) / chunk;
  if (n_split > kMaxSplits || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = SplitSmem<T, D>::bytes(G, chunk);
  static bool opted_in = false;  // per instance: above 48 KB needs opt-in
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SplitSmem<T, D>::bytes(kMaxG, kMaxChunk)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  split_kernel<T, D><<<dim3(n_split, Hkv, B), kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int32_t*>(slot_pos),
      static_cast<const int32_t*>(q_pos), static_cast<float*>(ws), Hq, Hkv,
      W, chunk, n_split, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * Hq + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, merge_kernel<T, D>, static_cast<const float*>(ws),
      static_cast<T*>(out), B, Hq, Hkv, n_split));
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_cache, const void* v_cache,
               const void* slot_pos, const void* q_pos, void* out, void* ws,
               int B, int Hq, int Hkv, int W, int chunk, int window,
               float scale, cudaStream_t stream) {
  if (D == 32)
    return launch<T, 32>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                         Hq, Hkv, W, chunk, window, scale, stream);
  if (D == 64)
    return launch<T, 64>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                         Hq, Hkv, W, chunk, window, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                          Hq, Hkv, W, chunk, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Hq,D); k_cache/v_cache (B,W,Hkv,D); slot_pos (B,W) int32 (-1
// empty); q_pos (B,) int32; out (B,Hq,D); ws float32 workspace of
// B * Hkv * ceil(W / chunk) * (Hq / Hkv) * (D + 2) values.  dtype 0 is
// float32, 1 is bfloat16; D in {32, 64, 128}, Hq / Hkv <= 8, any W >= 1,
// chunk a multiple of 16 in [16, 2048] (slots per split) with at most
// 1024 splits, caches 16-byte
// aligned; window <= 0 means none.  Launches both passes on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* slot_pos,
                                       const void* q_pos, void* out,
                                       void* ws, int B, int Hq, int Hkv,
                                       int D, int W, int chunk, int window,
                                       float scale, void* stream) {
  if (B * Hkv == 0) return 0;
  if (W < 1 || Hq % Hkv || Hq / Hkv > kMaxG || chunk < kPage ||
      chunk % kPage)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_cache, v_cache, slot_pos, q_pos, out,
                             ws, B, Hq, Hkv, W, chunk, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, slot_pos, q_pos,
                                     out, ws, B, Hq, Hkv, W, chunk, window,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
