// Causal, left-pad-masked GQA prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py
// (flash_prefill, pallas_call at :96) and computes what
// repro/kernels/ref.py:flash_prefill_ref computes: query token i of row b
// and head j attends to key token k of the same row where
//   (pk >= 0) & (pk <= pq) [& (pq - pk < window)]   or   i == k,
// pq, pk the tokens' positions (pads < 0).  The diagonal rule keeps the
// left pads' query rows finite: each takes exactly its own V.  Scores are
// q . k * scale in float32 with masked scores at the oracle's finite
// NEG_INF; the online softmax and the accumulator are float32; the output
// is written in q's type.
//
// Bound: bytes, then operations.  At llama3.2-1b's prefill shapes (8 rows
// of 512, 32/8 heads, D 64) the causal products are ~7 GFLOP against
// ~42 MB of q, K, V and output: ~170 flop/byte, below the card's bf16
// balance point, so memory bounds it (~12.5 us) with the tensor cores
// close behind (~7 us).
//
// Design: one thread block per (row, kv head, q-tile).  The tile holds
// BQ = R / G query tokens times the G = Hq / Hkv query heads of the kv
// head, so each K/V tile brought into shared memory serves every query
// head of its kv head (R query rows: R = 64 for bf16, 8192 / D for
// float32).  The Pallas grid's sequential kv axis becomes a loop over K/V
// tiles of 64 keys (32 at D 128 in float32).
//  - bfloat16: 4 warps of 16 query rows each multiply on the tensor cores
//    (mma.sync m16n8k16, float32 accumulators): S = Q K^T from q held in
//    registers and K in shared memory, the online softmax on the score
//    fragments (row max and sum over the 4 threads of a quad), then
//    O += P V with each weight split into two bf16 (high and low part, two
//    products) and V stored transposed in shared memory.  Rows are padded
//    by 8 values so that fragment loads do not collide.
//  - float32 (exact to 2e-5 of the oracle): the CUDA cores, D / 32
//    neighbouring threads per query row (one at D 32), each holding 32 of
//    its dims in interleaved 4-dim chunks; the parts of a score are summed
//    by shuffles.  Bound by one shared-memory operand per multiply-add.
//  wgmma with TMA-fed tiles is the next step for the bf16 path.
//
// Where the trouble lies, and what both kernels do:
//  - Tile skipping: a K/V tile is skipped only when no key in it can be
//    unmasked for any query of the block by position (pk >= 0, pk <= max pq,
//    pk > min valid pq - window) AND the tile does not overlap the block's
//    diagonal (by index): the pad rows' diagonal tile is always computed.
//  - Fully masked tiles: masked scores are the finite NEG_INF, so a tile
//    met while the running max is still NEG_INF adds weights that the first
//    live key scales by exp(NEG_INF - m) = 0; every query row has a live
//    key (its diagonal), so nothing of them survives, as in the oracle.
//  - T need not divide the tiles: key slots past T score -inf (weight
//    exactly 0) and are not loaded; query rows past T are not stored.
#include <climits>

#include "paged_attention.cuh"

namespace {

using paged::kFull;
using paged::kMinusInf;
using paged::kNegInf;

__device__ __forceinline__ bool pair_live(int pk, int pq, int ki, int qi,
                                          int window) {
  return (pk >= 0 && pk <= pq && (window <= 0 || pq - pk < window)) ||
         qi == ki;
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
                                            int window, int* pos_s) {
  int maybe = 0;
  if (threadIdx.x < n) {
    const int ki = k0 + threadIdx.x;
    const int pk = ki < T_len ? pos_row[ki] : -1;
    pos_s[threadIdx.x] = pk;
    maybe = pk >= 0 && pk <= q_max && (window <= 0 || pk > q_min - window);
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
    float* __restrict__ out, int T_len, int Hq, int Hkv, int bq, int n_qt,
    int window, float scale) {
  using Cfg = Tile<D>;
  constexpr int kTpr = Cfg::kTpr, kBK = Cfg::kBK;
  constexpr int kPerRow = D / 4;
  __shared__ __align__(16) float k_s[kBK * D];
  __shared__ __align__(16) float v_s[kBK * D];
  __shared__ int pos_s[kBK];
  __shared__ int q_stat[2];

  const int G = Hq / Hkv;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hkv;
  const int b = blockIdx.x / (n_qt * Hkv);
  const int tid = threadIdx.x;
  const int r = tid / kTpr, part = tid % kTpr;
  const int q0 = qt * bq;
  const int q_end = min(q0 + bq, T_len);
  const int t = q0 + r / G;
  const int g = r % G;
  const bool valid = r < bq * G && t < T_len;
  const int64_t row0 = (int64_t)b * T_len;
  const int32_t* pos_row = positions + row0;
  query_span(pos_row, q0, q_end, q_stat);

  const int pq = valid ? pos_row[t] : -1;
  const int qi = valid ? t : -1;
  const int64_t q_off = ((row0 + t) * Hq + (int64_t)h * G + g) * D;
  float qf[4 * Cfg::kChunks], acc[4 * Cfg::kChunks];
#pragma unroll
  for (int i = 0; i < Cfg::kChunks; ++i) {
    const float4 x = valid ? *reinterpret_cast<const float4*>(
                                 q + q_off + 4 * (part + kTpr * i))
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
                     window, pos_s))
      continue;  // uniform

    for (int i = tid; i < kBK * kPerRow; i += kThreads) {
      const int kk = i / kPerRow, c = i % kPerRow;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kk < T_len) {
        const int64_t off = ((row0 + k0 + kk) * Hkv + h) * D + 4 * c;
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
              : (pair_live(pos_s[kk], pq, ki, qi, window) ? s[kk] * scale
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
  for (int i = 0; i < Cfg::kChunks; ++i)
    *reinterpret_cast<float4*>(out + q_off + 4 * (part + kTpr * i)) =
        make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                    acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* positions,
           void* out, int B, int T_len, int Hq, int Hkv, int window,
           float scale, cudaStream_t stream) {
  const int bq = Tile<D>::kRows / (Hq / Hkv);  // query tokens per block
  const int n_qt = (T_len + bq - 1) / bq;
  const int64_t blocks = (int64_t)B * Hkv * n_qt;
  if (bq < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_prefill_kernel<D><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(positions),
      static_cast<float*>(out), T_len, Hq, Hkv, bq, n_qt, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kPad = 8;             // bf16 of padding per shared-memory row

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const int32_t* __restrict__ positions, __nv_bfloat16* __restrict__ out,
    int T_len, int Hq, int Hkv, int bq, int n_qt, int window, float scale) {
  constexpr int kKS = D / 16;        // k-steps of Q K^T
  constexpr int kND = D / 8;         // n-tiles of the output
  constexpr int kNK = kBK / 8;       // n-tiles of the scores
  constexpr int kChunks = D / 8;     // 16-byte chunks of a K/V row
  constexpr int kStrideK = D + kPad;    // k_s: (key, dim)
  constexpr int kStrideV = kBK + kPad;  // vt_s: (dim, key), V transposed
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kStrideK];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * kStrideV];
  __shared__ int pos_s[kBK];
  __shared__ int q_stat[2];

  const int G = Hq / Hkv;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hkv;
  const int b = blockIdx.x / (n_qt * Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const int q0 = qt * bq;
  const int q_end = min(q0 + bq, T_len);
  const int64_t row0 = (int64_t)b * T_len;
  const int32_t* pos_row = positions + row0;
  query_span(pos_row, q0, q_end, q_stat);

  // this thread's two query rows of the warp's 16: grp and grp + 8
  int pq[2], qi[2];
  bool valid[2];
  int64_t q_off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + grp + 8 * hh;
    const int t = q0 + r / G;
    valid[hh] = r < bq * G && t < T_len;
    pq[hh] = valid[hh] ? pos_row[t] : -1;
    qi[hh] = valid[hh] ? t : -1;
    q_off[hh] = ((row0 + t) * Hq + (int64_t)h * G + r % G) * D;
  }
  // A fragments of Q: a[0] (row grp, cols 2 tig..), a[1] (row grp + 8),
  // a[2] and a[3] the same rows 8 columns on
  uint32_t qa[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        qa[kk][hh + 2 * half] =
            valid[hh] ? word(q + q_off[hh] + 16 * kk + 8 * half + 2 * tig)
                      : 0u;
  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums
  __syncthreads();  // q_stat
  const int q_max = q_stat[0], q_min = q_stat[1];

  const int n_kt = (T_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_needed(pos_row, k0, kBK, T_len, q0, q_end, q_max, q_min,
                     window, pos_s))
      continue;  // uniform

    // K as it lies, (key, dim); V transposed to (dim, key), the key the
    // fastest index over a warp so that its stores fill whole words
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int kk = i / kChunks, c = i % kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < T_len)
        val = *reinterpret_cast<const uint4*>(
            k + ((row0 + k0 + kk) * Hkv + h) * D + 8 * c);
      *reinterpret_cast<uint4*>(k_s + kk * kStrideK + 8 * c) = val;
    }
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int kk = i % kBK, c = i / kBK;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < T_len)
        val = *reinterpret_cast<const uint4*>(
            v + ((row0 + k0 + kk) * Hkv + h) * D + 8 * c);
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
      uint16_t* vt = reinterpret_cast<uint16_t*>(vt_s) + 8 * c * kStrideV + kk;
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // the lower half is the first value
        vt[2 * x * kStrideV] = static_cast<uint16_t>(w[x] & 0xffffu);
        vt[(2 * x + 1) * kStrideV] = static_cast<uint16_t>(w[x] >> 16);
      }
    }
    __syncthreads();

    // S = Q K^T: B fragments of K^T are (dims 2 tig.., key grp) of k_s
    float s[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* kr = k_s + (8 * j + grp) * kStrideK + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        mma(s[j], qa[kk], word(kr + 16 * kk), word(kr + 16 * kk + 8));
    }
    // mask and scale; s[j][2 hh + e] is row hh, key 8 j + 2 tig + e
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * tig + e;
        const int ki = k0 + kc;
        const int pk = pos_s[kc];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& x = s[j][2 * hh + e];
          x = ki >= T_len ? kMinusInf
              : (pair_live(pk, pq[hh], ki, qi[hh], window) ? x * scale
                                                           : kNegInf);
          mt[hh] = fmaxf(mt[hh], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(kFull, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(kFull, mt[hh], 2));
      const float m_new = fmaxf(m[hh], mt[hh]);
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    // P = exp(S - m) as A fragments (score n-tiles 2 jj and 2 jj + 1 make
    // the k-step jj of P V), each weight a bf16 pair hi + lo that carries
    // ~16 bits: one bf16 alone would move outputs by a bf16 ulp against
    // the oracle, whose weights are float32 up to their normalisation
    uint32_t pa[kNK / 2][4], pa_lo[kNK / 2][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float p0 = expf(s[j][2 * hh] - m[hh]);
        const float p1 = expf(s[j][2 * hh + 1] - m[hh]);
        l[hh] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        pa[j / 2][hh + 2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&hi);
        pa_lo[j / 2][hh + 2 * (j % 2)] =
            *reinterpret_cast<const uint32_t*>(&lo);
      }
    // O += P V: B fragments of V are (keys 2 tig.., dim grp) of vt_s
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const __nv_bfloat16* vr = vt_s + (8 * nd + grp) * kStrideV + 2 * tig;
#pragma unroll
      for (int jj = 0; jj < kNK / 2; ++jj) {
        const uint32_t b0 = word(vr + 16 * jj), b1 = word(vr + 16 * jj + 8);
        mma(o[nd], pa[jj], b0, b1);
        mma(o[nd], pa_lo[jj], b0, b1);
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
    if (!valid[hh]) continue;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const __nv_bfloat162 w = __floats2bfloat162_rn(
          o[nd][2 * hh] * inv, o[nd][2 * hh + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + q_off[hh] + 8 * nd + 2 * tig) =
          w;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* positions,
           void* out, int B, int T_len, int Hq, int Hkv, int window,
           float scale, cudaStream_t stream) {
  const int bq = kRows / (Hq / Hkv);  // query tokens per block
  const int n_qt = (T_len + bq - 1) / bq;
  const int64_t blocks = (int64_t)B * Hkv * n_qt;
  if (bq < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_prefill_kernel<D><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(positions),
      static_cast<__nv_bfloat16*>(out), T_len, Hq, Hkv, bq, n_qt, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* positions, void* out, int B, int T_len, int Hq,
           int Hkv, int window, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<D>(q, k, v, positions, out, B, T_len, Hq, Hkv,
                           window, scale, stream);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, positions, out, B, T_len, Hq, Hkv, window,
                         scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,T,Hq,D); k/v (B,T,Hkv,D); positions (B,T) int32 (pads < 0); out
// (B,T,Hq,D).  dtype 0 is float32, 1 is bfloat16; D in {32, 64, 128}; Hq a
// multiple of Hkv with Hq / Hkv <= 64; any T >= 1; q, k, v and out 16-byte
// aligned; window <= 0 means none.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* positions,
                                    void* out, int B, int T_len, int Hq,
                                    int Hkv, int D, int window, float scale,
                                    void* stream) {
  if (B == 0 || T_len == 0 || Hkv == 0) return 0;
  if (Hq % Hkv || Hq / Hkv > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch<32>(dtype, q, k, v, positions, out, B, T_len, Hq, Hkv,
                      window, scale, s);
  if (D == 64)
    return launch<64>(dtype, q, k, v, positions, out, B, T_len, Hq, Hkv,
                      window, scale, s);
  if (D == 128)
    return launch<128>(dtype, q, k, v, positions, out, B, T_len, Hq, Hkv,
                       window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
