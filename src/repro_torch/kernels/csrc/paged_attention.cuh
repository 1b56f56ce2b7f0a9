// GQA decode attention for one (row, kv head) over the row's cache slots
// taken PG at a time as "pages", shared by paged_decode_attention.cu and
// fused_rope_decode_append.cu (pages found through the block table) and by
// decode_attention.cu (a dense row: its W contiguous slots, the last page
// possibly ragged).
//
// The block's 8 warps split the row's pages (warp w takes pages w, w + 8,
// ...), each keeping its own running max, sum and (G, D) accumulator in
// registers, and the block merges the 8 partial softmaxes at the end
// through shared memory.  Within a warp, slot s of a page belongs to the
// 32 / PG lanes s, s + PG, ...: each loads a 16-byte-aligned part of K row
// s and the parts' dot products are summed by shuffles; for the PV product
// lane i holds output dims [i * D / 32, (i + 1) * D / 32) of every head and
// loads exactly those dims of every V row of the page, so K and V are read
// with coalesced vector loads, once.  A page whose slots are all masked is
// skipped, unless the whole row is masked: then, as with the finite NEG_INF
// of the oracle, every slot weighs the same.  Head dim D and page size PG
// are template parameters (D in {32, 64, 128}, PG in {8, 16}), so every
// loop over them unrolls into registers.
#pragma once

#include <cstdint>
#include <limits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;  // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // ref.NEG_INF
// the score of a slot past the row's end: weight exactly 0
constexpr float kMinusInf = -std::numeric_limits<float>::infinity();

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the floats held by one 32-bit word of T values
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w,
                                                      float* out) {
  out[0] = __uint_as_float(w << 16);  // the lower half is the first value
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// N contiguous values of T at p, as floats; p is aligned to the load size
// (whole 32-bit words, or one value where N values are less than a word)
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* out) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values per word
  if constexpr (N * sizeof(T) % 4 != 0) {
    static_assert(N == 1, "sub-word loads are single values");
    out[0] = to_float(p[0]);
  } else if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack<T>(u.x, out + (4 * i + 0) * kPer);
      unpack<T>(u.y, out + (4 * i + 1) * kPer);
      unpack<T>(u.z, out + (4 * i + 2) * kPer);
      unpack<T>(u.w, out + (4 * i + 3) * kPer);
    }
  } else if constexpr (kWords % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 2; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      unpack<T>(u.x, out + (2 * i + 0) * kPer);
      unpack<T>(u.y, out + (2 * i + 1) * kPer);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      unpack<T>(reinterpret_cast<const uint32_t*>(p)[i], out + i * kPer);
  }
}

// 16 bytes of T values at p from floats, each rounded to nearest once
template <typename T>
__device__ __forceinline__ void store_16(T* p, const float* in);
template <>
__device__ __forceinline__ void store_16<float>(float* p, const float* in) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                 __float_as_uint(in[2]), __float_as_uint(in[3]));
}
template <>
__device__ __forceinline__ void store_16<__nv_bfloat16>(__nv_bfloat16* p,
                                                        const float* in) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&two);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Llama half rotation of element d of one head x (D values) at the angle
// pos * inv_freq[d % (D / 2)], with the unfused path's arithmetic: every
// product and the sum rounded separately (no fused multiply-add), and
// cosf / sinf at full precision (angles reach hundreds of radians).
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* x, int d, int pos,
                                           const float* inv_freq) {
  constexpr int kHalf = D / 2;
  const int e = d % kHalf;
  const float ang = __fmul_rn(static_cast<float>(pos), inv_freq[e]);
  const float c = cosf(ang), s = sinf(ang);
  const float x1 = to_float(x[e]), x2 = to_float(x[e + kHalf]);
  return d < kHalf ? __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))
                   : __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

__device__ __forceinline__ bool slot_live(int sp, int qp, int window) {
  return sp >= 0 && sp <= qp && (window <= 0 || qp - sp < window);
}

// shared memory the block needs: q (G, D) and the merge buffers
__host__ __device__ constexpr size_t smem_bytes(int G, int D) {
  return sizeof(float) * (G * D + kWarps * G * (2 + D));
}

// 1 when any of the row's slots is live for query position qp (also a
// block-wide barrier: shared and global writes made before it are visible
// to every thread of the block after it)
__device__ __forceinline__ int row_any_live(const int32_t* sp_row, int n,
                                            int qp, int window) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    any |= slot_live(sp_row[i], qp, window);
  return __syncthreads_or(any);
}

// Where a row's page j starts, as a slot row of the (slot, head, D) pools:
// through the block table (paged), or contiguously from the row's first
// slot (dense cache (B, W, Hkv, D)).
template <int PG>
struct PagedRows {
  const int32_t* bt_row;
  __device__ __forceinline__ int64_t operator()(int j) const {
    return static_cast<int64_t>(bt_row[j]) * PG;
  }
};
template <int PG>
struct DenseRows {
  int64_t first;  // b * W
  __device__ __forceinline__ int64_t operator()(int j) const {
    return first + static_cast<int64_t>(j) * PG;
  }
};

// Softmax(q . K * scale) V over the row's n_slots slots for the G query
// heads of kv head h, written to o_row (G, D).  q_s (G, D) floats at the
// start of smem, already published to the block; rows(j) gives page j's
// first slot row.  With kTail, n_slots need not be a multiple of PG: the
// last page's slots past n_slots are neither loaded nor weighed (score
// -inf, so weight exactly 0, also in a fully masked row).
template <typename T, int D, int PG, bool kTail = false, typename Rows>
__device__ __forceinline__ void attend_pages(
    float* smem, const T* k_pages, const T* v_pages, Rows rows,
    const int32_t* sp_row, int qp, int n_slots, int G, int Hkv, int h,
    int window, float scale, int row_live, T* o_row) {
  constexpr int kLanesPerSlot = 32 / PG;
  constexpr int kChunk = D / kLanesPerSlot;  // K values per lane per slot
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kDims = D / 32;  // output dims per lane
  static_assert(kChunk % kVec == 0, "K parts are whole 16-byte loads");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = lane % PG;     // this lane's slot in a page
  const int part = lane / PG;  // and its part of that slot's K row
  const float* q_s = smem;               // (G, D)
  float* m_w = smem + G * D;             // (kWarps, G) partial maxima
  float* l_w = m_w + kWarps * G;         // (kWarps, G) partial sums
  float* acc_w = l_w + kWarps * G;       // (kWarps, G, D) partial outputs

  float m[kMaxG], l[kMaxG], acc[kMaxG][kDims];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[g][i] = 0.f;
  }

  const int nb = (n_slots + PG - 1) / PG;
  for (int j = warp; j < nb; j += kWarps) {
    const bool in = !kTail || j * PG + s < n_slots;
    const bool live = in && slot_live(sp_row[j * PG + s], qp, window);
    if (row_live && !__any_sync(kFull, live)) continue;  // adds exactly 0
    const int64_t first = rows(j);
    // this lane's dims of every V row, issued first so that they are in
    // flight while the K part is loaded and scored
    float v[PG][kDims];
#pragma unroll
    for (int t = 0; t < PG; ++t) {
      if (kTail && j * PG + t >= n_slots) {
#pragma unroll
        for (int i = 0; i < kDims; ++i) v[t][i] = 0.f;
        continue;
      }
      load_floats<T, kDims>(
          v_pages + ((first + t) * Hkv + h) * D + lane * kDims, v[t]);
    }
    float kf[kChunk];
    if (in) {
      load_floats<T, kChunk>(
          k_pages + ((first + s) * Hkv + h) * D + part * kChunk, kf);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) kf[e] = 0.f;
    }

    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float* qg = q_s + g * D + part * kChunk;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) dot += qg[e] * kf[e];
#pragma unroll
      for (int o = PG; o < 32; o <<= 1)
        dot += __shfl_xor_sync(kFull, dot, o);  // sum the slot's parts
      const float sc = live ? dot * scale : (in ? kNegInf : kMinusInf);
      float mx = sc;
#pragma unroll
      for (int o = 1; o < PG; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[g], mx);
      p[g] = expf(sc - m_new);
      float sum = p[g];
#pragma unroll
      for (int o = 1; o < PG; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < PG; ++t) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float pt = __shfl_sync(kFull, p[g], t);  // lane t has slot t
#pragma unroll
        for (int i = 0; i < kDims; ++i) acc[g][i] += pt * v[t][i];
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_w[warp * G + g] = m[g];
      l_w[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      acc_w[(warp * G + g) * D + lane * kDims + i] = acc[g][i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * G + g]);
    float sum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w * G + g] - mx);
      sum += l_w[w * G + g] * c;
      o += acc_w[w * G * D + i] * c;
    }
    o_row[i] = from_float<T>(o / sum);
  }
}

// Dispatch a launcher template over the compiled (D, PG) instances:
// launch<T, D, PG>() for D in {32, 64, 128}, PG in {8, 16}, else
// cudaErrorInvalidValue.
template <typename T, template <typename, int, int> class L, typename... A>
int dispatch(int D, int pg, A... args) {
  if (D == 32 && pg == 8) return L<T, 32, 8>::run(args...);
  if (D == 32 && pg == 16) return L<T, 32, 16>::run(args...);
  if (D == 64 && pg == 8) return L<T, 64, 8>::run(args...);
  if (D == 64 && pg == 16) return L<T, 64, 16>::run(args...);
  if (D == 128 && pg == 8) return L<T, 128, 8>::run(args...);
  if (D == 128 && pg == 16) return L<T, 128, 16>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace paged
