// Helpers shared by the port's attention and KV-write kernels: float
// conversions and vector loads of float32 / bfloat16 values, the RoPE
// rotation of a pair, the slot mask of decode attention, where a slot's K/V row
// lies (a page pool through the block table, or a dense cache), the
// prefill writes' vectors per thread, and the dispatch over the compiled
// (head dim, slot-wise lookup) instances of the attention kernels.  The
// decode attention loop itself is split_attention.cuh.
#pragma once

#include <cstdint>
#include <limits>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged {

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

// The Llama half rotation of the pair (x1, x2) = (x[e], x[e + D / 2]) of
// one head by an angle with cosine c and sine s: (x1 c - x2 s, x2 c + x1
// s), every product and the sum rounded separately (no fused multiply-
// add), as the unfused path's torch RoPE computes it.
__device__ __forceinline__ float2 rope_pair(float x1, float x2, float c,
                                            float s) {
  return make_float2(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)),
                     __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

__device__ __forceinline__ bool slot_live(int sp, int qp, int window) {
  return sp >= 0 && sp <= qp && (window <= 0 || qp - sp < window);
}

// Where logical slot `slot` of a row lies, as a row of the (row, Hkv, D)
// K/V arrays: through the block table (a pool of pages of pg slots, pg a
// run-time value: PagedRows names the row's table, StagedRows reads a
// block's copy of its entries j0.. in shared memory), or contiguously from
// the row's first slot (a dense (B, W, Hkv, D) cache).  kSlotwise tells
// the decode loop how often to ask: false where the slots of every aligned
// 8-slot group are contiguous (a dense cache, or pg a multiple of 8), so
// it asks once per group; true for any other page size, where a group may
// span pages and it asks for every slot.
template <bool kPerSlot>
struct PagedRows {
  const int32_t* bt_row;
  int pg;
};
template <bool kPerSlot>
struct StagedRows {
  static constexpr bool kSlotwise = kPerSlot;
  const int32_t* bt_s;
  int j0;
  int pg;
  __device__ __forceinline__ int64_t operator()(int slot) const {
    const int j = slot / pg;
    return static_cast<int64_t>(bt_s[j - j0]) * pg + (slot - j * pg);
  }
};
struct DenseRows {
  static constexpr bool kSlotwise = false;
  int64_t first;  // b * W
  __device__ __forceinline__ int64_t operator()(int slot) const {
    return first + slot;
  }
};

// The 16-byte vectors of each tensor a thread of a prefill write moves: 2
// where that still leaves every SM kMinBlocksPerSM blocks of `threads`,
// else 1, so that a stage of a few hundred tokens spreads over the whole
// card and a larger one gives each thread twice the bytes in flight.
constexpr int kMinBlocksPerSM = 4;
inline int vectors_per_thread(int64_t n_vecs, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_vecs / (2 * threads) >= static_cast<int64_t>(kMinBlocksPerSM) * sms
             ? 2 : 1;
}

// The head dims the attention kernels are compiled for; a call's head dim
// hd runs on the smallest at or above it (rows at stride hd, loads past
// hd zero-filled): every multiple of 16 from 16 to 256.
constexpr int kHeadDims[] = {32, 64, 96, 128, 160, 192, 256};

// f(std::integral_constant<int, D>()) for the instance D that serves head
// dim hd, else cudaErrorInvalidValue (hd not a multiple of 16 in [16,
// 256]).
template <typename F>
int with_head_dim(int hd, F f) {
  if (hd < 16 || hd > 256 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32) return f(std::integral_constant<int, 32>());
  if (hd <= 64) return f(std::integral_constant<int, 64>());
  if (hd <= 96) return f(std::integral_constant<int, 96>());
  if (hd <= 128) return f(std::integral_constant<int, 128>());
  if (hd <= 160) return f(std::integral_constant<int, 160>());
  if (hd <= 192) return f(std::integral_constant<int, 192>());
  return f(std::integral_constant<int, 256>());
}

// Dispatch a launcher template over the compiled instances:
// L<T, D, pg % 8 != 0>::run(pg, hd, args...) for the instance D of head
// dim hd and any pg >= 1 (the page size is a run-time argument; the flag
// picks the loop that looks each slot up), else cudaErrorInvalidValue.
template <typename T, template <typename, int, bool> class L, typename... A>
int dispatch(int hd, int pg, A... args) {
  if (pg < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(hd, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return pg % 8 ? L<T, D, true>::run(pg, hd, args...)
                  : L<T, D, false>::run(pg, hd, args...);
  });
}

}  // namespace paged
