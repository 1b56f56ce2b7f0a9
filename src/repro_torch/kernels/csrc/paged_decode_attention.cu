// Batched GQA decode attention over a paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention, pallas_call at :107) and computes what
// repro/kernels/ref.py:paged_decode_attention_ref computes: for row b and
// query head j, softmax over the logical slots of the row's pages (masked
// by slot_pos >= 0, slot_pos <= q_pos and the optional window) of
// q . k * D^-0.5, times V.  Scores, the running softmax and the
// accumulator are float32; the output is written in q's type.
//
// Bound: bytes.  One decode step must stream every live K/V slot of every
// row once (2 * B * n_valid * Hkv * D * sizeof(T)); the arithmetic is
// 4 * G flops per K/V element, far below the card's ~295 flop/byte
// balance point.  So the design is about keeping many loads in flight.
//
// Design: one thread block per (row, kv head) covers the whole GQA group
// of G = Hq / Hkv query heads, so each K/V page is read from device memory
// once for all G heads.  The Pallas grid axis over pages ran in order on
// the TPU; here the block's 8 warps split the row's pages (warp w takes
// pages w, w + 8, ...), each keeping its own running max, sum and (G, D)
// accumulator in registers, and the block merges the 8 partial softmaxes
// at the end through shared memory.  The block table is read by each warp
// itself (there is no scalar prefetch).  Within a warp, slot s of a page
// belongs to the 32 / PG lanes s, s + PG, ...: each loads a 16-byte-aligned
// part of K row s and the parts' dot products are summed by shuffles; for
// the PV product lane i holds output dims [i * D / 32, (i + 1) * D / 32)
// of every head and loads exactly those dims of every V row of the page,
// so K and V are read with coalesced vector loads, once.  A page whose
// slots are all masked is skipped, unless the whole row is masked: then,
// as with the finite NEG_INF of the oracle, every slot weighs the same.
// Head dim D and page size PG are template parameters (D in {64, 128}, PG
// in {8, 16}), so every loop over them unrolls into registers.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;  // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // ref.NEG_INF

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
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* out) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values per word
  static_assert(N * sizeof(T) % 4 == 0, "loads are whole 32-bit words");
  if constexpr (kWords % 4 == 0) {
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

__device__ __forceinline__ bool slot_live(int sp, int qp, int window) {
  return sp >= 0 && sp <= qp && (window <= 0 || qp - sp < window);
}

template <typename T, int D, int PG>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ slot_pos, const int32_t* __restrict__ q_pos,
    T* __restrict__ out, int Hq, int Hkv, int nb, int window, float scale) {
  constexpr int kLanesPerSlot = 32 / PG;
  constexpr int kChunk = D / kLanesPerSlot;  // K values per lane per slot
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kDims = D / 32;  // output dims per lane
  static_assert(kChunk % kVec == 0, "K parts are whole 16-byte loads");
  static_assert(kDims * sizeof(T) % 4 == 0, "V parts are whole words");

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = lane % PG;     // this lane's slot in a page
  const int part = lane / PG;  // and its part of that slot's K row

  extern __shared__ float smem[];
  float* q_s = smem;                    // (G, D)
  float* m_w = q_s + G * D;             // (kWarps, G) partial maxima
  float* l_w = m_w + kWarps * G;        // (kWarps, G) partial sums
  float* acc_w = l_w + kWarps * G;      // (kWarps, G, D) partial outputs

  const int qp = q_pos[b];
  const int32_t* sp_row = slot_pos + (int64_t)b * nb * PG;
  const int32_t* bt_row = block_table + (int64_t)b * nb;
  const T* q_row = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_float(q_row[i]);
  int any = 0;
  for (int i = threadIdx.x; i < nb * PG; i += kThreads)
    any |= slot_live(sp_row[i], qp, window);
  const int row_live = __syncthreads_or(any);  // also publishes q_s

  float m[kMaxG], l[kMaxG], acc[kMaxG][kDims];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[g][i] = 0.f;
  }

  for (int j = warp; j < nb; j += kWarps) {
    const bool live = slot_live(sp_row[j * PG + s], qp, window);
    if (row_live && !__any_sync(kFull, live)) continue;  // adds exactly 0
    const int64_t page = bt_row[j];
    // this lane's dims of every V row, issued first so that they are in
    // flight while the K part is loaded and scored
    float v[PG][kDims];
#pragma unroll
    for (int t = 0; t < PG; ++t)
      load_floats<T, kDims>(
          v_pages + ((page * PG + t) * Hkv + h) * D + lane * kDims, v[t]);
    float kf[kChunk];
    load_floats<T, kChunk>(
        k_pages + ((page * PG + s) * Hkv + h) * D + part * kChunk, kf);

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
      const float sc = live ? dot * scale : kNegInf;
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
  T* o_row = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
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

template <typename T, int D, int PG>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_table, const void* slot_pos, const void* q_pos,
           void* out, int B, int Hq, int Hkv, int nb, int window, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (G * D + kWarps * G * (2 + D));
  paged_decode_attention_kernel<T, D, PG><<<B * Hkv, kThreads, smem,
                                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(slot_pos),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out), Hq, Hkv, nb,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_pg(int pg, const void* q, const void* k, const void* v,
              const void* bt, const void* sp, const void* qp, void* out,
              int B, int Hq, int Hkv, int nb, int window, float scale,
              cudaStream_t s) {
  switch (pg) {
    case 8:
      return launch<T, D, 8>(q, k, v, bt, sp, qp, out, B, Hq, Hkv, nb,
                             window, scale, s);
    case 16:
      return launch<T, D, 16>(q, k, v, bt, sp, qp, out, B, Hq, Hkv, nb,
                              window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_d(int D, int pg, const void* q, const void* k, const void* v,
             const void* bt, const void* sp, const void* qp, void* out, int B,
             int Hq, int Hkv, int nb, int window, float scale,
             cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_pg<T, 64>(pg, q, k, v, bt, sp, qp, out, B, Hq, Hkv, nb,
                              window, scale, s);
    case 128:
      return launch_pg<T, 128>(pg, q, k, v, bt, sp, qp, out, B, Hq, Hkv, nb,
                               window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Hq,D); k_pages/v_pages (P,pg,Hkv,D); block_table (B,nb) int32;
// slot_pos (B,nb*pg) int32; q_pos (B,) int32; out (B,Hq,D).  dtype 0 is
// float32, 1 is bfloat16; D in {64, 128}, pg in {8, 16}, Hq / Hkv <= 8,
// pools 16-byte aligned; window <= 0 means none.  Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* slot_pos, const void* q_pos,
    void* out, int B, int Hq, int Hkv, int D, int nb, int pg, int window,
    float scale, void* stream) {
  if (B * Hkv == 0) return 0;
  if (Hq % Hkv || Hq / Hkv > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, pg, q, k_pages, v_pages, block_table, slot_pos,
                           q_pos, out, B, Hq, Hkv, nb, window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, pg, q, k_pages, v_pages, block_table,
                                   slot_pos, q_pos, out, B, Hq, Hkv, nb,
                                   window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
