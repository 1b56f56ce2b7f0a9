// Fused RoPE + prefill K/V page-pool scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_rope_prefill_write.py
// (fused_rope_prefill_write, pallas_call at :117) and computes what
// repro/kernels/ref.py:fused_rope_prefill_write_ref computes: token (b, t)
// whose position positions[b, t] >= 0 has its K rotated at that position
// (Llama half rotation, float32, rounded once to the pool type) and written,
// with its V unrotated, to page block_table[b, pos / pg] at offset
// pos % pg; pads (pos < 0) are skipped.  Each token goes to the slot its
// own position names, so a tail prefill whose positions start past a
// shared prefix leaves the prefix slots untouched, whether or not that
// start is page-aligned (the Pallas kernel needs it page-aligned).
//
// Bound: bytes.  It reads each K/V token row once and writes it once
// (2 * 2 * B * T_valid * Hkv * D * sizeof(T)); the rotation is a few
// flops per K value.
// Design: paged_prefill_write's, one thread block per token with 16-byte
// copies of V.  The rotation pairs element i with i + D/2, so a thread
// loads 16 bytes from each half of a head and writes both rotated halves.
// The token's D/2 angles are computed once into shared memory and used by
// all Hkv heads; cosf / sinf run at full precision (no fast-math: the
// angles reach hundreds of radians) and every product and sum is rounded
// separately, so K matches the unfused path's torch RoPE bit for bit when
// both read the same inverse frequencies.  The pools are updated in place.
#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int kWriteThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kWriteThreads)
fused_rope_prefill_write_kernel(
    const T* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ block_table,
    const float* __restrict__ inv_freq, T* __restrict__ k_pages,
    uint4* __restrict__ v_pages, int T_len, int nb, int pg, int Hkv, int D) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a load
  const int token = blockIdx.x;  // b * T_len + t
  const int b = token / T_len;
  const int pos = positions[token];
  if (pos < 0) return;  // left pad: nothing to store (whole block)
  const int last = nb * pg - 1;
  const int slot = pos > last ? last : pos;  // the oracle's clip
  const int64_t row = block_table[(int64_t)b * nb + slot / pg] * (int64_t)pg
                      + slot % pg;
  const int half = D / 2;

  extern __shared__ float cs[];  // cos (half), sin (half)
  for (int e = threadIdx.x; e < half; e += kWriteThreads) {
    const float ang = __fmul_rn(static_cast<float>(pos), inv_freq[e]);
    cs[e] = cosf(ang);
    cs[half + e] = sinf(ang);
  }

  const int row_vecs = Hkv * D / kVec;
  for (int i = threadIdx.x; i < row_vecs; i += kWriteThreads)
    v_pages[row * row_vecs + i] = v_new[(int64_t)token * row_vecs + i];
  __syncthreads();  // the angles

  const int vecs_per_half = half / kVec;
  for (int i = threadIdx.x; i < Hkv * vecs_per_half; i += kWriteThreads) {
    const int h = i / vecs_per_half;
    const int e0 = (i % vecs_per_half) * kVec;
    const T* src = k_new + ((int64_t)token * Hkv + h) * D + e0;
    T* dst = k_pages + (row * Hkv + h) * D + e0;
    float x1[kVec], x2[kVec], r1[kVec], r2[kVec];
    load_floats<T, kVec>(src, x1);
    load_floats<T, kVec>(src + half, x2);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float c = cs[e0 + j], s = cs[half + e0 + j];
      r1[j] = __fsub_rn(__fmul_rn(x1[j], c), __fmul_rn(x2[j], s));
      r2[j] = __fadd_rn(__fmul_rn(x2[j], c), __fmul_rn(x1[j], s));
    }
    store_16<T>(dst, r1);
    store_16<T>(dst + half, r2);
  }
}

template <typename T>
int launch(const void* k_new, const void* v_new, const void* positions,
           const void* block_table, const void* inv_freq, void* k_pages,
           void* v_pages, int B, int T_len, int nb, int pg, int Hkv, int D,
           cudaStream_t stream) {
  fused_rope_prefill_write_kernel<T><<<B * T_len, kWriteThreads,
                                       sizeof(float) * D, stream>>>(
      static_cast<const T*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(block_table),
      static_cast<const float*>(inv_freq), static_cast<T*>(k_pages),
      static_cast<uint4*>(v_pages), T_len, nb, pg, Hkv, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_new/v_new (B,T,Hkv,D), positions (B,T) int32, block_table (B,nb)
// int32, inv_freq (D/2,) float32, k_pages/v_pages (P,pg,Hkv,D) updated in
// place.  dtype 0 is float32, 1 is bfloat16; D / 2 values of the type must
// fill whole 16-byte words, and every tensor is 16-byte aligned.  Launches
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int fused_rope_prefill_write_launch(
    int dtype, const void* k_new, const void* v_new, const void* positions,
    const void* block_table, const void* inv_freq, void* k_pages,
    void* v_pages, int B, int T, int nb, int pg, int Hkv, int D,
    void* stream) {
  if (B * T == 0) return 0;
  if (nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D % 8 == 0)
    return launch<float>(k_new, v_new, positions, block_table, inv_freq,
                         k_pages, v_pages, B, T, nb, pg, Hkv, D, s);
  if (dtype == 1 && D % 16 == 0)
    return launch<__nv_bfloat16>(k_new, v_new, positions, block_table,
                                 inv_freq, k_pages, v_pages, B, T, nb, pg,
                                 Hkv, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
