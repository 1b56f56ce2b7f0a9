// Batched GQA decode attention over a dense KV cache for Hopper (sm_90a).
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
// Design: the paged kernel without the block table.  One thread block per
// (row, kv head) serves the G = Hq / Hkv query heads of that kv head, so
// each K/V slot is read once for all of them; the row's W contiguous slots
// are walked as pages of 16 by the 8 warps of the block, each with a
// running softmax of its own, merged once at the end (attend_pages in
// paged_attention.cuh, shared with the paged kernels).  The Pallas kernel
// needs W % block_w == 0; here the last page may be ragged (kTail).  Pages
// whose slots are all masked are skipped after reading their slot_pos.
#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int kPage = 16;  // slots per warp step

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int32_t* __restrict__ slot_pos,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int Hq, int Hkv,
    int W, int window, float scale) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;  // (G, D)

  const int qp = q_pos[b];
  const int32_t* sp_row = slot_pos + (int64_t)b * W;
  const T* q_row = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_float(q_row[i]);
  const int row_live = row_any_live(sp_row, W, qp, window);
  const DenseRows<kPage> rows{(int64_t)b * W};
  attend_pages<T, D, kPage, true>(smem, k_cache, v_cache, rows, sp_row, qp,
                                  W, G, Hkv, h, window, scale, row_live,
                                  out + ((int64_t)b * Hq + (int64_t)h * G) * D);
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* slot_pos, const void* q_pos, void* out, int B, int Hq,
           int Hkv, int W, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D);
  decode_attention_kernel<T, D><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int32_t*>(slot_pos),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out), Hq, Hkv, W,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_cache, const void* v_cache,
               const void* slot_pos, const void* q_pos, void* out, int B,
               int Hq, int Hkv, int W, int window, float scale,
               cudaStream_t stream) {
  if (D == 32)
    return launch<T, 32>(q, k_cache, v_cache, slot_pos, q_pos, out, B, Hq,
                         Hkv, W, window, scale, stream);
  if (D == 64)
    return launch<T, 64>(q, k_cache, v_cache, slot_pos, q_pos, out, B, Hq,
                         Hkv, W, window, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k_cache, v_cache, slot_pos, q_pos, out, B, Hq,
                          Hkv, W, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Hq,D); k_cache/v_cache (B,W,Hkv,D); slot_pos (B,W) int32 (-1
// empty); q_pos (B,) int32; out (B,Hq,D).  dtype 0 is float32, 1 is
// bfloat16; D in {32, 64, 128}, Hq / Hkv <= 8, any W >= 1, caches 16-byte
// aligned; window <= 0 means none.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* slot_pos,
                                       const void* q_pos, void* out, int B,
                                       int Hq, int Hkv, int D, int W,
                                       int window, float scale,
                                       void* stream) {
  if (B * Hkv == 0) return 0;
  if (W < 1 || Hq % Hkv || Hq / Hkv > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_cache, v_cache, slot_pos, q_pos, out, B,
                             Hq, Hkv, W, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, slot_pos, q_pos,
                                     out, B, Hq, Hkv, W, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
