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
// the TPU; here the block's 8 warps split the row's pages, each with a
// running softmax of its own, merged once at the end (paged_attention.cuh,
// shared with fused_rope_decode_append.cu).  The block table is read by
// each warp itself (there is no scalar prefetch).
#include "paged_attention.cuh"

namespace {

using namespace paged;

template <typename T, int D, int PG>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ slot_pos, const int32_t* __restrict__ q_pos,
    T* __restrict__ out, int Hq, int Hkv, int nb, int window, float scale) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;  // (G, D)

  const int qp = q_pos[b];
  const int32_t* sp_row = slot_pos + (int64_t)b * nb * PG;
  const T* q_row = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_float(q_row[i]);
  const int row_live = row_any_live(sp_row, nb * PG, qp, window);
  const PagedRows<PG> rows{block_table + (int64_t)b * nb};
  attend_pages<T, D, PG>(smem, k_pages, v_pages, rows, sp_row, qp, nb * PG,
                         G, Hkv, h, window, scale, row_live,
                         out + ((int64_t)b * Hq + (int64_t)h * G) * D);
}

template <typename T, int D, int PG>
struct Launch {
  static int run(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_table, const void* slot_pos,
                 const void* q_pos, void* out, int B, int Hq, int Hkv,
                 int nb, int window, float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes(Hq / Hkv, D);
    paged_decode_attention_kernel<T, D, PG><<<B * Hkv, kThreads, smem,
                                              stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages),
        static_cast<const int32_t*>(block_table),
        static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(q_pos), static_cast<T*>(out), Hq, Hkv,
        nb, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q (B,Hq,D); k_pages/v_pages (P,pg,Hkv,D); block_table (B,nb) int32;
// slot_pos (B,nb*pg) int32; q_pos (B,) int32; out (B,Hq,D).  dtype 0 is
// float32, 1 is bfloat16; D in {32, 64, 128}, pg in {8, 16}, Hq / Hkv <= 8,
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
    return dispatch<float, Launch>(D, pg, q, k_pages, v_pages, block_table,
                                   slot_pos, q_pos, out, B, Hq, Hkv, nb,
                                   window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, Launch>(D, pg, q, k_pages, v_pages,
                                           block_table, slot_pos, q_pos, out,
                                           B, Hq, Hkv, nb, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
