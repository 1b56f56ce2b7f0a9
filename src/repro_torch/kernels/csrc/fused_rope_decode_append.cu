// Fused RoPE + KV append + paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_rope_decode_append.py
// (fused_rope_decode_append, pallas_call at :158) and computes what
// repro/kernels/ref.py:fused_rope_decode_append_ref computes, in one
// launch: the new token's q (Hq heads) and k (Hkv heads) are rotated at
// q_pos[b] (Llama half rotation, float32, rounded once to the pool type);
// the rotated k and the unrotated v are written into page
// block_table[b, slots[b] / pg] at offset slots[b] % pg; then every query
// head attends over the row's pages after that append, masked by
// slot_pos >= 0, slot_pos <= q_pos and the optional window.
//
// Bound: bytes, as the unfused decode attention (paged_decode_attention.cu)
// is: every live K/V slot of every row is read once; the prologue adds
// one q row, one k/v row and the append, (Hq + 2 * Hkv) * D values a row.
//
// Design: the grid and the page loop are paged_decode_attention's (one
// block per (row, kv head), 8 warps splitting the pages, one log-sum-exp
// merge; paged_attention.cuh).  A prologue rotates the block's G query
// heads into shared memory (rounded to the pool type, as the unfused path
// stores its rotated q) and writes the block's own kv head of the new
// token into its page slot.  The barrier that follows (row_any_live)
// makes that global write visible to every warp of the block, so the warp
// that scores the new slot's page reads the appended token; the pools are
// therefore not declared __restrict__, so the compiler keeps their loads
// on the coherent path.  No other block reads that slot: each block
// appends only its own kv head, and a decode row never appends into a
// page another row reads (allocator contract: shared prefix pages are
// full, a row's last, partial page is its own).  Rows of the batch bucket
// that carry no request point at the null page 0 and append there; their
// slots are masked and their outputs discarded.
#include "paged_attention.cuh"

namespace {

using namespace paged;

template <typename T, int D, int PG>
__global__ void __launch_bounds__(kThreads) fused_rope_decode_append_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pages, T* v_pages,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ slot_pos, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ q_pos, const float* __restrict__ inv_freq,
    T* __restrict__ out, int Hq, int Hkv, int nb, int window, float scale) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;  // (G, D) rotated queries

  const int qp = q_pos[b];
  const int32_t* bt_row = block_table + (int64_t)b * nb;
  const int32_t* sp_row = slot_pos + (int64_t)b * nb * PG;
  const T* q_row = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_float(from_float<T>(
        rope_elem<T, D>(q_row + (i / D) * D, i % D, qp, inv_freq)));

  int slot = slots[b];
  const int last = nb * PG - 1;
  slot = slot < 0 ? 0 : (slot > last ? last : slot);  // the oracle's clip
  const int64_t dst = ((bt_row[slot / PG] * (int64_t)PG + slot % PG) * Hkv
                       + h) * D;
  const T* kn = k_new + ((int64_t)b * Hkv + h) * D;
  const T* vn = v_new + ((int64_t)b * Hkv + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    k_pages[dst + d] = from_float<T>(rope_elem<T, D>(kn, d, qp, inv_freq));
    v_pages[dst + d] = vn[d];
  }

  // barrier: q_s and the appended token are visible block-wide after it
  const int row_live = row_any_live(sp_row, nb * PG, qp, window);
  attend_pages<T, D, PG>(smem, k_pages, v_pages, PagedRows<PG>{bt_row},
                         sp_row, qp, nb * PG, G, Hkv, h, window, scale,
                         row_live,
                         out + ((int64_t)b * Hq + (int64_t)h * G) * D);
}

template <typename T, int D, int PG>
struct Launch {
  static int run(const void* q, const void* k_new, const void* v_new,
                 void* k_pages, void* v_pages, const void* block_table,
                 const void* slot_pos, const void* slots, const void* q_pos,
                 const void* inv_freq, void* out, int B, int Hq, int Hkv,
                 int nb, int window, float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes(Hq / Hkv, D);
    fused_rope_decode_append_kernel<T, D, PG><<<B * Hkv, kThreads, smem,
                                                stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_pages),
        static_cast<T*>(v_pages), static_cast<const int32_t*>(block_table),
        static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(q_pos),
        static_cast<const float*>(inv_freq), static_cast<T*>(out), Hq, Hkv,
        nb, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q (B,Hq,D), k_new/v_new (B,Hkv,D); k_pages/v_pages (P,pg,Hkv,D), updated
// in place; block_table (B,nb), slot_pos (B,nb*pg), slots (B,) and q_pos
// (B,) int32; inv_freq (D/2,) float32; out (B,Hq,D).  dtype 0 is float32,
// 1 is bfloat16; D in {32, 64, 128}, pg in {8, 16}, Hq / Hkv <= 8, pools
// 16-byte aligned; window <= 0 means none.  Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int fused_rope_decode_append_launch(
    int dtype, const void* q, const void* k_new, const void* v_new,
    void* k_pages, void* v_pages, const void* block_table,
    const void* slot_pos, const void* slots, const void* q_pos,
    const void* inv_freq, void* out, int B, int Hq, int Hkv, int D, int nb,
    int pg, int window, float scale, void* stream) {
  if (B * Hkv == 0) return 0;
  if (Hq % Hkv || Hq / Hkv > kMaxG || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, Launch>(D, pg, q, k_new, v_new, k_pages, v_pages,
                                   block_table, slot_pos, slots, q_pos,
                                   inv_freq, out, B, Hq, Hkv, nb, window,
                                   scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, Launch>(D, pg, q, k_new, v_new, k_pages,
                                           v_pages, block_table, slot_pos,
                                           slots, q_pos, inv_freq, out, B, Hq,
                                           Hkv, nb, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
