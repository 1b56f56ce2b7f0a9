// Batched GQA decode attention over a paged KV pool for Hopper (sm_90a),
// with each row's slots split over several blocks (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention, pallas_call at :107) and computes what
// repro/kernels/ref.py:paged_decode_attention_ref computes: for row b and
// query head j, softmax over the logical slots of the row's pages (masked
// by slot_pos >= 0, slot_pos <= q_pos and the optional window) of
// q . k * D^-0.5, times V.  A fully masked row weighs every slot the same
// (the oracle's finite NEG_INF).  Scores, the running softmax and the
// accumulator are float32; the output is written in q's type.
//
// Bound: bytes.  One decode step must stream every live K/V slot of every
// row once (2 * B * n_valid * Hkv * D * sizeof(T)); the arithmetic is
// 4 * G flops per K/V element, far below the card's ~295 flop/byte
// balance point.
//
// Design: the split-slot loop of split_attention.cuh, shared with
// decode_attention.cu and fused_rope_decode_append.cu.  One block per
// (row, kv head) walking the whole row left most SMs idle at the slices'
// 4 to 8 rows; here pass 1 (paged_split_kernel) runs on a grid of (split,
// kv head, row), each block taking `chunk` of the row's nb * pg logical
// slots (chunk from the wrapper, by shapes alone), its warps copying 16
// slots a step with cp.async from the rows the block table names
// (PagedRows: the split's entries staged in shared memory with its
// slot_pos; the page size pg is a run-time argument: for pg a multiple of
// 8 each 8-slot half of a step lies in one page and is looked up once,
// for any other pg (the kPerSlot instances) each slot is looked up on its
// own; a page cut by a split boundary is staged by both splits, each
// reading only its own slots).  Each block covers
// a head block of the GQA group (the whole group up to kMaxG = 8 query
// heads a KV head; a larger one as rep blocks of at most 8, each reading
// the KV head's pages), so a K/V page is read once for up to 8 heads.
// Any head dim that is a multiple of 16 up to 256 runs on the smallest
// compiled instance at or above it (split_attention.cuh).  Pass
// 2 (merge_kernel) folds the splits' partials, launched as pass 1's
// programmatic dependent.
#include "split_attention.cuh"

namespace {

template <typename T, int D, bool kPerSlot>
__global__ void __launch_bounds__(kSplitThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ slot_pos, const int32_t* __restrict__ q_pos,
    float* __restrict__ ws, int Hq, int Hkv, int rep, int hd, int nb, int pg,
    int chunk, int n_split, int window, float scale) {
  using S = SplitSmem<T, D>;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z, hb = blockIdx.y, split = blockIdx.x;
  const int G = Hq / Hkv;
  const HeadBlock blk(hb, G, rep);
  const int W = nb * pg;
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  stage_q<T, D>(reinterpret_cast<float*>(smem + S::kQOff),
                q + (static_cast<int64_t>(b) * Hq + blk.h * G + blk.g0) * hd,
                blk.n, hd);
  split_pass<T, D>(smem, k_pages, v_pages,
                   PagedRows<kPerSlot>{block_table + static_cast<int64_t>(b) * nb,
                                      pg},
                   slot_pos + static_cast<int64_t>(b) * W, W, q_pos[b], lo,
                   hi, blk.n, Hkv, blk.h, hd, window, scale,
                   partial(ws, b, hb, split, Hkv * rep, n_split,
                           block_heads(G, rep), D));
}

template <typename T, int D, bool kPerSlot>
struct Launch {
  static int run(int pg, int hd, const void* q, const void* k_pages,
                 const void* v_pages, const void* block_table,
                 const void* slot_pos, const void* q_pos, void* out,
                 void* ws, int B, int Hq, int Hkv, int rep, int nb, int chunk,
                 int window, float scale, cudaStream_t stream) {
    using S = SplitSmem<T, D>;
    const int n_split = (nb * pg + chunk - 1) / chunk;
    const size_t smem = S::bytes(block_heads(Hq / Hkv, rep), chunk, pg);
    static bool opted_in = false;  // per instance
    const cudaError_t e0 = allow_smem(
        reinterpret_cast<const void*>(paged_split_kernel<T, D, kPerSlot>),
        smem, S::bytes(kMaxG, kMaxChunk, 1), &opted_in);
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    paged_split_kernel<T, D, kPerSlot><<<dim3(n_split, Hkv * rep, B),
                                         kSplitThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages),
        static_cast<const int32_t*>(block_table),
        static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(q_pos), static_cast<float*>(ws), Hq, Hkv,
        rep, hd, nb, pg, chunk, n_split, window, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_merge<T, D>(static_cast<const float*>(ws),
                              static_cast<T*>(out), B, Hq, Hkv, rep, n_split,
                              hd, stream);
  }
};

}  // namespace

// q (B,Hq,hd); k_pages/v_pages (P,pg,Hkv,hd); block_table (B,nb) int32;
// slot_pos (B,nb*pg) int32; q_pos (B,) int32; out (B,Hq,hd); ws float32
// workspace of B * Hkv * rep * ceil(nb * pg / chunk) * ceil(Hq / (Hkv *
// rep)) * (D + 2) values, D the instance of hd (kHeadDims).  dtype 0 is
// float32, 1 is bfloat16; hd a multiple of 16 in [16, 256], pg >= 1, rep
// head blocks of at most 8 query heads per KV head (none empty), nb >= 1,
// chunk a multiple of 16 in [16, 2048] (slots per split) with at most
// 1024 splits, pools 16-byte aligned; window <= 0 means none.  Launches
// both passes on `stream` and returns the launches' error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* slot_pos, const void* q_pos,
    void* out, void* ws, int B, int Hq, int Hkv, int rep, int hd, int nb,
    int pg, int chunk, int window, float scale, void* stream) {
  if (B * Hkv == 0) return 0;
  if (nb < 1 || !split_shapes_ok(Hq, Hkv, rep, nb * pg, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, Launch>(hd, pg, q, k_pages, v_pages, block_table,
                                   slot_pos, q_pos, out, ws, B, Hq, Hkv, rep,
                                   nb, chunk, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, Launch>(hd, pg, q, k_pages, v_pages,
                                           block_table, slot_pos, q_pos, out,
                                           ws, B, Hq, Hkv, rep, nb, chunk,
                                           window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
