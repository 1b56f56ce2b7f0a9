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
// Bound: bytes (every live K/V slot of every row read once).
//
// Design: the split-slot loop of split_attention.cuh, shared with the
// paged kernels (paged_decode_attention.cu, fused_rope_decode_append.cu).
// Pass 1 (split_kernel), grid (split, head block, row), reads the row's
// slots contiguously (DenseRows); pass 2 (merge_kernel) folds the splits'
// partials and is launched as pass 1's programmatic dependent.
//
// Groups above kMaxG (recurrentgemma-9b: 16 query heads on one KV head;
// Falcon-7B: 71): the G query heads of a KV head are split over `rep`
// head blocks of at most kMaxG heads each (split_attention.cuh's
// HeadBlock: ceil(G / rep) heads, the last block ragged), so a G-16 call
// runs as two 8-head halves of one KV head and a G-71 call as eight
// blocks of 8 and one of 7.  Each block is a block of the same instance:
// its registers, shared memory and loop are those of G 8 (no new
// instance, so nothing new to spill at head dim 256).  The price is that
// every block reads the KV head's slots (the others may find them in L2
// when the blocks of a split run together).  To pass 1 and the merge the
// call is one of Hkv * rep head blocks; only the K/V rows are read from
// KV head hb / rep.  Any head dim that is a multiple of 16 up to 256
// runs on the smallest compiled instance at or above it.
#include "split_attention.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int32_t* __restrict__ slot_pos,
    const int32_t* __restrict__ q_pos, float* __restrict__ ws, int Hq,
    int Hkv, int rep, int hd, int W, int chunk, int n_split, int window,
    float scale) {
  using S = SplitSmem<T, D>;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z, hb = blockIdx.y, split = blockIdx.x;
  const int G = Hq / Hkv;
  const HeadBlock blk(hb, G, rep);
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  stage_q<T, D>(reinterpret_cast<float*>(smem + S::kQOff),
                q + (static_cast<int64_t>(b) * Hq + blk.h * G + blk.g0) * hd,
                blk.n, hd);
  split_pass<T, D>(smem, k_cache, v_cache,
                   DenseRows{static_cast<int64_t>(b) * W},
                   slot_pos + static_cast<int64_t>(b) * W, W, q_pos[b], lo,
                   hi, blk.n, Hkv, blk.h, hd, window, scale,
                   partial(ws, b, hb, split, Hkv * rep, n_split,
                           block_heads(G, rep), D));
}

template <typename T, int D>
int launch(int hd, const void* q, const void* k_cache, const void* v_cache,
           const void* slot_pos, const void* q_pos, void* out, void* ws,
           int B, int Hq, int Hkv, int rep, int W, int chunk, int window,
           float scale, cudaStream_t stream) {
  using S = SplitSmem<T, D>;
  const int n_split = (W + chunk - 1) / chunk;
  const size_t smem = S::bytes(block_heads(Hq / Hkv, rep), chunk);
  static bool opted_in = false;  // per instance
  const cudaError_t e0 =
      allow_smem(reinterpret_cast<const void*>(split_kernel<T, D>), smem,
                 S::bytes(kMaxG, kMaxChunk), &opted_in);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  split_kernel<T, D>
      <<<dim3(n_split, Hkv * rep, B), kSplitThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_cache),
          static_cast<const T*>(v_cache),
          static_cast<const int32_t*>(slot_pos),
          static_cast<const int32_t*>(q_pos), static_cast<float*>(ws), Hq,
          Hkv, rep, hd, W, chunk, n_split, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<T, D>(static_cast<const float*>(ws),
                            static_cast<T*>(out), B, Hq, Hkv, rep, n_split,
                            hd, stream);
}

template <typename T>
int dispatch_d(int hd, const void* q, const void* k_cache,
               const void* v_cache, const void* slot_pos, const void* q_pos,
               void* out, void* ws, int B, int Hq, int Hkv, int rep, int W,
               int chunk, int window, float scale, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto d) {
    return launch<T, decltype(d)::value>(hd, q, k_cache, v_cache, slot_pos,
                                         q_pos, out, ws, B, Hq, Hkv, rep, W,
                                         chunk, window, scale, stream);
  });
}

}  // namespace

// q (B,Hq,hd); k_cache/v_cache (B,W,Hkv,hd); slot_pos (B,W) int32 (-1
// empty); q_pos (B,) int32; out (B,Hq,hd); ws float32 workspace of B *
// Hkv * rep * ceil(W / chunk) * ceil(Hq / (Hkv * rep)) * (D + 2) values,
// D the instance of hd (kHeadDims).  dtype 0 is float32, 1 is bfloat16;
// hd a multiple of 16 in [16, 256]; rep head blocks of at most 8 query
// heads per KV head, none empty (rep 2 at group 16, 9 at 71); any W >=
// 1, chunk a multiple of 16 in [16, 2048] (slots per split) with at most
// 1024 splits, caches 16-byte aligned; window <= 0 means none.  Launches
// both passes on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* slot_pos,
                                       const void* q_pos, void* out,
                                       void* ws, int B, int Hq, int Hkv,
                                       int rep, int hd, int W, int chunk,
                                       int window, float scale,
                                       void* stream) {
  if (B * Hkv == 0) return 0;
  if (!split_shapes_ok(Hq, Hkv, rep, W, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(hd, q, k_cache, v_cache, slot_pos, q_pos, out,
                             ws, B, Hq, Hkv, rep, W, chunk, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(hd, q, k_cache, v_cache, slot_pos,
                                     q_pos, out, ws, B, Hq, Hkv, rep, W,
                                     chunk, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
