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
// Groups above kMaxG (recurrentgemma-9b: 16 query heads on one KV head):
// the G query heads of a KV head are split over `rep` head blocks of
// G / rep <= kMaxG heads each (rep = 1 up to kMaxG), so a G-16 call runs
// as two 8-head halves of one KV head.  Each half is a G-8 block of the
// same instance: its registers, shared memory and loop are those of G 8
// (no new instance, so nothing new to spill at head dim 256).  The price
// is that both halves read the KV head's slots (the second may find them
// in L2 when the halves of a split run together).  To pass 1 and the
// merge the call is one of Hkv * rep "KV heads" with G / rep query heads
// each; only the K/V rows are read from KV head hb / rep.
#include "split_attention.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int32_t* __restrict__ slot_pos,
    const int32_t* __restrict__ q_pos, float* __restrict__ ws, int Hq,
    int Hkv, int rep, int W, int chunk, int n_split, int window,
    float scale) {
  using S = SplitSmem<T, D>;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // head block hb: query heads hb * G .. + G - 1 of KV head hb / rep
  const int b = blockIdx.z, hb = blockIdx.y, split = blockIdx.x;
  const int G = Hq / (Hkv * rep);
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  float* q_s = reinterpret_cast<float*>(smem + S::kQOff);
  const T* q_row = q + (static_cast<int64_t>(b) * Hq + hb * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kSplitThreads)
    q_s[i] = to_float(q_row[i]);
  split_pass<T, D>(smem, k_cache, v_cache,
                   DenseRows{static_cast<int64_t>(b) * W},
                   slot_pos + static_cast<int64_t>(b) * W, W, q_pos[b], lo,
                   hi, G, Hkv, hb / rep, window, scale,
                   partial(ws, b, hb, split, Hkv * rep, n_split, G, D));
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* slot_pos, const void* q_pos, void* out, void* ws,
           int B, int Hq, int Hkv, int rep, int W, int chunk, int window,
           float scale, cudaStream_t stream) {
  using S = SplitSmem<T, D>;
  const int n_split = (W + chunk - 1) / chunk;
  const size_t smem = S::bytes(Hq / (Hkv * rep), chunk);
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
          Hkv, rep, W, chunk, n_split, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<T, D>(static_cast<const float*>(ws),
                            static_cast<T*>(out), B, Hq, Hkv * rep, n_split,
                            stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_cache, const void* v_cache,
               const void* slot_pos, const void* q_pos, void* out, void* ws,
               int B, int Hq, int Hkv, int rep, int W, int chunk, int window,
               float scale, cudaStream_t stream) {
  if (D == 32)
    return launch<T, 32>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                         Hq, Hkv, rep, W, chunk, window, scale, stream);
  if (D == 64)
    return launch<T, 64>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                         Hq, Hkv, rep, W, chunk, window, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                          Hq, Hkv, rep, W, chunk, window, scale, stream);
  if (D == 256)
    return launch<T, 256>(q, k_cache, v_cache, slot_pos, q_pos, out, ws, B,
                          Hq, Hkv, rep, W, chunk, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Hq,D); k_cache/v_cache (B,W,Hkv,D); slot_pos (B,W) int32 (-1
// empty); q_pos (B,) int32; out (B,Hq,D); ws float32 workspace of
// B * Hkv * ceil(W / chunk) * (Hq / Hkv) * (D + 2) values.  dtype 0 is
// float32, 1 is bfloat16; D in {32, 64, 128, 256}; rep head blocks per KV
// head, rep dividing Hq / Hkv with Hq / (Hkv * rep) <= 8 (rep 2 at group
// 16); any W >= 1, chunk a multiple of 16 in [16, 2048] (slots per split)
// with at most 1024 splits, caches 16-byte aligned; window <= 0 means
// none.  Launches both passes on `stream` and returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* slot_pos,
                                       const void* q_pos, void* out,
                                       void* ws, int B, int Hq, int Hkv,
                                       int rep, int D, int W, int chunk,
                                       int window, float scale,
                                       void* stream) {
  if (B * Hkv == 0) return 0;
  if (Hkv < 1 || rep < 1 || Hq % Hkv || (Hq / Hkv) % rep ||
      !split_shapes_ok(Hq, Hkv * rep, W, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_cache, v_cache, slot_pos, q_pos, out,
                             ws, B, Hq, Hkv, rep, W, chunk, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, slot_pos, q_pos,
                                     out, ws, B, Hq, Hkv, rep, W, chunk,
                                     window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
