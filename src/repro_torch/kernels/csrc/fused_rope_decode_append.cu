// Fused RoPE + KV append + paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_rope_decode_append.py
// (fused_rope_decode_append, pallas_call at :158) and computes what
// repro/kernels/ref.py:fused_rope_decode_append_ref computes: the new
// token's q (Hq heads) and k (Hkv heads) are rotated at q_pos[b] (Llama
// half rotation, float32, rounded once to the pool type); the rotated k
// and the unrotated v are written into page block_table[b, slots[b] / pg]
// at offset slots[b] % pg; then every query head attends over the row's
// pages after that append, masked by slot_pos >= 0, slot_pos <= q_pos and
// the optional window.
//
// Bound: bytes, as the unfused decode attention (paged_decode_attention.cu)
// is: every live K/V slot of every row is read once; the prologue adds
// one q row, one k/v row and the append, (Hq + 2 * Hkv) * D values a row.
//
// Design: paged_decode_attention's two passes (split_attention.cuh): pass
// 1 (fused_split_kernel) on a grid of (split, kv head, row), each block
// taking `chunk` of the row's logical slots; pass 2 (merge_kernel) folds
// the splits' partials as pass 1's programmatic dependent.  Pass 1's
// prologue issues all its loads (q, the inverse frequencies, the new k/v,
// with split_pass's slot_pos and block-table entries) before one barrier,
// then (RopeAppend) rotates the block's G query heads in shared memory
// (rounded to the pool type, as the unfused path stores its rotated q; the
// bf16 tensor-core loop takes its fragments from there), each thread at
// the one angle it needs, and, in the one split whose slot range holds the
// new slot (after the oracle's clip to [0, nb * pg - 1]), writes the
// rotated k and the v of its own kv head into the pool.  Only that block
// reads the new slot: splits are disjoint ranges of slots (a page cut by
// a split boundary has its other slots read by the other split, which
// the append does not touch), for every page size pg.  The writing
// threads fence at device scope
// (cp.async.cg reads the page from L2), and a barrier orders the write
// before the block's copies; the pools are not declared __restrict__.  No
// other block reads that slot: each block appends only its own kv head,
// and a decode row never appends into a page another row reads (allocator
// contract: shared prefix pages are full, a row's last, partial page is
// its own).  Rows of the batch bucket that carry no request point at the
// null page 0 and append there; their slots are masked and their outputs
// discarded (with more than one such row, which of their appends lands is
// unspecified).
#include "split_attention.cuh"

namespace {

// The fused kernel's work between split_pass's first barrier and its page
// loop.  Thread i rotates the pairs (e, e + D / 2), e = i % (D / 2), of q
// (G, D) in shared memory in place, all at one angle (kSplitThreads is a
// multiple of D / 2), rounding each value to T; in the split that holds
// the new slot, thread e < D / 2 also writes the rotated pair of the new
// k and the pair of its v into the pool row of that slot, then fences at
// device scope (the block's cp.async.cg copies read the page from L2;
// split_pass's barrier follows).  Loaded before the first barrier:
// the inverse frequency and, in that split, the new k/v pair.
template <typename T, int D>
struct RopeAppend {
  float* q_s;
  T* k_pages;
  T* v_pages;
  int G, Hkv, h, qp, slot;
  bool mine;                  // this split holds the new slot
  float freq;                 // inv_freq[threadIdx.x % (D / 2)]
  float k1, k2, v1, v2;       // the new k and v at e, e + D / 2

  template <typename Rows>
  __device__ __forceinline__ void operator()(const Rows& rows) const {
    constexpr int kHalf = D / 2;
    static_assert(kSplitThreads % kHalf == 0, "one angle per thread");
    const int e = threadIdx.x % kHalf;
    const float ang = __fmul_rn(static_cast<float>(qp), freq);
    const float c = cosf(ang), s = sinf(ang);  // full precision
    for (int p = threadIdx.x; p < G * kHalf; p += kSplitThreads) {
      float* x = q_s + (p / kHalf) * D + e;
      const float2 r = rope_pair(x[0], x[kHalf], c, s);
      x[0] = to_float(from_float<T>(r.x));
      x[kHalf] = to_float(from_float<T>(r.y));
    }
    if (mine && threadIdx.x < kHalf) {
      const int64_t dst = (rows(slot) * Hkv + h) * D + e;
      const float2 r = rope_pair(k1, k2, c, s);
      k_pages[dst] = from_float<T>(r.x);
      k_pages[dst + kHalf] = from_float<T>(r.y);
      v_pages[dst] = from_float<T>(v1);
      v_pages[dst + kHalf] = from_float<T>(v2);
      __threadfence();
    }
  }
};

template <typename T, int D, bool kPerSlot>
__global__ void __launch_bounds__(kSplitThreads) fused_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pages, T* v_pages,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ slot_pos, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ q_pos, const float* __restrict__ inv_freq,
    float* __restrict__ ws, int Hq, int Hkv, int nb, int pg, int chunk,
    int n_split, int window, float scale) {
  using S = SplitSmem<T, D>;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z, h = blockIdx.y, split = blockIdx.x;
  const int G = Hq / Hkv;
  const int W = nb * pg;
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  // every load the prologue needs is issued before split_pass's barrier
  float* q_s = reinterpret_cast<float*>(smem + S::kQOff);
  const T* q_row = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kSplitThreads)
    q_s[i] = to_float(q_row[i]);
  int slot = slots[b];
  slot = slot < 0 ? 0 : (slot > W - 1 ? W - 1 : slot);  // the oracle's clip
  const int qp = q_pos[b];
  RopeAppend<T, D> post{q_s, k_pages, v_pages, G, Hkv, h, qp, slot,
                        slot >= lo && slot < hi,
                        inv_freq[threadIdx.x % kHalf], 0.f, 0.f, 0.f, 0.f};
  if (post.mine && threadIdx.x < kHalf) {
    const int64_t row = (static_cast<int64_t>(b) * Hkv + h) * D;
    post.k1 = to_float(k_new[row + threadIdx.x]);
    post.k2 = to_float(k_new[row + threadIdx.x + kHalf]);
    post.v1 = to_float(v_new[row + threadIdx.x]);
    post.v2 = to_float(v_new[row + threadIdx.x + kHalf]);
  }
  split_pass<T, D>(smem, k_pages, v_pages,
                   PagedRows<kPerSlot>{block_table + static_cast<int64_t>(b) * nb,
                                      pg},
                   slot_pos + static_cast<int64_t>(b) * W, W, qp, lo, hi, G,
                   Hkv, h, window, scale,
                   partial(ws, b, h, split, Hkv, n_split, G, D), post);
}

template <typename T, int D, bool kPerSlot>
struct Launch {
  static int run(int pg, const void* q, const void* k_new,
                 const void* v_new, void* k_pages, void* v_pages,
                 const void* block_table, const void* slot_pos,
                 const void* slots, const void* q_pos, const void* inv_freq,
                 void* out, void* ws, int B, int Hq, int Hkv, int nb,
                 int chunk, int window, float scale, cudaStream_t stream) {
    using S = SplitSmem<T, D>;
    const int n_split = (nb * pg + chunk - 1) / chunk;
    const size_t smem = S::bytes(Hq / Hkv, chunk, pg);
    static bool opted_in = false;  // per instance
    const cudaError_t e0 = allow_smem(
        reinterpret_cast<const void*>(fused_split_kernel<T, D, kPerSlot>),
        smem, S::bytes(kMaxG, kMaxChunk, 1), &opted_in);
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    fused_split_kernel<T, D, kPerSlot><<<dim3(n_split, Hkv, B),
                                         kSplitThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_pages),
        static_cast<T*>(v_pages), static_cast<const int32_t*>(block_table),
        static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(q_pos),
        static_cast<const float*>(inv_freq), static_cast<float*>(ws), Hq,
        Hkv, nb, pg, chunk, n_split, window, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_merge<T, D>(static_cast<const float*>(ws),
                              static_cast<T*>(out), B, Hq, Hkv, n_split,
                              stream);
  }
};

}  // namespace

// q (B,Hq,D), k_new/v_new (B,Hkv,D); k_pages/v_pages (P,pg,Hkv,D), updated
// in place; block_table (B,nb), slot_pos (B,nb*pg), slots (B,) and q_pos
// (B,) int32; inv_freq (D/2,) float32; out (B,Hq,D); ws float32 workspace
// of B * Hkv * ceil(nb * pg / chunk) * (Hq / Hkv) * (D + 2) values.  dtype
// 0 is float32, 1 is bfloat16; D in {32, 64, 128, 256}, pg >= 1,
// Hq / Hkv <= 8, nb >= 1, chunk a multiple of 16 in [16, 2048] (slots per
// split) with at most 1024 splits, pools 16-byte aligned; window <= 0
// means none.
// Launches both passes on `stream` and returns the launches' error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int fused_rope_decode_append_launch(
    int dtype, const void* q, const void* k_new, const void* v_new,
    void* k_pages, void* v_pages, const void* block_table,
    const void* slot_pos, const void* slots, const void* q_pos,
    const void* inv_freq, void* out, void* ws, int B, int Hq, int Hkv, int D,
    int nb, int pg, int chunk, int window, float scale, void* stream) {
  if (B * Hkv == 0) return 0;
  if (nb < 1 || !split_shapes_ok(Hq, Hkv, nb * pg, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, Launch>(D, pg, q, k_new, v_new, k_pages, v_pages,
                                   block_table, slot_pos, slots, q_pos,
                                   inv_freq, out, ws, B, Hq, Hkv, nb, chunk,
                                   window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, Launch>(D, pg, q, k_new, v_new, k_pages,
                                           v_pages, block_table, slot_pos,
                                           slots, q_pos, inv_freq, out, ws,
                                           B, Hq, Hkv, nb, chunk, window,
                                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
