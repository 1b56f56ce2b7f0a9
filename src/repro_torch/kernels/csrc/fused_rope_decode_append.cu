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
// Design: paged_decode_attention's two passes (split_attention.cuh): pass 1
// (fused_split_kernel) on a grid of (split, head block, row), each block taking
// `chunk` of the row's logical slots for at most kMaxG query heads of one kv
// head (a larger group as several head blocks, the last ragged; any head dim
// that is a multiple of 16 up to 256 on the smallest instance at or above it);
// pass 2 (merge_kernel) folds the splits' partials as pass 1's programmatic
// dependent.  Pass 1's prologue issues its loads (q, the inverse frequency, the
// new k/v, with split_pass's slot_pos and block-table entries) before one
// barrier, then (RopeAppend) rotates the block's query heads in shared memory
// (rounded to the pool type, as the unfused path stores its rotated q; the bf16
// tensor-core loop takes its fragments from there), and, in the split whose
// slot range holds the new slot (after the oracle's clip to [0, nb * pg - 1]),
// writes the rotated k and the v of its own kv head into the pool.  Only the
// blocks of that split read the new slot: splits are disjoint ranges of slots
// (a page cut by a split boundary has its other slots read by the other split,
// which the append does not touch), for every page size pg.  With several head
// blocks a kv head, every block of that split writes the slot itself (the same
// bytes: the same k, v and angle) before it reads it, so no block reads a slot
// that it has not written, whatever order the blocks run in; none waits for
// another.  The writing threads fence at device scope (cp.async.cg reads the
// page from L2), and a barrier orders the write before the block's copies; the
// pools are not declared __restrict__.  No block of another kv head reads that
// slot's row of this head, and a decode row never appends into a page another
// row reads (allocator contract: shared prefix pages are full, a row's last,
// partial page is its own).  Rows of the batch bucket that carry no request
// point at the null page 0 and append there; their slots are masked and their
// outputs discarded (with more than one such row, which of their appends lands
// is unspecified).
#include "split_attention.cuh"

namespace {

// The fused kernel's work between split_pass's first barrier and its page
// loop.  The pairs (e, e + hd / 2), e < hd / 2, of the block's n query
// heads (q_s (n, D) in shared memory) are rotated in place, thread i
// taking pairs i, i + kSplitThreads, ..., each rounded to T; a thread
// computes the angle of its first pair once (loaded before the barrier)
// and another pair's only where hd / 2 does not divide kSplitThreads (hd
// 48, 80, ...).  In the split that holds the new slot, thread e < hd / 2
// also writes the rotated pair of the new k and the pair of its v into
// the pool row of that slot, then fences at device scope (the block's
// cp.async.cg copies read the page from L2; split_pass's barrier
// follows).
template <typename T, int D>
struct RopeAppend {
  float* q_s;
  T* k_pages;
  T* v_pages;
  const float* inv_freq;
  int n, Hkv, h, hd, qp, slot;
  bool mine;                  // this split holds the new slot
  float freq;                 // inv_freq[threadIdx.x % (hd / 2)]
  float k1, k2, v1, v2;       // the new k and v at e, e + hd / 2

  template <typename Rows>
  __device__ __forceinline__ void operator()(const Rows& rows) const {
    const int half = hd / 2;
    const int e0 = threadIdx.x % half;
    const float ang = __fmul_rn(static_cast<float>(qp), freq);
    const float c0 = cosf(ang), s0 = sinf(ang);  // full precision
    for (int p = threadIdx.x; p < n * half; p += kSplitThreads) {
      const int e = p % half;
      float c = c0, s = s0;
      if (e != e0) {
        const float a = __fmul_rn(static_cast<float>(qp), inv_freq[e]);
        c = cosf(a);
        s = sinf(a);
      }
      float* x = q_s + (p / half) * D + e;
      const float2 r = rope_pair(x[0], x[half], c, s);
      x[0] = to_float(from_float<T>(r.x));
      x[half] = to_float(from_float<T>(r.y));
    }
    if (mine && static_cast<int>(threadIdx.x) < half) {
      const int64_t dst = (rows(slot) * Hkv + h) * hd + e0;
      const float2 r = rope_pair(k1, k2, c0, s0);
      k_pages[dst] = from_float<T>(r.x);
      k_pages[dst + half] = from_float<T>(r.y);
      v_pages[dst] = from_float<T>(v1);
      v_pages[dst + half] = from_float<T>(v2);
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
    float* __restrict__ ws, int Hq, int Hkv, int rep, int hd, int nb, int pg,
    int chunk, int n_split, int window, float scale) {
  using S = SplitSmem<T, D>;
  extern __shared__ __align__(16) char smem[];
  // the merge may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z, hb = blockIdx.y, split = blockIdx.x;
  const int G = Hq / Hkv, half = hd / 2;
  const HeadBlock blk(hb, G, rep);
  const int W = nb * pg;
  const int lo = split * chunk;
  const int hi = min(W, lo + chunk);
  // every load the prologue needs is issued before split_pass's barrier
  float* q_s = reinterpret_cast<float*>(smem + S::kQOff);
  stage_q<T, D>(q_s,
                q + (static_cast<int64_t>(b) * Hq + blk.h * G + blk.g0) * hd,
                blk.n, hd);
  int slot = slots[b];
  slot = slot < 0 ? 0 : (slot > W - 1 ? W - 1 : slot);  // the oracle's clip
  const int qp = q_pos[b];
  RopeAppend<T, D> post{q_s, k_pages, v_pages, inv_freq, blk.n, Hkv, blk.h,
                        hd, qp, slot, slot >= lo && slot < hi,
                        inv_freq[threadIdx.x % half], 0.f, 0.f, 0.f, 0.f};
  if (post.mine && static_cast<int>(threadIdx.x) < half) {
    const int64_t row = (static_cast<int64_t>(b) * Hkv + blk.h) * hd;
    post.k1 = to_float(k_new[row + threadIdx.x]);
    post.k2 = to_float(k_new[row + threadIdx.x + half]);
    post.v1 = to_float(v_new[row + threadIdx.x]);
    post.v2 = to_float(v_new[row + threadIdx.x + half]);
  }
  split_pass<T, D>(smem, k_pages, v_pages,
                   PagedRows<kPerSlot>{block_table + static_cast<int64_t>(b) * nb,
                                      pg},
                   slot_pos + static_cast<int64_t>(b) * W, W, qp, lo, hi,
                   blk.n, Hkv, blk.h, hd, window, scale,
                   partial(ws, b, hb, split, Hkv * rep, n_split,
                           block_heads(G, rep), D),
                   post);
}

template <typename T, int D, bool kPerSlot>
struct Launch {
  static int run(int pg, int hd, const void* q, const void* k_new,
                 const void* v_new, void* k_pages, void* v_pages,
                 const void* block_table, const void* slot_pos,
                 const void* slots, const void* q_pos, const void* inv_freq,
                 void* out, void* ws, int B, int Hq, int Hkv, int rep,
                 int nb, int chunk, int window, float scale,
                 cudaStream_t stream) {
    using S = SplitSmem<T, D>;
    const int n_split = (nb * pg + chunk - 1) / chunk;
    const size_t smem = S::bytes(block_heads(Hq / Hkv, rep), chunk, pg);
    static bool opted_in = false;  // per instance
    const cudaError_t e0 = allow_smem(
        reinterpret_cast<const void*>(fused_split_kernel<T, D, kPerSlot>),
        smem, S::bytes(kMaxG, kMaxChunk, 1), &opted_in);
    if (e0 != cudaSuccess) return static_cast<int>(e0);
    fused_split_kernel<T, D, kPerSlot><<<dim3(n_split, Hkv * rep, B),
                                         kSplitThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_pages),
        static_cast<T*>(v_pages), static_cast<const int32_t*>(block_table),
        static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(slots),
        static_cast<const int32_t*>(q_pos),
        static_cast<const float*>(inv_freq), static_cast<float*>(ws), Hq,
        Hkv, rep, hd, nb, pg, chunk, n_split, window, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_merge<T, D>(static_cast<const float*>(ws),
                              static_cast<T*>(out), B, Hq, Hkv, rep, n_split,
                              hd, stream);
  }
};

}  // namespace

// q (B,Hq,hd), k_new/v_new (B,Hkv,hd); k_pages/v_pages (P,pg,Hkv,hd),
// updated in place; block_table (B,nb), slot_pos (B,nb*pg), slots (B,)
// and q_pos (B,) int32; inv_freq (hd/2,) float32; out (B,Hq,hd); ws
// float32 workspace of B * Hkv * rep * ceil(nb * pg / chunk) * ceil(Hq /
// (Hkv * rep)) * (D + 2) values, D the instance of hd (kHeadDims).  dtype
// 0 is float32, 1 is bfloat16; hd a multiple of 16 in [16, 256], pg >= 1,
// rep head blocks of at most 8 query heads per KV head (none empty), nb
// >= 1, chunk a multiple of 16 in [16, 2048] (slots per split) with at
// most 1024 splits, pools 16-byte aligned; window <= 0 means none.
// Launches both passes on `stream` and returns the launches' error, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int fused_rope_decode_append_launch(
    int dtype, const void* q, const void* k_new, const void* v_new,
    void* k_pages, void* v_pages, const void* block_table,
    const void* slot_pos, const void* slots, const void* q_pos,
    const void* inv_freq, void* out, void* ws, int B, int Hq, int Hkv,
    int rep, int hd, int nb, int pg, int chunk, int window, float scale,
    void* stream) {
  if (B * Hkv == 0) return 0;
  if (nb < 1 || !split_shapes_ok(Hq, Hkv, rep, nb * pg, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, Launch>(hd, pg, q, k_new, v_new, k_pages, v_pages,
                                   block_table, slot_pos, slots, q_pos,
                                   inv_freq, out, ws, B, Hq, Hkv, rep, nb,
                                   chunk, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, Launch>(hd, pg, q, k_new, v_new, k_pages,
                                           v_pages, block_table, slot_pos,
                                           slots, q_pos, inv_freq, out, ws,
                                           B, Hq, Hkv, rep, nb, chunk, window,
                                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
