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
//
// The first design gave each token a block of 64 threads (4,096 short
// blocks at 8 rows of 512, 341 of them only to read a pad's position):
// each block read its position, computed its D / 2 angles into shared
// memory, waited at a barrier, and only then loaded K, after a chain of
// position, page and angles; the rotation had Hkv * (D / 2) / 8 = 32 work
// items for its 64 threads.  It reached 34 % of the bound at 8 rows of
// 512 (NVIDIA H100 80GB HBM3, 700 W).
//
// This design is paged_prefill_write's: a block of 64 threads takes a
// tile of consecutive tokens, each thread kV 16-byte vectors of V (2 where
// that leaves every SM 4 blocks, else 1) and one pair of K vectors (the 16
// bytes at element e of a head and the 16 at e + D / 2, which rotate
// together: a thread owns a whole pair, so at kV 2 every thread has the
// same work in the rotation and the copy; at kV 1, on the one-row stages,
// half the threads rotate).  Each thread reads the positions of its own
// tokens and issues all its loads at once with the page lookups they
// need; while those are in flight the block computes each valid token's
// D / 2 angles once into shared memory; after one barrier every thread
// rotates its pair and stores.  So the chain is position, then page,
// source and angles at once, and pads are never read.  cosf / sinf run at
// full precision (no fast-math: the angles reach hundreds of radians) and
// every product and sum is rounded separately, so K matches the unfused
// path's torch RoPE bit for bit when both read the same inverse
// frequencies.  Each token is addressed on its own, so any positions the
// wrapper takes (runs, shuffled rows, slots clipped at the table's end)
// go where the plain version puts them.  The pools are updated in place;
// nothing is allocated here.  What bounds it is what bounds
// paged_prefill_write (scripts/write_variants.py, PERF.md), with the
// angles' few hundred cycles on the chain at the one-row stages.
#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 64;

// the floats held by 16 bytes of T values
template <typename T>
__device__ __forceinline__ void unpack_16(const uint4& u, float* out) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  unpack<T>(u.x, out);
  unpack<T>(u.y, out + kPer);
  unpack<T>(u.z, out + 2 * kPer);
  unpack<T>(u.w, out + 3 * kPer);
}

// kV 16-byte vectors of V a thread moves (1 or 2), and at most one pair of
// K vectors: the 16 bytes at element e of a head and the 16 at e + D / 2,
// which rotate together.  A block's kThreads * kV vectors of V are as
// many of K, so at kV 2 every thread owns one pair, at kV 1 half of them.
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads) fused_rope_prefill_write_kernel(
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ block_table,
    const float* __restrict__ inv_freq, uint4* __restrict__ k_pages,
    uint4* __restrict__ v_pages, int n_tokens, int T_len, int nb, int pg,
    int Hkv, int D, int tile) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a vector
  constexpr int kTileVecs = kThreads * kV;
  extern __shared__ float cs[];  // per token: cos, sin (D/2 each)
  const int first = blockIdx.x * tile;
  const int n = min(tile, n_tokens - first);
  const int last = nb * pg - 1;
  const int half = D / 2;
  const int hv = half / kVec;          // vectors in half a head
  const int row_vecs = Hkv * D / kVec;
  const int pairs = Hkv * hv;          // K vector pairs a token
  const int n_vecs = n * row_vecs;
  // one pass for every row of up to kTileVecs vectors (tile >= 1 token)
  for (int base = 0; base < n_vecs; base += kTileVecs) {
    uint4 vv[kV], x1, x2;
    int64_t vpage[kV], kpage = 0;
    int vslot[kV], vcol[kV];
    int kslot = -1, kcol = 0, kt = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      vslot[j] = -1;
      if (i < n_vecs) {
        const int t = i / row_vecs;
        const int pos = __ldg(positions + first + t);
        if (pos >= 0) {
          const int token = first + t;
          vcol[j] = i - t * row_vecs;
          vslot[j] = pos > last ? last : pos;  // the oracle's clip
          vv[j] = __ldg(v_new + static_cast<int64_t>(token) * row_vecs
                        + vcol[j]);
          vpage[j] = __ldg(block_table
                           + static_cast<int64_t>(token / T_len) * nb
                           + vslot[j] / pg);
        }
      }
    }
    const int p = base / 2 + threadIdx.x;  // this thread's pair
    if (threadIdx.x < kTileVecs / 2 && p < n_vecs / 2) {
      const int t = p / pairs;
      const int pos = __ldg(positions + first + t);
      if (pos >= 0) {
        const int token = first + t;
        const int r = p - t * pairs;
        // vector of the first half of head r / hv, at its (r % hv)-th
        kcol = (r / hv) * 2 * hv + r % hv;
        kt = t;
        kslot = pos > last ? last : pos;
        const int64_t src = static_cast<int64_t>(token) * row_vecs + kcol;
        x1 = __ldg(k_new + src);
        x2 = __ldg(k_new + src + hv);
        kpage = __ldg(block_table + static_cast<int64_t>(token / T_len) * nb
                      + kslot / pg);
      }
    }
    if (base == 0) {  // every token of the tile: its angles, once
      for (int a = threadIdx.x; a < n * half; a += kThreads) {
        const int t = a / half, e = a - t * half;
        const int pos = __ldg(positions + first + t);
        if (pos < 0) continue;
        const float ang = __fmul_rn(static_cast<float>(pos), inv_freq[e]);
        cs[t * D + e] = cosf(ang);
        cs[t * D + half + e] = sinf(ang);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (vslot[j] < 0) continue;
      v_pages[(vpage[j] * pg + vslot[j] % pg) * row_vecs + vcol[j]] = vv[j];
    }
    if (kslot >= 0) {
      const float* c = cs + kt * D + (kcol % (2 * hv)) * kVec;
      const float* s = c + half;
      float a1[kVec], a2[kVec], r1[kVec], r2[kVec];
      unpack_16<T>(x1, a1);
      unpack_16<T>(x2, a2);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float2 r = rope_pair(a1[e], a2[e], c[e], s[e]);
        r1[e] = r.x;
        r2[e] = r.y;
      }
      uint4* dst = k_pages + (kpage * pg + kslot % pg) * row_vecs + kcol;
      store_16<T>(reinterpret_cast<T*>(dst), r1);
      store_16<T>(reinterpret_cast<T*>(dst + hv), r2);
    }
  }
}

template <typename T, int kV>
int launch_tiles(const void* k_new, const void* v_new, const void* positions,
                 const void* block_table, const void* inv_freq,
                 void* k_pages, void* v_pages, int n_tokens, int T_len,
                 int nb, int pg, int Hkv, int D, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kTileVecs = kThreads * kV;
  const int row_vecs = Hkv * D / kVec;
  const int tile = row_vecs >= kTileVecs ? 1 : kTileVecs / row_vecs;
  // cos and sin of every token: tile * D floats, at most 4 KiB a block
  // (kV 2, bfloat16, one head of 16)
  const size_t smem = sizeof(float) * tile * D;
  fused_rope_prefill_write_kernel<T, kV>
      <<<(n_tokens + tile - 1) / tile, kThreads, smem, stream>>>(
          static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
          static_cast<const int32_t*>(positions),
          static_cast<const int32_t*>(block_table),
          static_cast<const float*>(inv_freq), static_cast<uint4*>(k_pages),
          static_cast<uint4*>(v_pages), n_tokens, T_len, nb, pg, Hkv, D,
          tile);
  return static_cast<int>(cudaGetLastError());
}


template <typename T>
int launch(const void* k_new, const void* v_new, const void* positions,
           const void* block_table, const void* inv_freq, void* k_pages,
           void* v_pages, int B, int T_len, int nb, int pg, int Hkv, int D,
           cudaStream_t stream) {
  const int n_tokens = B * T_len;
  const int64_t n_vecs = static_cast<int64_t>(n_tokens) * Hkv * D
                         / (16 / static_cast<int>(sizeof(T)));
  switch (vectors_per_thread(n_vecs, kThreads)) {
    case 2:
      return launch_tiles<T, 2>(k_new, v_new, positions, block_table,
                                inv_freq, k_pages, v_pages, n_tokens, T_len,
                                nb, pg, Hkv, D, stream);
    default:
      return launch_tiles<T, 1>(k_new, v_new, positions, block_table,
                                inv_freq, k_pages, v_pages, n_tokens, T_len,
                                nb, pg, Hkv, D, stream);
  }
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
