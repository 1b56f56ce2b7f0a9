// Prefill K/V page-pool scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_prefill_write.py
// (paged_prefill_write, pallas_call at :85).  Semantics are those of the
// oracle repro/kernels/ref.py:paged_prefill_write_ref, not of the Pallas
// body: token (b, t) whose destination slot positions[b, t] >= 0 goes to
// page block_table[b, slot / pg] at offset slot % pg; pads (slot < 0) are
// skipped.  The Pallas body derives only a left-pad width and writes token
// pad + s to slot s, which is wrong when positions start past 0 (the
// shared-prefix tail prefill); this kernel reads each token's own slot.
//
// Bound: bytes.  It reads each K/V token row once and writes it once
// (2 * 2 * B * T_valid * Hkv * D * sizeof(T)) and does no arithmetic.
//
// The first design gave each token a block of 64 threads, one 16-byte
// vector per thread per tensor: 4,096 short blocks at 8 rows of 512, a
// block launched and retired per token, 341 of them only to read a pad's
// position, and in each a chain of three dependent loads (position, page,
// source row) before its two stores.  It reached 37 % of the bound at 8
// rows of 512 (NVIDIA H100 80GB HBM3, 700 W).
//
// This design gives a block of 64 threads a tile of consecutive tokens;
// each thread moves kPer 16-byte vectors of K and as many of V: 2 where
// the call has tokens enough to leave every SM 4 blocks (8 rows of 512:
// 2,048 blocks of 2 tokens), else 1, so that a one-row stage of a few
// hundred tokens still spreads over the whole card.  (4 vectors a thread
// measured no faster than 2 at 8 rows of 512 and slower below.)  Each
// thread reads the positions of its own tokens (the lanes of a warp share
// a token, so one load a warp, and no barrier), then issues all its source
// loads together with the page lookups they need and stores only after
// those have all been issued, so the chain is two loads deep (position,
// then page and source at once) and pads are never read.
// Each token is addressed on its own (its row of Hkv * D values is
// contiguous in the source and in its page), so any positions the
// wrapper takes go where the plain version puts them: consecutive runs,
// shuffled rows and slots clipped at the table's end alike.  The copy is
// type-agnostic (float32 and bfloat16 share it); the pools are updated in
// place and nothing is allocated here.
//
// What bounds it (scripts/write_variants.py, PERF.md): at 8 rows of 512
// the bytes, and with them the write-back of whatever the L2 cache held
// dirty; a contiguous copy of the same bytes takes longer.  At the
// slices' one-row stages a launch costs more than the bytes: the kernel
// takes about 2 us beyond an empty launch, a contiguous copy 1 us
// (NVIDIA H100 80GB HBM3, 700 W).
// Staging the tile's positions in shared memory behind a barrier measured
// slower at one-row stages; loading the source rows before the positions
// are known, with the rows' block table staged beside them, no faster.
#include "paged_attention.cuh"

namespace {

using paged::vectors_per_thread;

constexpr int kThreads = 64;

template <int kPer>  // 16-byte vectors of each tensor a thread moves
__global__ void __launch_bounds__(kThreads) paged_prefill_write_kernel(
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ block_table, uint4* __restrict__ k_pages,
    uint4* __restrict__ v_pages, int n_tokens, int T, int nb, int pg,
    int row_vecs, int tile) {
  constexpr int kTileVecs = kThreads * kPer;
  const int first = blockIdx.x * tile;
  const int n = min(tile, n_tokens - first);
  const int last = nb * pg - 1;
  const int n_vecs = n * row_vecs;
  // one pass for every row of up to kTileVecs vectors (tile >= 1 token)
  for (int base = 0; base < n_vecs; base += kTileVecs) {
    uint4 kv[kPer], vv[kPer];
    int64_t page[kPer];
    int slot[kPer], col[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      slot[j] = -1;
      if (i < n_vecs) {
        const int t = i / row_vecs;
        const int pos = __ldg(positions + first + t);
        if (pos >= 0) {
          const int token = first + t;
          col[j] = i - t * row_vecs;
          slot[j] = pos > last ? last : pos;  // the oracle's clip
          const int64_t src = static_cast<int64_t>(token) * row_vecs + col[j];
          kv[j] = __ldg(k_new + src);
          vv[j] = __ldg(v_new + src);
          page[j] = __ldg(block_table
                          + static_cast<int64_t>(token / T) * nb
                          + slot[j] / pg);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (slot[j] < 0) continue;
      const int64_t dst = (page[j] * pg + slot[j] % pg) * row_vecs + col[j];
      k_pages[dst] = kv[j];
      v_pages[dst] = vv[j];
    }
  }
}

template <int kPer>
int launch(const void* k_new, const void* v_new, const void* positions,
           const void* block_table, void* k_pages, void* v_pages,
           int n_tokens, int T, int nb, int pg, int row_vecs,
           cudaStream_t stream) {
  constexpr int kTileVecs = kThreads * kPer;
  const int tile = row_vecs >= kTileVecs ? 1 : kTileVecs / row_vecs;
  paged_prefill_write_kernel<kPer><<<(n_tokens + tile - 1) / tile, kThreads,
                                     0, stream>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(block_table),
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages), n_tokens,
      T, nb, pg, row_vecs, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_new/v_new (B,T,Hkv,D), positions (B,T) int32, block_table (B,nb)
// int32, k_pages/v_pages (P,pg,Hkv,D), every tensor 16-byte aligned;
// row_bytes = Hkv * D * elem_size, a multiple of 16.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int paged_prefill_write_launch(
    const void* k_new, const void* v_new, const void* positions,
    const void* block_table, void* k_pages, void* v_pages, int B, int T,
    int nb, int pg, int row_bytes, void* stream) {
  if (B * T == 0) return 0;
  const int row_vecs = row_bytes / 16;
  const int n_tokens = B * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vectors_per_thread(static_cast<int64_t>(n_tokens) * row_vecs,
                             kThreads)) {
    case 2:
      return launch<2>(k_new, v_new, positions, block_table, k_pages,
                       v_pages, n_tokens, T, nb, pg, row_vecs, s);
    default:
      return launch<1>(k_new, v_new, positions, block_table, k_pages,
                       v_pages, n_tokens, T, nb, pg, row_vecs, s);
  }
}
