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
// Design: one thread block per token; the Hkv * D row (1 KiB at
// Hkv 8, D 64, bf16) is copied with 16-byte vector loads and stores, so
// neighbouring threads touch neighbouring addresses and the copy is
// type-agnostic (float32 and bfloat16 share it).  The pools are updated
// in place; nothing is allocated here.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void paged_prefill_write_kernel(
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ block_table, uint4* __restrict__ k_pages,
    uint4* __restrict__ v_pages, int T, int nb, int pg, int row_vecs) {
  const int token = blockIdx.x;  // b * T + t
  const int b = token / T;
  int slot = positions[token];
  if (slot < 0) return;  // left pad: nothing to store
  const int last = nb * pg - 1;
  slot = slot > last ? last : slot;  // the oracle's clip
  const int64_t page = block_table[(int64_t)b * nb + slot / pg];
  const int64_t dst = (page * pg + slot % pg) * row_vecs;
  const int64_t src = (int64_t)token * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += kThreads) {
    k_pages[dst + i] = k_new[src + i];
    v_pages[dst + i] = v_new[src + i];
  }
}

}  // namespace

// k_new/v_new (B,T,Hkv,D), positions (B,T) int32, block_table (B,nb)
// int32, k_pages/v_pages (P,pg,Hkv,D); row_bytes = Hkv * D * elem_size,
// a multiple of 16.  Launches on `stream`; returns cudaGetLastError().
extern "C" int paged_prefill_write_launch(
    const void* k_new, const void* v_new, const void* positions,
    const void* block_table, void* k_pages, void* v_pages, int B, int T,
    int nb, int pg, int row_bytes, void* stream) {
  if (B * T == 0) return 0;
  paged_prefill_write_kernel<<<B * T, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(block_table),
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages), T, nb, pg,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
