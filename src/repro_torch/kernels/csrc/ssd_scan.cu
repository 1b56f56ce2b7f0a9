// Mamba-2 SSD chunked scan for Hopper (sm_90a), in four chunk-parallel
// passes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :89) and computes its function, which is what
// repro_torch/kernels/ref.py:ssd_scan_ref computes: for row b and head h,
// over chunks of Q tokens, with cum the inclusive in-chunk cumulative sum
// of dt * A (A < 0, dt >= 0, so cum falls),
//   y[t]      = sum_{s<=t} (C_t . B_s) e^{cum_t - cum_s} dt_s x_s
//             + e^{cum_t} C_t . state_in
//   state_out = e^{cum_last} state_in
//             + sum_s e^{cum_last - cum_s} dt_s x_s (x) B_s
// B and C are read per group, head h taking group h / (H / G), as
// jnp.repeat broadcasts them.  The state starts at zero; y and the final
// state are returned.
//
// The passes, each a kernel on the wrapper's stream; passes 2-4 are
// launched as programmatic dependents of the pass before them:
//   1. ssd_cb_kernel, per (row, chunk, group) and 64 x 64 tile of the lower
//      triangle: CB = C_c B_c^T, once per group (all H / G heads of the
//      group read it), into a (B, nc, G, Q, Q) float32 scratch.
//   2. ssd_state_kernel, per (row, chunk, head): cum by warp scans (shuffles),
//      then S_loc = sum_s e^{cum_last - cum_s} dt_s x_s (x) B_s, a
//      (P x Q)(Q x N) product; writes cum, e^{cum_last} and S_loc.  It reads
//      nothing of pass 1, so it runs beside it; it waits for pass 1 only
//      before it exits, so that pass 3's wait covers pass 1 too.
//   3. ssd_pass_kernel, per (row, head), each thread 4 of the P x N
//      entries: the only serial part, S_in[0] = 0, S_in[c] = e^{cum_last[c-1]}
//      S_in[c-1] + S_loc[c-1], written over S_loc; the last is the final
//      state.  kAhead chunks' loads are in flight at once.
//   4. ssd_output_kernel, per (row, chunk, head) and 128-token tile:
//      acc = C . S_in^T (skipped at chunk 0), scaled row t by e^{cum_t}, then
//      acc += M x with M[t, s] = CB[t, s] e^{cum_t - cum_s} dt_s for s <= t
//      and 0 above, k-steps above the diagonal skipped; warp w takes the
//      16-row tiles w % 4 and 7 - w % 4 of half the columns, so the
//      triangle's work is even.
// Every product runs on the tensor cores as 3xTF32: mma.sync m16n8k8 .tf32,
// each operand split by cvt.rna into hi + lo, a_lo b_hi + a_hi b_lo + a_hi
// b_hi accumulated in float32.  Why: mma.sync TF32 peaks at ~320 TFLOP/s
// on the H100 against ~56 for float32 FMAs (scripts/ssd_variants.py), so
// three TF32 products still beat the CUDA cores, and the split keeps float32's
// accuracy (~5e-6 of the largest |y| against the plain version at the
// smoke shapes) where plain TF32 keeps about three decimal digits, which
// the recurrence compounds (~6e-4, past the tests' 1e-4).  Operand tiles
// are staged by cp.async into a ring of kStages slots, so that the next
// tiles' loads are in flight while one multiplies; shapes that are no
// multiple of the tiles are zero-filled there.  The kernels allocate
// nothing and do not synchronise: the wrapper takes the scratch from
// torch.empty.
//
// C2 invariant: no positive exponent is ever computed (each decay is
// e^{difference <= 0}, never e^{cum_t} e^{-cum_s}), because that factoring
// overflows to inf and gives 0 * inf = NaN on the chunks where the JAX
// oracle does (ROADMAP C2).  The masked weight is selected after it is
// computed, so the unwritten upper triangle of CB never reaches y.
//
// Bound: at mamba2-130m's prefill shapes (8 rows of 512 tokens, 24 heads of
// P 64, N 128, Q 128) the work is ~1.85 G multiply-adds against ~61 MB of
// inputs and outputs: three TF32 products each, ~22 us at 495 TFLOP/s,
// against ~18 us of memory traffic.  What bounds each pass (profiler,
// 8 x 512, passes launched one after another; scripts/ssd_variants.py):
// pass 4 ~96 us and pass 2 ~49 us are bound by the instructions around
// the products, not by the tensor cores: each fragment is loaded and
// split by every warp that reads it, and the copies are only partly
// hidden at two blocks per SM (without the splits the call takes ~21 %
// less, without the copies ~22 %, with one product instead of three
// ~30 %); pass 3 (~14 us) by the bytes of the states; pass 1 (~7 us) runs
// beside pass 2.  At one row of 640 tokens the call takes ~55 us.
//
// What a later PR would do: split each operand into hi and lo once per
// block, when it is staged (each element is split by 2 to 4 warps now);
// read one group's B, C and CB tiles once for several heads per block;
// and move passes 2 and 4 to wgmma, whose operands come from shared
// memory without per-warp fragment loads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;               // depth (k) of a staged operand tile
constexpr int kSK = kBK + 4;          // row stride of a k-contiguous tile
constexpr int kStages = 3;            // slots of each pass's ring
constexpr size_t kMaxSmem = 232448;   // bytes a block may have on Hopper
constexpr int kMaxGridY = 65535;

// pass 1: 64 x 64 tiles of CB, 4 warps of 32 x 32
constexpr int kT1 = 128, kCB = 64;
constexpr int kRing1 = 2 * kCB * kSK;             // C rows t, B rows s
// pass 2: 64 (P) x 128 (N) tiles of S_loc, 8 warps of 32 x 32
constexpr int kT2 = 256, kP2 = 64, kN2 = 128;
constexpr int kNJ2 = kN2 / (kT2 / 64) / 8;        // n-tiles of 8 a warp
constexpr int kSX2 = kP2 + 8, kSB2 = kN2 + 8;     // rows s of x and of B
constexpr int kRing2 = kBK * kSX2 + kBK * kSB2;
// pass 3: 4 state entries a thread, kAhead chunks' loads in flight
constexpr int kT3 = 256, kAhead = 8;
// pass 4: 128 (tokens) x 64 (P) tiles of y, 8 warps of 2 x 16 rows x 32
constexpr int kT4 = 256, kM4 = 128, kP4 = 64;
constexpr int kNJ4 = kP4 / (kT4 / 128) / 8;       // n-tiles of 8 a warp
constexpr int kSX4 = kP4 + 8;                     // rows s of x
constexpr int kRing4 = kM4 * kSK + kP4 * kSK;     // C or CB rows t; S_in or x
static_assert(kBK * kSX4 == kP4 * kSK, "pass 4's B tiles share a slot");
static_assert(kM4 == 8 * 16 && kT4 % 128 == 0, "pass 4 pairs 16-row tiles");
static_assert(kT2 % 64 == 0 && kNJ2 >= 1 && kNJ4 >= 1, "warp tiles");
static_assert(kCB * kBK / 4 % kT1 == 0 && kBK * kP2 / 4 % kT2 == 0 &&
                  kBK * kN2 / 4 % kT2 == 0 && kM4 * kBK / 4 % kT4 == 0 &&
                  kP4 * kBK / 4 % kT4 == 0,
              "every thread issues the same copies");

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}

// Dynamic shared memory of pass 1, 2 or 4 (pass 3 has none).
__host__ __device__ inline size_t smem_bytes(int pass, int Q) {
  switch (pass) {
    case 1: return sizeof(float) * kStages * kRing1;
    case 2: return sizeof(float) * (kStages * kRing2 + 2 * round_up(Q, kBK) +
                                    kT2 / 32);
    case 4: return sizeof(float) * (kStages * kRing4 + 2 * round_up(Q, kM4));
    default: return 0;
  }
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits until the grids this one depends on have completed and their
// writes are visible.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 16 bytes from global to shared memory, or 16 zero bytes where !ok (src
// is then only a valid address and is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Runs n steps through a ring of kStages slots: load(step, slot) issues the
// step's cp.async copies, compute(step, slot) consumes them once every
// thread's copies have landed.  kStages - 1 steps are in flight ahead.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed; every thread left step i - 1's slot
    const int next = i + kStages - 1;
    if (next < n) load(next, next % kStages);
    cp_async_commit();
    compute(i, i % kStages);
  }
  cp_async_wait<0>();
}

// A TF32 operand value split into hi + lo, each a TF32 bit pattern.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

struct FragA {  // 16 x 8 (rows m, depth k)
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8 (depth k, columns n)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += a[i] b[j] for every tile at float32 accuracy: the small
// terms first, then hi * hi, each round over all the tiles, so that
// neighbouring products are independent and the tensor pipe stays full.
template <int I, int J>
__device__ __forceinline__ void mma3(float (&acc)[I][J][4],
                                     const FragA (&a)[I], const FragB (&b)[J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(acc[i][j], a[i].lo, b[j].hi);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].lo);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].hi);
}
// The same for one row of tiles.
template <int J>
__device__ __forceinline__ void mma3_row(float (&acc)[J][4], const FragA& a,
                                         const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(acc[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(acc[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(acc[j], a.hi, b[j].hi);
}

// Fragment layouts of m16n8k8 (lane = 4 gq + tq): A holds (gq, tq),
// (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4); B holds (k tq, n gq) and
// (k tq + 4, n gq); the sum holds (gq, 2 tq), (gq, 2 tq + 1), (gq + 8,
// 2 tq), (gq + 8, 2 tq + 1).  Strides of k-contiguous tiles are 4 mod 32
// words and of k-major ones 8 mod 32, so a fragment's 32 loads hit 32
// banks.

// A from a tile of rows m with k contiguous; p at (row 0, k 0).
__device__ __forceinline__ void frag_a_mk(FragA& f, const float* p, int ld,
                                          int gq, int tq) {
  split_tf32(p[gq * ld + tq], f.hi[0], f.lo[0]);
  split_tf32(p[(gq + 8) * ld + tq], f.hi[1], f.lo[1]);
  split_tf32(p[gq * ld + tq + 4], f.hi[2], f.lo[2]);
  split_tf32(p[(gq + 8) * ld + tq + 4], f.hi[3], f.lo[3]);
}
// B from a tile of rows n with k contiguous.
__device__ __forceinline__ void frag_b_nk(FragB& f, const float* p, int ld,
                                          int gq, int tq) {
  split_tf32(p[gq * ld + tq], f.hi[0], f.lo[0]);
  split_tf32(p[gq * ld + tq + 4], f.hi[1], f.lo[1]);
}
// B from a tile of rows k with n contiguous.
__device__ __forceinline__ void frag_b_kn(FragB& f, const float* p, int ld,
                                          int gq, int tq) {
  split_tf32(p[tq * ld + gq], f.hi[0], f.lo[0]);
  split_tf32(p[(tq + 4) * ld + gq], f.hi[1], f.lo[1]);
}

// Stores a 16 x 8 sum at (row + gq, col + 2 tq) of out (row stride ld),
// inside rows x cols (cols even, so a pair is in or out together).
__device__ __forceinline__ void store_acc(float* out, int64_t ld, int row,
                                          int col, const float (&d)[4],
                                          int rows, int cols) {
  if (col >= cols) return;
  if (row < rows)
    *reinterpret_cast<float2*>(out + row * ld + col) = make_float2(d[0], d[1]);
  if (row + 8 < rows)
    *reinterpret_cast<float2*>(out + (row + 8) * ld + col) =
        make_float2(d[2], d[3]);
}

// The decay-weighted, causally masked score M[t, s]; the exponent is
// clamped at 0 (it is <= 0 but for the rounding of the scan), and the
// select comes last, so that no value above the diagonal survives.
__device__ __forceinline__ float masked_weight(float cb, const float* cum,
                                               const float* dts, int t,
                                               int s) {
  const float w = cb * expf(fminf(cum[t] - cum[s], 0.f)) * dts[s];
  return s <= t ? w : 0.f;
}

// ---------------------------------------------------------------------------
// pass 1: CB = C B^T per (row, chunk, group), lower-triangle tiles
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kT1) ssd_cb_kernel(
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ cb, int N, int G, int Q) {
  pdl_trigger();
  extern __shared__ __align__(16) float smem[];
  const int bcg = blockIdx.x, g = bcg % G;
  const int64_t tok0 = static_cast<int64_t>(bcg / G) * Q;  // b T + c Q
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.y)) ++ti;
  const int t0 = ti * kCB;
  const int s0 = (static_cast<int>(blockIdx.y) - ti * (ti + 1) / 2) * kCB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4] = {};

  auto load = [&](int step, int slot) {  // C rows t, B rows s
    float* tile = smem + slot * kRing1;
#pragma unroll
    for (int j = 0; j < kCB * (kBK / 4) / kT1; ++j) {
      const int i = threadIdx.x + j * kT1;
      const int r = i / (kBK / 4), kq = 4 * (i % (kBK / 4));
      const int k = step * kBK + kq, t = t0 + r, s = s0 + r;
      const bool okc = t < Q && k < N, okb = s < Q && k < N;
      cp_async16(tile + r * kSK + kq,
                 okc ? Cm + ((tok0 + t) * G + g) * N + k : Cm, okc);
      cp_async16(tile + (kCB + r) * kSK + kq,
                 okb ? Bm + ((tok0 + s) * G + g) * N + k : Bm, okb);
    }
  };
  auto compute = [&](int, int slot) {
    const float* As = smem + slot * kRing1;
    const float* Bs = As + kCB * kSK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      FragA a[2];
      FragB b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        frag_a_mk(a[i], As + (wm + 16 * i) * kSK + kk, kSK, gq, tq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        frag_b_nk(b[j], Bs + (wn + 8 * j) * kSK + kk, kSK, gq, tq);
      mma3(acc, a, b);
    }
  };
  pipeline(ceil_div(N, kBK), load, compute);

  float* out = cb + static_cast<int64_t>(bcg) * Q * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_acc(out, Q, t0 + wm + 16 * i + gq, s0 + wn + 8 * j + 2 * tq,
                acc[i][j], Q, Q);
}

// ---------------------------------------------------------------------------
// pass 2: cum, e^{cum_last} and S_loc per (row, chunk, head)
// ---------------------------------------------------------------------------
// Inclusive cumulative sum of dt_s * a over the chunk's Q tokens (dt at
// stride H): warp scans by shuffles, the warps' totals added after one
// barrier, a carry from each kThreads-token segment to the next.  Leaves
// dts[s] = dt_s and cum[s].
template <int kThreads>
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             int H, float a, int Q,
                                             float* dts, float* cum,
                                             float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kThreads) {
    const int s = base + threadIdx.x;
    const float d = s < Q ? dt[static_cast<int64_t>(s) * H] : 0.f;
    float v = __fmul_rn(d, a);  // log a_s, rounded before the sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre += wsum[w];
    if (s < Q) {
      dts[s] = d;
      cum[s] = pre + v;
    }
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) carry += wsum[w];
    __syncthreads();  // before the next segment overwrites wsum
  }
}

__global__ void __launch_bounds__(kT2, 2) ssd_state_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ S, float* __restrict__ cum_out,
    float* __restrict__ decay_out, int H, int P, int N, int G, int Q) {
  pdl_trigger();
  extern __shared__ __align__(16) float smem[];
  const int Qp = round_up(Q, kBK);
  float* w = smem + kStages * kRing2;  // dt_s, then e^{cum_last - cum_s} dt_s
  float* cum = w + Qp;
  float* wsum = cum + Qp;
  const int bch = blockIdx.x, h = bch % H, g = h / (H / G);
  const int64_t tok0 = static_cast<int64_t>(bch / H) * Q;
  const int n_tiles = ceil_div(N, kN2);
  const int p0 = (blockIdx.y / n_tiles) * kP2;
  const int n0 = (blockIdx.y % n_tiles) * kN2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 8 * kNJ2;

  chunk_cumsum<kT2>(dt + tok0 * H + h, H, A[h], Q, w, cum, wsum);
  const float last = cum[Q - 1];
  const bool first = blockIdx.y == 0;  // one tile writes cum and the decay
  for (int s = threadIdx.x; s < Qp; s += kT2) {
    if (first && s < Q) cum_out[static_cast<int64_t>(bch) * Q + s] = cum[s];
    w[s] = s < Q ? expf(fminf(last - cum[s], 0.f)) * w[s] : 0.f;
  }
  if (first && threadIdx.x == 0) decay_out[bch] = expf(last);
  // (the pipeline's first barrier publishes w)

  float acc[2][kNJ2][4] = {};
  auto load = [&](int step, int slot) {
    float* Xs = smem + slot * kRing2;
    float* Bs = Xs + kBK * kSX2;
    const int k0 = step * kBK;
#pragma unroll
    for (int j = 0; j < kBK * (kP2 / 4) / kT2; ++j) {
      const int i = threadIdx.x + j * kT2;
      const int r = i / (kP2 / 4), pq = 4 * (i % (kP2 / 4));
      const int s = k0 + r, p = p0 + pq;
      const bool ok = s < Q && p < P;
      cp_async16(Xs + r * kSX2 + pq,
                 ok ? x + ((tok0 + s) * H + h) * P + p : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kBK * (kN2 / 4) / kT2; ++j) {
      const int i = threadIdx.x + j * kT2;
      const int r = i / (kN2 / 4), nq = 4 * (i % (kN2 / 4));
      const int s = k0 + r, n = n0 + nq;
      const bool ok = s < Q && n < N;
      cp_async16(Bs + r * kSB2 + nq,
                 ok ? Bm + ((tok0 + s) * G + g) * N + n : Bm, ok);
    }
  };
  auto compute = [&](int step, int slot) {
    const float* Xs = smem + slot * kRing2;
    const float* Bs = Xs + kBK * kSX2;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int s = step * kBK + kk;
      const float w0 = w[s + tq], w1 = w[s + tq + 4];
      FragA a[2];
      FragB b[kNJ2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A[p, s] = x[s, p] w_s, rows k of Xs
        const float* X = Xs + kk * kSX2 + wm + 16 * i;
        split_tf32(X[tq * kSX2 + gq] * w0, a[i].hi[0], a[i].lo[0]);
        split_tf32(X[tq * kSX2 + gq + 8] * w0, a[i].hi[1], a[i].lo[1]);
        split_tf32(X[(tq + 4) * kSX2 + gq] * w1, a[i].hi[2], a[i].lo[2]);
        split_tf32(X[(tq + 4) * kSX2 + gq + 8] * w1, a[i].hi[3], a[i].lo[3]);
      }
#pragma unroll
      for (int j = 0; j < kNJ2; ++j)
        frag_b_kn(b[j], Bs + kk * kSB2 + wn + 8 * j, kSB2, gq, tq);
      mma3(acc, a, b);
    }
  };
  pipeline(ceil_div(Q, kBK), load, compute);

  float* out = S + static_cast<int64_t>(bch) * P * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNJ2; ++j)
      store_acc(out, N, p0 + wm + 16 * i + gq, n0 + wn + 8 * j + 2 * tq,
                acc[i][j], P, N);
  pdl_wait();  // pass 1 done before this grid is: pass 3's wait covers both
}

// ---------------------------------------------------------------------------
// pass 3: the states entering each chunk, per (row, head)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kT3) ssd_pass_kernel(
    float* __restrict__ S, const float* __restrict__ decay,
    float* __restrict__ state_out, int nc, int H, int PN) {
  pdl_trigger();
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int e = (blockIdx.y * kT3 + threadIdx.x) * 4;
  pdl_wait();  // S_loc and the decays of pass 2
  if (e >= PN) return;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + i) * H + h;
        loc[i] = __ldcg(reinterpret_cast<const float4*>(S + bch * PN + e));
        dec[i] = __ldcg(decay + bch);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + i) * H + h;
        if (c0 + i > 0)  // S_in[c] over S_loc[c]; chunk 0 enters with zero
          *reinterpret_cast<float4*>(S + bch * PN + e) = st;
        st.x = st.x * dec[i] + loc[i].x;
        st.y = st.y * dec[i] + loc[i].y;
        st.z = st.z * dec[i] + loc[i].z;
        st.w = st.w * dec[i] + loc[i].w;
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + static_cast<int64_t>(bh) * PN + e) =
      st;
}

// ---------------------------------------------------------------------------
// pass 4: y per (row, chunk, head) and 128-token tile
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kT4, 2) ssd_output_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Cm, const float* __restrict__ cb,
    const float* __restrict__ cum_in, const float* __restrict__ S,
    float* __restrict__ y, int nc, int H, int P, int N, int G, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int Qp = round_up(Q, kM4);
  float* cum = smem + kStages * kRing4;
  float* dts = cum + Qp;
  const int bch = blockIdx.x, h = bch % H, bc = bch / H, c = bc % nc;
  const int g = h / (H / G);
  const int64_t tok0 = static_cast<int64_t>(bc) * Q;
  const int64_t bcg = static_cast<int64_t>(bc) * G + g;
  const int p_tiles = ceil_div(P, kP4);
  const int R0 = (blockIdx.y / p_tiles) * kM4;
  const int p0 = (blockIdx.y % p_tiles) * kP4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wq = warp & 3;                         // rows: tiles wq, 7 - wq
  const int mt[2] = {16 * wq, 16 * (7 - wq)};
  const int wn = (warp >> 2) * 8 * kNJ4;           // columns wn ..

  pdl_wait();  // CB (pass 1), cum (pass 2) and S_in (pass 3)
  for (int s = threadIdx.x; s < Qp; s += kT4) {
    cum[s] = s < Q ? cum_in[static_cast<int64_t>(bch) * Q + s] : 0.f;
    dts[s] = s < Q ? dt[(tok0 + s) * H + h] : 0.f;
  }
  // (the pipeline's first barrier publishes cum and dts)
  const int n_inter = c > 0 ? ceil_div(N, kBK) : 0;  // zero state at c = 0
  const int rows_end = min(Q, R0 + kM4);
  const int n_steps = n_inter + ceil_div(rows_end, kBK);
  float acc[2][kNJ4][4] = {};

  auto load = [&](int step, int slot) {
    float* As = smem + slot * kRing4;
    float* Bs = As + kM4 * kSK;
    const bool inter = step < n_inter;
    const int k0 = (inter ? step : step - n_inter) * kBK;
#pragma unroll
    for (int j = 0; j < kM4 * (kBK / 4) / kT4; ++j) {  // C or CB rows t
      const int i = threadIdx.x + j * kT4;
      const int r = i / (kBK / 4), kq = 4 * (i % (kBK / 4));
      const int t = R0 + r, k = k0 + kq;
      const bool ok = t < Q && k < (inter ? N : Q);
      const float* src = inter ? Cm + ((tok0 + t) * G + g) * N + k
                               : cb + (bcg * Q + t) * Q + k;
      cp_async16(As + r * kSK + kq, ok ? src : cb, ok);
    }
    if (inter) {  // S_in rows p, k = n
#pragma unroll
      for (int j = 0; j < kP4 * (kBK / 4) / kT4; ++j) {
        const int i = threadIdx.x + j * kT4;
        const int r = i / (kBK / 4), kq = 4 * (i % (kBK / 4));
        const int p = p0 + r, n = k0 + kq;
        const bool ok = p < P && n < N;
        cp_async16(Bs + r * kSK + kq,
                   ok ? S + (static_cast<int64_t>(bch) * P + p) * N + n : S,
                   ok);
      }
    } else {  // x rows s
#pragma unroll
      for (int j = 0; j < kBK * (kP4 / 4) / kT4; ++j) {
        const int i = threadIdx.x + j * kT4;
        const int r = i / (kP4 / 4), pq = 4 * (i % (kP4 / 4));
        const int s = k0 + r, p = p0 + pq;
        const bool ok = s < Q && p < P;
        cp_async16(Bs + r * kSX4 + pq,
                   ok ? x + ((tok0 + s) * H + h) * P + p : x, ok);
      }
    }
  };
  auto compute = [&](int step, int slot) {
    const float* As = smem + slot * kRing4;
    const float* Bs = As + kM4 * kSK;
    if (step < n_inter) {  // acc += C_t . S_in[p]
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        FragA a[2];
        FragB b[kNJ4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          frag_a_mk(a[i], As + mt[i] * kSK + kk, kSK, gq, tq);
#pragma unroll
        for (int j = 0; j < kNJ4; ++j)
          frag_b_nk(b[j], Bs + (wn + 8 * j) * kSK + kk, kSK, gq, tq);
        mma3(acc, a, b);
      }
      if (step == n_inter - 1) {  // row t of C . S_in times e^{cum_t} <= 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = R0 + mt[i] + gq;
          const float e0 = expf(cum[t]), e1 = expf(cum[t + 8]);
#pragma unroll
          for (int j = 0; j < kNJ4; ++j) {
            acc[i][j][0] *= e0;
            acc[i][j][1] *= e0;
            acc[i][j][2] *= e1;
            acc[i][j][3] *= e1;
          }
        }
      }
      return;
    }
    const int k0 = (step - n_inter) * kBK;  // acc += M x over keys k0..
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int s = k0 + kk;
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) live[i] = s <= R0 + mt[i] + 15;
      if (!live[0] && !live[1]) continue;  // above the diagonal (per warp)
      FragB b[kNJ4];
#pragma unroll
      for (int j = 0; j < kNJ4; ++j)
        frag_b_kn(b[j], Bs + kk * kSX4 + wn + 8 * j, kSX4, gq, tq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live[i]) continue;
        const int r = mt[i] + gq, t = R0 + r;
        const float* Ar = As + r * kSK + kk;
        FragA a;
        split_tf32(masked_weight(Ar[tq], cum, dts, t, s + tq), a.hi[0],
                   a.lo[0]);
        split_tf32(masked_weight(Ar[8 * kSK + tq], cum, dts, t + 8, s + tq),
                   a.hi[1], a.lo[1]);
        split_tf32(masked_weight(Ar[tq + 4], cum, dts, t, s + tq + 4),
                   a.hi[2], a.lo[2]);
        split_tf32(
            masked_weight(Ar[8 * kSK + tq + 4], cum, dts, t + 8, s + tq + 4),
            a.hi[3], a.lo[3]);
        mma3_row(acc[i], a, b);
      }
    }
  };
  pipeline(n_steps, load, compute);

  float* out = y + (tok0 * H + h) * P;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNJ4; ++j)
      store_acc(out, static_cast<int64_t>(H) * P, R0 + mt[i] + gq,
                p0 + wn + 8 * j + 2 * tq, acc[i][j], Q, P);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Lets `kernel` take `need` bytes of dynamic shared memory (above 48 KB
// that needs an opt-in); *most remembers the largest granted.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t need, size_t* most) {
  if (need <= 48 * 1024 || need <= *most) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(need));
  if (e == cudaSuccess) *most = need;
  return e;
}

// Launches `kernel` as the programmatic dependent of the kernel launched
// last on `stream`: it may start while that one runs, and waits for it in
// griddepcontrol.wait.
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// Dynamic shared memory of pass 1, 2 or 4 at chunk Q, for the wrapper's
// plan to be checked against.
extern "C" long long ssd_scan_smem_bytes(int pass, int Q) {
  return static_cast<long long>(smem_bytes(pass, Q));
}

// x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,G,N): float32, contiguous,
// x, Bm and Cm 16-byte aligned; y (B,T,H,P) and state_out (B,H,P,N)
// float32.  Scratch from the caller, float32: cb (B,nc,G,Q,Q), S
// (B,nc,H,P,N), cum (B,nc,H,Q), decay (B,nc,H), nc = T / Q.  T % Q == 0,
// H % G == 0, Q, P and N multiples of 4.  Launches the four passes on
// `stream` and returns the first launch error, or cudaErrorInvalidValue
// for a shape the kernels do not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state_out, void* cb, void* S, void* cum,
                               void* decay, int B, int T, int H, int P, int N,
                               int G, int Q, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Q < 4 || T % Q || G < 1 || H % G || Q % 4 || P % 4 || N % 4 || T == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = T / Q, nt = ceil_div(Q, kCB);
  const dim3 g1(B * nc * G, nt * (nt + 1) / 2);
  const dim3 g2(B * nc * H, ceil_div(P, kP2) * ceil_div(N, kN2));
  const dim3 g3(B * H, ceil_div(P * N, 4 * kT3));
  const dim3 g4(B * nc * H, ceil_div(Q, kM4) * ceil_div(P, kP4));
  const size_t s1 = smem_bytes(1, Q), s2 = smem_bytes(2, Q),
               s4 = smem_bytes(4, Q);
  if (s2 > kMaxSmem || s4 > kMaxSmem ||
      static_cast<int>(g1.y) > kMaxGridY ||
      static_cast<int>(g2.y) > kMaxGridY ||
      static_cast<int>(g3.y) > kMaxGridY ||
      static_cast<int>(g4.y) > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t most1 = 0, most2 = 0, most4 = 0;
  cudaError_t err;
  if ((err = allow_smem(ssd_cb_kernel, s1, &most1)) != cudaSuccess ||
      (err = allow_smem(ssd_state_kernel, s2, &most2)) != cudaSuccess ||
      (err = allow_smem(ssd_output_kernel, s4, &most4)) != cudaSuccess)
    return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto dtf = static_cast<const float*>(dt);
  const auto Bf = static_cast<const float*>(Bm);
  const auto Cf = static_cast<const float*>(Cm);
  const auto cbf = static_cast<float*>(cb);
  const auto Sf = static_cast<float*>(S);
  const auto cumf = static_cast<float*>(cum);
  const auto decf = static_cast<float*>(decay);

  ssd_cb_kernel<<<g1, kT1, s1, st>>>(Bf, Cf, cbf, N, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_dependent(ssd_state_kernel, g2, kT2, s2, st, xf, dtf,
                              static_cast<const float*>(A), Bf, Sf, cumf,
                              decf, H, P, N, G, Q)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_dependent(ssd_pass_kernel, g3, kT3, 0, st, Sf,
                              static_cast<const float*>(decf),
                              static_cast<float*>(state_out), nc, H,
                              P * N)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_dependent(ssd_output_kernel, g4, kT4, s4, st, xf, dtf, Cf,
                              static_cast<const float*>(cbf),
                              static_cast<const float*>(cumf),
                              static_cast<const float*>(Sf),
                              static_cast<float*>(y), nc, H, P, N, G, Q)) !=
      cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
