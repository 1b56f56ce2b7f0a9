// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :89) and computes its function, which is what
// repro_torch/kernels/ref.py:ssd_scan_ref computes: for row b and head h,
// over chunks of Q tokens, with cum the inclusive in-chunk cumulative sum
// of dt * A (A < 0, so cum falls),
//   y[t]      = sum_{s<=t} (C_t . B_s) e^{cum_t - cum_s} dt_s x_s
//             + e^{cum_t} C_t . state_in
//   state_out = e^{cum_last} state_in + sum_s e^{cum_last - cum_s} dt_s x_s (x) B_s
// B and C are read per group, head h taking group h / (H / G), as
// jnp.repeat broadcasts them.  The state starts at zero; y and the final
// state are returned.  Everything is float32 and every product runs on the
// CUDA cores: TF32 would change the numbers that the recurrence compounds
// from chunk to chunk.
//
// The decay e^{cum_t - cum_s} is computed only for s <= t, where its
// exponent is <= 0.  The JAX oracle exponentiates the upper triangle too
// and masks by multiplying, which gives inf * 0 = NaN once a chunk's
// sum of dt * |A| passes ln(float32 max) ~ 88.7 (ROADMAP C2); here that
// cannot happen by construction, as in the Pallas kernel's jnp.where.
//
// Bound: operations.  At mamba2-130m's prefill shapes (8 rows of 512
// tokens, 24 heads of P 64, N 128, Q 128) the work is ~1.85 G
// multiply-adds (C . state is skipped in each row's first chunk, whose
// entering state is zero) against ~61 MB of inputs and outputs: ~55 us on
// the float32 CUDA cores against ~18 us of memory traffic.
//
// Design: one thread block per (row, head) walks the row's chunks in
// order and carries the (P, N) float32 state in shared memory; that loop
// takes the place of the Pallas grid's sequential chunk axis.  Per chunk
// the block stages x (Q, P), B and C (Q, N) and dt in shared memory, takes
// the cumulative sum in one thread (Q dependent adds), then
//   1. builds the masked score tile S[t, s] = (C_t . B_s) e^{cum_t - cum_s}
//      dt_s for a tile of R = 32 query rows and the keys s < t0 + R: x, B,
//      C, the state and this tile take 216 KB of the 232 KB a block may
//      have, where a whole Q x Q tile (64 KB) would not fit;
//   2. writes those rows of y = S x + e^{cum_t} C state^T;
//   3. after the last row tile, updates the state in place, each thread
//      owning its entries.
// Each product gives every thread a micro-tile of outputs whose rows and
// columns are strided by the tile count, so the lanes of a warp read
// neighbouring rows of B, C or the state; those rows are padded by one
// float, which puts them in different banks.
//
// What bounds this kernel, and what a later PR would do: C . B is computed
// once per head, although all heads of a group share it (at G = 1 one
// (row, chunk) tile would serve all 24 heads); the chunks of a row run in
// sequence, where a first chunk-parallel pass could compute every chunk's
// local state and output at once, leaving only the short recurrence
// serial; the products could use 3xTF32 or mma.sync on the tensor cores at
// float32 accuracy; and at one row the 24 blocks fill a fifth of the 132
// SMs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 32;           // query rows per score tile
constexpr size_t kMaxSmem = 232448;    // bytes a block may have on Hopper

// Shared-memory layout, offsets in floats.
struct Layout {
  int R;          // query rows per score tile
  int bc_stride;  // row stride of B, C (N + 1)
  int st_stride;  // row stride of the state (N + 1)
  int ss_stride;  // row stride of the score tile (Q + 1)
  size_t xs, bs, cs, st, ss, cum, dts, w, ecum, total;
};

__host__ __device__ inline Layout make_layout(int Q, int P, int N) {
  Layout L;
  L.R = Q < kRowTile ? Q : kRowTile;
  while (Q % L.R) L.R -= 4;  // a multiple of 4 that divides Q
  L.bc_stride = N + 1;
  L.st_stride = N + 1;
  L.ss_stride = Q + 1;
  size_t o = 0;
  L.xs = o;   o += (size_t)Q * P;             // x chunk (Q, P)
  L.bs = o;   o += (size_t)Q * L.bc_stride;   // B chunk (Q, N)
  L.cs = o;   o += (size_t)Q * L.bc_stride;   // C chunk (Q, N)
  L.st = o;   o += (size_t)P * L.st_stride;   // state (P, N)
  L.ss = o;   o += (size_t)L.R * L.ss_stride; // score tile (R, Q)
  L.cum = o;  o += Q;                         // inclusive cumsum of dt * A
  L.dts = o;  o += Q;                         // dt
  L.w = o;    o += Q;                         // e^{cum_last - cum_s} dt_s
  L.ecum = o; o += Q;                         // e^{cum_t}
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ state_out, int T, int H, int P, int N, int G,
    int Q) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const Layout L = make_layout(Q, P, N);
  extern __shared__ float smem[];
  float* xs = smem + L.xs;
  float* bs = smem + L.bs;
  float* cs = smem + L.cs;
  float* st = smem + L.st;
  float* ss = smem + L.ss;
  float* cum = smem + L.cum;
  float* dts = smem + L.dts;
  float* w = smem + L.w;
  float* ecum = smem + L.ecum;
  const int R = L.R, bcs = L.bc_stride, sts = L.st_stride,
            sss = L.ss_stride;
  const float a = A[h];

  for (int i = tid; i < P * N; i += kThreads)
    st[(i / N) * sts + i % N] = 0.f;

  const int nc = T / Q;
  for (int c = 0; c < nc; ++c) {
    const int64_t tok0 = (int64_t)b * T + (int64_t)c * Q;  // (b, c*Q)
    for (int i = tid; i < Q * P; i += kThreads) {
      const int s = i / P, p = i % P;
      xs[i] = x[((tok0 + s) * H + h) * P + p];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int s = i / N, n = i % N;
      const int64_t src = ((tok0 + s) * G + g) * N + n;
      bs[s * bcs + n] = Bm[src];
      cs[s * bcs + n] = Cm[src];
    }
    for (int s = tid; s < Q; s += kThreads) dts[s] = dt[(tok0 + s) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < Q; ++s) {
        run = run + __fmul_rn(dts[s], a);  // log a_s, then the sum
        cum[s] = run;
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int s = tid; s < Q; s += kThreads) {
      w[s] = expf(last - cum[s]) * dts[s];
      ecum[s] = expf(cum[s]);
    }
    __syncthreads();

    for (int t0 = 0; t0 < Q; t0 += R) {
      const int S = t0 + R;  // keys s < S reach the tile's rows
      // 1. score tile: 4 x 4 outputs per thread, rows t0 + ti + i*Mt,
      //    keys tj + j*Nt
      {
        const int Mt = R / 4, Nt = S / 4;
        for (int tile = tid; tile < Mt * Nt; tile += kThreads) {
          const int ti = tile / Nt, tj = tile % Nt;
          float acc[4][4] = {};
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = cs[(t0 + ti + i * Mt) * bcs + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bs[(tj + j * Nt) * bcs + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ti + i * Mt, t = t0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int s = tj + j * Nt;
              ss[r * sss + s] =
                  s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
            }
          }
        }
      }
      __syncthreads();
      // 2. y rows t0 .. t0+R-1: 2 x 4 outputs per thread, rows ti + i*Mt,
      //    columns tj + j*Nt
      {
        const int Mt = R / 2, Nt = P / 4;
        for (int tile = tid; tile < Mt * Nt; tile += kThreads) {
          const int ti = tile / Nt, tj = tile % Nt;
          float intra[2][4] = {}, inter[2][4] = {};
          for (int s = 0; s < S; ++s) {
            float sv[2], xv[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) sv[i] = ss[(ti + i * Mt) * sss + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = xs[s * P + tj + j * Nt];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                intra[i][j] = fmaf(sv[i], xv[j], intra[i][j]);
          }
          if (c > 0) {  // the state entering chunk 0 is zero
            for (int n = 0; n < N; ++n) {
              float cv[2], sv[4];
#pragma unroll
              for (int i = 0; i < 2; ++i)
                cv[i] = cs[(t0 + ti + i * Mt) * bcs + n];
#pragma unroll
              for (int j = 0; j < 4; ++j) sv[j] = st[(tj + j * Nt) * sts + n];
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = t0 + ti + i * Mt;
            float* y_row = y + ((tok0 + t) * H + h) * P;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              y_row[tj + j * Nt] = intra[i][j] + inter[i][j] * ecum[t];
          }
        }
      }
      __syncthreads();
    }

    // 3. state update, 4 x 4 entries per thread (rows p, columns n), in
    //    place: each thread reads and writes only its own entries
    {
      const int Mt = P / 4, Nt = N / 4;
      const float decay = ecum[Q - 1];
      for (int tile = tid; tile < Mt * Nt; tile += kThreads) {
        const int ti = tile / Nt, tj = tile % Nt;
        float acc[4][4] = {};
        for (int s = 0; s < Q; ++s) {
          const float ws = w[s];
          float xv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xs[s * P + ti + i * Mt] * ws;
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[s * bcs + tj + j * Nt];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* e = st + (ti + i * Mt) * sts + tj + j * Nt;
            *e = *e * decay + acc[i][j];
          }
      }
    }
    __syncthreads();  // before the next chunk overwrites x, B, C
  }

  float* out = state_out + ((int64_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    out[i] = st[(i / N) * sts + i % N];
}

}  // namespace

// x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,G,N): float32, contiguous;
// y (B,T,H,P) and state_out (B,H,P,N) float32.  T % Q == 0, H % G == 0,
// Q, P and N multiples of 4, the layout within kMaxSmem.  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state_out, int B, int T, int H, int P,
                               int N, int G, int Q, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Q < 4 || T % Q || G < 1 || H % G || Q % 4 || P % 4 || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = make_layout(Q, P, N).total * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state_out), T, H, P, N, G, Q);
  return static_cast<int>(cudaGetLastError());
}
