// A decode slice's loop on the device: the WHILE conditional node of a CUDA
// graph and the one-block kernel that sets its condition (sm_90a).
//
// Replaces no Pallas kernel.  It is the counterpart of the JAX engines'
// lax.while_loop over a slice's decode steps (repro/engine/
// static_engine.py: _serve_fn and the paged decode, whose cond is
// (step < slice_len) & ~all(done)), which XLA runs inside one executable
// so that the host waits once per slice.  What it computes is
// repro_torch/kernels/ref.py:graph_loop_ref: step < limit and not
// all(done), for the 0-d int64 step counter and the (B,) bool done flags
// of a bucket's static buffers.
//
// Bound: latency.  One block reads 8 + B bytes; the bytes bound is
// nanoseconds, and what the loop pays per step is the node's launch inside
// the graph, not the read.
//
// Design: cond_kernel reads the step and the flags (one __syncthreads_or
// over the block: some row live) and sets the WHILE node's handle with
// cudaGraphSetConditional.  graph_loop_build rewrites a captured step
// graph in place (the raw graph of a torch.cuda.CUDAGraph captured with
// keep_graph=True) into
//
//   [head] -> cond_kernel -> WHILE { child(step graph) -> cond_kernel }
//
// The condition is evaluated by a node ahead of the WHILE node, so the
// first body runs only if the loop's condition holds, as the while_loop's
// cond is evaluated before its first body; the handle's default is never
// read.  `head` (may be null) is a graph run once before the loop, as a
// child node: the dense engine's captured prefill.  The step's nodes move
// into the body as one child-graph node (a clone), which keeps the
// capture's own edges, programmatic ones included.  graph_loop_eval
// launches the same predicate as a plain kernel that writes it out, so
// that the predicate can be held against the plain version alone.
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

constexpr int kThreads = 256;

// Whether the loop goes on: some row not done and *step < limit.  Every
// thread of the block calls it (the flags are read across the block).
__device__ __forceinline__ bool loop_goes_on(const long long* step,
                                             const unsigned char* done,
                                             int B, long long limit) {
  int live = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) live |= done[i] == 0;
  live = __syncthreads_or(live);
  return live != 0 && *step < limit;
}

__global__ void __launch_bounds__(kThreads)
    cond_kernel(cudaGraphConditionalHandle handle, const long long* step,
                const unsigned char* done, int B, long long limit) {
  const bool go = loop_goes_on(step, done, B, limit);
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads)
    eval_kernel(const long long* step, const unsigned char* done, int B,
                long long limit, int* out) {
  const bool go = loop_goes_on(step, done, B, limit);
  if (threadIdx.x == 0) *out = go ? 1 : 0;
}

// Adds a cond_kernel node to `graph` after `deps`.
cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphConditionalHandle handle, const long long* step,
                     const unsigned char* done, int B, long long limit) {
  void* args[] = {&handle, &step, &done, &B, &limit};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

}  // namespace

#define GRAPH_LOOP_CHECK(call)                   \
  do {                                           \
    const cudaError_t e_ = (call);               \
    if (e_ != cudaSuccess) {                     \
      if (body_src) cudaGraphDestroy(body_src);  \
      return static_cast<int>(e_);               \
    }                                            \
  } while (0)

// graph: a cudaGraph_t holding one captured loop body (the step); head: a
// cudaGraph_t to run once before the loop, or null; step: the body's 0-d
// int64 step counter and done: its (B,) bool flags, both device memory
// that the body advances; limit: the slice length.  Rewrites `graph` in
// place into [head] -> cond -> WHILE { step -> cond } (head and the step
// are cloned into child-graph nodes; the caller keeps its own graphs) and
// returns 0, or the first CUDA error.  The caller instantiates `graph`
// afterwards.  B >= 1.
extern "C" int graph_loop_build(void* graph, void* head, const void* step,
                                const void* done, int B, long long limit) {
  if (B < 1 || graph == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraph_t body_src = nullptr;
  const auto st = static_cast<const long long*>(step);
  const auto dn = static_cast<const unsigned char*>(done);
  GRAPH_LOOP_CHECK(cudaGraphClone(&body_src, g));
  size_t n = 0;
  GRAPH_LOOP_CHECK(cudaGraphGetNodes(g, nullptr, &n));
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) GRAPH_LOOP_CHECK(cudaGraphGetNodes(g, nodes.data(), &n));
  for (cudaGraphNode_t node : nodes) GRAPH_LOOP_CHECK(cudaGraphDestroyNode(node));

  cudaGraphConditionalHandle handle;
  GRAPH_LOOP_CHECK(cudaGraphConditionalHandleCreate(&handle, g, 0, 0));
  cudaGraphNode_t before = nullptr;
  if (head != nullptr)
    GRAPH_LOOP_CHECK(cudaGraphAddChildGraphNode(
        &before, g, nullptr, 0, static_cast<cudaGraph_t>(head)));
  cudaGraphNode_t first;
  GRAPH_LOOP_CHECK(add_cond(&first, g, before ? &before : nullptr,
                            before ? 1 : 0, handle, st, dn, B, limit));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  GRAPH_LOOP_CHECK(cudaGraphAddNode(&loop, g, &first, 1, &cp));
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t child, again;
  GRAPH_LOOP_CHECK(cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                              body_src));
  GRAPH_LOOP_CHECK(add_cond(&again, body, &child, 1, handle, st, dn, B,
                            limit));
  cudaGraphDestroy(body_src);
  return 0;
}

// step: 0-d int64, done: (B,) bool, out: one int32, all device memory.
// Writes step < limit and not all(done) to *out (1 or 0) on `stream` and
// returns cudaGetLastError().  B >= 1.
extern "C" int graph_loop_eval(const void* step, const void* done, int B,
                               long long limit, void* out, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  eval_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(step),
      static_cast<const unsigned char*>(done), B, limit,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
