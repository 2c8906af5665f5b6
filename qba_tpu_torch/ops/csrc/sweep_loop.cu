// The device-resident stop loop of a precision-targeted sweep: one CUDA
// graph whose WHILE node runs one captured chunk a pass.
//
// Counterpart of the condition and the per-chunk reduce of the JAX
// package's `lax.while_loop` (qba_tpu/sweep.py::_device_while, with
// qba_tpu/rounds/engine.py::run_chunk_counts); not a pallas_call site.
//
// `sweep_stop` ends each chunk.  One block sums the chunk's success bits
// and ORs its overflow flags, stores both in the carry at the chunk's
// index, advances the chunk index and the running success count, and
// evaluates the stop tables (qba_tpu_torch/stats/device.py) at the new
// totals: the loop goes on while
//     i < n_chunks && !(k_total <= lo[i] || k_total >= hi[i]).
// It stores that flag in the carry and, inside the graph, sets the WHILE
// node's handle to it (cudaGraphSetConditional).  Bound: it reads
// 2 x chunk_trials bytes and a few words, a microsecond of HBM time far
// under one launch's latency, so it is one block and no more.
//
// The carry, int32: [0] the chunk index i, [1] k_total, [2] the flag,
// [3, 3 + n) each chunk's successes, [3 + n, 3 + 2n) its overflow flag.
//
// The graph: the host creates the parent graph and its conditional handle
// first (the chunk's `sweep_stop` is captured with the handle as an
// argument), then adds the WHILE node, puts the captured chunk in its body
// as a child graph, and instantiates the parent; one launch runs the loop.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) sweep_stop_kernel(
    const uint8_t* __restrict__ success, const uint8_t* __restrict__ overflow,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int32_t* __restrict__ carry, int n_trials, int n_chunks,
    cudaGraphConditionalHandle handle) {
  int k = 0, o = 0;
  for (int t = threadIdx.x; t < n_trials; t += kThreads) {
    k += success[t] != 0;
    o |= overflow[t] != 0;
  }
  for (int s = 16; s > 0; s >>= 1) {
    k += __shfl_xor_sync(0xffffffffu, k, s);
    o |= __shfl_xor_sync(0xffffffffu, o, s);
  }
  __shared__ int ks[kWarps], os[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ks[warp] = k;
    os[warp] = o;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    ks[0] += ks[w];
    os[0] |= os[w];
  }
  const int i = carry[0];
  unsigned int go = 0;
  if (i >= 0 && i < n_chunks) {
    const int k_total = carry[1] + ks[0];
    carry[3 + i] = ks[0];
    carry[3 + n_chunks + i] = os[0];
    carry[0] = i + 1;
    carry[1] = k_total;
    go = i + 1 < n_chunks &&
         !(k_total <= lo[i + 1] || k_total >= hi[i + 1]);
  }
  carry[2] = int(go);
  if (handle != 0) cudaGraphSetConditional(handle, go);
}

}  // namespace

// Each entry returns a cudaError_t: 0 on success.

// The runtime's name for error `e`.
extern "C" const char* qba_sweep_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// One chunk's stop step on `stream`; `handle` 0 sets no graph handle
// (a launch outside the loop's graph).
extern "C" int qba_sweep_stop(const void* success, const void* overflow,
                              const void* lo, const void* hi, void* carry,
                              int n_trials, int n_chunks,
                              unsigned long long handle, void* stream) {
  if (n_trials < 0 || n_chunks < 1) return int(cudaErrorInvalidValue);
  sweep_stop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(success),
      static_cast<const uint8_t*>(overflow),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<int32_t*>(carry), n_trials, n_chunks,
      static_cast<cudaGraphConditionalHandle>(handle));
  return int(cudaGetLastError());
}

// The parent graph and its WHILE handle; every launch of the graph resets
// the handle to `go0` (the loop's condition on the carry it starts from).
extern "C" int qba_sweep_graph_create(unsigned int go0, void** graph,
                                      unsigned long long* handle) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return int(e);
  cudaGraphConditionalHandle h = 0;
  e = cudaGraphConditionalHandleCreate(&h, g, go0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return int(e);
  }
  *graph = g;
  *handle = static_cast<unsigned long long>(h);
  return 0;
}

// Adds the WHILE node on `handle` to `graph`, a copy of `chunk` (the
// captured chunk) as its body, and instantiates the graph into `exec`.
extern "C" int qba_sweep_graph_instantiate(void* graph,
                                           unsigned long long handle,
                                           void* chunk, void** exec) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(&node, g, nullptr, nullptr, 0, &params);
#else
  cudaError_t e = cudaGraphAddNode(&node, g, nullptr, 0, &params);
#endif
  if (e != cudaSuccess) return int(e);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  cudaGraphNode_t child = nullptr;
  e = cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                 static_cast<cudaGraph_t>(chunk));
  if (e != cudaSuccess) return int(e);
  cudaGraphExec_t x = nullptr;
  e = cudaGraphInstantiate(&x, g, 0);
  if (e != cudaSuccess) return int(e);
  *exec = x;
  return 0;
}

// One launch of the instantiated loop on `stream`.
extern "C" int qba_sweep_graph_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

// Frees the instantiated loop (when not null) and the parent graph.
extern "C" int qba_sweep_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr)
    e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return int(e);
}

// The node types of `graph`, its child graphs' nodes included (the body
// of a WHILE node may hold kernel, memset, memcpy, empty, child-graph and
// conditional nodes only): counts[t] += nodes of cudaGraphNodeType t, for
// t < 16.  Returns the error of the first query that fails.
extern "C" int qba_sweep_graph_node_types(void* graph, int* counts) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return int(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(g, nodes, &n);
  for (size_t j = 0; e == cudaSuccess && j < n; ++j) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[j], &t);
    if (e != cudaSuccess) break;
    if (int(t) >= 0 && int(t) < 16) ++counts[int(t)];
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      e = cudaGraphChildGraphNodeGetGraph(nodes[j], &child);
      if (e == cudaSuccess)
        e = static_cast<cudaError_t>(
            qba_sweep_graph_node_types(child, counts));
    }
  }
  delete[] nodes;
  return int(e);
}
