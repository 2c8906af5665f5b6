// The device surface: the whole adaptive (strategy x noise x sizeL) grid
// of a precision-targeted run as one CUDA graph.
//
// Counterpart of the body of the JAX package's single-dispatch surface
// (qba_tpu/sweep.py::_device_surface_loop, the `lax.while_loop` whose
// body scores every open cell and `lax.switch`es into the chosen cell's
// chunk) and of the float32 interval it orders cells by
// (qba_tpu/stats/device.py::device_ci_interval); not a pallas_call site.
//
// One pass of the loop is three parts of a WHILE node's body:
//
//   surface_pick -> SWITCH (branch c: cell c's captured chunk) -> surface_fold
//
// `surface_pick` (one block; thread t takes cells t, t + blockDim.x, ...)
// computes each cell's mixture interval at its totals (k successes in
// i * chunk_trials trials) in float32 with two 60-step bisections outward
// from the MLE, scores it as the JAX loop does (1e9 where done, else
// 2 * tier + (bootstrap ? 0 : 1 - width), tier 0 bootstrap, 1 straddling
// the threshold, 2 undecided), takes the block's argmin (first index on
// ties, as jnp.argmin), stores the chosen cell, its chunk index and its
// tier, and sets the SWITCH node's handle to the chosen cell.  The branch
// copies its chunk's success and overflow flags into one slot that every
// branch shares.  `surface_fold` (one block) sums the slot, folds the
// chunk into the chosen cell's totals, decides the cell's stop from the
// exact integer stop tables (qba_tpu_torch/stats/device.py, so float32
// can reorder near-tied cells but never change a stop), stores the
// chunk's count, overflow flag and schedule entry, advances the step and
// sets the WHILE node's handle to step < steps && !all(done).
//
// Bound: pick does n_cells x (3 lgamma + 2 x 60 x (log + log1p)) float
// operations and reads 12 bytes a cell; fold reads the slot (2 bytes a
// trial) and a word a cell.  Both are far under one launch's latency at
// the grid sizes a surface has, so each is one block.  The file is built
// with -fmad=false: every float operation rounds on its own, as in the
// plain PyTorch version (ops/surface_loop.py).
//
// The carry, int32: [0] step, [1] steps, [2] chosen, [3] i_cur, [4] the
// loop's flag; then k[n_cells], i[n_cells], done[n_cells],
// counts[n_cells][budget], ovf[n_cells][budget], sched[steps],
// tier[steps].
//
// The graph: the host creates the parent graph, its WHILE handle and node,
// and the SWITCH handle in the WHILE body first (the captured pick and
// fold take the handles as arguments), then adds to the body the captured
// pick, the SWITCH node (one branch a cell, each a copy of that cell's
// captured chunk) and the captured fold, in a chain, and instantiates the
// parent, then uploads it.  One launch runs the whole surface.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 0, kSteps = 1, kChosen = 2, kICur = 3, kFlag = 4;
constexpr int kHead = 5;
constexpr int kIters = 60;
constexpr unsigned kFull = 0xffffffffu;

// The carry's sections after the head.
struct Carry {
  int32_t* k;
  int32_t* i;
  int32_t* done;
  int32_t* counts;
  int32_t* ovf;
  int32_t* sched;
  int32_t* tier;
  __device__ Carry(int32_t* c, int n_cells, int budget, int steps)
      : k(c + kHead),
        i(k + n_cells),
        done(i + n_cells),
        counts(done + n_cells),
        ovf(counts + n_cells * budget),
        sched(ovf + n_cells * budget),
        tier(sched + steps) {}
};

// The mixture's log-likelihood ratio at rate p (clipped as the JAX
// package clips it), for k successes in n trials.
struct Mixture {
  float k, n, lbeta_rel;
  __device__ float at(float p) const {
    const float p_min = static_cast<float>(1e-7);
    const float p_max = static_cast<float>(1.0 - 1e-7);
    p = fminf(fmaxf(p, p_min), p_max);
    return lbeta_rel - (k * logf(p) + (n - k) * log1pf(-p));
  }
};

__device__ float boundary(const Mixture& m, float crit, float lo, float hi,
                          bool rising_at_hi) {
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if ((m.at(mid) >= crit) == rising_at_hi)
      hi = mid;
    else
      lo = mid;
  }
  return 0.5f * (lo + hi);
}

// The float32 interval at totals (k, n); (0, 1) where n == 0 or the
// mixture is past `crit` at the MLE.
__device__ void interval(float k, float n, float crit, float lbeta0,
                         float* lo, float* hi) {
  const float lbeta = (lgammaf(k + 0.5f) + lgammaf((n - k) + 0.5f)) -
                      lgammaf((n + 0.5f) + 0.5f);
  const Mixture m{k, n, lbeta - lbeta0};
  const float p_hat = n > 0.0f ? k / fmaxf(n, 1.0f) : 0.5f;
  if (n == 0.0f || m.at(p_hat) >= crit) {
    *lo = 0.0f;
    *hi = 1.0f;
    return;
  }
  *lo = m.at(0.0f) < crit ? 0.0f : boundary(m, crit, 0.0f, p_hat, false);
  *hi = m.at(1.0f) < crit ? 1.0f : boundary(m, crit, p_hat, 1.0f, true);
}

// (score, cell, tier) of the better of two candidates: the lower score,
// the lower cell on a tie.
__device__ bool better(float s, int c, float s_best, int c_best) {
  return s < s_best || (s == s_best && c < c_best);
}

__global__ void __launch_bounds__(kThreads) surface_pick_kernel(
    int32_t* __restrict__ carry, float* __restrict__ ci, int n_cells,
    int budget, int chunk_trials, float crit, float lbeta0, float threshold,
    int has_threshold, cudaGraphConditionalHandle handle) {
  const int steps = carry[kSteps];
  const Carry c(carry, n_cells, budget, steps);
  float best = INFINITY;
  int best_cell = n_cells, best_tier = 0;
  for (int cell = threadIdx.x; cell < n_cells; cell += kThreads) {
    const int i = c.i[cell];
    float lo, hi;
    interval(static_cast<float>(c.k[cell]),
             static_cast<float>(i * chunk_trials), crit, lbeta0, &lo, &hi);
    ci[cell] = lo;
    ci[n_cells + cell] = hi;
    const bool boot = i == 0;
    const bool straddle =
        !has_threshold || (lo <= threshold && threshold <= hi);
    const int tier = boot ? 0 : (straddle ? 1 : 2);
    const float score =
        c.done[cell] ? 1e9f
                     : static_cast<float>(tier) * 2.0f +
                           (boot ? 0.0f : 1.0f - (hi - lo));
    if (score < best) {  // cells ascend: the first of equal scores stays
      best = score;
      best_cell = cell;
      best_tier = tier;
    }
  }
  for (int s = 16; s > 0; s >>= 1) {
    const float os = __shfl_xor_sync(kFull, best, s);
    const int oc = __shfl_xor_sync(kFull, best_cell, s);
    const int ot = __shfl_xor_sync(kFull, best_tier, s);
    if (better(os, oc, best, best_cell)) {
      best = os;
      best_cell = oc;
      best_tier = ot;
    }
  }
  __shared__ float scores[kWarps];
  __shared__ int cells[kWarps], tiers[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    scores[warp] = best;
    cells[warp] = best_cell;
    tiers[warp] = best_tier;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    if (better(scores[w], cells[w], best, best_cell)) {
      best = scores[w];
      best_cell = cells[w];
      best_tier = tiers[w];
    }
  }
  if (best_cell >= n_cells) return;  // no cell: nothing to choose
  const int step = carry[kStep];
  carry[kChosen] = best_cell;
  carry[kICur] = c.i[best_cell];
  if (step >= 0 && step < steps) c.tier[step] = best_tier;
  if (handle != 0) cudaGraphSetConditional(handle, best_cell);
}

__global__ void __launch_bounds__(kThreads) surface_fold_kernel(
    const uint8_t* __restrict__ success, const uint8_t* __restrict__ overflow,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int32_t* __restrict__ carry, int n_trials, int n_cells, int budget,
    cudaGraphConditionalHandle handle) {
  const int steps = carry[kSteps];
  const Carry c(carry, n_cells, budget, steps);
  const int chosen = carry[kChosen], i_cur = carry[kICur];
  const int step = carry[kStep];
  const bool valid = chosen >= 0 && chosen < n_cells && i_cur >= 0 &&
                     i_cur < budget && step >= 0 && step < steps;
  int k = 0, o = 0;
  for (int t = threadIdx.x; t < n_trials; t += kThreads) {
    k += success[t] != 0;
    o |= overflow[t] != 0;
  }
  for (int s = 16; s > 0; s >>= 1) {
    k += __shfl_xor_sync(kFull, k, s);
    o |= __shfl_xor_sync(kFull, o, s);
  }
  __shared__ int ks[kWarps], os[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ks[warp] = k;
    os[warp] = o;
  }
  __syncthreads();
  k = 0;
  o = 0;
  for (int w = 0; w < kWarps; ++w) {
    k += ks[w];
    o |= os[w];
  }
  // Every thread reads the chosen cell's totals before thread 0 stores
  // them (after the barrier of __syncthreads_or below).
  int k_new = 0;
  bool stopped = false;
  if (valid) {
    k_new = c.k[chosen] + k;
    stopped = k_new <= lo[i_cur + 1] || k_new >= hi[i_cur + 1];
  }
  int open = 0;
  for (int cell = threadIdx.x; cell < n_cells; cell += kThreads)
    open |= !(cell == chosen && valid ? stopped : c.done[cell] != 0);
  const int any_open = __syncthreads_or(open);
  if (threadIdx.x != 0) return;
  unsigned int go = 0;
  if (valid) {
    c.k[chosen] = k_new;
    c.i[chosen] = i_cur + 1;
    c.done[chosen] = stopped;
    c.counts[chosen * budget + i_cur] = k;
    c.ovf[chosen * budget + i_cur] = o;
    c.sched[step] = chosen;
    carry[kStep] = step + 1;
    go = step + 1 < steps && any_open;
  }
  carry[kFlag] = int(go);
  if (handle != 0) cudaGraphSetConditional(handle, go);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, g, deps, n_deps, params);
#endif
}

}  // namespace

// Each entry returns a cudaError_t: 0 on success.

// The runtime's name for error `e`.
extern "C" const char* qba_surface_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The driver's and the runtime's CUDA versions (1000 * major + 10 * minor).
extern "C" int qba_surface_versions(int* driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(driver);
  if (e != cudaSuccess) return int(e);
  return int(cudaRuntimeGetVersion(runtime));
}

// One pick step on `stream`; `handle` 0 sets no graph handle.  `ci` takes
// each cell's interval, lo at [cell], hi at [n_cells + cell].
extern "C" int qba_surface_pick(void* carry, void* ci, int n_cells,
                                int budget, int chunk_trials, float crit,
                                float lbeta0, float threshold,
                                int has_threshold, unsigned long long handle,
                                void* stream) {
  if (n_cells < 1 || budget < 1 || chunk_trials < 0)
    return int(cudaErrorInvalidValue);
  surface_pick_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(carry), static_cast<float*>(ci), n_cells, budget,
      chunk_trials, crit, lbeta0, threshold, has_threshold,
      static_cast<cudaGraphConditionalHandle>(handle));
  return int(cudaGetLastError());
}

// One fold step on `stream`; `handle` 0 sets no graph handle.
extern "C" int qba_surface_fold(const void* success, const void* overflow,
                                const void* lo, const void* hi, void* carry,
                                int n_trials, int n_cells, int budget,
                                unsigned long long handle, void* stream) {
  if (n_trials < 0 || n_cells < 1 || budget < 1)
    return int(cudaErrorInvalidValue);
  surface_fold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(success),
      static_cast<const uint8_t*>(overflow), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<int32_t*>(carry), n_trials,
      n_cells, budget, static_cast<cudaGraphConditionalHandle>(handle));
  return int(cudaGetLastError());
}

// The parent graph with its WHILE node (handle default `go0`, reset at
// every launch) and, in the WHILE body, the SWITCH handle.
extern "C" int qba_surface_graph_create(unsigned int go0, void** graph,
                                        unsigned long long* while_handle,
                                        void** body,
                                        unsigned long long* switch_handle) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return int(e);
  cudaGraphConditionalHandle wh = 0, sh = 0;
  e = cudaGraphConditionalHandleCreate(&wh, g, go0,
                                       cudaGraphCondAssignDefault);
  cudaGraphNodeParams params = {};
  cudaGraphNode_t node = nullptr;
  if (e == cudaSuccess) {
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = wh;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    e = add_node(&node, g, nullptr, 0, &params);
  }
  cudaGraph_t b = nullptr;
  if (e == cudaSuccess) {
    b = params.conditional.phGraph_out[0];
    e = cudaGraphConditionalHandleCreate(&sh, b, 0,
                                         cudaGraphCondAssignDefault);
  }
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    return int(e);
  }
  *graph = g;
  *while_handle = static_cast<unsigned long long>(wh);
  *body = b;
  *switch_handle = static_cast<unsigned long long>(sh);
  return 0;
}

// Fills the WHILE body `body` of `graph`: a copy of `pick`, then a SWITCH
// node on `switch_handle` whose branch c holds a copy of `branches[c]`,
// then a copy of `fold`; instantiates `graph` into `exec`.
extern "C" int qba_surface_graph_instantiate(void* graph, void* body,
                                             unsigned long long switch_handle,
                                             void* pick, void* fold,
                                             void** branches, int n_cells,
                                             void** exec) {
  cudaGraph_t b = static_cast<cudaGraph_t>(body);
  cudaGraphNode_t pick_node = nullptr, switch_node = nullptr,
                  fold_node = nullptr;
  cudaError_t e = cudaGraphAddChildGraphNode(&pick_node, b, nullptr, 0,
                                             static_cast<cudaGraph_t>(pick));
  if (e != cudaSuccess) return int(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle =
      static_cast<cudaGraphConditionalHandle>(switch_handle);
  params.conditional.type = cudaGraphCondTypeSwitch;
  params.conditional.size = static_cast<unsigned int>(n_cells);
  e = add_node(&switch_node, b, &pick_node, 1, &params);
  if (e != cudaSuccess) return int(e);
  for (int cell = 0; cell < n_cells; ++cell) {
    cudaGraphNode_t child = nullptr;
    e = cudaGraphAddChildGraphNode(&child,
                                   params.conditional.phGraph_out[cell],
                                   nullptr, 0,
                                   static_cast<cudaGraph_t>(branches[cell]));
    if (e != cudaSuccess) return int(e);
  }
  e = cudaGraphAddChildGraphNode(&fold_node, b, &switch_node, 1,
                                 static_cast<cudaGraph_t>(fold));
  if (e != cudaSuccess) return int(e);
  cudaGraphExec_t x = nullptr;
  e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  if (e != cudaSuccess) return int(e);
  *exec = x;
  return 0;
}

// Uploads the instantiated surface's nodes to the device on `stream`, so
// that the launch runs the graph rather than first moving it there.
extern "C" int qba_surface_graph_upload(void* exec, void* stream) {
  return int(cudaGraphUpload(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

// One launch of the instantiated surface on `stream`.
extern "C" int qba_surface_graph_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

// Frees the instantiated surface (when not null) and the parent graph.
extern "C" int qba_surface_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr)
    e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return int(e);
}
