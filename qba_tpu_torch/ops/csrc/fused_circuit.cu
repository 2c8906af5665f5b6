// A whole statevector circuit in one launch, for a batch of circuit runs:
// every gate of a static op list applied to |0...0>, one run per param
// vector.
//
// Replaces the TPU kernel qba_tpu/ops/fused_circuit.py ::
// build_fused_circuit_run (line 93, pallas_call at line 283).  The plain
// PyTorch version it is held against is
// qba_tpu_torch/ops/fused_circuit.py :: fused_circuit_reference.
//
// Design.  The TPU kernel unrolls the op list at trace time, one compiled
// kernel per circuit, and splits gates into 128 x 128 lane matmuls and
// sublane rolls.  Here ONE compiled kernel serves every circuit: the op
// list arrives as data (per op: kind, target bit, control mask, param
// index and the 2x2 entries as real and imaginary floats, and the passes
// below) and the kernel loops over it.  Every gate is the same pair update: for each
// flat index i with the target bit clear and every control bit set,
// combine state[i] and state[i | bit]; the flat index bit of qubit q is
// n - 1 - q.  All-real circuits (H, X, CNOT, X**b: the protocol circuits)
// carry no imaginary plane.  XPOW reads a runtime 0/1 param of its run,
// so one launch serves every list position and trial.  Sampling stays
// outside the kernel.
//
// Passes.  The host groups consecutive in-block ops whose targets lie in
// at most PASS_BITS bits into a pass (ops/fused_circuit.py ::
// circuit_tables); each thread loads the 2^k amplitudes that differ in a
// pass's k bits, applies the pass's ops to them in registers, in order,
// and stores them, so a pass costs one sweep of the state and one
// barrier, not one per op.  Every amplitude meets the same operations in
// the same order as op by op.
//
// Routes, by the state's width alone (ops/fused_circuit.py ::
// circuit_route; circuit_tables classifies each op for the route in the
// pass table):
//   block    the state fits one block's shared memory (128 KB: 15 qubits
//            real, 14 complex): a block a run, the state in shared memory,
//            __syncthreads() between passes, written out once at the end.
//   cluster  a thread-block cluster a run holds the state in its blocks'
//            shared memory: block rank b holds the 2^L amplitudes whose
//            high flat bits (qubits 0..c-1) are b, L = n - c local bits.
//            An op whose target is a local bit belongs to one of the
//            block's passes, __syncthreads() after each; a control on a
//            rank bit applies or skips the op for the whole block by its
//            rank.  An op whose target is a rank bit (a pass of its own,
//            mask 0: an exchange) pairs block b with block b ^ bit
//            through distributed shared memory
//            (map_shared_rank): the block whose rank has the bit clear
//            updates the pairs of the lower half of the local indices in
//            both blocks, its partner those of the upper half, so the two
//            touch disjoint words, four consecutive indices a thread with
//            16-byte accesses; cluster.sync() before the exchange (the
//            partner's earlier ops are done; the previous exchange's
//            barrier serves where no pass came between) and after it
//            (both halves are written before either block reads on).  Each
//            block writes its own slice of the run's state once, at the
//            end.  At 18 qubits real a cluster of 16 blocks of 64 KB.
//   global   wider states (to 20 qubits, 4 MiB): a block a run, the
//            state in the run's slice of the output buffer in global
//            memory, which L2 holds only in part.
//
// Bound on this card: bytes at the interface (params in, the final state
// out, 4 B x 2**n per plane per run); the block and cluster routes keep
// the per-op traffic on chip.  The operations are two to eight float32
// multiply-adds per amplitude and op.
//
// Arithmetic: H is (x0 + x1) * INV_SQRT2 and (x0 - x1) * INV_SQRT2, X a
// swap, every other gate the coefficient form new = c_s * self + c_p *
// partner, written in the plain version's order (apply_pair, one
// function for every route: the exchange changes no arithmetic); the
// compiler may still contract a multiply and an add into one fused
// multiply-add, so the kernel and the plain version agree to a few
// float32 ulps, not bit for bit.
//
// Layouts: ops_i int32 [n_ops, 4] = (kind, target bit, control mask,
// param index or -1); ops_f float32 [n_ops, 8] = (m00, m01, m10,
// m11) as (real, imag) pairs; passes int32 [n_pass, 3] = (first op, ops,
// mask of the target bits; 0 for an exchange, one op); params int32 [B,
// n_params]; out float32 [B, planes, 2**n], planes = 1 (real) or 2
// (real, imag).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
// Blocks an SM the kernels are compiled for: two of 64 KB of state (the
// cluster route at 18 qubits) need at most 64 registers a thread.
constexpr int kMinBlocks = 2;
constexpr int kH = 0, kX = 1, kXpow = 2, kGen = 3;
constexpr int kOpCols = 4;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
// Largest state a block keeps in shared memory (bytes, all planes).
constexpr size_t kSmemState = 128 * 1024;

struct Params {
  const int32_t* ops_i;
  const float* ops_f;
  const int32_t* passes;
  const int32_t* params;
  float* out;
  int n_qubits, n_ops, n_pass, n_params, planes, in_smem, local_bits;
};

// One op as every route reads it.
struct Gate {
  int kind, bit, pi;
  size_t ctrl;
  float m00r, m00i, m01r, m01i, m10r, m10i, m11r, m11i;
};

__device__ inline Gate load_gate(const Params& P, int k) {
  const int32_t* o = P.ops_i + kOpCols * k;
  const float* m = P.ops_f + 8 * k;
  return Gate{o[0], o[1], o[3], size_t(uint32_t(o[2])),
              m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7]};
}

// A pair's amplitudes: real parts x0, x1 and imaginary parts y0, y1.
struct Pair {
  float x0, x1, y0, y1;
};

// The pair's new amplitudes under gate g, the plain version's arithmetic
// in its order; a real state (kCplx false) leaves the imaginary parts
// alone.
template <bool kCplx>
__device__ inline Pair apply_pair(const Gate& g, const Pair& a) {
  Pair n = a;
  if (g.kind == kH) {
    n.x0 = (a.x0 + a.x1) * kInvSqrt2;
    n.x1 = (a.x0 - a.x1) * kInvSqrt2;
    if constexpr (kCplx) {
      n.y0 = (a.y0 + a.y1) * kInvSqrt2;
      n.y1 = (a.y0 - a.y1) * kInvSqrt2;
    }
  } else if (g.kind == kX || g.kind == kXpow) {
    n.x0 = a.x1;
    n.x1 = a.x0;
    n.y0 = a.y1;
    n.y1 = a.y0;
  } else if constexpr (!kCplx) {  // real coefficient form
    n.x0 = g.m00r * a.x0 + g.m01r * a.x1;
    n.x1 = g.m11r * a.x1 + g.m10r * a.x0;
  } else {
    n.x0 = g.m00r * a.x0 - g.m00i * a.y0 + g.m01r * a.x1 - g.m01i * a.y1;
    n.y0 = g.m00i * a.x0 + g.m00r * a.y0 + g.m01i * a.x1 + g.m01r * a.y1;
    n.x1 = g.m11r * a.x1 - g.m11i * a.y1 + g.m10r * a.x0 - g.m10i * a.y0;
    n.y1 = g.m11i * a.x1 + g.m11r * a.y1 + g.m10i * a.x0 + g.m10r * a.y0;
  }
  return n;
}

// Whether op g applies in this block: its run's X**b bit, and its
// controls on rank bits (the block's `rank` above `lbits` local bits; the
// block and global routes have none).  Uniform over the block.
__device__ inline bool op_on(const Gate& g, const int32_t* prm,
                             unsigned rank, int lbits) {
  if (g.kind == kXpow && prm[g.pi] == 0) return false;
  const unsigned ctrl_rank = unsigned(g.ctrl >> lbits);
  return (rank & ctrl_rank) == ctrl_rank;
}

// Op g on the 2^K amplitudes a thread holds (vx, vy: index m has the
// pass's bits m, at offsets off[m] from `base`), g's target the pass's
// bit T: the pairs (m, m | 2^T) whose control bits are set.
template <int K, bool kCplx, int T>
__device__ inline void pass_pairs(const Gate& g, uint32_t ctrl, uint32_t base,
                                  const uint32_t (&off)[1 << K],
                                  float (&vx)[1 << K], float (&vy)[1 << K]) {
  constexpr int hi = 1 << T;
#pragma unroll
  for (int m = 0; m < (1 << K); ++m) {
    if (m & hi) continue;
    if (((base + off[m]) & ctrl) != ctrl) continue;
    const Pair a{vx[m], vx[m | hi], kCplx ? vy[m] : 0.f,
                 kCplx ? vy[m | hi] : 0.f};
    const Pair n = apply_pair<kCplx>(g, a);
    vx[m] = n.x0;
    vx[m | hi] = n.x1;
    if constexpr (kCplx) {
      vy[m] = n.y0;
      vy[m | hi] = n.y1;
    }
  }
}

// pass_pairs for the pass bit t, a runtime value below K.
template <int K, bool kCplx, int T = 0>
__device__ inline void pass_op(int t, const Gate& g, uint32_t ctrl,
                               uint32_t base, const uint32_t (&off)[1 << K],
                               float (&vx)[1 << K], float (&vy)[1 << K]) {
  if constexpr (T < K) {
    if (t == T)
      pass_pairs<K, kCplx, T>(g, ctrl, base, off, vx, vy);
    else
      pass_op<K, kCplx, T + 1>(t, g, ctrl, base, off, vx, vy);
  }
}

// The exchange's pairs (x0[i], x1[i]), i in [base, base + half), four
// consecutive indices a thread with 16-byte accesses; x0 and x1 lie in
// two blocks' shared memory.
template <bool kCplx>
__device__ inline void exchange_pairs(const Gate& g, uint32_t ctrl, float* x0,
                                      float* x1, float* y0, float* y1,
                                      size_t base, size_t half) {
  for (size_t p = 4 * size_t(threadIdx.x); p < half; p += 4 * kThreads) {
    const size_t i = base + p;
    float4 a0 = *reinterpret_cast<const float4*>(x0 + i);
    float4 a1 = *reinterpret_cast<const float4*>(x1 + i);
    float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
    if constexpr (kCplx) {
      b0 = *reinterpret_cast<const float4*>(y0 + i);
      b1 = *reinterpret_cast<const float4*>(y1 + i);
    }
    float* pa0 = &a0.x;
    float* pa1 = &a1.x;
    float* pb0 = &b0.x;
    float* pb1 = &b1.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (((uint32_t(i) + e) & ctrl) != ctrl) continue;
      const Pair n = apply_pair<kCplx>(g, Pair{pa0[e], pa1[e], pb0[e], pb1[e]});
      pa0[e] = n.x0;
      pa1[e] = n.x1;
      pb0[e] = n.y0;
      pb1[e] = n.y1;
    }
    *reinterpret_cast<float4*>(x0 + i) = a0;
    *reinterpret_cast<float4*>(x1 + i) = a1;
    if constexpr (kCplx) {
      *reinterpret_cast<float4*>(y0 + i) = b0;
      *reinterpret_cast<float4*>(y1 + i) = b1;
    }
  }
}

// An op as the block's passes read it, staged in shared memory once per
// block: its kind and target bit (kind | bit << 4), or -1 where it does
// not apply in this block (op_on), and its control bits among the local
// ones.
struct Staged {
  int code;
  uint32_t ctrl;
};

// Stage every op for this block (then a barrier).
__device__ inline void stage_ops(const Params& P, const int32_t* prm,
                                 unsigned rank, int lbits, Staged* staged) {
  const uint32_t lmask = (1u << lbits) - 1;
  for (int k = threadIdx.x; k < P.n_ops; k += kThreads) {
    const Gate g = load_gate(P, k);
    staged[k] = Staged{op_on(g, prm, rank, lbits) ? g.kind | g.bit << 4 : -1,
                       uint32_t(g.ctrl) & lmask};
  }
}

// A pass: ops first..first+count-1, consecutive in-block ops whose target
// bits are the K bits of `mask`, on the state (sx, sy) of 2^lbits
// amplitudes.  Each thread loads the 2^K amplitudes that differ in those
// bits, applies every op of the pass to them in registers, in order, and
// stores them: one pass over the state, and one barrier, for the run.
template <int K, bool kCplx>
__device__ void run_pass(const Params& P, const Staged* staged, int lbits,
                         int first, int count, uint32_t mask, float* sx,
                         float* sy) {
  constexpr int M = 1 << K;
  int pos[K];
  uint32_t rest = mask;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    pos[j] = __ffs(int(rest)) - 1;
    rest &= rest - 1;
  }
  // 32-bit indices: a state has at most 2^20 amplitudes.
  uint32_t off[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    off[m] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((m >> j) & 1) off[m] |= 1u << pos[j];
  }
  const uint32_t n_base = 1u << (lbits - K);
  for (uint32_t q = threadIdx.x; q < n_base; q += kThreads) {
    // q with a 0 inserted at each of the pass's bits, lowest first.
    uint32_t base = q;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t low = (1u << pos[j]) - 1;
      base = ((base & ~low) << 1) | (base & low);
    }
    float vx[M], vy[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      vx[m] = sx[base + off[m]];
      vy[m] = kCplx ? sy[base + off[m]] : 0.f;
    }
    for (int k = first; k < first + count; ++k) {
      const Staged op = staged[k];
      if (op.code < 0) continue;
      // Only the coefficient form reads the entries.
      const Gate g = (op.code & 15) == kGen ? load_gate(P, k)
                                            : Gate{op.code & 15};
      pass_op<K, kCplx>(__popc(mask & ((1u << (op.code >> 4)) - 1)), g,
                        op.ctrl, base, off, vx, vy);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      sx[base + off[m]] = vx[m];
      if constexpr (kCplx) sy[base + off[m]] = vy[m];
    }
  }
}

// Pass s of the table if any of its ops applies in this block; returns
// whether it ran (then the caller's barrier follows).  Passes span 1 to 3
// bits (PASS_BITS).
template <bool kCplx>
__device__ inline bool local_pass(const Params& P, const Staged* staged,
                                  int lbits, int s, float* sx, float* sy) {
  const int first = P.passes[3 * s], count = P.passes[3 * s + 1];
  const uint32_t mask = uint32_t(P.passes[3 * s + 2]);
  bool any = false;
  for (int k = first; k < first + count && !any; ++k)
    any = staged[k].code >= 0;
  if (!any) return false;
  const int k = __popc(mask);
  if (k == 1)
    run_pass<1, kCplx>(P, staged, lbits, first, count, mask, sx, sy);
  else if (k == 2)
    run_pass<2, kCplx>(P, staged, lbits, first, count, mask, sx, sy);
  else
    run_pass<3, kCplx>(P, staged, lbits, first, count, mask, sx, sy);
  return true;
}

// The block and global routes: a block a run, every pass in the block.
template <bool kCplx>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_circuit_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t N = size_t(1) << P.n_qubits;
  const size_t run = blockIdx.x;
  float* gout = P.out + run * size_t(P.planes) * N;
  float* sx = P.in_smem ? reinterpret_cast<float*>(smem_raw) : gout;
  float* sy = P.planes == 2 ? sx + N : nullptr;
  Staged* staged = reinterpret_cast<Staged*>(
      smem_raw + (P.in_smem ? 4 * N * P.planes : 0));
  const int32_t* prm = P.params + run * size_t(P.n_params);

  // |0...0>: real amplitude 1 at index 0.
  for (size_t i = threadIdx.x; i < N * P.planes; i += kThreads) sx[i] = 0.f;
  stage_ops(P, prm, 0, P.n_qubits, staged);
  __syncthreads();
  if (threadIdx.x == 0) sx[0] = 1.f;
  __syncthreads();

  for (int s = 0; s < P.n_pass; ++s)
    if (local_pass<kCplx>(P, staged, P.n_qubits, s, sx, sy))
      __syncthreads();
  if (P.in_smem)
    for (size_t i = threadIdx.x; i < N * P.planes; i += kThreads)
      gout[i] = sx[i];
}

// The cluster route: a cluster of 2^c blocks a run, block rank b holding
// the amplitudes whose high c flat bits are b.
template <bool kCplx>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_circuit_cluster_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int L = P.local_bits;
  const size_t NL = size_t(1) << L, N = size_t(1) << P.n_qubits;
  const size_t run = blockIdx.x / cluster.num_blocks();
  float* sx = reinterpret_cast<float*>(smem_raw);
  float* sy = P.planes == 2 ? sx + NL : nullptr;
  Staged* staged = reinterpret_cast<Staged*>(smem_raw + 4 * NL * P.planes);
  const int32_t* prm = P.params + run * size_t(P.n_params);

  for (size_t i = threadIdx.x; i < NL * P.planes; i += kThreads) sx[i] = 0.f;
  stage_ops(P, prm, rank, L, staged);
  __syncthreads();
  if (rank == 0 && threadIdx.x == 0) sx[0] = 1.f;
  __syncthreads();

  bool after_exchange = false;
  for (int s = 0; s < P.n_pass; ++s) {
    if (P.passes[3 * s + 2] != 0) {
      after_exchange = false;
      if (local_pass<kCplx>(P, staged, L, s, sx, sy)) __syncthreads();
      continue;
    }
    // An exchange: one op whose target is rank bit g.bit - L.  X**b skips
    // are run-uniform, so the whole cluster skips it, barriers included;
    // otherwise every block meets the barriers, and a pair with its
    // control ranks clear skips the update.  The pass table is the same
    // in every block, so every block skips the same leading barriers.
    const Gate g = load_gate(P, P.passes[3 * s]);
    if (g.kind == kXpow && prm[g.pi] == 0) continue;
    if (!after_exchange) cluster.sync();
    after_exchange = true;
    if (op_on(g, prm, rank, L)) {
      const unsigned tb = 1u << (g.bit - L);
      const bool lower = (rank & tb) == 0;
      float* px = cluster.map_shared_rank(sx, rank ^ tb);
      float* py = sy ? cluster.map_shared_rank(sy, rank ^ tb) : nullptr;
      const size_t half = NL >> 1, base = lower ? 0 : half;
      exchange_pairs<kCplx>(g, uint32_t(g.ctrl & (NL - 1)), lower ? sx : px,
                            lower ? px : sx, lower ? sy : py,
                            lower ? py : sy, base, half);
    }
    cluster.sync();
  }
  float* gout = P.out + run * size_t(P.planes) * N + size_t(rank) * NL;
  for (int pl = 0; pl < P.planes; ++pl)
    for (size_t i = threadIdx.x; i < NL; i += kThreads)
      gout[pl * N + i] = sx[pl * NL + i];
}

cudaLaunchConfig_t cluster_config(int n_runs, int cluster, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_runs) * unsigned(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster kernel's attributes for this shared memory and cluster size.
template <bool kCplx>
int cluster_attrs(size_t smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_circuit_cluster_kernel<kCplx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(fused_circuit_cluster_kernel<kCplx>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return int(e);
}

// Launch the route's kernel for a real or complex state.
template <bool kCplx>
int launch(Params prm, int n_runs, int cluster, void* stream) {
  const size_t bytes = (size_t(4) << prm.n_qubits) * prm.planes;
  const size_t stage = sizeof(Staged) * prm.n_ops;
  if (cluster > 1) {
    int c = 0;
    while ((1 << c) < cluster) ++c;
    prm.local_bits = prm.n_qubits - c;
    prm.in_smem = 1;
    if (bytes / cluster > kSmemState) return int(cudaErrorInvalidValue);
    const size_t smem = bytes / cluster + stage;
    if (int e = cluster_attrs<kCplx>(smem, cluster)) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        n_runs, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
    cudaError_t e =
        cudaLaunchKernelEx(&cfg, fused_circuit_cluster_kernel<kCplx>, prm);
    if (e != cudaSuccess) return int(e);
    return int(cudaGetLastError());
  }
  prm.local_bits = prm.n_qubits;
  prm.in_smem = cluster == 1;
  if (prm.in_smem && bytes > kSmemState) return int(cudaErrorInvalidValue);
  const size_t smem = (prm.in_smem ? bytes : 0) + stage;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_circuit_kernel<kCplx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_circuit_kernel<kCplx><<<n_runs, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  cluster is the
// route: 0 global, 1 block, 2..16 (a power of two) the blocks of a
// cluster route's clusters, which hold 2^n / cluster amplitudes each.
extern "C" int qba_fused_circuit(
    const void* ops_i, const void* ops_f, const void* passes,
    const void* params, void* out, int n_runs, int n_qubits, int n_ops,
    int n_pass, int n_params, int planes, int cluster, void* stream) {
  if (n_runs <= 0) return 0;
  if (n_qubits < 1 || n_qubits > 20 || n_ops < 0 || n_pass < 0 ||
      n_params < 1 ||
      (planes != 1 && planes != 2) || cluster < 0 || cluster > 16 ||
      (cluster > 1 && (!is_pow2(cluster) || cluster >= (1 << n_qubits))))
    return int(cudaErrorInvalidValue);
  Params prm;
  prm.ops_i = static_cast<const int32_t*>(ops_i);
  prm.ops_f = static_cast<const float*>(ops_f);
  prm.passes = static_cast<const int32_t*>(passes);
  prm.params = static_cast<const int32_t*>(params);
  prm.out = static_cast<float*>(out);
  prm.n_qubits = n_qubits;
  prm.n_ops = n_ops;
  prm.n_pass = n_pass;
  prm.n_params = n_params;
  prm.planes = planes;
  return planes == 2 ? launch<true>(prm, n_runs, cluster, stream)
                     : launch<false>(prm, n_runs, cluster, stream);
}

// How many clusters of `cluster` blocks, each holding `smem` bytes of a
// real state, the card runs at once (cudaOccupancyMaxActiveClusters; 0
// when one does not fit).  Returns a cudaError_t.
extern "C" int qba_fused_circuit_clusters(int cluster, int smem,
                                          int* clusters_out) {
  if (cluster < 2 || cluster > 16 || !is_pow2(cluster) || smem < 0)
    return int(cudaErrorInvalidValue);
  if (int e = cluster_attrs<false>(size_t(smem), cluster)) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, cluster, size_t(smem), nullptr, &attr);
  return int(cudaOccupancyMaxActiveClusters(
      clusters_out, fused_circuit_cluster_kernel<false>, &cfg));
}
