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
// index, and the 2x2 entries as real and imaginary floats) and the kernel
// loops over it.  Every gate is the same pair update: for each flat index
// i with the target bit clear and every control bit set, combine state[i]
// and state[i | bit]; the flat index bit of qubit q is n - 1 - q.  One
// thread block per circuit run, __syncthreads() between ops.  The state
// lives in the block's dynamic shared memory while it fits (float32 up to
// 15 qubits real, 14 complex: 128 KB) and is copied out once; wider
// states (to 20 qubits, 4 MiB) stay in the run's slice of the output
// buffer in global memory, which the 50 MB L2 holds.  All-real circuits
// (H, X, CNOT, X**b: the protocol circuits) carry no imaginary plane.
// XPOW reads a runtime 0/1 param of its run, so one launch serves every
// list position and trial.  Sampling stays outside the kernel.
//
// Bound on this card: bytes at the interface (params in, the final state
// out, 4 B x 2**n per plane per run); the per-op traffic stays on chip
// (shared memory or L2) by design.  The operations are two to eight
// float32 multiply-adds per amplitude and op.
//
// Arithmetic: H is (x0 + x1) * INV_SQRT2 and (x0 - x1) * INV_SQRT2, X a
// swap, every other gate the coefficient form new = c_s * self + c_p *
// partner, written in the plain version's order; the compiler may still
// contract a multiply and an add into one fused multiply-add, so the two
// agree to a few float32 ulps, not bit for bit.
//
// Layouts: ops_i int32 [n_ops, 4] = (kind, target bit, control mask,
// param index or -1); ops_f float32 [n_ops, 8] = (m00, m01, m10, m11) as
// (real, imag) pairs; params int32 [B, n_params]; out float32 [B, planes,
// 2**n], planes = 1 (real) or 2 (real, imag).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kH = 0, kX = 1, kXpow = 2, kGen = 3;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
// Largest state kept in shared memory (bytes, all planes).
constexpr size_t kSmemState = 128 * 1024;

struct Params {
  const int32_t* ops_i;
  const float* ops_f;
  const int32_t* params;
  float* out;
  int n_qubits, n_ops, n_params, planes, in_smem;
};

__global__ void __launch_bounds__(kThreads)
fused_circuit_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t N = size_t(1) << P.n_qubits;
  const size_t run = blockIdx.x;
  float* gout = P.out + run * size_t(P.planes) * N;
  float* sx = P.in_smem ? reinterpret_cast<float*>(smem_raw) : gout;
  float* sy = P.planes == 2 ? sx + N : nullptr;
  const int32_t* prm = P.params + run * size_t(P.n_params);

  // |0...0>: real amplitude 1 at index 0.
  for (size_t i = threadIdx.x; i < N * P.planes; i += kThreads) sx[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) sx[0] = 1.f;
  __syncthreads();

  const size_t half = N >> 1;
  for (int k = 0; k < P.n_ops; ++k) {
    const int kind = P.ops_i[4 * k], bit = P.ops_i[4 * k + 1];
    const size_t ctrl = size_t(uint32_t(P.ops_i[4 * k + 2]));
    const int pi = P.ops_i[4 * k + 3];
    // X**b with b == 0 is the identity for this whole run.
    if (kind == kXpow && prm[pi] == 0) continue;
    const float* m = P.ops_f + 8 * k;
    const float m00r = m[0], m00i = m[1], m01r = m[2], m01i = m[3];
    const float m10r = m[4], m10i = m[5], m11r = m[6], m11i = m[7];
    const size_t stride = size_t(1) << bit, low = stride - 1;
    for (size_t p = threadIdx.x; p < half; p += kThreads) {
      const size_t i0 = ((p & ~low) << 1) | (p & low);
      if ((i0 & ctrl) != ctrl) continue;
      const size_t i1 = i0 | stride;
      const float x0 = sx[i0], x1 = sx[i1];
      if (kind == kH) {
        sx[i0] = (x0 + x1) * kInvSqrt2;
        sx[i1] = (x0 - x1) * kInvSqrt2;
        if (sy) {
          const float y0 = sy[i0], y1 = sy[i1];
          sy[i0] = (y0 + y1) * kInvSqrt2;
          sy[i1] = (y0 - y1) * kInvSqrt2;
        }
      } else if (kind == kX || kind == kXpow) {
        sx[i0] = x1;
        sx[i1] = x0;
        if (sy) {
          const float y0 = sy[i0], y1 = sy[i1];
          sy[i0] = y1;
          sy[i1] = y0;
        }
      } else if (!sy) {  // real coefficient form
        sx[i0] = m00r * x0 + m01r * x1;
        sx[i1] = m11r * x1 + m10r * x0;
      } else {
        const float y0 = sy[i0], y1 = sy[i1];
        sx[i0] = m00r * x0 - m00i * y0 + m01r * x1 - m01i * y1;
        sy[i0] = m00i * x0 + m00r * y0 + m01i * x1 + m01r * y1;
        sx[i1] = m11r * x1 - m11i * y1 + m10r * x0 - m10i * y0;
        sy[i1] = m11i * x1 + m11r * y1 + m10i * x0 + m10r * y0;
      }
    }
    __syncthreads();
  }
  if (P.in_smem)
    for (size_t i = threadIdx.x; i < N * P.planes; i += kThreads)
      gout[i] = sx[i];
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.
extern "C" int qba_fused_circuit(
    const void* ops_i, const void* ops_f, const void* params, void* out,
    int n_runs, int n_qubits, int n_ops, int n_params, int planes,
    void* stream) {
  if (n_runs <= 0) return 0;
  if (n_qubits < 1 || n_qubits > 20 || n_ops < 0 || n_params < 1 ||
      (planes != 1 && planes != 2))
    return int(cudaErrorInvalidValue);
  Params prm;
  prm.ops_i = static_cast<const int32_t*>(ops_i);
  prm.ops_f = static_cast<const float*>(ops_f);
  prm.params = static_cast<const int32_t*>(params);
  prm.out = static_cast<float*>(out);
  prm.n_qubits = n_qubits;
  prm.n_ops = n_ops;
  prm.n_params = n_params;
  prm.planes = planes;
  const size_t bytes = (size_t(4) << n_qubits) * planes;
  prm.in_smem = bytes <= kSmemState;
  const size_t smem = prm.in_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_circuit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_circuit_kernel<<<n_runs, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
