// The GF(2) measurement sweep over a batch of shots, as each shot's
// family's affine map: one warp per shot at a time.
//
// This kernel is the counterpart of the JAX package's XLA host sweep
// (qba_tpu/gf2/symplectic.py :: gf2_measure_sweep, line 121), not of a
// pallas_call: the TPU's in-kernel sweep is the gen entry of
// trial_megakernel.cu, and both run shot_bits (gf2_sweep.cuh), where the
// function, the table layout, the bound and the design are described.
// The plain PyTorch version it is held against, bit for bit, is
// qba_tpu_torch/ops/gf2_sweep.py :: gf2_sweep_reference (the serial
// sweep).
//
// Grid: persistent blocks, as many as the card holds at once (or fewer
// where the batch is small); each warp takes shots b, b + (the grid's
// warps), ....  The families' tables
// are copied into the block's shared memory where they fit (in_smem),
// else read where they lie (L1 and L2 hold them: every shot reads them).
//
// Layouts: tables int32 [F, wt, n_pad] (gf2_sweep.cuh); family uint8 [B]
// (null: family 0); r uint8 [B, 2n]; coins uint8 [B, n]; mflip uint8
// [B, n] (null: none); out bits int32 [B, n] = outcome ^ mflip.

#include <cassert>

#include "gf2_sweep.cuh"

namespace {

using namespace qba_gf2;

constexpr int kThreads = 512;
// Three blocks an SM, 48 warps to overlap the shots' loads: at 46
// registers (two blocks) the 33-party sweep took a third longer on the
// H100 (PERF.md).
constexpr int kMinBlocks = 3;
// Output chunks a lane holds at once: 256 qubits a pass.
constexpr int kChunks = 8;

struct Params {
  const uint32_t* tables;
  const uint8_t* family;
  const uint8_t* r;
  const uint8_t* coins;
  const uint8_t* mflip;
  int32_t* bits;
  int n_shots, n_fam, in_smem;
  AffineDims d;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf2_sweep_kernel(Params P) {
  extern __shared__ __align__(16) uint32_t smem_tab[];
  const AffineDims d = P.d;
  const size_t tab_words = size_t(d.wt) * d.n_pad;
  const uint32_t* tabs = P.tables;
  if (P.in_smem) {
    for (size_t i = threadIdx.x; i < tab_words * P.n_fam; i += kThreads)
      smem_tab[i] = P.tables[i];
    __syncthreads();
    tabs = smem_tab;
  }
  const int lane = threadIdx.x & 31, warps = kThreads / 32;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
  const int chunks = d.n_pad / 32;
  for (int b0 = first; b0 < P.n_shots; b0 += gridDim.x * warps) {
    for (int c0 = 0; c0 < chunks; c0 += kChunks) {
      const size_t b = b0;
      const int f = P.family ? P.family[b] : 0;
      assert(f < P.n_fam);
      unsigned bit[kChunks];
      shot_bits<kChunks>(tabs + f * tab_words, d, P.r + b * 2 * d.n,
                         P.coins + b * d.n,
                         P.mflip ? P.mflip + b * d.n : nullptr, c0, bit);
      int32_t* out = P.bits + b * d.n;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int q = 32 * (c0 + c) + lane;
        if (q < d.n) out[q] = int32_t(bit[c]);
      }
    }
  }
}

int launch(const Params& prm, size_t smem, void* stream) {
  auto kernel = gf2_sweep_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long shots_a_block = kThreads / 32;
  const long needed = (prm.n_shots + shots_a_block - 1) / shots_a_block;
  const int grid = int(needed < long(sms) * per_sm ? needed
                                                   : long(sms) * per_sm);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  n_fam tables
// of n qubits; in_smem copies them into each block's shared memory.
extern "C" int qba_gf2_sweep(const void* tables, const void* family,
                             const void* r, const void* coins,
                             const void* mflip, void* bits, int n_shots,
                             int n, int n_fam, int in_smem, void* stream) {
  if (n_shots <= 0) return 0;
  if (n < 1 || n_fam < 1) return int(cudaErrorInvalidValue);
  Params prm{static_cast<const uint32_t*>(tables),
             static_cast<const uint8_t*>(family),
             static_cast<const uint8_t*>(r),
             static_cast<const uint8_t*>(coins),
             static_cast<const uint8_t*>(mflip),
             static_cast<int32_t*>(bits),
             n_shots, n_fam, in_smem != 0, affine_dims(n)};
  const size_t smem =
      in_smem ? size_t(4) * prm.d.wt * prm.d.n_pad * n_fam : 0;
  return launch(prm, smem, stream);
}
