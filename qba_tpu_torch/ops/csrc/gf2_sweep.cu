// The GF(2) measurement sweep over a batch of shots: one warp per shot,
// each shot starting from its family's static tableau.
//
// This kernel is the counterpart of the JAX package's XLA host sweep
// (qba_tpu/gf2/symplectic.py :: gf2_measure_sweep, line 121), not of a
// pallas_call: the TPU's in-kernel sweep is the gen entry of
// trial_megakernel.cu, and both run sweep_shot (gf2_sweep.cuh), where the
// algebra, the bound and the design are described.  The plain PyTorch
// version it is held against is qba_tpu_torch/ops/gf2_sweep.py ::
// gf2_sweep_reference.
//
// Each shot's tableau is built in the warp's own storage from the
// family's tableau (x0 and z0, word-major [F, W, 2n], read by every shot
// and so held in L2); nothing of size [B, 2n, W] exists in device memory.  The storage
// is shared memory (one slot per warp) or per-warp global scratch, as the
// wrapper (qba_tpu_torch/ops/gf2_sweep.py) picks by the slot's size.
//
// Layouts: x0, z0 int32 [F, W, 2n]; family uint8 [B] (null: family 0);
// r uint8 [B, 2n]; coins uint8 [B, n]; mflip uint8 [B, n] (null: none);
// out bits int32 [B, n] = outcome ^ mflip.

#include "gf2_sweep.cuh"

namespace {

using namespace qba_gf2;

struct Params {
  const uint32_t* x0;
  const uint32_t* z0;
  const uint8_t* family;
  const uint8_t* r;
  const uint8_t* coins;
  const uint8_t* mflip;
  int32_t* bits;
  unsigned char* scratch;  // null: the tableaux live in shared memory
  int n_shots, n, w;
};

// Each warp takes shots b, b + (all warps of the grid), ... in its slot.
__global__ void gf2_sweep_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + warp;
  const int n = P.n, w = P.w;
  const size_t slot = shot_bytes(n, w);
  unsigned char* base = P.scratch ? P.scratch + size_t(first) * slot
                                  : smem_raw + size_t(warp) * slot;
  const ShotTab t = shot_tab(base, n, w);
  const size_t words = size_t(2) * n * w;
  for (int b = first; b < P.n_shots; b += gridDim.x * warps) {
    const int f = P.family ? P.family[b] : 0;
    load_shot(t, n, w, P.x0 + f * words, P.z0 + f * words,
              P.r + size_t(b) * 2 * n);
    sweep_shot(t, n, w, P.coins + size_t(b) * n);
    for (int a = lane; a < n; a += 32) {
      const int flip = P.mflip ? (P.mflip[size_t(b) * n + a] & 1) : 0;
      P.bits[size_t(b) * n + a] = t.bits[a] ^ flip;
    }
    __syncwarp();
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  The launch is
// grid blocks of warps_per_block warps.  scratch null keeps each warp's
// tableau in shared memory (warps_per_block slots a block); else it holds
// grid * warps_per_block slots.  slot_bytes is the caller's size of a
// slot, which must be shot_bytes(n, w).
extern "C" int qba_gf2_sweep(const void* x0, const void* z0,
                             const void* family, const void* r,
                             const void* coins, const void* mflip,
                             void* bits, void* scratch, int n_shots, int n,
                             int w, int warps_per_block, int grid,
                             int slot_bytes, void* stream) {
  if (n_shots <= 0) return 0;
  if (n < 1 || w != (n + 31) / 32 || w > kMaxWords || warps_per_block < 1 ||
      warps_per_block > 32 || grid < 1 ||
      size_t(slot_bytes) != shot_bytes(n, w))
    return int(cudaErrorInvalidValue);
  Params prm{static_cast<const uint32_t*>(x0),
             static_cast<const uint32_t*>(z0),
             static_cast<const uint8_t*>(family),
             static_cast<const uint8_t*>(r),
             static_cast<const uint8_t*>(coins),
             static_cast<const uint8_t*>(mflip),
             static_cast<int32_t*>(bits),
             static_cast<unsigned char*>(scratch),
             n_shots, n, w};
  const size_t smem = scratch ? 0 : shot_bytes(n, w) * warps_per_block;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  gf2_sweep_kernel<<<grid, 32 * warps_per_block, smem,
                     static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
