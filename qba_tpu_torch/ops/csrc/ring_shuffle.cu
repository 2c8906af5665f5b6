// The neighbour-ring all-gather over the tp shards of a party-sharded
// trial batch, on one card: every shard's segment goes to every shard in
// n_tp - 1 hops from each shard to its right-hand neighbour.
//
// Replaces the TPU kernel qba_tpu/ops/ring_shuffle.py ::
// build_ring_gather (pallas_call at line 133).  The plain PyTorch version
// it is held against is qba_tpu_torch/ops/ring_shuffle.py ::
// ring_gather_reference.
//
// Layout.  x holds the shards' segments, [n_tp, outer, seg] in units of
// `Unit` (a segment is one shard's slice of the gathered axis and every
// axis after it; `outer` runs over the axes before it); out is
// [n_tp, outer, n_tp * seg]: out[my, o, s * seg + i] = x[s, o, i] for
// every shard my, so each shard's slice is the tiled all-gather, the
// shards' segments concatenated in tp order.
//
// Design.  The TPU moves a shard's segment to the next chip by remote
// DMA into a two-slot VMEM buffer, one hop at a time, with DMA
// semaphores and a barrier semaphore (ring_shuffle.py:63-94).  On one
// card the shards of a tp row become the blocks of a thread-block
// cluster: scheduled together on neighbouring SMs, able to write each
// other's shared memory and to meet at a cluster barrier.  One cluster
// of n_tp blocks moves one tile of one segment; block rank = shard.
//   0. the block stores its own tile at its own offset and into slot 0
//      of a two-slot shared-memory buffer; cluster barrier;
//   k. (k = 0 .. n_tp - 2) the block writes its slot k % 2 into slot
//      (k + 1) % 2 of its right-hand neighbour (distributed shared
//      memory, cooperative_groups::cluster_group::map_shared_rank);
//      cluster barrier; the tile that arrived came from shard
//      (my - k - 1) mod n_tp, and the block stores it at that owner's
//      offset: ring_shuffle.py:79-94's schedule.
// One barrier a hop is enough: a slot is written by the left-hand
// neighbour in hop k only after every block passed hop k - 1's barrier,
// and the slot it writes was last read before that barrier.  No block
// touches another's shared memory after the last barrier, so blocks may
// exit.  The launch is cudaLaunchKernelEx with a cluster dimension of
// n_tp (at most 8, the portable size); a refused launch returns its
// error.
//
// Bound on this card: bytes.  n_tp segments read once and n_tp * n_tp
// written; the hops through shared memory do not touch device memory.
// Loads and stores are 16 B a thread where the segment and the pointers
// allow it (4 B or 1 B otherwise).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;  // one slot; two slots a block

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(const Unit* __restrict__ x, Unit* __restrict__ out,
                   int n_tp, long long seg, long long tiles_per_seg) {
  constexpr int kTile = kTileBytes / sizeof(Unit);
  __shared__ __align__(16) Unit buf[2][kTile];
  cg::cluster_group cl = cg::this_cluster();
  const int my = int(cl.block_rank());
  const long long tile = blockIdx.x / n_tp;
  const long long o = tile / tiles_per_seg;
  const long long first = (tile - o * tiles_per_seg) * kTile;
  const int n = int(seg - first < kTile ? seg - first : kTile);
  const long long outer = gridDim.x / n_tp / tiles_per_seg;
  // Shard my's row o of the output, at this tile's offset in a segment.
  Unit* row = out + (my * outer + o) * (n_tp * seg) + first;
  const Unit* src = x + (my * outer + o) * seg + first;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Unit v = src[i];
    row[my * seg + i] = v;
    buf[0][i] = v;
  }
  if (n_tp == 1) return;
  cl.sync();
  Unit* right = cl.map_shared_rank(&buf[0][0], (my + 1) % n_tp);
  for (int k = 0; k < n_tp - 1; ++k) {
    const int send = k & 1, recv = send ^ 1;
    for (int i = threadIdx.x; i < n; i += kThreads)
      right[recv * kTile + i] = buf[send][i];
    cl.sync();
    const int owner = (my - k - 1 + n_tp) % n_tp;
    for (int i = threadIdx.x; i < n; i += kThreads)
      row[owner * seg + i] = buf[recv][i];
  }
}

template <typename Unit>
int launch(const void* x, void* out, int n_tp, long long outer,
           long long seg_bytes, cudaStream_t stream) {
  constexpr int kTile = kTileBytes / sizeof(Unit);
  const long long seg = seg_bytes / static_cast<long long>(sizeof(Unit));
  const long long tiles = (seg + kTile - 1) / kTile;
  const long long blocks = outer * tiles * n_tp;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = unsigned(n_tp);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ring_gather_kernel<Unit>,
                                     static_cast<const Unit*>(x),
                                     static_cast<Unit*>(out), n_tp, seg,
                                     tiles);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

// x [n_tp, outer, seg_bytes] bytes -> out [n_tp, outer, n_tp * seg_bytes].
// Returns a cudaError_t: 0 on a launch that was accepted.
extern "C" int qba_ring_gather(const void* x, void* out, int n_tp,
                               long long outer, long long seg_bytes,
                               void* stream) {
  if (n_tp < 1 || n_tp > 8 || outer < 0 || seg_bytes < 0)
    return int(cudaErrorInvalidValue);
  if (outer == 0 || seg_bytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out);
  if (seg_bytes % 16 == 0 && a % 16 == 0)
    return launch<uint4>(x, out, n_tp, outer, seg_bytes, s);
  if (seg_bytes % 4 == 0 && a % 4 == 0)
    return launch<uint32_t>(x, out, n_tp, outer, seg_bytes, s);
  return launch<uint8_t>(x, out, n_tp, outer, seg_bytes, s);
}
