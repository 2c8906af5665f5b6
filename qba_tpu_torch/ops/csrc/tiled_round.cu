// One voting round as two launches split at the accepted matrix: the
// verdict kernel (verdict of every pool packet against every receiver,
// first-accept dedup into vi) writes the accepted matrix as one receiver
// mask a packet, uint64 [T, n_pool] (int64 to the host; bit rv the
// block's receiver rv); the rebuild kernel reads it back and builds the
// successor pool.
//
// Replaces the TPU kernels qba_tpu/ops/round_kernel_tiled.py ::
// build_verdict_kernel (pallas_call at line 563) and ::
// build_rebuild_kernel (pallas_call at line 1200), the `pallas_tiled`
// engine, and their party-sharded n_recv builds.  The plain PyTorch
// versions they are held against are
// qba_tpu_torch/ops/round_kernel_tiled.py :: verdict_reference and
// :: rebuild_reference (per shard in the n_recv variant).
//
// Design.  Over round_common.cuh's phases.
//   verdict  a (shard, trial) is one block, or a thread-block cluster
//            of two (verdict_ranks in round_kernel_tiled.py: two above
//            16 receivers a block), each a Part of the round: it loads
//            its receivers' vi and lists and its words of the cells'
//            sent and honesty bits and copies the rest from its partner
//            through distributed shared memory; lists the sent cells; A,
//            the shared verdict over its share of the list (a warp a
//            packet, staged with cp.async, its receivers' bits one
//            ballot a pass into the packet's 64-bit mask in shared
//            memory), then copies its partner's masks; B, the dedup of its
//            receivers over the list, a warp per receiver, which clears
//            the bits that lose in place (a 32-bit atomicAnd a loss), so
//            each listed packet's mask ends as its accepted receivers;
//            then it stores its part of the n_pool words, one 8-byte
//            word a thread, each word's bits from the block that owns
//            them, 0 for every unsent cell (store_acc).  The TPU's
//            accepted matrix is one bit a (packet, receiver): 16 KiB a
//            trial at 33 parties as masks against 256 KiB as int32 0/1,
//            and no strided store (a lane a packet at a stride of n_rv
//            words) and no zero-fill of the rows past the scan extent.
//            The layout takes no slot lists (Smem's `slots`), so at 33
//            parties four blocks fit an SM's shared memory.  A trial's
//            packets spread over two SMs: the trials with the most live
//            packets set the launch's length.
//   rebuild  a block per (shard, trial): each receiver's slots come from
//            bit rv of the masks in packet order (a lane a packet's word,
//            coalesced, a ballot a receiver: slots_from_acc), with the
//            overflow flag; then C, D and E as in the fused kernel.
// The TPU kernels walk a grid of pool blocks in order and carry vi
// across the steps; here a block holds a whole trial, so no carry
// crosses blocks.
//
// The party-sharded variant, as in fused_round.cu: a launch takes
// n_shards shards of a batch, a block per (shard, trial), shard-major;
// a shard's receivers are the global [start + shard * n_local, ...) of
// n_glob, its mask bit rv the local receiver rv.  Its verdict drains
// them against its copy of the assembled pool, whose entries between
// the segments are unsent: phase A skips them and their words are zero,
// so the rebuild's slot walk sees the accepted packets in the global
// (sender, slot) order the dedup gave them.  Its rebuild writes the
// shard's LOCAL successor segment (capacity n_local * slots, compacted,
// global cell ids) and reads its receivers' columns of the global draw
// tables.  Each kernel is instantiated for one shard too, with the shard
// terms fixed at compile time (BlockAt in round_common.cuh): the
// single-device kernels; and for the phase clock (kClock), which only
// the timing scripts launch.
//
// Bound on this card: the verdict's integer operations at 33 parties
// (its compares, PERF.md), bytes elsewhere.  The verdict reads the live
// packets' valid rows, lens, P, meta and draws, li and vi, and writes
// the masks (8 B a packet) and vi.  The rebuild reads the masks, the
// accepted packets' rows, li and draws, and writes the whole successor
// pool.
//
// Layouts as fused_round.cu (B = n_shards * T blocks; pool, li, vi and
// acc per block, honesty and draws per trial); acc uint64 [B, n_pool].

#include <cooperative_groups.h>

#include "round_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace qba;

struct VerdictParams {
  const int8_t* vals;
  const int32_t* lens;
  const int8_t* p;
  const int32_t* meta;
  const int32_t* li;
  const int32_t* vi;
  const int32_t* honest;
  const uint8_t* attack;
  const uint8_t* rand_v;
  const uint8_t* late;
  unsigned long long* o_acc;
  int32_t* o_vi;
  long long* clock;  // the clock's instantiations only: int64 [B, kRoundPhases]
  Dims d;
  int n_trials, start, round_idx, use_fp;
};

// The split round's exchanges through distributed shared memory (a
// cluster of kSplitRanks blocks a (shard, trial); each block's Part, its
// partner the other).  A block only reads its partner's words, ones the
// partner does not write again before the barrier that follows the read;
// the kernel's last cluster barrier keeps both blocks until the other's
// reads end.  More blocks, or two at 16 receivers or fewer, cost more
// set-up and barriers than they save (PERF.md).
constexpr int kSplitRanks = 2;

// After set-up: the partner's words of sent and honesty bits, its
// receivers' lists and ineligibility words, and its warps' lossy
// receivers (or-ed in).  The first cluster barrier also makes sure both
// blocks of the cluster run before either reads the other.
__device__ void gather_setup(const Shared& sh, const Dims& d,
                             const Part& part) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int n_words = (d.n_pool() + 31) / 32, ld = sh.L.ld, sw = sh.L.sw;
  const Part o{1 - part.rank, kSplitRanks};
  const unsigned* sent = cl.map_shared_rank(sh.sent, o.rank);
  const unsigned* hon = cl.map_shared_rank(sh.hon, o.rank);
  for (int w = o.lo(n_words) + threadIdx.x; w < o.hi(n_words);
       w += kThreads) {
    sh.sent[w] = sent[w];
    sh.hon[w] = hon[w];
  }
  const unsigned* li = cl.map_shared_rank(sh.li, o.rank);
  const unsigned* oor = cl.map_shared_rank(sh.oor, o.rank);
  const int r0 = o.lo(d.n_rv), n_r = o.hi(d.n_rv) - r0;
  for (int i = threadIdx.x; i < n_r * sw; i += kThreads) {
    const int q = i / n_r, at = q * ld + r0 + (i - q * n_r);
    sh.li[at] = li[at];
    sh.oor[at] = oor[at];
  }
  if (threadIdx.x < kWarps)
    sh.lossy_w[threadIdx.x] |=
        *cl.map_shared_rank(sh.lossy_w + threadIdx.x, o.rank);
  __syncthreads();
}

// After the verdict: each block checked the list entries verdict_owner
// gives it; it copies its partner's verdict masks and packet infos, so
// that its dedup reads every packet's locally.  A block's dedup then
// clears only its own receivers' bits, which its partner does not read
// before store_acc's barrier.  A block of one rank needs only its own
// barrier.
__device__ void gather_verdicts(const Shared& sh, int n_sent,
                                const Part& part) {
  if (part.n_ranks > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (int i = threadIdx.x; i < n_sent; i += kThreads) {
      const int owner = verdict_owner(i, part.n_ranks);
      if (owner == part.rank) continue;
      const int pk = sh.list[i];
      sh.ok_mask[pk] = *cl.map_shared_rank(sh.ok_mask + pk, owner);
      sh.info[pk] = *cl.map_shared_rank(sh.info + pk, owner);
    }
  }
  __syncthreads();
}

// The verdict's output: one receiver mask a packet (bit rv the block's
// receiver rv; 64 bits because the block's receivers are a 64-bit mask,
// dims_ok), the pruned verdict of each sent cell and 0 for every other
// cell of the pool, one 8-byte word a thread, coalesced.  Of a split
// round, after a cluster barrier (both blocks' dedup done), block `rank`
// stores its Part of the cells, each word's bits of its own receivers
// from its mask and the rest from its partner's.
__device__ void store_acc(const Shared& sh, unsigned long long* acc,
                          const Dims& d, const Part& part) {
  const int n_pool = d.n_pool();
  if (part.n_ranks == 1) {
    for (int c = threadIdx.x; c < n_pool; c += kThreads)
      acc[c] = ((sh.sent[c >> 5] >> (c & 31)) & 1u) ? sh.ok_mask[c] : 0ull;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const unsigned long long mine =
      low_bits(part.hi(d.n_rv)) & ~low_bits(part.lo(d.n_rv));
  const unsigned long long theirs = low_bits(d.n_rv) & ~mine;
  const unsigned long long* other =
      cl.map_shared_rank(sh.ok_mask, 1 - part.rank);
  for (int c = part.lo(n_pool) + threadIdx.x; c < part.hi(n_pool);
       c += kThreads)
    acc[c] = ((sh.sent[c >> 5] >> (c & 31)) & 1u)
                 ? (mine & sh.ok_mask[c]) | (theirs & other[c])
                 : 0ull;
}

struct RebuildParams {
  const int8_t* vals;
  const int32_t* lens;
  const int8_t* p;
  const int32_t* meta;
  const int32_t* li;
  const unsigned long long* acc;
  const int32_t* honest;
  const uint8_t* attack;
  const uint8_t* rand_v;
  int8_t* o_vals;
  int32_t* o_lens;
  int8_t* o_p;
  int32_t* o_meta;
  int32_t* o_ovf;
  long long* clock;
  Dims d;
  int n_trials, start, n_dis, round_idx, use_fp;
};

// Four blocks an SM for the verdict (at most 64 registers a thread: at
// 33 parties the layout without slot lists is 52 KB a block), four for
// the rebuild, as timed side by side on the H100 (PERF.md).
constexpr int kVerdictBlocks = 4;

// The verdict of a cluster of kSplitRanks blocks a (shard, trial)
// (kSplit, see the source's head) or of one block (the whole round's Part folded
// in at compile time, the faster form where one block a trial serves).
template <bool kSharded, bool kClock, bool kSplit>
__global__ void __launch_bounds__(kThreads, kVerdictBlocks)
tiled_verdict_kernel(VerdictParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhaseClock<kClock, kRoundPhases> clk;
  clk.start();
  const Part part =
      kSplit ? Part{int(cg::this_cluster().block_rank()), kSplitRanks}
             : Part{};
  const int block = int(blockIdx.x) / part.n_ranks;
  const BlockAt<kSharded> at(P.n_trials, block);
  const size_t b = block, t = at.t;
  const Dims d = at.dims(P.d, P.start);
  const int n_pool = d.n_pool();
  const Shared sh(smem_raw, d, true, false);
  const PoolIn in = pool_at(P.vals, P.lens, P.p, P.meta, b, n_pool, d);
  const int32_t* li = P.li + b * size_t(d.n_rv) * d.size_l;
  const int32_t* honest = P.honest + t * size_t(n_pool);
  const Draws dr = draws_at(P.attack, P.rand_v, P.late, t, d);

  round_setup(sh, in.meta, honest, P.vi + b * size_t(d.n_rv) * d.w, li, d,
              part);
  __syncthreads();
  if (part.n_ranks > 1) gather_setup(sh, d, part);
  clk.mark(kRpSetup);
  list_sent(sh, d);
  __syncthreads();
  const int n_sent = sh.misc[0];
  clk.mark(kRpList);

  verdict_phase(sh, in, li, dr, d, n_sent, P.round_idx, P.use_fp, clk,
                part);
  gather_verdicts(sh, n_sent, part);
  clk.mark(kRpVerdictWait);
  dedup_phase(sh, dr, d, n_sent, false, true, part);
  __syncthreads();
  clk.mark(kRpDedup);
  store_acc(sh, P.o_acc + b * size_t(n_pool), d, part);
  store_vi(sh, P.o_vi + b * size_t(d.n_rv) * d.w, d, part);
  // No block leaves while another reads its shared memory.
  if (part.n_ranks > 1) cg::this_cluster().sync();
  clk.mark(kRpFill);
  if (part.rank == 0) clk.store(P.clock + b * kRoundPhases);
}

// The single-device instantiation takes the host's dims (r_off = 0 and
// n_glob = n_rv at run time, the successor pool's capacity n_pool): with
// the constants of BlockAt::dims folded in, the compiler took it from 64
// registers to 80 with a spill, and 12% more time at 33 parties.
template <bool kSharded, bool kClock>
__global__ void __launch_bounds__(kThreads, 4)
tiled_rebuild_kernel(RebuildParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhaseClock<kClock, kRoundPhases> clk;
  clk.start();
  const BlockAt<kSharded> at(P.n_trials);
  const size_t b = blockIdx.x, t = at.t;
  const Dims d = kSharded ? at.dims(P.d, P.start) : P.d;
  const int n_pool = d.n_pool();
  const Shared sh(smem_raw, d, false);
  const PoolIn in = pool_at(P.vals, P.lens, P.p, P.meta, b, n_pool, d);
  const PoolOut out = pool_at(P.o_vals, P.o_lens, P.o_p, P.o_meta, b,
                              kSharded ? d.n_out() : n_pool, d);
  const int32_t* li = P.li + b * size_t(d.n_rv) * d.size_l;
  const int32_t* honest = P.honest + t * size_t(n_pool);
  const unsigned long long* acc = P.acc + b * size_t(n_pool);
  // Phase D reads no late draw.
  Draws dr = draws_at(P.attack, P.rand_v, P.attack, t, d);
  dr.late = nullptr;

  if (threadIdx.x == 0) sh.misc[1] = 0;
  __syncthreads();
  clk.mark(kRpSetup);
  slots_from_acc(sh, acc, d, n_pool, P.round_idx <= P.n_dis);
  __syncthreads();
  clk.mark(kRpDedup);
  offsets_phase(sh.offs, sh.k_cnt, d.n_rv);
  if (threadIdx.x == 0) P.o_ovf[b] = sh.misc[1];
  __syncthreads();
  clk.mark(kRpOffsets);
  const int total = sh.offs[d.n_rv];
  rebuild_phase(sh, in, out, li, honest, dr, d, total, P.use_fp);
  clk.mark(kRpRebuild);
  fill_dead_tail(out, d, total);
  clk.mark(kRpFill);
  clk.store(P.clock + b * kRoundPhases);
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  n_local
// receivers a shard, n_shards shards from receiver `start` on, of n_glob.
extern "C" int qba_tiled_verdict(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* vi, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* o_acc, void* o_vi,
    void* clock, int n_trials, int n_shards, int n_local, int n_glob,
    int start, int slots, int max_l, int size_l, int w, int round_idx,
    int use_fp, int n_ranks, void* stream) {
  if (n_trials <= 0 || n_shards <= 0) return 0;
  Dims d;
  if (!launch_dims(n_shards, n_local, n_glob, start, slots, max_l, size_l, w,
                   &d) || (n_ranks != 1 && n_ranks != kSplitRanks))
    return int(cudaErrorInvalidValue);
  VerdictParams prm;
  prm.vals = static_cast<const int8_t*>(vals);
  prm.lens = static_cast<const int32_t*>(lens);
  prm.p = static_cast<const int8_t*>(p);
  prm.meta = static_cast<const int32_t*>(meta);
  prm.li = static_cast<const int32_t*>(li);
  prm.vi = static_cast<const int32_t*>(vi);
  prm.honest = static_cast<const int32_t*>(honest);
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.late = static_cast<const uint8_t*>(late);
  prm.o_acc = static_cast<unsigned long long*>(o_acc);
  prm.o_vi = static_cast<int32_t*>(o_vi);
  prm.clock = static_cast<long long*>(clock);
  prm.d = d;
  prm.n_trials = n_trials;
  prm.start = start;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  const bool sharded = sharded_launch(n_shards, n_local, n_glob);
  using Kernel = void (*)(VerdictParams);
  // [sharded][clock][split]
  const Kernel kernels[2][2][2] = {
      {{tiled_verdict_kernel<false, false, false>,
        tiled_verdict_kernel<false, false, true>},
       {tiled_verdict_kernel<false, true, false>,
        tiled_verdict_kernel<false, true, true>}},
      {{tiled_verdict_kernel<true, false, false>,
        tiled_verdict_kernel<true, false, true>},
       {tiled_verdict_kernel<true, true, false>,
        tiled_verdict_kernel<true, true, true>}}};
  const Kernel kernel = kernels[sharded][clock != nullptr][n_ranks > 1];
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem, true, false)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_trials) * n_shards * n_ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = unsigned(n_ranks);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, prm)) return int(e);
  return int(cudaGetLastError());
}

// Returns a cudaError_t: 0 on a launch that was accepted.  Shards as
// qba_tiled_verdict.
extern "C" int qba_tiled_rebuild(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* acc, const void* honest, const void* attack,
    const void* rand_v, void* o_vals, void* o_lens, void* o_p, void* o_meta,
    void* o_ovf, void* clock, int n_trials, int n_shards, int n_local,
    int n_glob, int start, int slots, int max_l, int size_l, int w, int n_dis,
    int round_idx, int use_fp, void* stream) {
  if (n_trials <= 0 || n_shards <= 0) return 0;
  Dims d;
  if (!launch_dims(n_shards, n_local, n_glob, start, slots, max_l, size_l, w,
                   &d))
    return int(cudaErrorInvalidValue);
  RebuildParams prm;
  prm.vals = static_cast<const int8_t*>(vals);
  prm.lens = static_cast<const int32_t*>(lens);
  prm.p = static_cast<const int8_t*>(p);
  prm.meta = static_cast<const int32_t*>(meta);
  prm.li = static_cast<const int32_t*>(li);
  prm.acc = static_cast<const unsigned long long*>(acc);
  prm.honest = static_cast<const int32_t*>(honest);
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.o_vals = static_cast<int8_t*>(o_vals);
  prm.o_lens = static_cast<int32_t*>(o_lens);
  prm.o_p = static_cast<int8_t*>(o_p);
  prm.o_meta = static_cast<int32_t*>(o_meta);
  prm.o_ovf = static_cast<int32_t*>(o_ovf);
  prm.clock = static_cast<long long*>(clock);
  prm.d = d;
  prm.n_trials = n_trials;
  prm.start = start;
  prm.n_dis = n_dis;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  const bool sharded = sharded_launch(n_shards, n_local, n_glob);
  const auto kernel =
      clock ? (sharded ? tiled_rebuild_kernel<true, true>
                       : tiled_rebuild_kernel<false, true>)
            : (sharded ? tiled_rebuild_kernel<true, false>
                       : tiled_rebuild_kernel<false, false>);
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem, false)) return e;
  kernel<<<n_trials * n_shards, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
