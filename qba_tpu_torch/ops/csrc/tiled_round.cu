// One voting round as two launches split at the accepted matrix: the
// verdict kernel (verdict of every pool packet against every receiver,
// first-accept dedup into vi) writes acc int32 0/1 [T, n_pool, n_rv];
// the rebuild kernel reads it back and builds the successor pool.
//
// Replaces the TPU kernels qba_tpu/ops/round_kernel_tiled.py ::
// build_verdict_kernel (pallas_call at line 563) and ::
// build_rebuild_kernel (pallas_call at line 1200), the `pallas_tiled`
// engine, and their party-sharded n_recv builds.  The plain PyTorch
// versions they are held against are
// qba_tpu_torch/ops/round_kernel_tiled.py :: verdict_reference and
// :: rebuild_reference (per shard in the n_recv variant).
//
// Design.  The fused round kernel's phases (round_common.cuh), one block
// per trial, cut after phase B:
//   verdict  setup, A, B; A is the fused round's verdict over the list of
//            sent packets; B walks the packets below the scan extent (one
//            past the last sent one), writes their rows of acc, and the
//            rest of acc is zeroed.  No slots are taken.
//   rebuild  each receiver's slots come from its column of acc in
//            packet order (a warp per receiver, ballots), with the
//            overflow flag; then C, D and E as in the fused kernel.
// The TPU kernels walk a grid of pool blocks in order and carry vi
// across the steps; here a block holds a whole trial, so no carry
// crosses blocks.
//
// The party-sharded variant, as in fused_round.cu: a launch takes
// n_shards shards of a batch, a block per (shard, trial), shard-major;
// a shard's receivers are the global [start + shard * n_local, ...) of
// n_glob.  Its verdict drains them against its copy of the assembled
// pool, whose entries between the segments are unsent: phase A skips
// them and their rows of acc stay zero, so the rebuild's slot walk sees
// the accepted packets in the global (sender, slot) order the dedup
// gave them.  Its rebuild writes the shard's LOCAL successor segment
// (capacity n_local * slots, compacted, global cell ids) and reads its
// receivers' columns of the global draw tables.  Each kernel is
// instantiated for one shard too, with the shard terms fixed at compile
// time (BlockAt in round_common.cuh): the single-device kernels.
//
// Bound on this card: bytes.  The verdict reads the live packets' valid
// rows, lens, P, meta and draws, li and vi, and writes acc (4 B per
// packet and receiver) and vi.  The rebuild reads acc, the accepted
// packets' rows, li and draws, and writes the whole successor pool.
// Compared with the fused kernel the pair moves acc through HBM twice.
//
// Layouts as fused_round.cu (B = n_shards * T blocks; pool, li, vi and
// acc per block, honesty and draws per trial); acc int32 [B, n_pool,
// n_local].

#include "round_common.cuh"

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
  int32_t* o_acc;
  int32_t* o_vi;
  Dims d;
  int n_trials, start, round_idx, use_fp;
};

struct RebuildParams {
  const int8_t* vals;
  const int32_t* lens;
  const int8_t* p;
  const int32_t* meta;
  const int32_t* li;
  const int32_t* acc;
  const int32_t* honest;
  const uint8_t* attack;
  const uint8_t* rand_v;
  int8_t* o_vals;
  int32_t* o_lens;
  int8_t* o_p;
  int32_t* o_meta;
  int32_t* o_ovf;
  Dims d;
  int n_trials, start, n_dis, round_idx, use_fp;
};

// Three blocks an SM (at most 85 registers a thread), four for the rebuild
// (64), as timed side by side on the H100 (PERF.md).
template <bool kSharded>
__global__ void __launch_bounds__(kThreads, 3)
tiled_verdict_kernel(VerdictParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockAt<kSharded> at(P.n_trials);
  const size_t b = blockIdx.x, t = at.t;
  const Dims d = at.dims(P.d, P.start);
  const int n_pool = d.n_pool();
  const Shared sh(smem_raw, d);
  const PoolIn in = pool_at(P.vals, P.lens, P.p, P.meta, b, n_pool, d);
  const int32_t* li = P.li + b * size_t(d.n_rv) * d.size_l;
  const int32_t* honest = P.honest + t * size_t(n_pool);
  const Draws dr = draws_at(P.attack, P.rand_v, P.late, t, d);
  int32_t* acc = P.o_acc + b * size_t(n_pool) * d.n_rv;

  // The dedup walks cells [0, n_scan), so every cell's verdict starts 0.
  round_setup(sh, in.meta, honest, P.vi + b * size_t(d.n_rv) * d.w, li, d,
              true);
  __syncthreads();
  list_sent(sh, d);
  __syncthreads();
  const int n_sent = sh.misc[0];
  const int n_scan = n_sent ? sh.list[n_sent - 1] + 1 : 0;

  PhaseClock<false, kRoundPhases> clk;
  verdict_phase(sh, in, li, dr, d, n_sent, P.round_idx, P.use_fp, clk);
  __syncthreads();
  dedup_phase(sh, dr, d, n_scan, nullptr, false, acc);
  block_fill(reinterpret_cast<int8_t*>(acc + size_t(n_scan) * d.n_rv),
             size_t(n_pool - n_scan) * d.n_rv * 4, 0);
  __syncthreads();
  store_vi(sh, P.o_vi + b * size_t(d.n_rv) * d.w, d);
}

// The single-device instantiation takes the host's dims (r_off = 0 and
// n_glob = n_rv at run time, the successor pool's capacity n_pool): with
// the constants of BlockAt::dims folded in, the compiler took it from 64
// registers to 80 with a spill, and 12% more time at 33 parties.
template <bool kSharded>
__global__ void __launch_bounds__(kThreads, 4)
tiled_rebuild_kernel(RebuildParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  const int32_t* acc = P.acc + b * size_t(n_pool) * d.n_rv;
  // Phase D reads no late draw.
  Draws dr = draws_at(P.attack, P.rand_v, P.attack, t, d);
  dr.late = nullptr;

  if (threadIdx.x == 0) sh.misc[1] = 0;
  __syncthreads();
  slots_from_acc(sh, acc, d, n_pool, P.round_idx <= P.n_dis);
  __syncthreads();
  offsets_phase(sh.offs, sh.k_cnt, d.n_rv);
  if (threadIdx.x == 0) P.o_ovf[b] = sh.misc[1];
  __syncthreads();
  const int total = sh.offs[d.n_rv];
  rebuild_phase(sh, in, out, li, honest, dr, d, total, P.use_fp);
  fill_dead_tail(out, d, total);
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  n_local
// receivers a shard, n_shards shards from receiver `start` on, of n_glob.
extern "C" int qba_tiled_verdict(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* vi, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* o_acc, void* o_vi,
    int n_trials, int n_shards, int n_local, int n_glob, int start,
    int slots, int max_l, int size_l, int w, int round_idx, int use_fp,
    void* stream) {
  if (n_trials <= 0 || n_shards <= 0) return 0;
  Dims d;
  if (!launch_dims(n_shards, n_local, n_glob, start, slots, max_l, size_l, w,
                   &d))
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
  prm.o_acc = static_cast<int32_t*>(o_acc);
  prm.o_vi = static_cast<int32_t*>(o_vi);
  prm.d = d;
  prm.n_trials = n_trials;
  prm.start = start;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  const auto kernel = sharded_launch(n_shards, n_local, n_glob)
                          ? tiled_verdict_kernel<true>
                          : tiled_verdict_kernel<false>;
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem)) return e;
  kernel<<<n_trials * n_shards, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

// Returns a cudaError_t: 0 on a launch that was accepted.  Shards as
// qba_tiled_verdict.
extern "C" int qba_tiled_rebuild(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* acc, const void* honest, const void* attack,
    const void* rand_v, void* o_vals, void* o_lens, void* o_p, void* o_meta,
    void* o_ovf, int n_trials, int n_shards, int n_local, int n_glob,
    int start, int slots, int max_l, int size_l, int w, int n_dis,
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
  prm.acc = static_cast<const int32_t*>(acc);
  prm.honest = static_cast<const int32_t*>(honest);
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.o_vals = static_cast<int8_t*>(o_vals);
  prm.o_lens = static_cast<int32_t*>(o_lens);
  prm.o_p = static_cast<int8_t*>(o_p);
  prm.o_meta = static_cast<int32_t*>(o_meta);
  prm.o_ovf = static_cast<int32_t*>(o_ovf);
  prm.d = d;
  prm.n_trials = n_trials;
  prm.start = start;
  prm.n_dis = n_dis;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  const auto kernel = sharded_launch(n_shards, n_local, n_glob)
                          ? tiled_rebuild_kernel<true>
                          : tiled_rebuild_kernel<false>;
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem, false)) return e;
  kernel<<<n_trials * n_shards, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
