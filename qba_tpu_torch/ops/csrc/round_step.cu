// One voting round of the QBA protocol over the dense mailbox, for a
// batch of trials in one launch: every one of the n_pk = n_lieutenants x
// slots cells, sent or not; the verdict of every sent cell against every
// receiver under its corruption draws; first-accept dedup per (receiver,
// value) into the accepted sets; slot allocation per receiver with the
// overflow flag; and the whole successor mailbox, every cell written
// once (unsent cells as SENTINEL / 0).
//
// Replaces the TPU kernel qba_tpu/ops/round_kernel.py :: build_round_step
// (line 162, pallas_call at line 493), the `pallas` round engine.  The
// plain PyTorch version it is held against is
// qba_tpu_torch/ops/round_kernel.py :: round_step_reference.
//
// Design.  One thread block per trial; the phases of round_common.cuh
// separated by __syncthreads().  The mailbox is a pool whose packet pk
// sits at its own cell (meta lane 3 holds pk), so the setup, the verdict
// (phase A) and the first-accept dedup with slot allocation (phase B) are
// the device functions the pool kernels run.  The setup compacts the sent
// cells into a list in shared memory, in cell order, so the verdict's
// warps take sent cells evenly (a warp a cell, staged with cp.async one
// cell ahead) and never touch an unsent one, and the dedup walks the list
// in the same first-accept order.  What differs is the rebuild: the
// rebroadcast of receiver r in slot s goes to cell r * slots + s with no
// compaction, so a warp per live destination cell rebuilds it from its
// source packet (rebuild_entry) and the block fills each receiver's unsent
// slots, which lie together, with 16-byte stores.  The TPU kernel's
// triangular-matmul prefix count and one-hot-matmul gathers become
// popcounts and direct indexed loads: only integer compares, no dot, so
// there is no value bound to guard.  The TPU kernel donates the mailbox
// into its outputs; here warps read cells that others rewrite, so the
// caller passes two mailboxes and ping-pongs (never in place).  Its lane
// groups, tail-overlap group and `done` set fill 128 TPU lanes and have
// no counterpart.  On an NVIDIA H100 80GB HBM3 at 700 W the list and the
// shared verdict took the 33-party kernel from 1.99 to 1.07 ms (PERF.md).
//
// The party-sharded variant (the TPU kernel's n_recv build), as in
// fused_round.cu: a launch takes n_shards shards of a batch, a block per
// (shard, trial), shard-major, whose receivers are the global [start +
// shard * n_local, ...) of n_glob.  A shard drains them against its copy
// of the gathered GLOBAL mailbox (n_pk = n_glob * slots cells; unsent
// cells are skipped, whatever stale rows they hold) and writes its LOCAL
// mailbox of n_local * slots cells: local receiver r's rebroadcast in
// slot s at local cell r * slots + s, every cell's lane 3 its GLOBAL id,
// so that the segments concatenated in shard order are again a mailbox
// whose cells carry their own index.  The kernel is instantiated for one
// shard too, with the shard terms fixed at compile time (BlockAt in
// round_common.cuh): the single-device kernel.  Not ported: the compile
// probes and VMEM pre-filter, which are TPU machinery.
//
// Bound on this card: bytes.  Per trial and round: every cell's meta
// (16 B, the scan), the sent cells' valid rows, lens and P, their three
// draws per receiver, li and vi in; the whole successor mailbox (int8
// vals and P, int32 lens and meta) and vi out, live or not.  At 33
// parties / sizeL 64 / 10 dishonest the successor is 1,835,008 B per
// trial, and most rounds write nothing else.
//
// Layouts (shard- and trial-major, contiguous; B = n_shards * T): vals
// int8 [B, n_pk, max_l, S], lens int32 [B, n_pk, max_l], p int8 [B, n_pk,
// S], meta int32 [B, n_pk, 4] = (count, v, sent, cell = pk), li int32
// [B, n_local, S], vi int32 [B, n_local, w], honest int32 [T, n_pk],
// draws uint8 [T, n_pk, n_glob]; the successor mailboxes as the mailboxes
// with n_local * slots cells; n_pk = n_glob * slots.

#include "round_common.cuh"

namespace {

using namespace qba;

struct Params {
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
  int8_t* o_vals;
  int32_t* o_lens;
  int8_t* o_p;
  int32_t* o_meta;
  int32_t* o_vi;
  int32_t* o_ovf;
  long long* clock;  // the clock's instantiations only: int64 [B, kRoundPhases]
  Dims d;
  int n_trials, start, n_dis, round_idx, use_fp;
};

// One trial's mailbox: a pool in packet-major layout.
using MailIn = PoolInT<true>;
using MailOut = PoolOutT<true>;

// Block b's mailbox of n_cells cells.
__device__ inline MailIn mailbox_at(const int8_t* vals, const int32_t* lens,
                                    const int8_t* p, const int32_t* meta,
                                    size_t b, int n_cells, const Dims& d) {
  const size_t n = n_cells, S = d.size_l, max_l = d.max_l;
  return MailIn{vals + b * n * max_l * S, lens + b * n * max_l,
                p + b * n * S, meta + b * n * 4, 0};
}
__device__ inline MailOut mailbox_at(int8_t* vals, int32_t* lens, int8_t* p,
                                     int32_t* meta, size_t b, int n_cells,
                                     const Dims& d) {
  const size_t n = n_cells, S = d.size_l, max_l = d.max_l;
  return MailOut{vals + b * n * max_l * S, lens + b * n * max_l,
                 p + b * n * S, meta + b * n * 4, 0};
}

// The single-device instantiation takes the host's dims (r_off = 0 and
// n_glob = n_rv at run time, n_pk successor cells from cell 0): with the
// constants of BlockAt::dims folded in, the compiler spilled 28 bytes.
// Both ask for three blocks an SM (at most 85 registers a thread): left to
// the compiler they took 128 registers and 16% more time at 11 parties
// (PERF.md).
template <bool kSharded, bool kClock>
__global__ void __launch_bounds__(kThreads, 3)
round_step_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhaseClock<kClock, kRoundPhases> clk;
  clk.start();
  const BlockAt<kSharded> at(P.n_trials);
  const size_t b = blockIdx.x, t = at.t;
  const Dims d = kSharded ? at.dims(P.d, P.start) : P.d;
  const int n_pk = d.n_pool(), slots = d.slots;
  const int n_out = kSharded ? d.n_out() : n_pk;
  const int max_l = d.max_l, S = d.size_l;
  const Shared sh(smem_raw, d);
  const MailIn in = mailbox_at(P.vals, P.lens, P.p, P.meta, b, n_pk, d);
  const MailOut out =
      mailbox_at(P.o_vals, P.o_lens, P.o_p, P.o_meta, b, n_out, d);
  const int32_t* li = P.li + b * size_t(d.n_rv) * S;
  const int32_t* honest = P.honest + t * size_t(n_pk);
  const Draws dr = draws_at(P.attack, P.rand_v, P.late, t, d);
  const int warp = threadIdx.x >> 5;

  // Setup: vi as masks, the cells' sent and honesty bits; then the sent
  // cells' list (cell order) and the block's lists in shared memory.
  round_setup(sh, in.meta, honest, P.vi + b * size_t(d.n_rv) * d.w, li, d);
  __syncthreads();
  clk.mark(kRpSetup);
  list_sent(sh, d);
  __syncthreads();
  const int n_sent = sh.misc[0];
  clk.mark(kRpList);

  verdict_phase(sh, in, li, dr, d, n_sent, P.round_idx, P.use_fp, clk);
  __syncthreads();
  clk.mark(kRpVerdictWait);
  // Rebroadcast only while round <= n_dishonest; else every receiver's
  // slot count stays 0 and the successor is empty.
  dedup_phase(sh, dr, d, n_sent, P.round_idx <= P.n_dis);
  __syncthreads();
  clk.mark(kRpDedup);
  store_vi(sh, P.o_vi + b * size_t(d.n_rv) * d.w, d);
  if (threadIdx.x == 0) P.o_ovf[b] = sh.misc[1];
  clk.mark(kRpOffsets);

  // Rebuild: a warp per live destination cell c = receiver * slots +
  // slot of the block's receivers; then each receiver's unsent slots,
  // which are contiguous in every array, filled by the whole block.
  for (int c = warp; c < n_out; c += kWarps) {
    const int rr = c / slots, slot = c - rr * slots;
    if (slot < sh.k_cnt[rr])
      rebuild_entry(in, out, li, honest, dr, d, c, rr, slot, sh.src_list[c],
                    P.use_fp);
  }
  clk.mark(kRpRebuild);
  for (int rr = 0; rr < d.n_rv; ++rr) {
    const int first = rr * slots + sh.k_cnt[rr];
    const size_t dead = size_t(slots - sh.k_cnt[rr]);
    if (!dead) continue;
    block_fill(out.row(0, first, d), dead * max_l * S, -1);
    block_fill(reinterpret_cast<int8_t*>(out.lens + size_t(first) * max_l),
               dead * max_l * 4, 0);
    block_fill(out.p + size_t(first) * S, dead * S, 0);
  }
  const int cell0 = kSharded ? d.r_off * slots : 0;  // first global cell
  for (int c = threadIdx.x; c < n_out; c += kThreads) {
    const int rr = c / slots;
    if (c - rr * slots >= sh.k_cnt[rr])
      reinterpret_cast<int4*>(out.meta)[c] = make_int4(0, 0, 0, cell0 + c);
  }
  clk.mark(kRpFill);
  clk.store(P.clock + b * kRoundPhases);
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  n_local
// receivers a shard, n_shards shards from receiver `start` on, of n_glob.
// A non-null `clock` launches the phase clock's instantiation, which adds
// each block's cycles into it (int64 [n_shards * n_trials, kRoundPhases]).
extern "C" int qba_round_step(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* vi, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* o_vals, void* o_lens,
    void* o_p, void* o_meta, void* o_vi, void* o_ovf, void* clock,
    int n_trials,
    int n_shards, int n_local, int n_glob, int start, int slots, int max_l,
    int size_l, int w, int n_dis, int round_idx, int use_fp, void* stream) {
  if (n_trials <= 0 || n_shards <= 0) return 0;
  Dims d;
  if (!launch_dims(n_shards, n_local, n_glob, start, slots, max_l, size_l, w,
                   &d))
    return int(cudaErrorInvalidValue);
  Params prm;
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
  prm.o_vals = static_cast<int8_t*>(o_vals);
  prm.o_lens = static_cast<int32_t*>(o_lens);
  prm.o_p = static_cast<int8_t*>(o_p);
  prm.o_meta = static_cast<int32_t*>(o_meta);
  prm.o_vi = static_cast<int32_t*>(o_vi);
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
      clock ? (sharded ? round_step_kernel<true, true>
                       : round_step_kernel<false, true>)
            : (sharded ? round_step_kernel<true, false>
                       : round_step_kernel<false, false>);
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem)) return e;
  kernel<<<n_trials * n_shards, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
