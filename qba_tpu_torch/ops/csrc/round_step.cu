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
// (phase A, a warp per sent cell; unsent cells are skipped on `sent`
// after one meta read) and the first-accept dedup with slot allocation
// (phase B, a warp per receiver, ballots and popcounts) are the device
// functions the pool kernels run.  What differs is the rebuild: the
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
// no counterpart.
//
// Not ported: the party-sharded variant (n_recv receivers from a runtime
// offset), which belongs to the mesh paths, and the compile probes and
// VMEM pre-filter, which are TPU machinery.
//
// Bound on this card: bytes.  Per trial and round: every cell's meta
// (16 B, the scan), the sent cells' valid rows, lens and P, their three
// draws per receiver, li and vi in; the whole successor mailbox (int8
// vals and P, int32 lens and meta) and vi out, live or not.  At 33
// parties / sizeL 64 / 10 dishonest the successor is 1,835,008 B per
// trial, and most rounds write nothing else.
//
// Layouts (trial-major, contiguous): vals int8 [T, n_pk, max_l, S], lens
// int32 [T, n_pk, max_l], p int8 [T, n_pk, S], meta int32 [T, n_pk, 4] =
// (count, v, sent, cell = pk), li int32 [T, n_rv, S], vi int32
// [T, n_rv, w], honest int32 [T, n_pk], draws uint8 [T, n_pk, n_rv];
// n_pk = n_rv * slots.

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
  Dims d;
  int n_dis, round_idx, use_fp;
};

// One trial's mailbox: a pool in packet-major layout.
using MailIn = PoolInT<true>;
using MailOut = PoolOutT<true>;

__device__ inline MailIn mailbox_at(const int8_t* vals, const int32_t* lens,
                                    const int8_t* p, const int32_t* meta,
                                    size_t t, const Dims& d) {
  const size_t n_pk = d.n_pool(), S = d.size_l, max_l = d.max_l;
  return MailIn{vals + t * n_pk * max_l * S, lens + t * n_pk * max_l,
                p + t * n_pk * S, meta + t * n_pk * 4, 0};
}
__device__ inline MailOut mailbox_at(int8_t* vals, int32_t* lens, int8_t* p,
                                     int32_t* meta, size_t t, const Dims& d) {
  const size_t n_pk = d.n_pool(), S = d.size_l, max_l = d.max_l;
  return MailOut{vals + t * n_pk * max_l * S, lens + t * n_pk * max_l,
                 p + t * n_pk * S, meta + t * n_pk * 4, 0};
}

__global__ void __launch_bounds__(kThreads)
round_step_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = P.d;
  const int n_pk = d.n_pool(), slots = d.slots, max_l = d.max_l;
  const int S = d.size_l;
  const Shared sh(smem_raw, d);
  const size_t t = blockIdx.x;
  const MailIn in = mailbox_at(P.vals, P.lens, P.p, P.meta, t, d);
  const MailOut out = mailbox_at(P.o_vals, P.o_lens, P.o_p, P.o_meta, t, d);
  const int32_t* li = P.li + t * size_t(d.n_rv) * S;
  const int32_t* honest = P.honest + t * size_t(n_pk);
  const Draws dr = draws_at(P.attack, P.rand_v, P.late, t, d);
  const int warp = threadIdx.x >> 5;

  // Setup: zeroed verdicts, vi as masks, one past the last sent cell.
  clear_round(sh, n_pk);
  load_vi_mask(sh, P.vi + t * size_t(d.n_rv) * d.w, d);
  __syncthreads();
  scan_extent(sh, in.meta, n_pk);
  __syncthreads();
  const int n_scan = sh.misc[0];

  verdict_phase(sh, in, li, honest, dr, d, n_scan, P.round_idx, P.use_fp);
  __syncthreads();
  // Rebroadcast only while round <= n_dishonest; else every receiver's
  // slot count stays 0 and the successor is empty.
  dedup_phase(sh, in.meta, honest, dr, d, n_scan, P.round_idx <= P.n_dis,
              nullptr);
  __syncthreads();
  store_vi(sh, P.o_vi + t * size_t(d.n_rv) * d.w, d);
  if (threadIdx.x == 0) P.o_ovf[t] = sh.misc[1];

  // Rebuild: a warp per live destination cell c = receiver * slots +
  // slot; then each receiver's unsent slots, which are contiguous in
  // every array, filled by the whole block.
  for (int c = warp; c < n_pk; c += kWarps) {
    const int rr = c / slots, slot = c - rr * slots;
    if (slot < sh.k_cnt[rr])
      rebuild_entry(in, out, li, honest, dr, d, c, rr, slot, sh.src_list[c],
                    P.use_fp);
  }
  for (int rr = 0; rr < d.n_rv; ++rr) {
    const int first = rr * slots + sh.k_cnt[rr];
    const size_t dead = size_t(slots - sh.k_cnt[rr]);
    if (!dead) continue;
    block_fill(out.row(0, first, d), dead * max_l * S, -1);
    block_fill(reinterpret_cast<int8_t*>(out.lens + size_t(first) * max_l),
               dead * max_l * 4, 0);
    block_fill(out.p + size_t(first) * S, dead * S, 0);
  }
  for (int c = threadIdx.x; c < n_pk; c += kThreads) {
    const int rr = c / slots;
    if (c - rr * slots >= sh.k_cnt[rr])
      reinterpret_cast<int4*>(out.meta)[c] = make_int4(0, 0, 0, c);
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.
extern "C" int qba_round_step(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* vi, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* o_vals, void* o_lens,
    void* o_p, void* o_meta, void* o_vi, void* o_ovf, int n_trials,
    int n_rv, int slots, int max_l, int size_l, int w, int n_dis,
    int round_idx, int use_fp, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  if (!dims_ok(d)) return int(cudaErrorInvalidValue);
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
  prm.d = d;
  prm.n_dis = n_dis;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  size_t smem = 0;
  if (int e = prepare_smem(round_step_kernel, d, &smem)) return e;
  round_step_kernel<<<n_trials, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
