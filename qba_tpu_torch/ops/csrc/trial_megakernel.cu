// A whole QBA trial in one launch: step 3a on entry, every voting round
// 1..n_dishonest+1 over ping-pong pools, and the lieutenants' decisions
// (min of the accepted set) on exit.
//
// Replaces the TPU kernel qba_tpu/ops/trial_megakernel.py ::
// build_trial_megakernel (pallas_call at line 874).  The plain PyTorch
// version it is held against is
// qba_tpu_torch/ops/trial_megakernel.py :: trial_megakernel_reference.
//
// Design.  One thread block per trial, looping over the rounds inside
// the block; trials are independent, so no grid-wide sync exists.  The
// block's layout and phases are the megakernel's own (mega_phases.cuh),
// not the per-round kernels' (round_common.cuh): its pools are private to
// the launch, so they are entry-major (a packet's meta, lens, P and rows
// one span of MegaEntry bytes), and each round runs on pool A into pool
// B, then the pointers swap; barriers between phases make one round's
// global writes visible to the next.
//   Entry  the trial's lists go to shared memory once, as int8 words of
//          four positions, position-major [sw][n_glob + 1], with the words
//          of their out-of-range positions; a warp per lieutenant decides
//          step 3a's verdict (trial_megakernel.py:328-433): consistent
//          unless a P position whose list value is not SENTINEL holds v, a
//          value > w or < 0.  vi starts as {v} for the lieutenants that
//          accept; their broadcasts are compacted into pool A at the
//          exclusive prefix count of the accepting lieutenants (a warp
//          scan; row 0 = own row, lens[0] = |P|, meta = (1, v, 1,
//          lieutenant * slots)).
//   Rounds the previous round's live total is this round's scan extent.
//          Verdict (mega_verdict): a warp a live packet, whose entry it
//          copies into shared memory with cp.async while the previous one
//          is checked; the packet's facts once, then the receivers across
//          lanes, four positions a word.  Dedup: a warp a receiver over
//          the verdict masks and each packet's cell and order, in shared
//          memory.  Offsets: a warp scan.  Rebuild (mega_rebuild): a warp
//          a successor entry, its source copied in ahead the same way,
//          turned into the successor in shared memory and written out in
//          16-byte stores.  The vi masks stay in shared memory across
//          rounds.  The last round rebroadcasts nothing, so it runs the
//          verdict and dedup only.
//   Layout entries too large for the warps' buffers (past about 400
//          positions at 33 parties on the H100) are read where they lie,
//          and each successor is written straight into the next pool
//          (choose_smem, kStaged).
//   Exit   decisions = lowest set bit of each vi mask, or w when empty.
// Nothing past a round's live total is read, and a reader reads only the
// fields the writer wrote (meta, lens, P and the rows below count).
// The block is kMegaWarps = 16 warps, two blocks an SM (64 registers a
// thread).  On an NVIDIA H100 80GB HBM3 at 700 W the parent body's
// phase clock put 71% of a 33p block in the verdict's serial receiver
// loop, 14.5% in the rebuild and 9.5% in staging (PERF.md); block shapes
// of 8 warps (three and four blocks an SM) and 12 were timed against 16
// side by side (PERF.md).
//
// Bound on this card: bytes.  The kernel must read li, P, the orders and
// the cells' honesty once, write vi, the decisions and the overflow
// flag, and per round write and read back the live pool entries and read
// the draws of the live packets' cells (three per receiver in the
// verdict, two per rebuilt entry).  A round with no live packet reads
// none of its draw slab: at 33 parties / sizeL 64 / 10 dishonest the
// stacks hold 1000 x 11 x 2048 x 32 x 3 B = 2.16 GB per 1000-trial
// batch, most of which no round reads.  The pools live in per-trial
// global scratch (at 33p one pool is 2048 entries of 896 B, far above a
// block's shared memory), so live entries make an L2/HBM round trip per
// round, one copy a packet.
//
// Layouts (trial-major, contiguous): p_rows bool [T, n_rv, S], li int32
// [T, n_rv, S], v_sent int32 [T, n_rv], honest int32 [T, n_pool], draws
// uint8 [T, n_rounds, n_pool, n_rv]; pools A and B uint8 [T, n_pool,
// MegaEntry bytes]; out vi int32 [T, n_rv, w], decisions int32 [T,
// n_rv], overflow int32 [T].
//
// The gen entry (qba_trial_megakernel_gen) is the TPU kernel's gen=True
// form (mega_gen="gf2", the prologue at trial_megakernel.py:232-324):
// the launch also generates the step-1 lists.  Its inputs replace P and
// li with the GF(2) operands: the two circuit families' affine maps
// (int32 [2, wt, n_pad], family 0 not Q-correlated, 1 Q-correlated, as
// gf2_sweep.cuh lays them out), qcorr bool [T, S], coins and mflip uint8
// [T, S, total], r_q and r_nq uint8 [T, S, 2 total].  Its plain version
// is qba_tpu_torch/ops/trial_megakernel.py ::
// trial_megakernel_gen_reference.
//   Prologue  the block's warps take the trial's size_l shots in turn.
//             A warp evaluates the shot's outcomes with shot_bits
//             (gf2_sweep.cuh, the function the standalone sweep kernel
//             runs) on its family's map (by qcorr) and phases, the
//             readout flips XORed, packs them into words held a word a
//             lane, decodes each party's n_qubits bits big-endian into
//             its order value (lanes over the parties, the words by
//             shuffles) and writes the lieutenants' li and P (the QSD's
//             value differs from the commander's, and the commander's is
//             the order sent) to per-trial global scratch.
//             __syncthreads(), then the body above runs unchanged on that
//             scratch.  The maps are read where they lie (L1 and L2 hold
//             them), so the prologue takes no shared memory and the block
//             keeps the body's footprint.
// Bound of the prologue: as the sweep (gf2_sweep.cuh); its bytes are the
// operands, read once, and the maps.
//
// The party-sharded entry (qba_sharded_trial_megakernel) replaces the TPU
// kernel qba_tpu/ops/trial_megakernel.py :: build_sharded_trial_megakernel
// (pallas_call at line 1526).  Its plain PyTorch version is
// qba_tpu_torch/ops/trial_megakernel.py ::
// sharded_trial_megakernel_reference.
//   Grid   one thread-block cluster of n_tp blocks per trial; block rank
//          s drains the trial's receivers [s * n_local, (s + 1) *
//          n_local) (n_local = n_rv / n_tp), so a trial's receivers
//          spread over n_tp SMs that the hardware schedules together.
//          Each block runs the body above at n_rv = n_local with global
//          cell ids ((s * n_local + r) * slots + slot), so the draws and
//          the sender algebra are the single-device kernel's.
//   Verdict the blocks split the round's packets, not its receivers:
//          block s checks the packets pk with pk % n_tp == s against every
//          receiver of the trial (each block holds every receiver's
//          lists), then after a cluster barrier copies the others' verdict
//          masks and packet infos through distributed shared memory
//          (gather_verdicts), and its dedup and rebuild serve its own
//          receivers.  Each block so stages and checks 1 / n_tp of the
//          packets where it used to stage all of them for n_local
//          receivers: on an NVIDIA H100 80GB HBM3 at 700 W, 4.45 -> 3.03
//          ms at 33p, tp = 4, and faster than the receiver split at 11p,
//          tp = 2 (PERF.md).
//   Pools  ONE assembled pool pair per trial, as the single-device
//          kernel, not n_tp copies.  The TPU kernel keeps a local
//          segment and an assembled copy on every chip and moves the
//          segments by remote DMA in the round loop (trial_megakernel.py
//          :1191-1247), because chips do not share memory.  The blocks of
//          a cluster share the card's memory, so the exchange is a
//          barrier: each block publishes its live count in shared memory,
//          meets the others at a cluster barrier, reads their counts
//          through distributed shared memory, and writes its rebuilt
//          entries straight into the next pool at the exclusive prefix of
//          the lower ranks' counts; a fence and a second cluster barrier
//          (release and acquire at cluster scope) make those global
//          writes visible to the whole cluster before the next round.
//   Order  the next pool is therefore the single-device kernel's
//          globally compacted pool, entry for entry: every block scans the
//          live rows [0, sum of the counts) in (sender, slot) order, never
//          a stale row of an earlier round (the dead tail is still not
//          filled), and the dedup's first-accept order is the single-device
//          one.  Step 3a's broadcasts are compacted the same way.
//   Launch cudaLaunchKernelEx with a cluster dimension of n_tp (at most
//          8, the portable size); a refused launch returns its error.
// Bound: bytes, as the single-device kernel (one assembled pool per trial;
// each block reads its receivers' columns of the draws).
//
// The keyed entries (qba_trial_megakernel_keyed, qba_trial_megakernel_gen_
// keyed, qba_sharded_trial_megakernel_keyed; template flag kKeyed) take
// no draw stacks.  They take each trial's rounds key (k_rounds int64 [T,
// 2]), the collude target (int32 [T], strategy collude) and the round law
// (strategy, scope, delivery, float32 p_late), and hash each draw where a
// phase reads it (draws.cuh), the counterpart of the TPU kernel reading
// its round's slab of the XLA-drawn stack.  The phases read their draws
// through a source (round_common.cuh): the stacked source loads a table
// entry, the hashed one (HashedDraws below) runs threefry2x32 on the
// entry's flat index.  Three lanes of warp 1 derive a round's attack,
// late and adapt keys into shared memory during the round before (while
// warp 0 scans the offsets; two sets of words alternate), beside the
// trial's collude target and orders (adaptive forges from the sender's
// order, any sender of the trial, so a sharded block keeps all of them).
// The verdict, a warp per live packet reading the packet's draws for
// every receiver, first fills the warp's row in shared memory: a lane a
// receiver (two past 32) hashes the cell's attack word, and under racy
// delivery its late word, so the receivers' checks read bytes, not hash
// chains.  Under attack_scope="broadcast" the row's scan
// over the receivers rv' <= rv (skipping the sender) is three ballots a
// slot of 32 receivers and a shuffle for the last forge's order
// (draws.cuh :: broadcast_step, which the draws kernel runs too).  The
// dedup's and the rebuild's single reads hash their entry alone, walking
// the cell's receivers downwards under the broadcast scope until the
// last forge and both clears are found (scanned_attack).  Only a
// dishonest sender's entry hashes its attack word; under sync delivery
// no late word is hashed.  On the H100 the row took the 33p keyed
// megakernel from 11.27 ms (each read hashing alone) to 9.99-10.11,
// level with the stacked entry's 9.87-10.20, and the broadcast scope
// from 8.70 to 5.17-5.43 (PERF.md).
// Each keyed entry is instantiated for both of JAX's threefry modes
// (template flag kLegacy, draws.cuh :: bits_at; the C entries' `legacy`):
// the legacy form pairs the entries of a round's whole [n_pool, n_glob]
// table, so a shard's or a walk's hash takes the table's size, and still
// hashes each entry once.  The phase clock is the partitionable form's.
// Bound of the keyed entries: the larger of the bytes above without the
// draws and the operations of the hashes the trial reads, each entry once
// (about 80 a hash); the dedup's and rebuild's hashes of entries the
// verdict's row hashed already are this design's own work.

#include <cooperative_groups.h>

#include <cstring>

#include "draws.cuh"
#include "gf2_sweep.cuh"
#include "mega_phases.cuh"
#include "round_common.cuh"

namespace {

using namespace qba;
namespace cg = cooperative_groups;

// The gen entry's operands and scratch.
struct GenParams {
  const uint32_t* tables;  // the families' maps, [2, wt, n_pad]
  const uint8_t* qcorr;
  const uint8_t* coins;
  const uint8_t* r_q;
  const uint8_t* r_nq;
  const uint8_t* mflip;
  uint8_t* p_scr;
  int32_t* li_scr;
  int total, nq;
};

struct Params {
  const uint8_t* p_rows;
  const int32_t* li;
  const int32_t* v_sent;
  const int32_t* honest;
  const uint8_t* attack;
  const uint8_t* rand_v;
  const uint8_t* late;
  unsigned char* pool_a;  // the ping-pong pools, MegaEntry-major
  unsigned char* pool_b;
  int32_t* o_vi;
  int32_t* o_dec;
  int32_t* o_ovf;
  Dims d;
  int n_rounds, n_dis, use_fp;
  int n_tp;  // blocks a trial: 1, or the cluster of the sharded entry
  GenParams g;
  // The keyed entries: the trials' rounds keys, the strategy's context
  // (collude targets [T], adaptive's orders [T, n_glob]) and the round law.
  const int64_t* k_rounds;
  const int32_t* collude;
  const int32_t* orders;
  int strategy, broadcast, racy, n_mod, legacy;
  float p32;
  // The phase clock's int64 [T * n_tp, kPhases] (kClock instantiations).
  long long* clock;
};

// The keyed entries' shared words, past the body's shared memory: an odd
// round's attack, late and adapt keys, the trial's collude target, its
// orders [n_glob] (adaptive), then an even round's keys (a round's keys
// are derived during the round before, keys_of).  After them each warp's
// draw row: the attack bits, forged orders and late flags of one cell by
// global receiver, uint8 [3][64].
constexpr int kDrawWords = 8 + 64 + 8;
constexpr int kWordCollude = 6, kWordOrders = 8, kWordEvenKeys = 72;
constexpr int kRowBytes = 3 * 64;

// One hashed draw: the attack bits and the forged order (0 without the
// forge bit).
struct HashedDraw {
  int attack, v;
  __device__ int rand_v() const { return v; }
};

// A warp's draw row in shared memory (kRowBytes).
struct HashedRow {
  const uint8_t* p;
};

// The keyed entries' draw source (the phases' other source is the stacked
// Draws of round_common.cuh): entry (cell, rv) of the block hashes the
// global flat index cell * n_glob + r_off + rv on the round's streams.
// The verdict's row hashes a cell's receivers a lane each, and under the
// broadcast scope scans them with ballots; the dedup's and rebuild's
// single reads hash (and walk) the entry alone.  kLegacy: JAX's legacy
// threefry mode, whose hashes take the round's table size (n_tab).
template <bool kLegacy>
struct HashedDraws {
  const uint32_t* s;  // the shared words above
  const uint32_t* k;  // the round's keys among them (keys_of)
  uint8_t* rows;      // the warps' draw rows
  int strategy, n_mod, w, slots;
  bool late_phase, broadcast, racy;
  float p32;
  // Entries of a round's table, [n_pool, n_glob] (read by kLegacy only).
  __device__ uint32_t n_tab(const Dims& d) const {
    return uint32_t(d.n_glob) * uint32_t(slots) * uint32_t(d.n_glob);
  }
  // Cell `cell`'s row, by the whole warp: lane j takes the global
  // receivers j and j + 32.
  __device__ HashedRow row(const Dims& d, int cell, bool biz) const {
    using namespace qba_draws;
    const int lane = threadIdx.x & 31, n = d.n_glob;
    uint8_t* p = rows + (threadIdx.x >> 5) * kRowBytes;
    const uint32_t base = uint32_t(cell) * uint32_t(n);
    const Key attack{k[0], k[1]}, late{k[2], k[3]};
    uint32_t b[2] = {0u, 0u};
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      if (q >= n) continue;
      if (biz) b[k] = bits_at<kLegacy>(attack, base + uint32_t(q), n_tab(d));
      p[128 + q] = uint8_t(
          racy && late_at<kLegacy>(late, base + uint32_t(q), p32, n_tab(d)));
    }
    if (biz && broadcast) {
      // Receiver q's scan covers receivers 0..q other than the sender.
      BroadcastScan sc;
      for (int k = 0; k < 2; ++k) {
        const int q = lane + 32 * k;
        int v;
        const int att =
            broadcast_step(b[k], q, n, cell / slots, n_mod, k == 0, sc, &v);
        if (q >= n) continue;
        p[q] = uint8_t(att);
        p[64 + q] = uint8_t(att & kForgeBit ? v : 0);
      }
    } else {
      for (int k = 0; k < 2; ++k) {
        const int q = lane + 32 * k;
        if (q >= n) continue;
        int att = 0, v = 0;
        if (biz) {
          att = attack_bits(b[k], strategy, late_phase);
          if (att & kForgeBit)
            v = forged(b[k], base + uint32_t(q), cell, n_tab(d));
        }
        p[q] = uint8_t(att);
        p[64 + q] = uint8_t(v);
      }
    }
    __syncwarp();
    return HashedRow{p};
  }
  __device__ HashedDraw draw(HashedRow r, const Dims& d, int, int rv,
                             bool) const {
    const int g = d.r_off + rv;
    return HashedDraw{r.p[g], r.p[64 + g]};
  }
  __device__ bool is_late(HashedRow r, const Dims& d, int, int rv) const {
    return r.p[128 + d.r_off + rv] != 0;
  }
  // The forged order of attack word b at flat index i of a table of n
  // entries (delivery scope).
  __device__ int forged(uint32_t b, uint32_t i, int cell, uint32_t n) const {
    using namespace qba_draws;
    if (strategy == kCollude) return int(s[kWordCollude]);
    if (strategy == kAdaptive)
      return adaptive_rand_v<kLegacy>(Key{k[4], k[5]}, i,
                                      int(s[kWordOrders + cell / slots]), w,
                                      n);
    return raw_rand_v(b, n_mod);
  }
  __device__ HashedDraw draw(const Dims& d, int cell, int rv,
                             bool biz) const {
    using namespace qba_draws;
    if (!biz) return HashedDraw{0, 0};
    const Key attack{k[0], k[1]};
    const int g = d.r_off + rv;
    const uint32_t base = uint32_t(cell) * uint32_t(d.n_glob);
    const uint32_t n = n_tab(d);
    const uint32_t b = bits_at<kLegacy>(attack, base + uint32_t(g), n);
    int v = 0;
    if (broadcast)
      return HashedDraw{scanned_attack<kLegacy>(attack, base, g, cell / slots,
                                                b, n_mod, &v, n), v};
    const int att = attack_bits(b, strategy, late_phase);
    if (att & kForgeBit) v = forged(b, base + uint32_t(g), cell, n);
    return HashedDraw{att, v};
  }
  __device__ bool is_late(const Dims& d, int cell, int rv) const {
    return racy && qba_draws::late_at<kLegacy>(
        qba_draws::Key{k[2], k[3]},
        uint32_t(cell) * uint32_t(d.n_glob) + uint32_t(d.r_off + rv), p32,
        n_tab(d));
  }
};

// Round r's keys among the shared words: odd rounds' first, even rounds'
// past the orders, so that round r + 1's are derived during round r.
__device__ inline uint32_t* keys_of(uint32_t* s, int r) {
  return s + (r & 1 ? 0 : kWordEvenKeys);
}

// Key i (0 attack, 1 late, 2 adapt) of round r of trial t,
// fold_in(fold_in(k_rounds[t], r), tag), into keys_of(s, r).  Three lanes
// derive a round's keys; the caller synchronises before they are read.
__device__ inline void round_keys(const Params& P, size_t t, int r,
                                  uint32_t* s, int i) {
  using namespace qba_draws;
  const uint32_t tag = i == 0 ? kAttackTag : i == 1 ? kLateTag : kAdaptTag;
  const Key trial{uint32_t(P.k_rounds[2 * t]), uint32_t(P.k_rounds[2 * t + 1])};
  const Key k = fold_in(fold_in(trial, uint32_t(r)), tag);
  keys_of(s, r)[2 * i] = k.k0;
  keys_of(s, r)[2 * i + 1] = k.k1;
}

// Round r's draw source: hashed (kKeyed, in the mode kLegacy) or the
// stacked slab.
template <bool kKeyed, bool kLegacy>
__device__ inline auto round_draws(const Params& P, size_t t, int r,
                                   const Dims& d, uint32_t* s) {
  if constexpr (kKeyed) {
    return HashedDraws<kLegacy>{s, keys_of(s, r),
                       reinterpret_cast<uint8_t*>(s + kDrawWords),
                       P.strategy, P.n_mod, d.w, d.slots,
                       2 * r > P.n_rounds, P.broadcast != 0, P.racy != 0,
                       P.p32};
  } else {
    return draws_at(P.attack, P.rand_v, P.late,
                    t * size_t(P.n_rounds) + (r - 1), d);
  }
}

// The party-sharded exchange.  Every block of the trial's cluster
// publishes `mine` (its live count), meets the others at a cluster
// barrier and reads their counts through distributed shared memory:
// misc[3] is the sum of the lower ranks' counts, misc[4] of all.  The
// caller reads both after this returns.
__device__ void cluster_counts(int* misc, int mine, int n_tp) {
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) misc[2] = mine;
  cl.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, rank = int(cl.block_rank());
    const int c = lane < n_tp ? *cl.map_shared_rank(&misc[2], lane) : 0;
    const int below = __reduce_add_sync(kFull, lane < rank ? c : 0);
    const int all = __reduce_add_sync(kFull, c);
    if (lane == 0) {
      misc[3] = below;
      misc[4] = all;
    }
  }
  __syncthreads();
}

// The sharded verdict's exchange: each block of the cluster checked the
// packets pk with pk % n_tp == its rank against every receiver; after a
// cluster barrier every block copies the other blocks' verdict masks and
// packet infos through distributed shared memory, so that its dedup reads
// every packet's locally.  The owners do not write these words again
// before the round's later cluster barriers.
__device__ void gather_verdicts(const MegaShared& sh, int n_scan, int rank,
                                int n_tp) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int pk = threadIdx.x; pk < n_scan; pk += kMegaThreads) {
    const int owner = pk % n_tp;
    if (owner == rank) continue;
    sh.ok_mask[pk] = *cl.map_shared_rank(sh.ok_mask + pk, owner);
    sh.info[pk] = *cl.map_shared_rank(sh.info + pk, owner);
  }
  __syncthreads();
}

// The end of a pool write: the block's global writes become visible to
// the trial's other blocks (kSharded) or to its own threads.
template <bool kSharded>
__device__ inline void pool_written() {
  if constexpr (kSharded) {
    __threadfence();
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Output chunks a lane evaluates at once in the gen prologue: 256 qubits
// a pass (65 parties take two).
constexpr int kGenChunks = 8;

// The gen prologue: trial t's lists from its GF(2) operands, into the
// scratch P and li the body reads.
__device__ void gen_prologue(const Params& P, size_t t) {
  const GenParams& g = P.g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = P.d.size_l, n_rv = P.d.n_rv, T = g.total;
  const int nq = g.nq, n_groups = n_rv + 2;
  const qba_gf2::AffineDims ad = qba_gf2::affine_dims(T);
  const size_t tab_words = size_t(ad.wt) * ad.n_pad;
  const int chunks = ad.n_pad / 32;
  int32_t* li = g.li_scr + t * size_t(n_rv) * S;
  uint8_t* pr = g.p_scr + t * size_t(n_rv) * S;
  const int32_t* v_sent = P.v_sent + t * size_t(n_rv);
  for (int s = warp; s < S; s += kMegaWarps) {
    const size_t shot = t * S + s;
    const bool q = g.qcorr[shot] != 0;
    // The shot's outcome bits 32c..32c+31 in lane c's word.
    uint32_t word = 0;
    for (int c0 = 0; c0 < chunks; c0 += kGenChunks) {
      unsigned bit[kGenChunks];
      qba_gf2::shot_bits<kGenChunks>(
          g.tables + (q ? tab_words : 0), ad,
          (q ? g.r_q : g.r_nq) + shot * 2 * T, g.coins + shot * T,
          g.mflip + shot * T, c0, bit);
#pragma unroll
      for (int c = 0; c < kGenChunks; ++c) {
        const uint32_t w = __ballot_sync(kFull, bit[c]);
        if (lane == c0 + c) word = w;
      }
    }
    int l0 = 0, l1 = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      const int grp = g0 + lane;
      // A party's n_qubits bits span at most two words.
      const int first = (grp < n_groups ? grp : 0) * nq;
      const uint32_t w0 = __shfl_sync(kFull, word, first >> 5);
      const uint32_t w1 = __shfl_sync(kFull, word, (first + nq - 1) >> 5);
      int v = 0;
      for (int j = 0; j < nq; ++j) {
        const int i = first + j;
        const uint32_t w = (i >> 5) == (first >> 5) ? w0 : w1;
        v = (v << 1) | int((w >> (i & 31)) & 1u);
      }
      if (g0 == 0) {
        l0 = __shfl_sync(kFull, v, 0);
        l1 = __shfl_sync(kFull, v, 1);
      }
      if (grp >= 2 && grp < n_groups) {
        li[size_t(grp - 2) * S + s] = v;
        pr[size_t(grp - 2) * S + s] = l0 != l1 && l1 == v_sent[grp - 2];
      }
    }
    __syncwarp();
  }
}

// kMegaBlocks blocks of kMegaWarps warps an SM (mega_phases.cuh): left to
// itself the compiler takes more registers than that allows.  kGen selects
// the gen entry; the host-gen instantiation has no prologue.  kSharded
// selects the party-sharded entry: a cluster of P.n_tp blocks a trial.
// kKeyed selects the keyed entries, which hash their draws; kStaged the
// layout (choose_smem: entries staged through the warps' buffers, or read
// where they lie); kClock the phase clock (mega_phases.cuh); kLegacy the
// keyed entries' legacy threefry mode.
template <bool kGen, bool kSharded, bool kKeyed, bool kStaged,
          bool kClock = false, bool kLegacy = false>
__global__ void __launch_bounds__(kMegaThreads, kMegaBlocks)
trial_megakernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MegaClock<kClock> clk;
  clk.start();
  Dims d = P.d;
  const int n_rv = d.n_rv, S = d.size_l, w = d.w, n_glob = d.n_glob;
  const int n_pool = d.n_pool();
  size_t t = blockIdx.x;
  int rank = 0;
  if constexpr (kSharded) {
    rank = int(cg::this_cluster().block_rank());
    t = blockIdx.x / P.n_tp;
    d.r_off = rank * n_rv;
  }
  const MegaShared sh(smem_raw, d, kStaged);
  // The block's receivers' rows of the trial's [n_glob, ...] inputs.
  const size_t row0 = t * size_t(n_glob) + d.r_off;
  const uint8_t* p_rows;
  const int32_t* li_all;  // the trial's lists, every receiver's
  if constexpr (kGen) {
    gen_prologue(P, t);
    __syncthreads();
    clk.mark(kPhGen);
    p_rows = P.g.p_scr + row0 * S;
    li_all = P.g.li_scr + t * size_t(n_glob) * S;
  } else {
    p_rows = P.p_rows + row0 * S;
    li_all = P.li + t * size_t(n_glob) * S;
  }
  // The verdict's receivers: a cluster's blocks split the packets, each
  // checking them against every receiver of the trial.
  Dims dx = d;
  dx.r_off = 0;
  dx.n_rv = n_glob;
  const int32_t* v_sent = P.v_sent + row0;
  const size_t pool_bytes = size_t(n_pool) * sh.E.bytes;
  unsigned char* pa = P.pool_a + t * pool_bytes;
  unsigned char* pb = P.pool_b + t * pool_bytes;
  uint32_t* s_draw = nullptr;
  if constexpr (kKeyed) {
    s_draw = reinterpret_cast<uint32_t*>(smem_raw + sh.L.total);
    if (P.orders)
      for (int i = threadIdx.x; i < n_glob; i += kMegaThreads)
        s_draw[kWordOrders + i] = uint32_t(P.orders[t * size_t(n_glob) + i]);
    if (threadIdx.x == 0)
      s_draw[kWordCollude] = P.collude ? uint32_t(P.collude[t]) : 0u;
    // Round 1's keys (the entry's barriers order them before the verdict).
    if (threadIdx.x >= 32 && threadIdx.x < 35)
      round_keys(P, t, 1, s_draw, threadIdx.x - 32);
  }
  if (threadIdx.x == 0) sh.misc[1] = 0;

  // ---- Entry: the lists into shared memory, step 3a's verdict per
  // lieutenant, its broadcasts compacted into pool A at the exclusive
  // prefix count of the accepting lieutenants. ----
  mega_entry(sh, p_rows, li_all, v_sent, P.honest + t * size_t(n_pool), d);
  __syncthreads();
  offsets_phase(sh.offs, sh.k_cnt, n_rv);
  __syncthreads();
  int base = 0, n_scan = sh.offs[n_rv];
  if constexpr (kSharded) {
    cluster_counts(sh.misc, n_scan, P.n_tp);
    base = sh.misc[3];
    n_scan = sh.misc[4];
  }
  mega_compact(sh, pa, p_rows, v_sent, d, base);
  pool_written<kSharded>();
  clk.mark(kPhEntry);

  // ---- Rounds 1..n_dis+1, pool A -> pool B. ----
  for (int r = 1; r <= P.n_rounds; ++r) {
    clk.mark(kPhClear);
    const auto dr = round_draws<kKeyed, kLegacy>(P, t, r, d, s_draw);
    const bool rebroadcast = r <= P.n_dis;
    mega_verdict<kStaged>(sh, pa, li_all,
                          round_draws<kKeyed, kLegacy>(P, t, r, dx, s_draw),
                          dx,
                          n_scan, r, P.use_fp, clk, rank, P.n_tp);
    if constexpr (kSharded) {
      gather_verdicts(sh, n_scan, rank, P.n_tp);
    } else {
      __syncthreads();
    }
    clk.mark(kPhVerdictWait);
    mega_dedup(sh, dr, d, n_scan, rebroadcast);
    __syncthreads();
    clk.mark(kPhDedup);
    if (!rebroadcast) break;  // the last round builds no successor
    offsets_phase(sh.offs, sh.k_cnt, n_rv);
    if constexpr (kKeyed) {
      // Warp 1 derives the next round's keys while warp 0 scans; round
      // r - 1, the last reader of their words, is past its barriers.
      if (threadIdx.x >= 32 && threadIdx.x < 35)
        round_keys(P, t, r + 1, s_draw, threadIdx.x - 32);
    }
    __syncthreads();
    clk.mark(kPhOffsets);
    const int total = sh.offs[n_rv];
    int first = 0, next_scan = total;
    if constexpr (kSharded) {
      cluster_counts(sh.misc, total, P.n_tp);
      first = sh.misc[3];
      next_scan = sh.misc[4];
      clk.mark(kPhExchange);
    }
    unsigned char* out = pb + size_t(first) * sh.E.bytes;
    mega_rebuild<kStaged>(sh, pa, out, dr, d, total, P.use_fp, clk);
    clk.mark(kPhRebuild);
    pool_written<kSharded>();
    clk.mark(kPhWritten);
    unsigned char* next = pb;
    pb = pa;
    pa = next;
    n_scan = next_scan;
  }

  // ---- Exit: vi, min(vi) per lieutenant, overflow. ----
  int32_t* o_vi = P.o_vi + row0 * w;
  for (int i = threadIdx.x; i < n_rv * w; i += kMegaThreads) {
    const int rv = i / w, x = i - rv * w;
    o_vi[i] = int32_t((sh.vi_mask[rv] >> x) & 1ull);
  }
  for (int rv = threadIdx.x; rv < n_rv; rv += kMegaThreads) {
    const unsigned long long m = sh.vi_mask[rv];
    P.o_dec[row0 + rv] = m ? __ffsll(static_cast<long long>(m)) - 1 : w;
  }
  if (threadIdx.x == 0) P.o_ovf[t * P.n_tp + rank] = sh.misc[1];
  // No block leaves while another may still read its shared memory.
  if constexpr (kSharded) cg::this_cluster().sync();
  clk.mark(kPhExit);
  if constexpr (kClock) clk.store(P.clock + (t * P.n_tp + rank) * kPhases);
}

}  // namespace

// ---- Host side. ----

namespace {

// The body's pools (uint8 [T, n_pool, MegaEntry bytes] each, scratch whose
// contents on entry are ignored), outputs and sizes.
void set_body(Params* p, void* pool_a, void* pool_b, void* o_vi, void* o_dec,
              void* o_ovf, const Dims& d, int n_dis, int use_fp, int n_tp) {
  p->pool_a = static_cast<unsigned char*>(pool_a);
  p->pool_b = static_cast<unsigned char*>(pool_b);
  p->o_vi = static_cast<int32_t*>(o_vi);
  p->o_dec = static_cast<int32_t*>(o_dec);
  p->o_ovf = static_cast<int32_t*>(o_ovf);
  p->d = d;
  p->n_rounds = n_dis + 1;
  p->n_dis = n_dis;
  p->use_fp = use_fp;
  p->n_tp = n_tp;
}

// The stacked entries' draw tables.
void set_stacks(Params* p, const void* attack, const void* rand_v,
                const void* late) {
  p->attack = static_cast<const uint8_t*>(attack);
  p->rand_v = static_cast<const uint8_t*>(rand_v);
  p->late = static_cast<const uint8_t*>(late);
}

// The keyed entries' keys, context and round law, or false where the
// kernels do not take it (draws.cuh's strategy codes; broadcast only for
// the reference strategy; collude needs its targets, adaptive its orders).
bool set_law(Params* p, const void* k_rounds, const void* collude,
             const void* orders, int strategy, int broadcast, int racy,
             int p32_bits, int n_mod, int legacy) {
  using namespace qba_draws;
  if (!k_rounds || strategy < kReference || strategy > kSplit ||
      (broadcast && strategy != kReference) ||
      (strategy == kCollude && !collude) ||
      (strategy == kAdaptive && !orders) || n_mod < 1 || n_mod > 256 ||
      legacy < 0 || legacy > 1)
    return false;
  p->legacy = legacy;
  p->k_rounds = static_cast<const int64_t*>(k_rounds);
  p->collude = static_cast<const int32_t*>(collude);
  p->orders = static_cast<const int32_t*>(orders);
  p->strategy = strategy;
  p->broadcast = broadcast;
  p->racy = racy;
  p->n_mod = n_mod;
  std::memcpy(&p->p32, &p32_bits, sizeof(float));
  return true;
}

// The gen entry's operands and scratch, or false where the sizes are not
// its own (a shot's outcome words are held a word a lane: at most 1024
// qubits).
bool set_gen(Params* p, const void* tables, const void* qcorr,
             const void* coins, const void* r_q, const void* r_nq,
             const void* mflip, void* p_scr, void* li_scr, int n_rv,
             int total, int n_qubits) {
  if (total != (n_rv + 2) * n_qubits || total > 32 * 32 || n_qubits > 32)
    return false;
  p->g = GenParams{static_cast<const uint32_t*>(tables),
                   static_cast<const uint8_t*>(qcorr),
                   static_cast<const uint8_t*>(coins),
                   static_cast<const uint8_t*>(r_q),
                   static_cast<const uint8_t*>(r_nq),
                   static_cast<const uint8_t*>(mflip),
                   static_cast<uint8_t*>(p_scr),
                   static_cast<int32_t*>(li_scr),
                   total, n_qubits};
  return true;
}

// Dynamic shared memory of an instantiation: the body's, and the keyed
// entries' words.
template <bool kKeyed>
size_t smem_bytes(const Dims& d, bool staged) {
  return MegaSmem(d, staged).total +
         (kKeyed ? sizeof(uint32_t) * kDrawWords + kMegaWarps * kRowBytes : 0);
}

// A launch's layout: the entries staged through the warps' buffers where
// that fits the card's limit for one block (on the H100 up to about 400
// positions at 33 parties), else read where they lie; its shared memory.
template <bool kKeyed>
size_t choose_smem(const Dims& d, bool* staged) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  *staged = smem_bytes<kKeyed>(d, true) <= size_t(limit);
  return smem_bytes<kKeyed>(d, *staged);
}

// The instantiation of a launch: its layout, the phase clock's form where
// a clock buffer is given (staged layouts only) and, for a keyed entry,
// the legacy threefry mode's form where `legacy` is set.
template <bool kGen, bool kSharded, bool kKeyed>
auto megakernel_for(bool staged, bool clock, bool legacy = false) {
  auto kernel = staged ? trial_megakernel<kGen, kSharded, kKeyed, true>
                       : trial_megakernel<kGen, kSharded, kKeyed, false>;
  if constexpr (kKeyed) {
    if (legacy)
      kernel = staged
          ? trial_megakernel<kGen, kSharded, true, true, false, true>
          : trial_megakernel<kGen, kSharded, true, false, false, true>;
    else if (clock && staged)
      kernel = trial_megakernel<kGen, kSharded, true, true, true>;
  }
  return kernel;
}

// Raise a kernel's dynamic shared-memory limit past 48 KB where needed.
int raise_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// One block a trial; with a clock buffer, the kClock instantiation.
template <bool kGen, bool kKeyed>
int launch_single(const Params& prm, int n_trials, void* stream) {
  bool staged;
  const size_t smem = choose_smem<kKeyed>(prm.d, &staged);
  if (prm.clock && (!staged || prm.legacy)) return int(cudaErrorInvalidValue);
  auto kernel =
      megakernel_for<kGen, false, kKeyed>(staged, prm.clock, prm.legacy);
  if (int e = raise_smem(reinterpret_cast<const void*>(kernel), smem))
    return e;
  kernel<<<n_trials, kMegaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prm);
  return int(cudaGetLastError());
}

// The sharded entry's launch: n_trials clusters of n_tp blocks.
cudaLaunchConfig_t sharded_config(int n_trials, int n_tp, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_trials) * unsigned(n_tp));
  cfg.blockDim = dim3(kMegaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(n_tp);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A cluster of n_tp blocks a trial; a refused launch returns its error.
template <bool kKeyed>
int launch_sharded(const Params& prm, int n_trials, void* stream) {
  bool staged;
  const size_t smem = choose_smem<kKeyed>(prm.d, &staged);
  if (prm.clock && (!staged || prm.legacy)) return int(cudaErrorInvalidValue);
  auto kernel =
      megakernel_for<false, true, kKeyed>(staged, prm.clock, prm.legacy);
  if (int e = raise_smem(reinterpret_cast<const void*>(kernel), smem))
    return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sharded_config(
      n_trials, prm.n_tp, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, prm);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// The sharded entry's sizes, or false when they are not its shapes: a
// cluster of 1 to 8 blocks (the portable size) that splits n_rv evenly.
bool sharded_dims(int n_tp, int n_rv, int slots, int max_l, int size_l,
                  int w, Dims* d) {
  if (n_tp < 1 || n_tp > 8 || n_rv % n_tp != 0) return false;
  *d = Dims{n_rv / n_tp, slots, max_l, size_l, w, 0, n_rv};
  return dims_ok(*d);
}

}  // namespace

// Each entry returns a cudaError_t: 0 on a launch that was accepted.
// Pools A and B are scratch, uint8 [T, n_pool, MegaEntry bytes] each
// (mega_phases.cuh).  The keyed entries' `clock`, when not null, is the
// phase clock's int64 [T * n_tp, kPhases] and launches its instantiation.

// The host-gen entry on stacked draws.
extern "C" int qba_trial_megakernel(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* attack, const void* rand_v,
    const void* late, void* pool_a, void* pool_b, void* o_vi,
    void* o_dec, void* o_ovf, int n_trials, int n_rv, int slots, int max_l,
    int size_l, int w, int n_dis, int use_fp, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  if (!dims_ok(d) || n_dis < 0) return int(cudaErrorInvalidValue);
  Params prm = {};
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_stacks(&prm, attack, rand_v, late);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  return launch_single<false, false>(prm, n_trials, stream);
}

// The host-gen entry, keyed: k_rounds int64 [T, 2], collude int32 [T]
// (strategy collude, else null) and orders int32 [T, n_rv] (strategy
// adaptive, else null) in place of the stacks.
extern "C" int qba_trial_megakernel_keyed(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* k_rounds, const void* collude,
    const void* orders, void* pool_a, void* pool_b, void* o_vi,
    void* o_dec, void* o_ovf, void* clock, int n_trials, int n_rv, int slots,
    int max_l, int size_l,
    int w, int n_dis, int use_fp, int strategy, int broadcast, int racy,
    int p32_bits, int n_mod, int legacy, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod, legacy))
    return int(cudaErrorInvalidValue);
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  prm.clock = static_cast<long long*>(clock);
  return launch_single<false, true>(prm, n_trials, stream);
}

// The gen entry: the GF(2) operands in place of p_rows and li, which the
// prologue writes to p_scr and li_scr.
extern "C" int qba_trial_megakernel_gen(
    const void* tables, const void* qcorr, const void* coins,
    const void* r_q, const void* r_nq, const void* mflip, void* p_scr,
    void* li_scr, const void* v_sent, const void* honest,
    const void* attack, const void* rand_v, const void* late, void* pool_a,
    void* pool_b, void* o_vi, void* o_dec, void* o_ovf, int n_trials,
    int n_rv, int slots, int max_l, int size_l, int w, int n_dis,
    int use_fp, int total, int n_qubits, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_gen(&prm, tables, qcorr, coins, r_q, r_nq, mflip, p_scr, li_scr,
               n_rv, total, n_qubits))
    return int(cudaErrorInvalidValue);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_stacks(&prm, attack, rand_v, late);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  return launch_single<true, false>(prm, n_trials, stream);
}

// The gen entry, keyed (k_rounds, collude and orders as the keyed host-gen
// entry).
extern "C" int qba_trial_megakernel_gen_keyed(
    const void* tables, const void* qcorr, const void* coins,
    const void* r_q, const void* r_nq, const void* mflip, void* p_scr,
    void* li_scr, const void* v_sent, const void* honest,
    const void* k_rounds, const void* collude, const void* orders,
    void* pool_a, void* pool_b, void* o_vi, void* o_dec, void* o_ovf,
    void* clock, int n_trials, int n_rv, int slots, int max_l, int size_l,
    int w, int n_dis, int use_fp, int total, int n_qubits, int strategy,
    int broadcast, int racy, int p32_bits, int n_mod, int legacy,
    void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_gen(&prm, tables, qcorr, coins, r_q, r_nq, mflip, p_scr, li_scr,
               n_rv, total, n_qubits) ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod, legacy))
    return int(cudaErrorInvalidValue);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  prm.clock = static_cast<long long*>(clock);
  return launch_single<true, true>(prm, n_trials, stream);
}

// Shared memory and resident blocks per SM of one launch configuration:
// `mode` 0 the host-gen kernel, 1 the gen entry, 2 and 3 their keyed
// forms.  Returns a cudaError_t.
extern "C" int qba_trial_megakernel_occupancy(int mode, int n_rv, int slots,
                                              int max_l, int size_l, int w,
                                              int* smem_out,
                                              int* blocks_out) {
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  if (mode < 0 || mode > 3) return int(cudaErrorInvalidValue);
  bool staged;
  const size_t smem = mode < 2 ? choose_smem<false>(d, &staged)
                               : choose_smem<true>(d, &staged);
  const void* fns[4] = {
      reinterpret_cast<const void*>(
          megakernel_for<false, false, false>(staged, false)),
      reinterpret_cast<const void*>(
          megakernel_for<true, false, false>(staged, false)),
      reinterpret_cast<const void*>(
          megakernel_for<false, false, true>(staged, false)),
      reinterpret_cast<const void*>(
          megakernel_for<true, false, true>(staged, false))};
  // Raise the kernel's limit as a launch does, never lower it.
  if (int e = raise_smem(fns[mode], smem)) return e;
  *smem_out = int(smem);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_out, fns[mode], kMegaThreads, smem));
}

// The party-sharded entry: the host-gen entry's operands and outputs,
// with the pools one pair per trial and o_ovf int32 [T, n_tp] (each
// shard's own overflow flag).  n_rv is the trial's lieutenants; a
// cluster of n_tp blocks drains them, n_rv / n_tp each.
extern "C" int qba_sharded_trial_megakernel(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* attack, const void* rand_v,
    const void* late, void* pool_a, void* pool_b, void* o_vi,
    void* o_dec, void* o_ovf, int n_trials, int n_tp, int n_rv, int slots,
    int max_l, int size_l, int w, int n_dis, int use_fp, void* stream) {
  if (n_trials <= 0) return 0;
  Dims d;
  if (!sharded_dims(n_tp, n_rv, slots, max_l, size_l, w, &d) || n_dis < 0)
    return int(cudaErrorInvalidValue);
  Params prm = {};
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_stacks(&prm, attack, rand_v, late);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, n_tp);
  return launch_sharded<false>(prm, n_trials, stream);
}

// The party-sharded entry, keyed (k_rounds, collude and orders as the
// keyed host-gen entry).
extern "C" int qba_sharded_trial_megakernel_keyed(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* k_rounds, const void* collude,
    const void* orders, void* pool_a, void* pool_b, void* o_vi,
    void* o_dec, void* o_ovf, void* clock, int n_trials, int n_tp, int n_rv,
    int slots, int max_l,
    int size_l, int w, int n_dis, int use_fp, int strategy, int broadcast,
    int racy, int p32_bits, int n_mod, int legacy, void* stream) {
  if (n_trials <= 0) return 0;
  Dims d;
  Params prm = {};
  if (!sharded_dims(n_tp, n_rv, slots, max_l, size_l, w, &d) || n_dis < 0 ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod, legacy))
    return int(cudaErrorInvalidValue);
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, pool_a, pool_b, o_vi, o_dec, o_ovf, d, n_dis, use_fp, n_tp);
  prm.clock = static_cast<long long*>(clock);
  return launch_sharded<true>(prm, n_trials, stream);
}

// Shared memory of the sharded entry and how many of its clusters the
// card holds at once (cudaOccupancyMaxActiveClusters; 0 when a cluster
// does not fit), for its keyed form, the one the engines launch (the
// stacked form takes kDrawWords fewer words).  Returns a cudaError_t.
extern "C" int qba_sharded_megakernel_clusters(int n_tp, int n_rv, int slots,
                                               int max_l, int size_l, int w,
                                               int* smem_out,
                                               int* clusters_out) {
  Dims d;
  if (!sharded_dims(n_tp, n_rv, slots, max_l, size_l, w, &d))
    return int(cudaErrorInvalidValue);
  bool staged;
  const size_t smem = choose_smem<true>(d, &staged);
  auto kernel = megakernel_for<false, true, true>(staged, false);
  if (int e = raise_smem(reinterpret_cast<const void*>(kernel), smem))
    return e;
  *smem_out = int(smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sharded_config(1, n_tp, smem, nullptr, &attr);
  return int(cudaOccupancyMaxActiveClusters(clusters_out, kernel, &cfg));
}
