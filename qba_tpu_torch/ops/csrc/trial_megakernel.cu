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
// the block; trials are independent, so no grid-wide sync exists.  Each
// round runs the fused round kernel's phases A-D (round_common.cuh) on
// pool A into pool B, then the pointers swap; __syncthreads() between
// phases makes one round's global writes visible to the next round.
//   Entry  (trial_megakernel.py:328-433) a warp per lieutenant decides
//          step 3a's verdict: consistent unless a P position whose list
//          value is not SENTINEL holds v, a value > w or < 0.  vi starts
//          as {v} for the lieutenants that accept; their broadcasts are
//          compacted into pool A at the exclusive prefix count of the
//          accepting lieutenants (row 0 = own row, lens[0] = |P|, meta =
//          (1, v, 1, lieutenant * slots)).
//   Rounds the previous round's live total is this round's scan extent.
//          The vi masks stay in shared memory across rounds.  The last
//          round rebroadcasts nothing, so it runs the verdict and dedup
//          only.
//   Exit   decisions = lowest set bit of each vi mask, or w when empty.
// The pools are private to the launch: phase E (the dead-tail fill) is
// not run, because nothing past a round's live total is ever read and
// phase D writes every field of every live entry.  Entry writes only the
// fields a one-row packet is read at (row 0, lens[0], P, meta).
//
// Bound on this card: bytes.  The kernel must read li, P, the orders and
// the cells' honesty once, write vi, the decisions and the overflow
// flag, and per round write and read back the live pool entries and read
// the draws of the live packets' cells (three per receiver in the
// verdict, two per rebuilt entry).  A round with no live packet reads
// none of its draw slab: at 33 parties / sizeL 64 / 10 dishonest the
// stacks hold 1000 x 11 x 2048 x 32 x 3 B = 2.16 GB per 1000-trial
// batch, most of which no round reads.  The pools live in per-trial
// global scratch (at 33p one pool is 1,835,008 B, far above a block's
// 227 KB of shared memory), so live entries make an L2/HBM round trip
// per round.
//
// Layouts (trial-major, contiguous): p_rows bool [T, n_rv, S], li int32
// [T, n_rv, S], v_sent int32 [T, n_rv], honest int32 [T, n_pool], draws
// uint8 [T, n_rounds, n_pool, n_rv]; pools A and B as fused_round.cu;
// out vi int32 [T, n_rv, w], decisions int32 [T, n_rv], overflow int32
// [T].
//
// The gen entry (qba_trial_megakernel_gen) is the TPU kernel's gen=True
// form (mega_gen="gf2", the prologue at trial_megakernel.py:232-324):
// the launch also generates the step-1 lists.  Its inputs replace P and
// li with the GF(2) operands: the four static tableaux (x and z of the
// Q-correlated and the not-Q-correlated circuit, int32 word-major [W,
// 2T]), qcorr
// bool [T, S], coins and mflip uint8 [T, S, total], r_q and r_nq uint8
// [T, S, 2 total].  Its plain version is
// qba_tpu_torch/ops/trial_megakernel.py :: trial_megakernel_gen_reference.
//   Prologue  the block's warps take the trial's size_l shots in turn.
//             A warp copies the shot's family's tableau (by qcorr) and
//             phases into its slot, runs sweep_shot (gf2_sweep.cuh, the
//             function the standalone sweep kernel runs), XORs the
//             readout flips, decodes each party's n_qubits bits
//             big-endian into its order value (lanes over the parties)
//             and writes the lieutenants' li and P (the QSD's value
//             differs from the commander's, and the commander's is the
//             order sent) to per-trial global scratch.  __syncthreads(),
//             then the body above runs unchanged on that scratch.
//   Slots     each warp's tableau lives in per-trial global scratch
//             (kWarps slots a trial), so the prologue takes no shared
//             memory and the block keeps the body's footprint and its
//             three blocks per SM.  Shared-memory slots were tried on
//             the H100: level at 11 parties, and at 33 parties (187.8 KB
//             for eight) one block per SM and 39 ms a batch against 24
//             (PERF.md).
// Bound of the prologue: operations, as the sweep (gf2_sweep.cuh); its
// bytes are the operands, read once, and the static tables, from L2.
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
// entry's flat index.  Once a round, lanes 0-2 of the block derive the
// round's attack, late and adapt keys into shared memory, beside the
// trial's collude target and orders (adaptive forges from the sender's
// order, any sender of the trial, so a sharded block keeps all of them).
// The verdict, a warp per live packet reading the packet's draws for
// every receiver in turn, first fills the warp's row in shared memory: a
// lane a receiver (two past 32) hashes the cell's attack word, and under
// racy delivery its late word, so the warp's serial receiver loop reads
// bytes, not hash chains.  Under attack_scope="broadcast" the row's scan
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
// Bound of the keyed entries: the larger of the bytes above without the
// draws and the operations of the hashes the trial reads, each entry once
// (about 80 a hash); the dedup's and rebuild's hashes of entries the
// verdict's row hashed already are this design's own work.

#include <cooperative_groups.h>

#include <cstring>

#include "draws.cuh"
#include "gf2_sweep.cuh"
#include "round_common.cuh"

namespace {

using namespace qba;
using qba_gf2::ShotTab;
namespace cg = cooperative_groups;

// The gen entry's operands and scratch.
struct GenParams {
  const uint32_t* xq;
  const uint32_t* zq;
  const uint32_t* xn;
  const uint32_t* zn;
  const uint8_t* qcorr;
  const uint8_t* coins;
  const uint8_t* r_q;
  const uint8_t* r_nq;
  const uint8_t* mflip;
  uint8_t* p_scr;
  int32_t* li_scr;
  unsigned char* tab_scratch;  // kWarps slots per trial
  int total, w, nq;
};

struct Params {
  const uint8_t* p_rows;
  const int32_t* li;
  const int32_t* v_sent;
  const int32_t* honest;
  const uint8_t* attack;
  const uint8_t* rand_v;
  const uint8_t* late;
  int8_t* a_vals;
  int32_t* a_lens;
  int8_t* a_p;
  int32_t* a_meta;
  int8_t* b_vals;
  int32_t* b_lens;
  int8_t* b_p;
  int32_t* b_meta;
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
  int strategy, broadcast, racy, n_mod;
  float p32;
};

// The keyed entries' shared words, past the body's shared memory: the
// round's attack, late and adapt keys, the trial's collude target, then
// its orders [n_glob] (adaptive).  After them each warp's draw row: the
// attack bits, forged orders and late flags of one cell by global
// receiver, uint8 [3][64].
constexpr int kDrawWords = 8 + 64;
constexpr int kWordCollude = 6, kWordOrders = 8;
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
// single reads hash (and walk) the entry alone.
struct HashedDraws {
  const uint32_t* s;  // the shared words above
  uint8_t* rows;      // the warps' draw rows
  int strategy, n_mod, w, slots;
  bool late_phase, broadcast, racy;
  float p32;
  // Cell `cell`'s row, by the whole warp: lane j takes the global
  // receivers j and j + 32.
  __device__ HashedRow row(const Dims& d, int cell, bool biz) const {
    using namespace qba_draws;
    const int lane = threadIdx.x & 31, n = d.n_glob;
    uint8_t* p = rows + (threadIdx.x >> 5) * kRowBytes;
    const uint32_t base = uint32_t(cell) * uint32_t(n);
    const Key attack{s[0], s[1]}, late{s[2], s[3]};
    uint32_t b[2] = {0u, 0u};
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      if (q >= n) continue;
      if (biz) b[k] = bits_at(attack, base + uint32_t(q));
      p[128 + q] = uint8_t(racy && late_at(late, base + uint32_t(q), p32));
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
          if (att & kForgeBit) v = forged(b[k], base + uint32_t(q), cell);
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
  // The forged order of attack word b at flat index i (delivery scope).
  __device__ int forged(uint32_t b, uint32_t i, int cell) const {
    using namespace qba_draws;
    if (strategy == kCollude) return int(s[kWordCollude]);
    if (strategy == kAdaptive)
      return adaptive_rand_v(Key{s[4], s[5]}, i,
                             int(s[kWordOrders + cell / slots]), w);
    return raw_rand_v(b, n_mod);
  }
  __device__ HashedDraw draw(const Dims& d, int cell, int rv,
                             bool biz) const {
    using namespace qba_draws;
    if (!biz) return HashedDraw{0, 0};
    const Key attack{s[0], s[1]};
    const int g = d.r_off + rv;
    const uint32_t base = uint32_t(cell) * uint32_t(d.n_glob);
    const uint32_t b = bits_at(attack, base + uint32_t(g));
    int v = 0;
    if (broadcast)
      return HashedDraw{scanned_attack(attack, base, g, cell / slots, b,
                                       n_mod, &v), v};
    const int att = attack_bits(b, strategy, late_phase);
    if (att & kForgeBit) v = forged(b, base + uint32_t(g), cell);
    return HashedDraw{att, v};
  }
  __device__ bool is_late(const Dims& d, int cell, int rv) const {
    return racy && qba_draws::late_at(
        qba_draws::Key{s[2], s[3]},
        uint32_t(cell) * uint32_t(d.n_glob) + uint32_t(d.r_off + rv), p32);
  }
};

// Lanes 0-2: round r's attack, late and adapt keys of trial t,
// fold_in(fold_in(k_rounds[t], r), tag), into the shared words.
__device__ inline void round_keys(const Params& P, size_t t, int r,
                                  uint32_t* s) {
  using namespace qba_draws;
  const int i = threadIdx.x;
  const uint32_t tag = i == 0 ? kAttackTag : i == 1 ? kLateTag : kAdaptTag;
  const Key trial{uint32_t(P.k_rounds[2 * t]), uint32_t(P.k_rounds[2 * t + 1])};
  const Key k = fold_in(fold_in(trial, uint32_t(r)), tag);
  s[2 * i] = k.k0;
  s[2 * i + 1] = k.k1;
}

// Round r's draw source: hashed (kKeyed) or the stacked slab.
template <bool kKeyed>
__device__ inline auto round_draws(const Params& P, size_t t, int r,
                                   const Dims& d, uint32_t* s) {
  if constexpr (kKeyed) {
    return HashedDraws{s, reinterpret_cast<uint8_t*>(s + kDrawWords),
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
__device__ void cluster_counts(const Shared& sh, int mine, int n_tp) {
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) sh.misc[2] = mine;
  cl.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, rank = int(cl.block_rank());
    const int c = lane < n_tp ? *cl.map_shared_rank(&sh.misc[2], lane) : 0;
    const int below = __reduce_add_sync(kFull, lane < rank ? c : 0);
    const int all = __reduce_add_sync(kFull, c);
    if (lane == 0) {
      sh.misc[3] = below;
      sh.misc[4] = all;
    }
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

// The gen prologue: trial t's lists from its GF(2) operands, into the
// scratch P and li the body reads.
__device__ void gen_prologue(const Params& P, size_t t) {
  const GenParams& g = P.g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = P.d.size_l, n_rv = P.d.n_rv, T = g.total, W = g.w;
  const int nq = g.nq, n_groups = n_rv + 2;
  const size_t slot = qba_gf2::shot_bytes(T, W);
  const ShotTab tab =
      qba_gf2::shot_tab(g.tab_scratch + (t * kWarps + warp) * slot, T, W);
  int32_t* li = g.li_scr + t * size_t(n_rv) * S;
  uint8_t* pr = g.p_scr + t * size_t(n_rv) * S;
  const int32_t* v_sent = P.v_sent + t * size_t(n_rv);
  for (int s = warp; s < S; s += kWarps) {
    const size_t shot = t * S + s;
    const bool q = g.qcorr[shot] != 0;
    qba_gf2::load_shot(tab, T, W, q ? g.xq : g.xn, q ? g.zq : g.zn,
                       (q ? g.r_q : g.r_nq) + shot * 2 * T);
    qba_gf2::sweep_shot(tab, T, W, g.coins + shot * T);
    const uint8_t* mf = g.mflip + shot * T;
    int l0 = 0, l1 = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      const int grp = g0 + lane;
      int v = 0;
      if (grp < n_groups)
        for (int j = 0; j < nq; ++j)
          v = (v << 1) | ((tab.bits[grp * nq + j] ^ mf[grp * nq + j]) & 1);
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

// Three blocks per SM (at most 85 registers a thread): left to itself the
// compiler has taken from 80 to 128 registers for this kernel as the shared
// header changed, and past 85 only two blocks fit an SM.  kGen selects the
// gen entry; the host-gen instantiation has no prologue.  kSharded
// selects the party-sharded entry: a cluster of P.n_tp blocks a trial.
// kKeyed selects the keyed entries, which hash their draws.
template <bool kGen, bool kSharded, bool kKeyed>
__global__ void __launch_bounds__(kThreads, 3)
trial_megakernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Dims d = P.d;
  const int n_rv = d.n_rv, slots = d.slots, S = d.size_l, w = d.w;
  const int max_l = d.max_l, n_glob = d.n_glob;
  const Shared sh(smem_raw, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  size_t t = blockIdx.x;
  int rank = 0;
  if constexpr (kSharded) {
    rank = int(cg::this_cluster().block_rank());
    t = blockIdx.x / P.n_tp;
    d.r_off = rank * n_rv;
  }
  // The block's receivers' rows of the trial's [n_glob, ...] inputs.
  const size_t row0 = t * size_t(n_glob) + d.r_off;
  const uint8_t* p_rows;
  const int32_t* li;
  if constexpr (kGen) {
    gen_prologue(P, t);
    __syncthreads();
    p_rows = P.g.p_scr + row0 * S;
    li = P.g.li_scr + row0 * S;
  } else {
    p_rows = P.p_rows + row0 * S;
    li = P.li + row0 * S;
  }
  const int32_t* v_sent = P.v_sent + row0;
  const int n_pool = d.n_pool();
  const int32_t* honest = P.honest + t * size_t(n_pool);
  PoolOut pa = pool_at(P.a_vals, P.a_lens, P.a_p, P.a_meta, t, n_pool, d);
  PoolOut pb = pool_at(P.b_vals, P.b_lens, P.b_p, P.b_meta, t, n_pool, d);
  uint32_t* s_draw = nullptr;
  if constexpr (kKeyed) {
    s_draw = reinterpret_cast<uint32_t*>(smem_raw + sh.L.total);
    if (P.orders)
      for (int i = threadIdx.x; i < n_glob; i += kThreads)
        s_draw[kWordOrders + i] = uint32_t(P.orders[t * size_t(n_glob) + i]);
    if (threadIdx.x == 0)
      s_draw[kWordCollude] = P.collude ? uint32_t(P.collude[t]) : 0u;
  }

  // ---- Entry: step 3a's verdict per lieutenant, a warp each. ----
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    const int v = v_sent[rv];
    const int32_t* lir = li + size_t(rv) * S;
    bool bad = false;
    for (int j = lane; j < S; j += 32) {
      const int x = lir[j];
      if (p_rows[size_t(rv) * S + j] && x != -1 && (x == v || x > w || x < 0))
        bad = true;
    }
    bad = __any_sync(kFull, bad);
    if (lane == 0) {
      sh.k_cnt[rv] = !bad;
      sh.vi_mask[rv] = (!bad && v >= 0 && v < w) ? (1ull << v) : 0ull;
    }
  }
  __syncthreads();
  offsets_phase(sh, n_rv);  // pool position = exclusive prefix of ok
  __syncthreads();
  int base = 0, n_scan = sh.offs[n_rv];
  if constexpr (kSharded) {
    cluster_counts(sh, n_scan, P.n_tp);
    base = sh.misc[3];
    n_scan = sh.misc[4];
  }
  // Compaction into pool A, a warp per accepting lieutenant.
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    if (!sh.k_cnt[rv]) continue;
    const int dst = base + sh.offs[rv];
    const int32_t* lir = li + size_t(rv) * S;
    int plen = 0;
    for (int j = lane; j < S; j += 32) {
      const bool pj = p_rows[size_t(rv) * S + j] != 0;
      pa.vals[size_t(dst) * S + j] = pj ? int8_t(lir[j]) : int8_t(-1);
      pa.p[size_t(dst) * S + j] = int8_t(pj);
      plen += pj;
    }
    plen = __reduce_add_sync(kFull, plen);
    if (lane == 0) pa.lens[size_t(dst) * max_l] = plen;
    if (lane < 4) {
      const int32_t f[4] = {1, v_sent[rv], 1, (d.r_off + rv) * slots};
      pa.meta[size_t(dst) * 4 + lane] = f[lane];
    }
  }
  int overflow = 0;
  pool_written<kSharded>();

  // ---- Rounds 1..n_dis+1, pool A -> pool B. ----
  for (int r = 1; r <= P.n_rounds; ++r) {
    if constexpr (kKeyed) {
      // The previous round's readers are past its last barrier.
      if (threadIdx.x < 3) round_keys(P, t, r, s_draw);
    }
    const auto dr = round_draws<kKeyed>(P, t, r, d, s_draw);
    const bool rebroadcast = r <= P.n_dis;
    const PoolIn in = as_in(pa);
    clear_round(sh, n_scan);
    __syncthreads();
    verdict_phase(sh, in, li, honest, dr, d, n_scan, r, P.use_fp);
    __syncthreads();
    dedup_phase(sh, in.meta, honest, dr, d, n_scan, rebroadcast, nullptr);
    __syncthreads();
    if (!rebroadcast) break;  // the last round builds no successor
    offsets_phase(sh, n_rv);
    __syncthreads();
    overflow |= sh.misc[1];
    const int total = sh.offs[n_rv];
    int first = 0, next_scan = total;
    if constexpr (kSharded) {
      cluster_counts(sh, total, P.n_tp);
      first = sh.misc[3];
      next_scan = sh.misc[4];
    }
    rebuild_phase(sh, in, pb.from(first, d), li, honest, dr, d, total,
                  P.use_fp);
    pool_written<kSharded>();
    const PoolOut next = pb;
    pb = pa;
    pa = next;
    n_scan = next_scan;
  }

  // ---- Exit: vi, min(vi) per lieutenant, overflow. ----
  store_vi(sh, P.o_vi + row0 * w, d);
  for (int rv = threadIdx.x; rv < n_rv; rv += kThreads) {
    const unsigned long long m = sh.vi_mask[rv];
    P.o_dec[row0 + rv] = m ? __ffsll(static_cast<long long>(m)) - 1 : w;
  }
  if (threadIdx.x == 0) P.o_ovf[t * P.n_tp + rank] = overflow;
}

}  // namespace

// ---- Host side. ----

namespace {

// The body's pools (scratch of the fused round kernel's pool shapes; their
// contents on entry are ignored), outputs and sizes.
void set_body(Params* p, void* a_vals, void* a_lens, void* a_p, void* a_meta,
              void* b_vals, void* b_lens, void* b_p, void* b_meta, void* o_vi,
              void* o_dec, void* o_ovf, const Dims& d, int n_dis, int use_fp,
              int n_tp) {
  p->a_vals = static_cast<int8_t*>(a_vals);
  p->a_lens = static_cast<int32_t*>(a_lens);
  p->a_p = static_cast<int8_t*>(a_p);
  p->a_meta = static_cast<int32_t*>(a_meta);
  p->b_vals = static_cast<int8_t*>(b_vals);
  p->b_lens = static_cast<int32_t*>(b_lens);
  p->b_p = static_cast<int8_t*>(b_p);
  p->b_meta = static_cast<int32_t*>(b_meta);
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
             int p32_bits, int n_mod) {
  using namespace qba_draws;
  if (!k_rounds || strategy < kReference || strategy > kSplit ||
      (broadcast && strategy != kReference) ||
      (strategy == kCollude && !collude) ||
      (strategy == kAdaptive && !orders) || n_mod < 1 || n_mod > 256)
    return false;
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
// its own.
bool set_gen(Params* p, const void* xq, const void* zq, const void* xn,
             const void* zn, const void* qcorr, const void* coins,
             const void* r_q, const void* r_nq, const void* mflip,
             void* p_scr, void* li_scr, void* tab_scratch, int n_rv,
             int total, int w_words, int n_qubits, int slot_bytes) {
  if (total != (n_rv + 2) * n_qubits || w_words != (total + 31) / 32 ||
      w_words > qba_gf2::kMaxWords || !tab_scratch ||
      size_t(slot_bytes) != qba_gf2::shot_bytes(total, w_words))
    return false;
  p->g = GenParams{static_cast<const uint32_t*>(xq),
                   static_cast<const uint32_t*>(zq),
                   static_cast<const uint32_t*>(xn),
                   static_cast<const uint32_t*>(zn),
                   static_cast<const uint8_t*>(qcorr),
                   static_cast<const uint8_t*>(coins),
                   static_cast<const uint8_t*>(r_q),
                   static_cast<const uint8_t*>(r_nq),
                   static_cast<const uint8_t*>(mflip),
                   static_cast<uint8_t*>(p_scr),
                   static_cast<int32_t*>(li_scr),
                   static_cast<unsigned char*>(tab_scratch),
                   total, w_words, n_qubits};
  return true;
}

// Dynamic shared memory of an instantiation: the body's, and the keyed
// entries' words.
template <bool kKeyed>
size_t smem_bytes(const Dims& d) {
  return Smem(d).total +
         (kKeyed ? sizeof(uint32_t) * kDrawWords + kWarps * kRowBytes : 0);
}

// Raise a kernel's dynamic shared-memory limit past 48 KB where needed.
int raise_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// One block a trial.
template <bool kGen, bool kKeyed>
int launch_single(const Params& prm, int n_trials, void* stream) {
  const size_t smem = smem_bytes<kKeyed>(prm.d);
  auto kernel = trial_megakernel<kGen, false, kKeyed>;
  if (int e = raise_smem(reinterpret_cast<const void*>(kernel), smem))
    return e;
  kernel<<<n_trials, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prm);
  return int(cudaGetLastError());
}

// The sharded entry's launch: n_trials clusters of n_tp blocks.
cudaLaunchConfig_t sharded_config(int n_trials, int n_tp, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_trials) * unsigned(n_tp));
  cfg.blockDim = dim3(kThreads);
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
  const size_t smem = smem_bytes<kKeyed>(prm.d);
  auto kernel = trial_megakernel<false, true, kKeyed>;
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
// Pools A and B are scratch of the fused round kernel's pool shapes.

// The host-gen entry on stacked draws.
extern "C" int qba_trial_megakernel(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* attack, const void* rand_v,
    const void* late, void* a_vals, void* a_lens, void* a_p, void* a_meta,
    void* b_vals, void* b_lens, void* b_p, void* b_meta, void* o_vi,
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
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  return launch_single<false, false>(prm, n_trials, stream);
}

// The host-gen entry, keyed: k_rounds int64 [T, 2], collude int32 [T]
// (strategy collude, else null) and orders int32 [T, n_rv] (strategy
// adaptive, else null) in place of the stacks.
extern "C" int qba_trial_megakernel_keyed(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* k_rounds, const void* collude,
    const void* orders, void* a_vals, void* a_lens, void* a_p, void* a_meta, void* b_vals,
    void* b_lens, void* b_p, void* b_meta, void* o_vi, void* o_dec,
    void* o_ovf, int n_trials, int n_rv, int slots, int max_l, int size_l,
    int w, int n_dis, int use_fp, int strategy, int broadcast, int racy,
    int p32_bits, int n_mod, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod))
    return int(cudaErrorInvalidValue);
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  return launch_single<false, true>(prm, n_trials, stream);
}

// The gen entry: the GF(2) operands in place of p_rows and li, which the
// prologue writes to p_scr and li_scr, and tab_scratch, which holds
// kWarps tableau slots per trial.  slot_bytes is the caller's slot size,
// which must be shot_bytes(total, w_words).
extern "C" int qba_trial_megakernel_gen(
    const void* xq, const void* zq, const void* xn, const void* zn,
    const void* qcorr, const void* coins, const void* r_q, const void* r_nq,
    const void* mflip, void* p_scr, void* li_scr, void* tab_scratch,
    const void* v_sent, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* a_vals, void* a_lens,
    void* a_p, void* a_meta, void* b_vals, void* b_lens, void* b_p,
    void* b_meta, void* o_vi, void* o_dec, void* o_ovf, int n_trials,
    int n_rv, int slots, int max_l, int size_l, int w, int n_dis,
    int use_fp, int total, int w_words, int n_qubits, int slot_bytes,
    void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_gen(&prm, xq, zq, xn, zn, qcorr, coins, r_q, r_nq, mflip, p_scr,
               li_scr, tab_scratch, n_rv, total, w_words, n_qubits,
               slot_bytes))
    return int(cudaErrorInvalidValue);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_stacks(&prm, attack, rand_v, late);
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
  return launch_single<true, false>(prm, n_trials, stream);
}

// The gen entry, keyed (k_rounds, collude and orders as the keyed host-gen
// entry).
extern "C" int qba_trial_megakernel_gen_keyed(
    const void* xq, const void* zq, const void* xn, const void* zn,
    const void* qcorr, const void* coins, const void* r_q, const void* r_nq,
    const void* mflip, void* p_scr, void* li_scr, void* tab_scratch,
    const void* v_sent, const void* honest, const void* k_rounds,
    const void* collude, const void* orders, void* a_vals, void* a_lens,
    void* a_p, void* a_meta, void* b_vals, void* b_lens, void* b_p,
    void* b_meta, void* o_vi, void* o_dec, void* o_ovf, int n_trials,
    int n_rv, int slots,
    int max_l, int size_l, int w, int n_dis, int use_fp, int total,
    int w_words, int n_qubits, int slot_bytes, int strategy, int broadcast,
    int racy, int p32_bits, int n_mod, void* stream) {
  if (n_trials <= 0) return 0;
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  Params prm = {};
  if (!dims_ok(d) || n_dis < 0 ||
      !set_gen(&prm, xq, zq, xn, zn, qcorr, coins, r_q, r_nq, mflip, p_scr,
               li_scr, tab_scratch, n_rv, total, w_words, n_qubits,
               slot_bytes) ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod))
    return int(cudaErrorInvalidValue);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, 1);
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
  const void* fns[4] = {
      reinterpret_cast<const void*>(trial_megakernel<false, false, false>),
      reinterpret_cast<const void*>(trial_megakernel<true, false, false>),
      reinterpret_cast<const void*>(trial_megakernel<false, false, true>),
      reinterpret_cast<const void*>(trial_megakernel<true, false, true>)};
  if (mode < 0 || mode > 3) return int(cudaErrorInvalidValue);
  const size_t smem = mode < 2 ? smem_bytes<false>(d) : smem_bytes<true>(d);
  // Raise the kernel's limit as a launch does, never lower it.
  if (int e = raise_smem(fns[mode], smem)) return e;
  *smem_out = int(smem);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_out, fns[mode], kThreads, smem));
}

// The party-sharded entry: the host-gen entry's operands and outputs,
// with the pools one pair per trial and o_ovf int32 [T, n_tp] (each
// shard's own overflow flag).  n_rv is the trial's lieutenants; a
// cluster of n_tp blocks drains them, n_rv / n_tp each.
extern "C" int qba_sharded_trial_megakernel(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* attack, const void* rand_v,
    const void* late, void* a_vals, void* a_lens, void* a_p, void* a_meta,
    void* b_vals, void* b_lens, void* b_p, void* b_meta, void* o_vi,
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
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, n_tp);
  return launch_sharded<false>(prm, n_trials, stream);
}

// The party-sharded entry, keyed (k_rounds, collude and orders as the
// keyed host-gen entry).
extern "C" int qba_sharded_trial_megakernel_keyed(
    const void* p_rows, const void* li, const void* v_sent,
    const void* honest, const void* k_rounds, const void* collude,
    const void* orders, void* a_vals, void* a_lens, void* a_p, void* a_meta, void* b_vals,
    void* b_lens, void* b_p, void* b_meta, void* o_vi, void* o_dec,
    void* o_ovf, int n_trials, int n_tp, int n_rv, int slots, int max_l,
    int size_l, int w, int n_dis, int use_fp, int strategy, int broadcast,
    int racy, int p32_bits, int n_mod, void* stream) {
  if (n_trials <= 0) return 0;
  Dims d;
  Params prm = {};
  if (!sharded_dims(n_tp, n_rv, slots, max_l, size_l, w, &d) || n_dis < 0 ||
      !set_law(&prm, k_rounds, collude, orders, strategy, broadcast, racy,
               p32_bits, n_mod))
    return int(cudaErrorInvalidValue);
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  set_body(&prm, a_vals, a_lens, a_p, a_meta, b_vals, b_lens, b_p, b_meta,
           o_vi, o_dec, o_ovf, d, n_dis, use_fp, n_tp);
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
  const size_t smem = smem_bytes<true>(d);
  auto kernel = trial_megakernel<false, true, true>;
  if (int e = raise_smem(reinterpret_cast<const void*>(kernel), smem))
    return e;
  *smem_out = int(smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sharded_config(1, n_tp, smem, nullptr, &attr);
  return int(cudaOccupancyMaxActiveClusters(clusters_out, kernel, &cfg));
}
