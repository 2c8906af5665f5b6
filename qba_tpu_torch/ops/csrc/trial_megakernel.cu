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

#include <cooperative_groups.h>

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
};

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
template <bool kGen, bool kSharded>
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
    const Draws dr = draws_at(P.attack, P.rand_v, P.late,
                              t * size_t(P.n_rounds) + (r - 1), d);
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

// Returns a cudaError_t: 0 on a launch that was accepted.  Pools A and B
// are scratch of the fused round kernel's pool shapes; their contents on
// entry are ignored.
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
  Params prm;
  prm.p_rows = static_cast<const uint8_t*>(p_rows);
  prm.li = static_cast<const int32_t*>(li);
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.late = static_cast<const uint8_t*>(late);
  prm.a_vals = static_cast<int8_t*>(a_vals);
  prm.a_lens = static_cast<int32_t*>(a_lens);
  prm.a_p = static_cast<int8_t*>(a_p);
  prm.a_meta = static_cast<int32_t*>(a_meta);
  prm.b_vals = static_cast<int8_t*>(b_vals);
  prm.b_lens = static_cast<int32_t*>(b_lens);
  prm.b_p = static_cast<int8_t*>(b_p);
  prm.b_meta = static_cast<int32_t*>(b_meta);
  prm.o_vi = static_cast<int32_t*>(o_vi);
  prm.o_dec = static_cast<int32_t*>(o_dec);
  prm.o_ovf = static_cast<int32_t*>(o_ovf);
  prm.d = d;
  prm.n_rounds = n_dis + 1;
  prm.n_dis = n_dis;
  prm.use_fp = use_fp;
  prm.n_tp = 1;
  prm.g = GenParams{};
  size_t smem = 0;
  if (int e = prepare_smem(trial_megakernel<false, false>, d, &smem))
    return e;
  trial_megakernel<false, false><<<n_trials, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

// The gen entry: the GF(2) operands in place of p_rows and li, which the
// prologue writes to p_scr and li_scr, and tab_scratch, which holds
// kWarps tableau slots per trial.  slot_bytes is the caller's slot size, which must be shot_bytes(total,
// w_words).  Returns a cudaError_t: 0 on a launch that was accepted.
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
  if (!dims_ok(d) || n_dis < 0 || total != (n_rv + 2) * n_qubits ||
      w_words != (total + 31) / 32 || w_words > qba_gf2::kMaxWords ||
      !tab_scratch || size_t(slot_bytes) != qba_gf2::shot_bytes(total, w_words))
    return int(cudaErrorInvalidValue);
  Params prm;
  prm.p_rows = nullptr;
  prm.li = nullptr;
  prm.v_sent = static_cast<const int32_t*>(v_sent);
  prm.honest = static_cast<const int32_t*>(honest);
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.late = static_cast<const uint8_t*>(late);
  prm.a_vals = static_cast<int8_t*>(a_vals);
  prm.a_lens = static_cast<int32_t*>(a_lens);
  prm.a_p = static_cast<int8_t*>(a_p);
  prm.a_meta = static_cast<int32_t*>(a_meta);
  prm.b_vals = static_cast<int8_t*>(b_vals);
  prm.b_lens = static_cast<int32_t*>(b_lens);
  prm.b_p = static_cast<int8_t*>(b_p);
  prm.b_meta = static_cast<int32_t*>(b_meta);
  prm.o_vi = static_cast<int32_t*>(o_vi);
  prm.o_dec = static_cast<int32_t*>(o_dec);
  prm.o_ovf = static_cast<int32_t*>(o_ovf);
  prm.d = d;
  prm.n_rounds = n_dis + 1;
  prm.n_dis = n_dis;
  prm.use_fp = use_fp;
  prm.n_tp = 1;
  prm.g = GenParams{static_cast<const uint32_t*>(xq),
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
  size_t smem = 0;
  if (int e = prepare_smem(trial_megakernel<true, false>, d, &smem))
    return e;
  trial_megakernel<true, false><<<n_trials, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

// Shared memory and resident blocks per SM of one launch configuration
// of the host-gen kernel (gen 0) or the gen entry (gen 1).  Returns a
// cudaError_t.
extern "C" int qba_trial_megakernel_occupancy(int gen, int n_rv, int slots,
                                              int max_l, int size_l, int w,
                                              int* smem_out,
                                              int* blocks_out) {
  const Dims d = make_dims(n_rv, slots, max_l, size_l, w);
  const size_t smem = Smem(d).total;
  const void* fn =
      gen ? reinterpret_cast<const void*>(trial_megakernel<true, false>)
          : reinterpret_cast<const void*>(trial_megakernel<false, false>);
  // Raise the kernel's limit as a launch does, never lower it: the
  // launches set it only past 48 KB.
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  *smem_out = int(smem);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_out, fn, kThreads, smem));
}

namespace {

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

// The sharded entry's sizes, or false when they are not its shapes: a
// cluster of 1 to 8 blocks (the portable size) that splits n_rv evenly.
bool sharded_dims(int n_tp, int n_rv, int slots, int max_l, int size_l,
                  int w, Dims* d) {
  if (n_tp < 1 || n_tp > 8 || n_rv % n_tp != 0) return false;
  *d = Dims{n_rv / n_tp, slots, max_l, size_l, w, 0, n_rv};
  return dims_ok(*d);
}

}  // namespace

// The party-sharded entry: the host-gen entry's operands and outputs,
// with the pools one pair per trial and o_ovf int32 [T, n_tp] (each
// shard's own overflow flag).  n_rv is the trial's lieutenants; a
// cluster of n_tp blocks drains them, n_rv / n_tp each.  Returns a
// cudaError_t: 0 on a launch that was accepted.
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
  prm.attack = static_cast<const uint8_t*>(attack);
  prm.rand_v = static_cast<const uint8_t*>(rand_v);
  prm.late = static_cast<const uint8_t*>(late);
  prm.a_vals = static_cast<int8_t*>(a_vals);
  prm.a_lens = static_cast<int32_t*>(a_lens);
  prm.a_p = static_cast<int8_t*>(a_p);
  prm.a_meta = static_cast<int32_t*>(a_meta);
  prm.b_vals = static_cast<int8_t*>(b_vals);
  prm.b_lens = static_cast<int32_t*>(b_lens);
  prm.b_p = static_cast<int8_t*>(b_p);
  prm.b_meta = static_cast<int32_t*>(b_meta);
  prm.o_vi = static_cast<int32_t*>(o_vi);
  prm.o_dec = static_cast<int32_t*>(o_dec);
  prm.o_ovf = static_cast<int32_t*>(o_ovf);
  prm.d = d;
  prm.n_rounds = n_dis + 1;
  prm.n_dis = n_dis;
  prm.use_fp = use_fp;
  prm.n_tp = n_tp;
  size_t smem = 0;
  if (int e = prepare_smem(trial_megakernel<false, true>, d, &smem)) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sharded_config(
      n_trials, n_tp, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, trial_megakernel<false, true>, prm);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// Shared memory of the sharded entry and how many of its clusters the
// card holds at once (cudaOccupancyMaxActiveClusters; 0 when a cluster
// does not fit).  Returns a cudaError_t.
extern "C" int qba_sharded_megakernel_clusters(int n_tp, int n_rv, int slots,
                                               int max_l, int size_l, int w,
                                               int* smem_out,
                                               int* clusters_out) {
  Dims d;
  if (!sharded_dims(n_tp, n_rv, slots, max_l, size_l, w, &d))
    return int(cudaErrorInvalidValue);
  size_t smem = 0;
  if (int e = prepare_smem(trial_megakernel<false, true>, d, &smem)) return e;
  *smem_out = int(smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sharded_config(1, n_tp, smem, nullptr, &attr);
  return int(cudaOccupancyMaxActiveClusters(
      clusters_out, trial_megakernel<false, true>, &cfg));
}
