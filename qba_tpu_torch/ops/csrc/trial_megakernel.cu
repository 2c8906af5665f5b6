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

#include "gf2_sweep.cuh"
#include "round_common.cuh"

namespace {

using namespace qba;
using qba_gf2::ShotTab;

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
  GenParams g;
};

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
// gen entry; the host-gen instantiation has no prologue.
template <bool kGen>
__global__ void __launch_bounds__(kThreads, 3)
trial_megakernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = P.d;
  const int n_rv = d.n_rv, slots = d.slots, S = d.size_l, w = d.w;
  const int max_l = d.max_l;
  const Shared sh(smem_raw, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t t = blockIdx.x;
  const uint8_t* p_rows;
  const int32_t* li;
  if constexpr (kGen) {
    gen_prologue(P, t);
    __syncthreads();
    p_rows = P.g.p_scr + t * size_t(n_rv) * S;
    li = P.g.li_scr + t * size_t(n_rv) * S;
  } else {
    p_rows = P.p_rows + t * size_t(n_rv) * S;
    li = P.li + t * size_t(n_rv) * S;
  }
  const int32_t* v_sent = P.v_sent + t * size_t(n_rv);
  const int32_t* honest = P.honest + t * size_t(d.n_pool());
  PoolOut pa = pool_at(P.a_vals, P.a_lens, P.a_p, P.a_meta, t, d);
  PoolOut pb = pool_at(P.b_vals, P.b_lens, P.b_p, P.b_meta, t, d);

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
  // Compaction into pool A, a warp per accepting lieutenant.
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    if (!sh.k_cnt[rv]) continue;
    const int dst = sh.offs[rv];
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
      const int32_t f[4] = {1, v_sent[rv], 1, rv * slots};
      pa.meta[size_t(dst) * 4 + lane] = f[lane];
    }
  }
  int n_scan = sh.offs[n_rv];
  int overflow = 0;
  __syncthreads();

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
    rebuild_phase(sh, in, pb, li, honest, dr, d, total, P.use_fp);
    __syncthreads();
    const PoolOut next = pb;
    pb = pa;
    pa = next;
    n_scan = total;
  }

  // ---- Exit: vi, min(vi) per lieutenant, overflow. ----
  store_vi(sh, P.o_vi + t * size_t(n_rv) * w, d);
  for (int rv = threadIdx.x; rv < n_rv; rv += kThreads) {
    const unsigned long long m = sh.vi_mask[rv];
    P.o_dec[t * size_t(n_rv) + rv] =
        m ? __ffsll(static_cast<long long>(m)) - 1 : w;
  }
  if (threadIdx.x == 0) P.o_ovf[t] = overflow;
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
  const Dims d{n_rv, slots, max_l, size_l, w};
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
  prm.g = GenParams{};
  size_t smem = 0;
  if (int e = prepare_smem(trial_megakernel<false>, d, &smem)) return e;
  trial_megakernel<false><<<n_trials, kThreads, smem,
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
  const Dims d{n_rv, slots, max_l, size_l, w};
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
  if (int e = prepare_smem(trial_megakernel<true>, d, &smem)) return e;
  trial_megakernel<true><<<n_trials, kThreads, smem,
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
  const Dims d{n_rv, slots, max_l, size_l, w};
  const size_t smem = Smem(d).total;
  const void* fn = gen ? reinterpret_cast<const void*>(trial_megakernel<true>)
                       : reinterpret_cast<const void*>(trial_megakernel<false>);
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
