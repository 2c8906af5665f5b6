// One voting round of the QBA protocol for a batch of trials, fused into
// one launch: the verdict of every pool packet against every receiver,
// first-accept dedup into the accepted sets, slot allocation with
// overflow, and the successor pool.
//
// Replaces the TPU kernel qba_tpu/ops/round_kernel_tiled.py ::
// build_fused_round_kernel (pallas_call at line 1799), whose verdict is
// _verdict_block_accepts (line 119) over ops/verdict_algebra.py.  The
// plain PyTorch version it is held against is
// qba_tpu_torch/ops/round_kernel_tiled.py :: fused_round_reference.
//
// Design.  One thread block per trial; the TPU's sequential grid (step 0
// runs the verdict, later steps read its scratch) becomes phases of one
// block separated by __syncthreads(), since CUDA blocks run in no order.
// The phases are device functions in round_common.cuh, shared with the
// tiled and dense-mailbox sources.
//   Setup  vi as 64-bit masks, the cells' sent and honesty bits (a ballot
//      a word of 32 cells) and the block's lists li as int8 words in
//      shared memory, each part's loads in flight together; then the sent
//      packets as a list in pool order.
//   A. verdict: a warp per listed packet.  The warp copies the packet's
//      valid rows, P and lens into one of its two shared buffers with
//      cp.async while it checks the packet before, and holds the next
//      packets' meta and draws in registers, so no global load waits in
//      the loop.  The packet's facts (out-of-range entries, colliding rows,
//      disagreeing lens, the values present) are computed once over its
//      words of four positions; then the receivers run across lanes (a
//      lane group a receiver, 4 lanes up to 8 receivers, 2 up to 16, else
//      1, two passes past 32): the corruption flags from the lane's draws,
//      cheap rejections first, then the own-row terms (duplicate row, own
//      length, bad own value, own-row collision) four positions a word
//      with __vcmpeq4 and zero-byte tests.  One ballot a pass gives the
//      packet's mask of accepting receivers.  A receiver whose list holds
//      a value past int8 checks it in global memory (lossy_hit).
//   B. dedup: a warp per receiver walks the listed packets in order, 32
//      at a time; __match_any_sync finds the first candidate per order
//      value and the receiver's accepted set is a 64-bit mask, so the walk
//      is exactly the sequential first-accept of v not in Vi.  Winners get
//      their outgoing slot in the same walk.
//   C. per-receiver offsets of the compacted successor pool (a warp scan).
//   D. rebuild: a warp per destination copies its source packet's rows
//      and appends the receiver's own row with the keep/dup algebra;
//   E. then the block fills the dead tail of the successor pool with
//      16-byte stores.
// Only integer compares and direct indexed loads: no matrix unit, so the
// TPU's one-hot bf16 gathers and their exactness bound have no analog.
// The phase clock's instantiation (kClock) adds warp 0's cycles per phase
// (RoundPhase) into a buffer; only the timing scripts launch it.  On an
// NVIDIA H100 80GB HBM3 at 700 W the first body's clock put 57% of a
// 33-party block in the verdict (49% its serial receiver loop); the
// redesign took the kernel from 1.65 to 0.94 ms (PERF.md).
//
// Bound on this card: bytes.  Per trial and round the kernel must read
// the live packets' valid rows, lens, P and meta, their cells' draws
// (3 bytes per receiver), li and vi, and write the whole successor pool
// (int8 vals/P, int32 lens/meta) and vi; at 33 parties / sizeL 64 / 10
// dishonest the pool write alone is ~1.7 MB per trial.  The design reads
// each live input byte once into shared memory or L1, skips dead packets
// entirely, and writes the dead tail with 16-byte stores.
//
// The party-sharded variant (the TPU kernel's n_recv build).  A shard
// drains its receivers [start, start + n_local) of the n_glob lieutenants
// against the whole assembled pool and writes its LOCAL successor
// segment (capacity n_local * slots, compacted, global cell ids); the
// verdict compares the sender with the receiver's global id and reads
// the receiver's column of the global draw tables.  The launch takes
// n_shards shards of a batch at once: block b is shard b / T of trial
// b % T, whose receivers start at start + (b / T) * n_local.  The
// single-device kernel is the case n_shards = 1, start = 0, n_local =
// n_glob, so both are one source, instantiated twice: the single-device
// instantiation fixes the shard terms at compile time (BlockAt in
// round_common.cuh).  Only sent packets are read, so the assembled pool
// may hold empty entries between the segments.
//
// Layouts (shard- and trial-major, contiguous; B = n_shards * T): vals
// int8 [B, max_l, n_pool, S], lens int32 [B, n_pool, max_l], p int8
// [B, n_pool, S], meta int32 [B, n_pool, 4] = (count, v, sent, cell), li
// int32 [B, n_local, S], vi int32 [B, n_local, w], honest int32
// [T, n_pool], draws uint8 [T, n_pool, n_glob]; the successor pools as
// the pools with n_local * slots entries; n_pool = n_glob * slots.

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

// One block's round; kSharded: see BlockAt; kClock the phase clock.
template <bool kSharded, bool kClock>
__device__ __forceinline__ void fused_round_body(const Params& P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhaseClock<kClock, kRoundPhases> clk;
  clk.start();
  const BlockAt<kSharded> at(P.n_trials);
  const size_t b = blockIdx.x, t = at.t;
  const Dims d = at.dims(P.d, P.start);
  const int n_pool = d.n_pool();
  const Shared sh(smem_raw, d);
  const PoolIn in = pool_at(P.vals, P.lens, P.p, P.meta, b, n_pool, d);
  const PoolOut out =
      pool_at(P.o_vals, P.o_lens, P.o_p, P.o_meta, b, d.n_out(), d);
  const int32_t* li = P.li + b * size_t(d.n_rv) * d.size_l;
  const int32_t* honest = P.honest + t * size_t(n_pool);
  const Draws dr = draws_at(P.attack, P.rand_v, P.late, t, d);

  // Setup: vi as masks, the cells' sent and honesty bits; then the sent
  // cells' list and the block's lists in shared memory.
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
  dedup_phase(sh, dr, d, n_sent, P.round_idx <= P.n_dis);
  __syncthreads();
  clk.mark(kRpDedup);
  store_vi(sh, P.o_vi + b * size_t(d.n_rv) * d.w, d);
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

// The two instantiations differ in their launch bounds, chosen by timing
// 8 and 16 warps and the bounds side by side on the H100 (PERF.md):
// the party-sharded kernel asks for three blocks an SM (at most 85
// registers a thread); the single-device kernel is left to the compiler
// (128 registers, two blocks an SM), which three blocks an SM cost 5% at
// 33 parties.
template <bool kClock>
__global__ void __launch_bounds__(kThreads)
fused_round_single(Params P) { fused_round_body<false, kClock>(P); }

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 3)
fused_round_sharded(Params P) { fused_round_body<true, kClock>(P); }

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  n_local
// receivers a shard, n_shards shards from receiver `start` on, of n_glob.
// A non-null `clock` launches the phase clock's instantiation, which adds
// each block's cycles into it (int64 [n_shards * n_trials, kRoundPhases]).
extern "C" int qba_fused_round(
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
      clock ? (sharded ? fused_round_sharded<true> : fused_round_single<true>)
            : (sharded ? fused_round_sharded<false>
                       : fused_round_single<false>);
  size_t smem = 0;
  if (int e = prepare_smem(kernel, d, &smem)) return e;
  kernel<<<n_trials * n_shards, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
