// A batch's trial set-up in one launch: the key split, the dishonest
// parties, the factorized lists, the commander's orders, the P-sets and
// the collude target of every trial; and, as a second entry, the batch's
// trial keys themselves.
//
// Not a pallas_call site: the counterpart of the set-up XLA compiles for
// the JAX package inside its jitted batch (qba_tpu/rounds/engine.py:511,
// setup_trial, over qba_tpu/qsim/sampler.py:30 generate_lists and
// qba_tpu/adversary/model.py:63,74,227 assign_dishonest, commander_orders
// and the collude target), and of the key split before it
// (jax.random.split(jax.random.fold_in(key(seed), d), num):
// qba_tpu/backends/jax_backend.py:33, qba_tpu/sweep.py:111, :349, :729,
// qba_tpu/benchmark.py:267).  The plain PyTorch versions they are held
// against are qba_tpu_torch/ops/setup_kernel.py :: setup_reference (the
// eager setup_trial, generate_lists, assign_dishonest, commander_orders
// and adversary_ctx) and keys_reference (random.py's split and fold_in);
// setup_at_reference there mirrors this file's own algorithm trial by
// trial.  Every draw is draws.cuh's threefry2x32 on the key tree of
// qba_tpu_torch/random.py, in both of JAX's threefry modes (kLegacy), bit
// for bit.
//
// For trial key k (form "lists": k is the lists key itself):
//   k_dis, k_lists, k_comm, k_rounds = split(k, 4)
//   honest   permutation(k_dis, 1..n): perm_rounds rounds of (k_dis, sub)
//            = split(k_dis, 2), a stable argsort of bits(sub, (n,)) and a
//            gather; ranks out[0 .. n_dishonest) are dishonest;
//   lists    l0..l3 = split(k_lists, 4); qcorr = uniform(l0, (S,)) < 0.5;
//            r = randint(l1, (S,), 0, w); noise = bits(l2, (S, n)), each
//            position's perm = argsort(noise[s]) + 1; u = randint(l3, (n,
//            S), 0, w); a Q-correlated position's row 0 is r, row 1 + j is
//            r ^ perm[j]; another's row 0 is u[0], row 1 + j is u[j]; with
//            noise each row XORs classical_flip_ints(k_lists, (n+1, S)):
//            per qubit bernoulli(p_dep) & randint(0, 3) != 2, XOR
//            bernoulli(p_mf), off split(fold_in(k_lists, 0x401E), 3);
//   orders   c0..c2 = split(k_comm, 3); v, v1 = randint(c0 | c1, (), 0,
//            w); v2 = (v1 + 1 + randint(c2, (), 0, w - 1)) % w; an honest
//            commander sends v to every lieutenant, a dishonest one v1 to
//            the first half of the ranks (even ranks under "split"), v2 to
//            the rest;
//   P-sets   p_rows[l][s] = lists[0][s] != lists[1][s] and lists[1][s] ==
//            v_sent[l];
//   target   randint(fold_in(k_rounds, 0xC011), (), 0, n + 1) (strategies
//            collude and adaptive).
// The forms (template kForm) compile what each caller needs: kWhole all of
// it; kGiven all but the lists, which it reads (the dense and stabilizer
// paths); kOrders the honesty, orders, target and k_lists (the megakernel's
// gen entry); kLists the lists alone.
//
// What the function needs, and only that, is drawn (the phase clock put
// the ranks and the noise words at 82-84% of a 33-party block when every
// position drew both):
// * the noise words of a position, and their ranks, only where it is
//   Q-correlated (its row 1 + rank_i is r ^ (i + 1)); elsewhere row j + 1
//   is u[j][s] whatever the ranks are, so thread (s, j) writes it;
// * r only where Q-correlated;
// * randint with a power-of-two span (w: u, r, v, v1) from the low word
//   alone (randint_pow2: 2^32 mod span is 0, so JAX's high word is
//   multiplied by zero); v2's span w - 1, the target's n + 1 and the
//   noise kind's 3 keep draws.cuh's general form;
// * a noise kind only where its qubit's Pauli draw fired, and no Pauli or
//   flip draw where its probability is 0 (a uniform in [0, 1) is never
//   below 0).
// In the legacy mode each draw still pairs its index with the one h =
// ceil(m / 2) away in its call's table of m words (draws.cuh :: bits_at
// <true>): S * n for the noise and for u, S for qcorr and r, n for the
// permutation, 1 for a scalar randint, (n + 1) * S * n_qubits for the
// noise flips; only whether a word is drawn changes.  One hash an entry
// in either mode.
//
// The stable argsort is a rank: key_i = (x_i << 32) | i, rank_i = #{j :
// key_j < key_i} (one 64-bit subtraction's borrow: argsort's order on
// ties), perm[rank_i] = i, O(n^2) over a position's n words in shared
// memory, read four at a time.
//
// Design.  A block of kThreads (128) threads a trial (64 and 256 ran no
// faster on the H100: PERF.md).  Warp 0 derives the trial's
// keys, a lane a key (kPaths: each lane walks its key's path from the
// trial key, so the prologue is as deep as the longest path, 4 hashes, 8
// in the legacy mode, where a split is two words).  Then warp 0 runs the
// permutation (one round for every n <= kMaxParties: party i + 1 is
// dishonest where rank_i < n_dishonest), the honesty and the orders under
// warp barriers, while the other warps draw the first tile's Q bits and r
// and start its words (named barriers 1 and 2; warp 0 joins the words
// after).  The positions walk in tiles of `tile` (tile * n within
// kTileWords, and the block's shared memory within kSmemBytes, the limit
// a launch may take without opting in, for any n and size_l): a warp takes
// 32 entries (s, i) at a time and hashes one word an entry (the noise word
// where Q-correlated, else u[i][s] into row i + 1); a thread a (Q
// position, word) ranks; with noise a thread a (row, position) XORs its
// flips; then the tile's rows go to device memory row by row (16 bytes a
// store where aligned) and the P-sets from rows 0 and 1 (4 a store).  A
// flat index splits into (quotient, remainder) by a multiply (Div): no
// division on an entry.
//
// Bound on this card: operations, the hashes (80 operations each) and the
// ranks' compares (see chip_smoke.py :: setup_cost).  About 10 KB of
// outputs a trial at 33 parties.
//
// Layouts: keys int64 [T, 2]; lists_in int32 [T, n + 1, S] (kGiven);
// honest bool [T, n + 1]; lists int32 [T, n + 1 - row0, S] (rows row0..n;
// row0 2 gives the lieutenants' lists); p_rows bool [T, n - 1, S]; v_sent
// int32 [T, n - 1]; v_comm int32 [T]; k_rounds, k_lists int64 [T, 2];
// target int32 [T] (null where the strategy has none); qcorr bool [T, S]
// (kLists); clock int64 [T, kPhases] (the phase clock).  All arithmetic is
// uint32_t; the bernoulli compares are IEEE float32: build without
// fast-math flags.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include "draws.cuh"

namespace {

using namespace qba_draws;

constexpr int kThreads = 128;  // a block's threads
constexpr int kWarp = 32;
constexpr int kTileWords = 4096;  // bounds a tile's positions: tile * n
// Bounds a launch's dynamic shared memory: 48 KB, the most a launch takes
// without cudaFuncSetAttribute, less 1 KB for the static arrays.
constexpr int kSmemBytes = 47 * 1024;
constexpr int kMaxParties = 1024;
constexpr uint32_t kNoiseTag = 0x401Eu;
constexpr uint32_t kColludeTag = 0xC011u;

enum Form { kWhole = 0, kGiven = 1, kOrders = 2, kLists = 3 };

// The phase clock's phases, in the order of its int64 [T, kPhases] buffer
// (SETUP_PHASES in setup_kernel.py).
enum SetupPhase {
  kSpKeys,   // warp 0's key paths
  kSpPerm,   // warp 0: permutation, honesty, orders (the others: Q bits, r)
  kSpWords,  // a hash an entry: noise words, u's rows
  kSpRanks,  // the Q-correlated positions' ranks and rows
  kSpFlips,  // the noise flips (0 without noise)
  kSpOut,    // rows to device memory, P-sets
  kPhases
};

// Warp 0's SM cycles between the block's barriers, a phase each (kOn: the
// clocked instantiation; off, the calls compile to nothing).
template <bool kOn>
struct SetupClock {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void store(long long*) const {}
};

template <>
struct SetupClock<true> {
  long long last, acc[kPhases];
  __device__ void start() {
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    last = clock64();
  }
  __device__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  }
  __device__ void store(long long* out) const {
    if (threadIdx.x == 0)
      for (int i = 0; i < kPhases; ++i) out[i] += acc[i];
  }
};

struct Params {
  const int64_t* keys;
  const int32_t* lists_in;
  uint8_t* honest;
  int32_t* lists;
  uint8_t* p_rows;
  int32_t* v_sent;
  int32_t* v_comm;
  int64_t* k_rounds;
  int32_t* target;
  int64_t* k_lists;
  uint8_t* qcorr;
  long long* clock;
  int n, n_dishonest, size_l, w, n_qubits, split, row0, noise;
  float p_dep, p_mf;
  int tile;  // positions a tile
  int np;    // a position's words in shared memory: n padded to 4
  int ld;    // a row's stride in the tile's rows: odd, at least 3
};

// The trial's derived keys, a lane each (kPaths' order).  A scalar draw's
// lane holds its word in k0.  The permutation has one round: JAX's
// ceil(3 ln n / ln(2^32 - 1)) is 1 for every 2 <= n <= kMaxParties.
enum KeyId {
  kKPerm,                                // the permutation's sub key
  kKL0, kKL2, kKRLo, kKULo,              // the lists' streams
  kKPauli, kKMflip, kKKindHi, kKKindLo,  // the noise flips'
  kKV, kKV1, kKV2Hi, kKV2Lo,             // the orders' words
  kKRounds, kKTargetHi, kKTargetLo,      // k_rounds, the target's words
  kKLists,                               // k_lists ("orders")
  kKeyCount
};

// A key path's steps: split(key, j, num), fold_in(key, tag), or the word
// bits(key, (), uint32) of a scalar draw; 0 ends a path.
enum Op : uint32_t { kOpEnd = 0, kOpSplit = 1, kOpFold = 2, kOpBits = 3 };
constexpr int kMaxSteps = 4;

__host__ __device__ constexpr uint32_t sp(uint32_t j, uint32_t num) {
  return kOpSplit | (num << 2) | (j << 16);
}
__host__ __device__ constexpr uint32_t fo(uint32_t tag) {
  return kOpFold | (tag << 16);
}
constexpr uint32_t kBits = kOpBits;

// Each key's path from the trial key.  The lists' lanes (kKL0..kKKindLo)
// start with k_lists = split(k, 1, 4), which the form "lists" skips.
__device__ const uint32_t kPaths[kKeyCount][kMaxSteps] = {
    {sp(0, 4), sp(1, 2)},                            // the perm's sub
    {sp(1, 4), sp(0, 4)},                            // l0: qcorr
    {sp(1, 4), sp(2, 4)},                            // l2: noise words
    {sp(1, 4), sp(1, 4), sp(1, 2)},                  // l1's low: r
    {sp(1, 4), sp(3, 4), sp(1, 2)},                  // l3's low: u
    {sp(1, 4), fo(kNoiseTag), sp(0, 3)},             // pauli
    {sp(1, 4), fo(kNoiseTag), sp(2, 3)},             // mflip
    {sp(1, 4), fo(kNoiseTag), sp(1, 3), sp(0, 2)},   // kind's high
    {sp(1, 4), fo(kNoiseTag), sp(1, 3), sp(1, 2)},   // kind's low
    {sp(2, 4), sp(0, 3), sp(1, 2), kBits},           // v's low word
    {sp(2, 4), sp(1, 3), sp(1, 2), kBits},           // v1's low word
    {sp(2, 4), sp(2, 3), sp(0, 2), kBits},           // v2's draw: high
    {sp(2, 4), sp(2, 3), sp(1, 2), kBits},           // and low
    {sp(3, 4)},                                      // k_rounds
    {sp(3, 4), fo(kColludeTag), sp(0, 2), kBits},    // target: high
    {sp(3, 4), fo(kColludeTag), sp(1, 2), kBits},    // and low
    {sp(1, 4)},                                      // k_lists
};

// One step of a key path.  The partitionable mode hashes (0, j) for a
// split or a fold (the same pair) and (0, 0) for a scalar word (y0 ^ y1).
// The legacy mode's split is words 2j and 2j + 1 of bits over 2 num words
// (h = num: word i < h is y0 of (i, i + h), else y1 of (i - h, i)); its
// fold hashes (0, tag) and its scalar word is y0 of (0, 0).  Both hashes
// run on every lane (no divergence among the ops).
template <bool kLegacy>
__device__ __forceinline__ Key key_step(Key k, uint32_t code) {
  const uint32_t op = code & 3u, num = (code >> 2) & 7u, arg = code >> 16;
  if constexpr (kLegacy) {
    const uint32_t ia = 2u * arg, ib = ia + 1u;
    const bool sa = ia >= num, sb = ib >= num;
    const bool split = op == kOpSplit;
    uint32_t a0 = split ? (sa ? ia - num : ia) : 0u;
    uint32_t a1 = split ? (sa ? ia : ia + num) : (op == kOpFold ? arg : 0u);
    uint32_t b0 = sb ? ib - num : ib, b1 = sb ? ib : ib + num;
    threefry2x32(k, a0, a1);
    threefry2x32(k, b0, b1);
    if (split) return Key{sa ? a1 : a0, sb ? b1 : b0};
    return Key{a0, op == kOpFold ? a1 : 0u};
  } else {
    uint32_t x0 = 0u, x1 = op == kOpBits ? 0u : arg;
    threefry2x32(k, x0, x1);
    return op == kOpBits ? Key{x0 ^ x1, 0u} : Key{x0, x1};
  }
}

__device__ __forceinline__ Key key_of(const int64_t* k) {
  return Key{uint32_t(k[0]), uint32_t(k[1])};
}

__device__ __forceinline__ void store_key(int64_t* out, Key k) {
  out[0] = int64_t(k.k0);
  out[1] = int64_t(k.k1);
}

// jax.random.randint(key, shape, 0, span) for a power-of-two span <=
// 2^16, from the low word `lo` (bits of split(key, 2)[1]) alone.  JAX
// scales the high word by (2^16 mod span)^2 mod span, which is 0 here, so
// its offset is (lo mod span) mod span = lo & (span - 1).
__device__ __forceinline__ uint32_t randint_pow2(uint32_t lo, uint32_t span) {
  return lo & (span - 1u);
}

// jax.random.randint's offset from its two words, any span (as
// draws.cuh :: randint_at, for words already hashed).
__device__ __forceinline__ uint32_t randint_words(uint32_t hi, uint32_t lo,
                                                  uint32_t span) {
  const uint32_t m16 = 65536u % span;
  const uint32_t mult = uint32_t(uint64_t(m16) * m16 % span);
  return ((hi % span) * mult + lo % span) % span;
}

// r - 1 where (xj, jj) < (xi, ci) as 64-bit unsigned keys, else r: the
// borrow of the 64-bit subtraction, taken by one more subtraction with
// borrow (whatever the carry flag's convention, the chain's own), three
// instructions with no compare.
__device__ __forceinline__ uint32_t sub_lt(uint32_t r, uint32_t xj,
                                          uint32_t jj, uint32_t xi,
                                          uint32_t ci) {
  uint32_t d;
  asm("sub.cc.u32 %0, %2, %3;\n\t"
      "subc.cc.u32 %0, %4, %5;\n\t"
      "subc.u32 %1, %1, 0;"
      : "=&r"(d), "+r"(r)
      : "r"(jj), "r"(ci), "r"(xj), "r"(xi));
  return r;
}

// The rank of word i among a position's words x[0 .. np) (np a multiple of
// 4; the pads past n hold 0xFFFFFFFF, whose keys exceed every real one):
// #{j : (x_j, j) < (x_i, i)}, argsort's stable position.  Word j = j0 + k
// of a load of four compares as (x_j, j0 + 4) < (x_i, i + 4 - k), so that
// no index is computed a word; the count runs down from 0.
__device__ __forceinline__ int rank_of(const uint32_t* x, int np, int i) {
  const uint32_t xi = x[i], ci = uint32_t(i) + 4u;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint32_t r = 0u;
  for (int j4 = 0; j4 < np / 4; ++j4) {
    const uint4 q = x4[j4];
    const uint32_t jj = 4u * uint32_t(j4) + 4u;
    r = sub_lt(r, q.x, jj, xi, ci);
    r = sub_lt(r, q.y, jj, xi, ci - 1u);
    r = sub_lt(r, q.z, jj, xi, ci - 2u);
    r = sub_lt(r, q.w, jj, xi, ci - 3u);
  }
  return int(0u - r);
}

// Division by d as a multiply: q(x) = umulhi(x, ceil(2^32 / d)) is x / d
// for every x < 2^32 / d (its error x (ceil(2^32 / d) d - 2^32) / (d
// 2^32) stays under 1 / d).  Every flat index here is below 2^13 (tile * n
// <= kTileWords), every divisor at most 2048.
struct Div {
  uint32_t d, m;
  __device__ explicit Div(int d_)
      : d(uint32_t(d_)), m(d_ > 1 ? 0xFFFFFFFFu / uint32_t(d_) + 1u : 0u) {}
  __device__ int q(int x) const {
    return d > 1u ? int(__umulhi(uint32_t(x), m)) : x;
  }
};

// Named barriers: the warps past warp 0 draw the first tile's Q bits and
// start its words while warp 0 runs the permutation.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// classical_flip_ints at (row, s): the row's qubits' flips, big-endian.
// The noise kind is drawn only where the qubit's Pauli draw fired, and
// neither stream where its probability is 0.
template <bool kLegacy>
__device__ __forceinline__ int flip_int(const Key* ks, const Params& P,
                                        uint32_t row, uint32_t s) {
  const uint32_t nq = uint32_t(P.n_qubits);
  const uint32_t table = uint32_t(P.n + 1) * uint32_t(P.size_l) * nq;
  const uint32_t base = (row * uint32_t(P.size_l) + s) * nq;
  int out = 0;
  for (uint32_t q = 0; q < nq; ++q) {
    const uint32_t i = base + q;
    bool flip = false;
    if (P.p_dep > 0.0f &&
        uniform_at<kLegacy>(ks[kKPauli], i, table) < P.p_dep)
      flip = randint_at<kLegacy>(ks[kKKindHi], ks[kKKindLo], i, 3u,
                                 table) != 2u;
    if (P.p_mf > 0.0f)
      flip ^= uniform_at<kLegacy>(ks[kKMflip], i, table) < P.p_mf;
    out |= int(flip) << (nq - 1u - q);
  }
  return out;
}

template <bool kLegacy, int kForm, bool kClock = false>
__global__ void __launch_bounds__(kThreads) setup_trial_kernel(Params P) {
  constexpr bool kHasLists = kForm == kWhole || kForm == kLists;
  constexpr bool kHasOrders = kForm != kLists;
  constexpr bool kHasPsets = kForm == kWhole || kForm == kGiven;
  __shared__ Key ks[kKeyCount];
  __shared__ int n_q;   // the tile's Q-correlated positions
  __shared__ int next;  // the words' next chunk of entries
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = P.n, S = P.size_l, n_lt = P.n - 1, tile = P.tile;
  const int np = P.np, ld = P.ld;
  const int tid = int(threadIdx.x);
  constexpr int nt = kThreads;
  const int lane = tid & (kWarp - 1);
  const bool warp0 = tid < kWarp;
  const size_t t = blockIdx.x;
  // Shared memory: a tile's words (np a position), the permutation's
  // words, the tile's rows ((n + 1) rows of stride ld), r and the Q list
  // of a tile, the lieutenants' orders (int32), then the honesty and a
  // tile's Q bits (bytes).
  uint32_t* words = smem;
  uint32_t* perm_w = words + size_t(tile) * np;
  int* rows = reinterpret_cast<int*>(perm_w + np);
  int* rs = rows + size_t(n + 1) * ld;
  int* qidx = rs + tile;
  int* vs = qidx + tile;
  uint8_t* hon = reinterpret_cast<uint8_t*>(vs + n_lt);
  uint8_t* qc = hon + n + 1;
  SetupClock<kClock> clk;
  clk.start();

  const Key trial = key_of(P.keys + 2 * t);
  if (warp0) {
    // A lane a key: its path from the trial key.
    const bool live =
        lane < kKeyCount &&
        (lane == kKPerm ? kHasOrders
         : lane < kKPauli ? kHasLists
         : lane < kKV ? kHasLists && P.noise
         : lane < kKTargetHi ? kHasOrders
         : lane < kKLists ? kHasOrders && P.target != nullptr
                          : kForm == kOrders);
    Key k = trial;
    if (live) {
      const int first = kForm == kLists && lane >= kKL0 && lane < kKV;
      for (int st = first; st < kMaxSteps; ++st) {
        const uint32_t code = kPaths[lane][st];
        if (code == kOpEnd) break;
        k = key_step<kLegacy>(k, code);
      }
    }
    if (lane < kKeyCount) ks[lane] = k;
    if (lane == kKRounds && live) store_key(P.k_rounds + 2 * t, k);
    if (lane == kKLists && live) store_key(P.k_lists + 2 * t, k);
    if (lane == 0) n_q = next = 0;
  }
  __syncthreads();
  clk.mark(kSpKeys);

  // A thread a position of the tile from s0: the Q bit, r and the Q list
  // where Q-correlated, the pads of the position's words.
  auto q_bits = [&](int s0, int tp, int from) {
    for (int sl = tid - from; sl < tp; sl += nt - from) {
      const uint32_t s = uint32_t(s0 + sl);
      const bool q = uniform_at<kLegacy>(ks[kKL0], s, uint32_t(S)) < 0.5f;
      qc[sl] = q;
      if (q) {
        rs[sl] = int(randint_pow2(
            bits_at<kLegacy>(ks[kKRLo], s, uint32_t(S)), uint32_t(P.w)));
        qidx[atomicAdd(&n_q, 1)] = sl;
      }
      for (int i = n; i < np; ++i) words[size_t(sl) * np + i] = ~0u;
    }
  };
  if (kHasOrders && warp0) {
    // The permutation of ranks 1..n (one round): word i's rank is its
    // party's place, and the first n_dishonest places are dishonest; then
    // the orders.  Warp 0 alone, warp barriers only.
    for (int i = lane; i < np; i += kWarp)
      perm_w[i] =
          i < n ? bits_at<kLegacy>(ks[kKPerm], uint32_t(i), uint32_t(n))
                : ~0u;
    __syncwarp();
    if (lane == 0) hon[0] = 1;
    for (int i = lane; i < n; i += kWarp)
      hon[i + 1] = rank_of(perm_w, np, i) >= P.n_dishonest;
    __syncwarp();
    uint8_t* honest = P.honest + t * size_t(n + 1);
    for (int i = lane; i <= n; i += kWarp) honest[i] = hon[i];
    const uint32_t w = uint32_t(P.w);
    const int v = int(randint_pow2(ks[kKV].k0, w));
    const int v1 = int(randint_pow2(ks[kKV1].k0, w));
    const int v2 = int((uint32_t(v1) + 1u +
                        randint_words(ks[kKV2Hi].k0, ks[kKV2Lo].k0,
                                      w > 1u ? w - 1u : 1u)) % w);
    if (lane == 0) {
      P.v_comm[t] = v;
      if (P.target)
        P.target[t] = int(randint_words(ks[kKTargetHi].k0,
                                        ks[kKTargetLo].k0, uint32_t(n + 1)));
    }
    const bool comm_honest = hon[1] != 0;
    for (int l = lane; l < n_lt; l += kWarp) {
      const int rank = l + 2;
      const bool first = P.split ? rank % 2 == 0 : rank <= (n + 1) / 2;
      const int vl = comm_honest ? v : first ? v1 : v2;
      vs[l] = vl;
      P.v_sent[t * size_t(n_lt) + l] = vl;
    }
  } else if (kHasLists && !warp0) {
    // The first tile's Q bits, then on to its words: warp 0 joins them
    // after the permutation (barrier 1), the others go on together
    // (barrier 2).
    q_bits(0, min(tile, S), kWarp);
    bar_arrive(1, nt);
    bar_sync(2, nt - kWarp);
  }
  if constexpr (kForm == kOrders) return;
  if constexpr (kHasLists) {
    if (warp0) bar_sync(1, nt);
  } else {
    __syncthreads();
  }
  clk.mark(kSpPerm);

  const int n_out = n + 1 - P.row0;
  int32_t* lists = P.lists + t * size_t(n_out) * S;
  // Whole 16-byte rows and 4-byte P-set words where S and the tiles keep
  // them aligned.
  const bool vec = (S & 3) == 0 && (tile & 3) == 0;
  const Div by_n(n);
  for (int s0 = 0; s0 < S; s0 += tile) {
    const int tp = min(tile, S - s0);
    const Div by_tp(tp);
    if constexpr (kHasLists) {
      if (s0 > 0) {
        q_bits(s0, tp, 0);
        __syncthreads();
      }
      // A hash an entry (s, i), a warp a chunk of 32 entries: the noise
      // word where Q-correlated, else u[i][s] into row i + 1 (and row 0
      // from u[0][s]).
      const uint32_t table = uint32_t(S) * uint32_t(n);
      const int total = tp * n;
      for (;;) {
        int c = 0;
        if (lane == 0) c = atomicAdd(&next, kWarp);
        c = __shfl_sync(0xFFFFFFFFu, c, 0);
        if (c >= total) break;
        const int idx = c + lane;
        if (idx < total) {
          const int sl = by_n.q(idx), i = idx - sl * n;
          const uint32_t s = uint32_t(s0 + sl);
          const bool q = qc[sl] != 0;
          const uint32_t h = bits_at<kLegacy>(
              q ? ks[kKL2] : ks[kKULo],
              q ? uint32_t(s0) * uint32_t(n) + uint32_t(idx)
                : uint32_t(i) * uint32_t(S) + s,
              table);
          if (q) {
            words[size_t(sl) * np + i] = h;
            if (i == 0) rows[sl] = rs[sl];
          } else {
            const int v = int(randint_pow2(h, uint32_t(P.w)));
            rows[(i + 1) * ld + sl] = v;
            if (i == 0) rows[sl] = v;
          }
        }
      }
      __syncthreads();
      if (tid == 0) next = 0;
      clk.mark(kSpWords);
      // A thread a (Q-correlated position, word): its rank, row 1 + rank.
      const int nq = n_q;
      for (int idx = tid; idx < nq * n; idx += nt) {
        const int k = by_n.q(idx), i = idx - k * n, sl = qidx[k];
        const int rank = rank_of(words + size_t(sl) * np, np, i);
        rows[(rank + 1) * ld + sl] = rs[sl] ^ (i + 1);
      }
      __syncthreads();
      if (tid == 0) n_q = 0;
      clk.mark(kSpRanks);
      if (P.noise) {
        for (int idx = tid; idx < (n + 1) * tp; idx += nt) {
          const int row = by_tp.q(idx), sl = idx - row * tp;
          rows[row * ld + sl] ^=
              flip_int<kLegacy>(ks, P, uint32_t(row), uint32_t(s0 + sl));
        }
        __syncthreads();
      }
      clk.mark(kSpFlips);
    } else {
      const int32_t* in = P.lists_in + t * size_t(n + 1) * S;
      for (int idx = tid; idx < (n + 1) * tp; idx += nt) {
        const int row = by_tp.q(idx), sl = idx - row * tp;
        rows[row * ld + sl] = in[size_t(row) * S + s0 + sl];
      }
      __syncthreads();
    }
    // The tile's rows row0.. to device memory, row by row, and the
    // P-sets from rows 0 and 1 (or the Q bits).
    if (vec) {
      const int q4 = tp / 4;
      const Div by_q4(q4);
      for (int idx = tid; idx < n_out * q4; idx += nt) {
        const int r = by_q4.q(idx), sl = 4 * (idx - r * q4);
        const int* src = rows + (r + P.row0) * ld + sl;
        *reinterpret_cast<int4*>(lists + size_t(r) * S + s0 + sl) =
            make_int4(src[0], src[1], src[2], src[3]);
      }
    } else {
      for (int idx = tid; idx < n_out * tp; idx += nt) {
        const int r = by_tp.q(idx), sl = idx - r * tp;
        lists[size_t(r) * S + s0 + sl] = rows[(r + P.row0) * ld + sl];
      }
    }
    if constexpr (kHasPsets) {
      uint8_t* p_rows = P.p_rows + t * size_t(n_lt) * S;
      if (vec) {
        const int q4 = tp / 4;
        const Div by_q4(q4);
        for (int idx = tid; idx < n_lt * q4; idx += nt) {
          const int l = by_q4.q(idx), sl = 4 * (idx - l * q4);
          uint32_t bits = 0u;
          for (int k = 0; k < 4; ++k) {
            const int r0 = rows[sl + k], r1 = rows[ld + sl + k];
            bits |= uint32_t(r0 != r1 && r1 == vs[l]) << (8 * k);
          }
          *reinterpret_cast<uint32_t*>(p_rows + size_t(l) * S + s0 + sl) =
              bits;
        }
      } else {
        for (int idx = tid; idx < n_lt * tp; idx += nt) {
          const int l = by_tp.q(idx), sl = idx - l * tp;
          const int r0 = rows[sl], r1 = rows[ld + sl];
          p_rows[size_t(l) * S + s0 + sl] = uint8_t(r0 != r1 && r1 == vs[l]);
        }
      }
    } else {
      for (int sl = tid; sl < tp; sl += nt)
        P.qcorr[t * size_t(S) + s0 + sl] = qc[sl];
    }
    __syncthreads();
    clk.mark(kSpOut);
  }
  if constexpr (kClock) clk.store(P.clock + t * kPhases);
}

template <bool kLegacy>
void* kernel_of(int form) {
  switch (form) {
    case kWhole: return (void*)setup_trial_kernel<kLegacy, kWhole>;
    case kGiven: return (void*)setup_trial_kernel<kLegacy, kGiven>;
    case kOrders: return (void*)setup_trial_kernel<kLegacy, kOrders>;
    default: return (void*)setup_trial_kernel<kLegacy, kLists>;
  }
}

// The trial keys split(root', num), root' = fold_in(root, d) or root, as
// 2 num words (key t is words 2t and 2t + 1): thread t hashes once.  In
// the partitionable mode its hash (0, t) is key t.  In the legacy mode
// the split is bits over 2 num words with h = num, so hash (t, t + num)
// gives word t (y0) and word t + num (y1): the thread writes both.  The
// root comes from device memory or by value; d from device memory (an
// int32, cast to uint32 as JAX casts it), so a CUDA graph replays the
// launch with a new carry, or by value.  The fold is a hash a thread.
constexpr int kKeyThreads = 256;
enum FoldMode { kFoldNone, kFoldTensor, kFoldValue };

template <bool kLegacy>
__global__ void __launch_bounds__(kKeyThreads)
    trial_keys_kernel(const int64_t* root, Key by_value, const int32_t* fold,
                      int fold_mode, uint32_t fold_value, int64_t* out,
                      uint32_t num) {
  const uint32_t t = blockIdx.x * uint32_t(kKeyThreads) + threadIdx.x;
  if (t >= num) return;
  Key k = root ? key_of(root) : by_value;
  if (fold_mode != kFoldNone)
    k = fold_in(k, fold_mode == kFoldTensor ? uint32_t(*fold) : fold_value);
  if constexpr (kLegacy) {
    uint32_t y0 = t, y1 = t + num;
    threefry2x32(k, y0, y1);
    out[t] = int64_t(y0);
    out[size_t(t) + num] = int64_t(y1);
  } else {
    store_key(out + 2 * size_t(t), split_at<false>(k, t, num));
  }
}

}  // namespace

// Shared memory of a launch in bytes (the Python mirror is
// setup_kernel.py :: setup_smem_bytes).
extern "C" int qba_setup_smem_bytes(int n, int tile) {
  const int np = (n + 3) & ~3, ld = tile | 1;
  return 4 * (tile * np + np + (n + 1) * ld + 2 * tile + (n - 1)) +
         (n + 1) + tile;
}

// List positions a tile (setup_kernel.py :: setup_tile): at most
// kTileWords / n, and as many as keep qba_setup_smem_bytes within
// kSmemBytes (the bytes a position adds, with ld <= tile + 1, over what
// the rest takes), a multiple of 4 there; at least one.
static int setup_tile(int n, int size_l) {
  const int np = (n + 3) & ~3;
  const int per = 4 * np + 4 * (n + 1) + 9;
  const int fixed = 4 * (np + (n + 1) + (n - 1)) + (n + 1);
  int tile = size_l < kTileWords / n ? size_l : kTileWords / n;
  const int fit = ((kSmemBytes - fixed) / per) & ~3;
  if (tile > fit) tile = fit;
  return tile > 1 ? tile : 1;
}

// Returns a cudaError_t: 0 on a launch that was accepted.  p_dep_bits and
// p_mf_bits are float32 p_depolarize's and p_measure_flip's bit patterns;
// legacy selects JAX's non-partitionable threefry mode; a clock launches
// the phase clock's instantiation (the whole form, partitionable).
extern "C" int qba_setup_trial(
    const void* keys, const void* lists_in, void* honest, void* lists,
    void* p_rows, void* v_sent, void* v_comm, void* k_rounds, void* target,
    void* k_lists, void* qcorr, void* clock, int n_trials, int n_parties,
    int n_dishonest, int size_l, int w, int n_qubits, int split, int row0,
    int noise, int p_dep_bits, int p_mf_bits,
    int form, int legacy, void* stream) {
  if (n_trials <= 0) return 0;
  const long long n = n_parties, S = size_l;
  if (n < 2 || n > kMaxParties || S < 1 || n_dishonest < 0 ||
      n_dishonest > n || w <= n || w > 2 * kMaxParties || (w & (w - 1)) ||
      n_qubits < 1 || (1 << n_qubits) != w || form < kWhole ||
      form > kLists ||
      (row0 != 0 && row0 != 2) || !keys ||
      (form != kLists && (!honest || !v_sent || !v_comm || !k_rounds)) ||
      (form == kOrders && !k_lists) || (form == kGiven && !lists_in) ||
      (form != kOrders && !lists) ||
      ((form == kWhole || form == kGiven) && !p_rows) ||
      (form == kLists && (!qcorr || row0 != 0)) ||
      (n + 1) * S * n_qubits >= 0xFFFFFFFFll || n_trials > INT_MAX ||
      (clock && (legacy || form != kWhole)))
    return int(cudaErrorInvalidValue);
  Params P;
  P.keys = static_cast<const int64_t*>(keys);
  P.lists_in = static_cast<const int32_t*>(lists_in);
  P.honest = static_cast<uint8_t*>(honest);
  P.lists = static_cast<int32_t*>(lists);
  P.p_rows = static_cast<uint8_t*>(p_rows);
  P.v_sent = static_cast<int32_t*>(v_sent);
  P.v_comm = static_cast<int32_t*>(v_comm);
  P.k_rounds = static_cast<int64_t*>(k_rounds);
  P.target = static_cast<int32_t*>(target);
  P.k_lists = static_cast<int64_t*>(k_lists);
  P.qcorr = static_cast<uint8_t*>(qcorr);
  P.clock = static_cast<long long*>(clock);
  P.n = n_parties;
  P.n_dishonest = n_dishonest;
  P.size_l = size_l;
  P.w = w;
  P.n_qubits = n_qubits;
  P.split = split;
  P.row0 = row0;
  P.noise = noise;
  std::memcpy(&P.p_dep, &p_dep_bits, sizeof(float));
  std::memcpy(&P.p_mf, &p_mf_bits, sizeof(float));
  P.tile = setup_tile(n_parties, size_l);
  P.np = (n_parties + 3) & ~3;
  P.ld = P.tile | 1;
  const int smem = qba_setup_smem_bytes(n_parties, P.tile);
  if (smem > kSmemBytes) return int(cudaErrorInvalidValue);
  void* kernel = clock ? (void*)setup_trial_kernel<false, kWhole, true>
                 : legacy ? kernel_of<true>(form) : kernel_of<false>(form);
  void* args[] = {&P};
  cudaError_t rc = cudaLaunchKernel(kernel, dim3(unsigned(n_trials)),
                                    dim3(unsigned(kThreads)), args,
                                    size_t(smem),
                                    static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return int(rc);
  return int(cudaGetLastError());
}

// The trial keys' split: out int64 [num, 2]; root int64 [2] on the device,
// or null for the key (root0, root1) by value; fold_mode 0 (no fold_in), 1
// (the int32 at `fold`) or 2 (fold_value).
extern "C" int qba_trial_keys(const void* root, const void* fold, void* out,
                              int num, int root0, int root1, int fold_mode,
                              int fold_value, int legacy, void* stream) {
  if (num <= 0) return 0;
  if (!out || fold_mode < kFoldNone || fold_mode > kFoldValue ||
      (fold_mode == kFoldTensor && !fold))
    return int(cudaErrorInvalidValue);
  const Key by_value{uint32_t(root0), uint32_t(root1)};
  const int64_t* r = static_cast<const int64_t*>(root);
  const int32_t* f = static_cast<const int32_t*>(fold);
  int64_t* o = static_cast<int64_t*>(out);
  const unsigned blocks = unsigned((num + kKeyThreads - 1) / kKeyThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (legacy)
    trial_keys_kernel<true><<<blocks, kKeyThreads, 0, st>>>(
        r, by_value, f, fold_mode, uint32_t(fold_value), o, uint32_t(num));
  else
    trial_keys_kernel<false><<<blocks, kKeyThreads, 0, st>>>(
        r, by_value, f, fold_mode, uint32_t(fold_value), o, uint32_t(num));
  return int(cudaGetLastError());
}
