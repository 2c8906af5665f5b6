// A batch's trial set-up in one launch: the key split, the dishonest
// parties, the factorized lists, the commander's orders, the P-sets and
// the collude target of every trial.
//
// Not a pallas_call site: the counterpart of the set-up XLA compiles for
// the JAX package inside its jitted batch (qba_tpu/rounds/engine.py:511,
// setup_trial, over qba_tpu/qsim/sampler.py:30 generate_lists and
// qba_tpu/adversary/model.py:63,74,227 assign_dishonest, commander_orders
// and the collude target).  The plain PyTorch version it is held against
// is qba_tpu_torch/ops/setup_kernel.py :: setup_reference (the eager
// setup_trial, generate_lists, assign_dishonest, commander_orders and
// adversary_ctx); setup_at_reference there mirrors this file's own
// algorithm trial by trial.  Every draw is draws.cuh's threefry2x32 on the
// key tree of qba_tpu_torch/random.py, in both of JAX's threefry modes
// (kLegacy), bit for bit.
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
// The stable argsort is a rank: rank_i = #{j : x_j < x_i} + #{j < i : x_j
// == x_i}, perm[rank_i] = i, O(n^2) over a position's n words in shared
// memory, with argsort's order on ties.  Position s's word i goes to row 1
// + rank_i: r ^ (i + 1) where Q-correlated, else u[rank_i][s], whose (row,
// position) pairs the ranks visit once each.
//
// Design.  A block of kThreads a trial (a trial's work, a permutation and
// S sorts of n words, shares each position's words in shared memory;
// 1000 trials give every SM several blocks).  Lane 0 of warps 0-3 derives
// the trial's keys, a chain a warp (the dishonesty chain; the lists keys;
// the noise keys; the orders, rounds key and target), then the block ranks
// the permutation's words, then walks the positions in tiles of `tile` (a
// tile's tile * n words fit kTileWords, so shared memory stays bounded for
// any size_l), a thread a (position, word).  The lieutenants' rows go
// straight to device memory; rows 0 and 1 stay in shared memory for the
// P-sets.  In the legacy mode each draw pairs its index with the one h =
// ceil(m / 2) away in its own call's table of m words (draws.cuh ::
// bits_at<true>): S * n for the noise, n * S for u, S for qcorr and r, n
// for the permutation, 1 for a scalar randint, (n + 1) * S * n_qubits for
// the noise flips.  One hash an entry in either mode.
//
// Bound on this card: operations.  A trial hashes S * n noise words, 2 S *
// (n + 1) words of u (two a value), 3 S for qcorr and r, the permutation's
// n and some 40 keys, plus 4 per qubit of every (row, position) with noise:
// about 6.6 M hashes (~530 M operations) at 33 parties x 1000 trials
// against about 10 MB of outputs.  The rank adds S * n^2 compares.
//
// Layouts: keys int64 [T, 2]; lists_in int32 [T, n + 1, S] (kGiven);
// honest bool [T, n + 1]; lists int32 [T, n + 1 - row0, S] (rows row0..n;
// row0 2 gives the lieutenants' lists); p_rows bool [T, n - 1, S]; v_sent
// int32 [T, n - 1]; v_comm int32 [T]; k_rounds, k_lists int64 [T, 2];
// target int32 [T] (null where the strategy has none); qcorr bool [T, S]
// (kLists).  All arithmetic is uint32_t; the bernoulli compares are IEEE
// float32: build without fast-math flags.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include "draws.cuh"

namespace {

using namespace qba_draws;

constexpr int kThreads = 128;
constexpr int kWarp = 32;  // the key chains run on lane 0 of warps 0-3
constexpr int kTileWords = 4096;  // a tile's sort words in shared memory
constexpr int kMaxParties = 1024;
constexpr int kMaxPermRounds = 4;
constexpr uint32_t kNoiseTag = 0x401Eu;
constexpr uint32_t kColludeTag = 0xC011u;

enum Form { kWhole = 0, kGiven = 1, kOrders = 2, kLists = 3 };

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
  int n, n_dishonest, size_l, w, n_qubits, split, perm_rounds, row0, noise;
  float p_dep, p_mf;
  int tile;  // positions a tile
};

// A trial's derived keys and scalar draws, shared by the block.
struct TrialKeys {
  Key perm[kMaxPermRounds];    // each permutation round's sub key
  Key l0, l2, r_hi, r_lo, u_hi, u_lo;  // the lists' streams
  Key pauli, kind_hi, kind_lo, mflip;  // the noise flips' streams
  int v, v1, v2;
};

__device__ __forceinline__ Key key_of(const int64_t* k) {
  return Key{uint32_t(k[0]), uint32_t(k[1])};
}

__device__ __forceinline__ void store_key(int64_t* out, Key k) {
  out[0] = int64_t(k.k0);
  out[1] = int64_t(k.k1);
}

// The rank of x[i] among x[0..n): argsort's stable position.
__device__ __forceinline__ int rank_of(const uint32_t* x, int n, int i) {
  const uint32_t xi = x[i];
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const uint32_t xj = x[j];
    r += int(xj < xi || (xj == xi && j < i));
  }
  return r;
}

// randint(key, (), 0, span) of a scalar draw (a table of one word).
template <bool kLegacy>
__device__ __forceinline__ int scalar_randint(Key k, uint32_t span) {
  return int(randint_at<kLegacy>(split_at<kLegacy>(k, 0u, 2u),
                                 split_at<kLegacy>(k, 1u, 2u), 0u, span, 1u));
}

// classical_flip_ints at (row, s): the row's qubits' flips, big-endian.
template <bool kLegacy>
__device__ __forceinline__ int flip_int(const TrialKeys& K, const Params& P,
                                        uint32_t row, uint32_t s) {
  const uint32_t nq = uint32_t(P.n_qubits);
  const uint32_t table = uint32_t(P.n + 1) * uint32_t(P.size_l) * nq;
  const uint32_t base = (row * uint32_t(P.size_l) + s) * nq;
  int out = 0;
  for (uint32_t q = 0; q < nq; ++q) {
    const uint32_t i = base + q;
    const bool pauli = uniform_at<kLegacy>(K.pauli, i, table) < P.p_dep;
    const uint32_t kind =
        randint_at<kLegacy>(K.kind_hi, K.kind_lo, i, 3u, table);
    const bool mflip = uniform_at<kLegacy>(K.mflip, i, table) < P.p_mf;
    out |= int((pauli && kind != 2u) != mflip) << (nq - 1u - q);
  }
  return out;
}

template <bool kLegacy, int kForm>
__global__ void __launch_bounds__(kThreads) setup_trial_kernel(Params P) {
  constexpr bool kHasLists = kForm == kWhole || kForm == kLists;
  constexpr bool kHasOrders = kForm != kLists;
  constexpr bool kHasPsets = kForm == kWhole || kForm == kGiven;
  __shared__ TrialKeys K;
  extern __shared__ uint32_t smem[];
  const int n = P.n, S = P.size_l, n_lt = P.n - 1, tile = P.tile;
  const int tid = int(threadIdx.x);
  const size_t t = blockIdx.x;
  // Shared memory: the sort words, the permutation's two buffers, the
  // lieutenants' orders, rows 0 and 1 and r of a tile (int32), then the
  // honesty and a tile's Q bits (bytes).
  uint32_t* words = smem;
  int* perm_a = reinterpret_cast<int*>(words + size_t(tile) * n);
  int* perm_b = perm_a + n;
  int* vs = perm_b + n;
  int* row0s = vs + n_lt;
  int* row1s = row0s + tile;
  int* rs = row1s + tile;
  uint8_t* hon = reinterpret_cast<uint8_t*>(rs + tile);
  uint8_t* qc = hon + n + 1;

  const Key trial = key_of(P.keys + 2 * t);
  if (tid == 0 * kWarp && kHasOrders) {
    Key kd = split_at<kLegacy>(trial, 0u, 4u);
    for (int r = 0; r < P.perm_rounds; ++r) {
      K.perm[r] = split_at<kLegacy>(kd, 1u, 2u);
      kd = split_at<kLegacy>(kd, 0u, 2u);
    }
  } else if (tid == 1 * kWarp && (kHasLists || kForm == kOrders)) {
    const Key kl =
        kForm == kLists ? trial : split_at<kLegacy>(trial, 1u, 4u);
    if constexpr (kForm == kOrders) {
      store_key(P.k_lists + 2 * t, kl);
    } else {
      K.l0 = split_at<kLegacy>(kl, 0u, 4u);
      const Key l1 = split_at<kLegacy>(kl, 1u, 4u);
      K.l2 = split_at<kLegacy>(kl, 2u, 4u);
      const Key l3 = split_at<kLegacy>(kl, 3u, 4u);
      K.r_hi = split_at<kLegacy>(l1, 0u, 2u);
      K.r_lo = split_at<kLegacy>(l1, 1u, 2u);
      K.u_hi = split_at<kLegacy>(l3, 0u, 2u);
      K.u_lo = split_at<kLegacy>(l3, 1u, 2u);
    }
  } else if (tid == 2 * kWarp && kHasLists && P.noise) {
    const Key kl =
        kForm == kLists ? trial : split_at<kLegacy>(trial, 1u, 4u);
    const Key kn = fold_in(kl, kNoiseTag);
    K.pauli = split_at<kLegacy>(kn, 0u, 3u);
    const Key kind = split_at<kLegacy>(kn, 1u, 3u);
    K.mflip = split_at<kLegacy>(kn, 2u, 3u);
    K.kind_hi = split_at<kLegacy>(kind, 0u, 2u);
    K.kind_lo = split_at<kLegacy>(kind, 1u, 2u);
  } else if (tid == 3 * kWarp && kHasOrders) {
    const Key kc = split_at<kLegacy>(trial, 2u, 4u);
    const uint32_t w = uint32_t(P.w);
    K.v = scalar_randint<kLegacy>(split_at<kLegacy>(kc, 0u, 3u), w);
    K.v1 = scalar_randint<kLegacy>(split_at<kLegacy>(kc, 1u, 3u), w);
    const int d = scalar_randint<kLegacy>(split_at<kLegacy>(kc, 2u, 3u),
                                          w > 1u ? w - 1u : 1u);
    K.v2 = (K.v1 + 1 + d) % P.w;
    const Key kr = split_at<kLegacy>(trial, 3u, 4u);
    store_key(P.k_rounds + 2 * t, kr);
    P.v_comm[t] = K.v;
    if (P.target)
      P.target[t] = scalar_randint<kLegacy>(fold_in(kr, kColludeTag),
                                            uint32_t(n + 1));
  }
  __syncthreads();

  if constexpr (kHasOrders) {
    // The permutation of ranks 1..n, then the honesty by rank.
    int* cur = perm_a;
    int* nxt = perm_b;
    for (int i = tid; i < n; i += kThreads) cur[i] = i + 1;
    for (int r = 0; r < P.perm_rounds; ++r) {
      for (int i = tid; i < n; i += kThreads)
        words[i] = bits_at<kLegacy>(K.perm[r], uint32_t(i), uint32_t(n));
      __syncthreads();
      for (int i = tid; i < n; i += kThreads)
        nxt[rank_of(words, n, i)] = cur[i];
      __syncthreads();
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int i = tid; i <= n; i += kThreads) hon[i] = 1;
    __syncthreads();
    for (int i = tid; i < P.n_dishonest; i += kThreads) hon[cur[i]] = 0;
    __syncthreads();
    uint8_t* honest = P.honest + t * size_t(n + 1);
    for (int i = tid; i <= n; i += kThreads) honest[i] = hon[i];
    const bool comm_honest = hon[1] != 0;
    for (int l = tid; l < n_lt; l += kThreads) {
      const int rank = l + 2;
      const bool first = P.split ? rank % 2 == 0 : rank <= (n + 1) / 2;
      const int v = comm_honest ? K.v : first ? K.v1 : K.v2;
      vs[l] = v;
      P.v_sent[t * size_t(n_lt) + l] = v;
    }
  }
  if constexpr (kForm == kOrders) return;

  const int n_out = n + 1 - P.row0;
  int32_t* lists = P.lists + t * size_t(n_out) * S;
  // A row's value at position s (tile slot sl): rows 0 and 1 into shared
  // memory for the P-sets, rows row0.. to device memory.
  auto put = [&](int row, int sl, int s, int v) {
    if (row == 0) row0s[sl] = v;
    if (row == 1) row1s[sl] = v;
    if (row >= P.row0) lists[size_t(row - P.row0) * S + s] = v;
  };
  const uint32_t w = uint32_t(P.w);
  for (int s0 = 0; s0 < S; s0 += tile) {
    const int tp = min(tile, S - s0);
    if constexpr (kHasLists) {
      const uint32_t noise_n = uint32_t(S) * uint32_t(n);
      for (int idx = tid; idx < tp * n; idx += kThreads)
        words[idx] = bits_at<kLegacy>(K.l2, uint32_t(s0 * n + idx), noise_n);
      for (int sl = tid; sl < tp; sl += kThreads) {
        const uint32_t s = uint32_t(s0 + sl);
        qc[sl] = uniform_at<kLegacy>(K.l0, s, uint32_t(S)) < 0.5f;
        rs[sl] = int(randint_at<kLegacy>(K.r_hi, K.r_lo, s, w, uint32_t(S)));
      }
      __syncthreads();
      for (int idx = tid; idx < tp * n; idx += kThreads) {
        const int sl = idx / n, i = idx - sl * n, s = s0 + sl;
        const int rank = rank_of(words + sl * n, n, i);
        int v = qc[sl] ? rs[sl] ^ (i + 1)
                       : int(randint_at<kLegacy>(
                             K.u_hi, K.u_lo, uint32_t(rank * S + s), w,
                             noise_n));
        if (P.noise) v ^= flip_int<kLegacy>(K, P, uint32_t(rank + 1), s);
        put(rank + 1, sl, s, v);
      }
      for (int sl = tid; sl < tp; sl += kThreads) {
        const int s = s0 + sl;
        int v = qc[sl] ? rs[sl]
                       : int(randint_at<kLegacy>(K.u_hi, K.u_lo, uint32_t(s),
                                                 w, noise_n));
        if (P.noise) v ^= flip_int<kLegacy>(K, P, 0u, uint32_t(s));
        put(0, sl, s, v);
      }
    } else {
      const int32_t* in = P.lists_in + t * size_t(n + 1) * S;
      for (int idx = tid; idx < (n + 1) * tp; idx += kThreads) {
        const int row = idx / tp, sl = idx - row * tp;
        put(row, sl, s0 + sl, in[size_t(row) * S + s0 + sl]);
      }
    }
    __syncthreads();
    if constexpr (kHasPsets) {
      uint8_t* p_rows = P.p_rows + t * size_t(n_lt) * S;
      for (int idx = tid; idx < n_lt * tp; idx += kThreads) {
        const int l = idx / tp, sl = idx - l * tp;
        p_rows[size_t(l) * S + s0 + sl] =
            uint8_t(row0s[sl] != row1s[sl] && row1s[sl] == vs[l]);
      }
    } else {
      for (int sl = tid; sl < tp; sl += kThreads)
        P.qcorr[t * size_t(S) + s0 + sl] = qc[sl];
    }
    __syncthreads();
  }
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

}  // namespace

// Shared memory of a launch in bytes (the Python mirror is
// setup_kernel.py :: setup_smem_bytes).
extern "C" int qba_setup_smem_bytes(int n, int tile) {
  return 4 * (tile * n + 2 * n + (n - 1) + 3 * tile) + (n + 1) + tile;
}

// Returns a cudaError_t: 0 on a launch that was accepted.  p_dep_bits and
// p_mf_bits are float32 p_depolarize's and p_measure_flip's bit patterns;
// legacy selects JAX's non-partitionable threefry mode.
extern "C" int qba_setup_trial(
    const void* keys, const void* lists_in, void* honest, void* lists,
    void* p_rows, void* v_sent, void* v_comm, void* k_rounds, void* target,
    void* k_lists, void* qcorr, int n_trials, int n_parties, int n_dishonest,
    int size_l, int w, int n_qubits, int split, int perm_rounds, int row0,
    int noise, int p_dep_bits, int p_mf_bits, int form, int legacy,
    void* stream) {
  if (n_trials <= 0) return 0;
  const long long n = n_parties, S = size_l;
  if (n < 2 || n > kMaxParties || S < 1 || n_dishonest < 0 ||
      n_dishonest > n || w <= n || w > 2 * kMaxParties || (w & (w - 1)) ||
      n_qubits < 1 || (1 << n_qubits) != w || perm_rounds < 0 ||
      perm_rounds > kMaxPermRounds || form < kWhole || form > kLists ||
      (row0 != 0 && row0 != 2) || !keys ||
      (form != kLists && (!honest || !v_sent || !v_comm || !k_rounds)) ||
      (form == kOrders && !k_lists) || (form == kGiven && !lists_in) ||
      (form != kOrders && !lists) ||
      ((form == kWhole || form == kGiven) && !p_rows) ||
      (form == kLists && (!qcorr || row0 != 0)) ||
      (n + 1) * S * n_qubits >= 0xFFFFFFFFll || n_trials > INT_MAX)
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
  P.n = n_parties;
  P.n_dishonest = n_dishonest;
  P.size_l = size_l;
  P.w = w;
  P.n_qubits = n_qubits;
  P.split = split;
  P.perm_rounds = perm_rounds;
  P.row0 = row0;
  P.noise = noise;
  std::memcpy(&P.p_dep, &p_dep_bits, sizeof(float));
  std::memcpy(&P.p_mf, &p_mf_bits, sizeof(float));
  P.tile = int(S < kTileWords / n ? S : kTileWords / n);
  const int smem = qba_setup_smem_bytes(n_parties, P.tile);
  void* kernel = legacy ? kernel_of<true>(form) : kernel_of<false>(form);
  void* args[] = {&P};
  cudaError_t rc = cudaLaunchKernel(kernel, dim3(unsigned(n_trials)),
                                    dim3(kThreads), args, size_t(smem),
                                    static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return int(rc);
  return int(cudaGetLastError());
}
