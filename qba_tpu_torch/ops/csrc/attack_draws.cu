// Rounds r0 .. r0 + n_r - 1 of a batch's attack draws in one launch.
//
// Not a pallas_call site: the counterpart of the threefry and adversary
// arithmetic XLA compiles for the JAX package (qba_tpu/adversary/model.py
// :: sample_attacks_round, stacked by qba_tpu/rounds/engine.py ::
// _stacked_draws).  The plain PyTorch version it is held against is
// qba_tpu_torch/ops/attack_draws.py :: attack_draws_reference; the
// per-entry arithmetic is draws.cuh's, which the trial megakernels' keyed
// entries run where they read a draw.
//
// Design.  A block takes kItems entries of one (trial, round) slab: lanes
// 0-2 derive the slab's attack, late and adapt keys (fold_in of the
// round's key) into shared memory, then each thread hashes its entries
// and writes the three uint8 tables.  Under attack_scope="broadcast" the
// items are cells and a warp takes a cell: a lane a receiver, 32 at a
// time, the forges and clears of the receivers before it from ballots
// (draws.cuh :: broadcast_step, the trial megakernel's scan too).  One
// hash an entry either way.  The kernel is instantiated for both of JAX's
// threefry modes (kLegacy, draws.cuh :: bits_at); the legacy form pairs
// entries across the whole [n_pool, n_rv] table, whatever the launch
// covers, so it takes the table's size.
//
// Bound on this card: operations.  Each entry costs one threefry2x32 of
// about 80 32-bit operations on the attack stream, one more under racy
// delivery and one more under the adaptive strategy, against 3 bytes
// written: at 33 parties x 1000 trials x 11 rounds, 721 M hashes (~58 G
// operations) against 2.16 GB of tables.
//
// Layouts: k_rounds int64 [T, 2] (two uint32 words), collude int32 [T]
// (strategy collude, else null), v_sent int32 [T, n_rv] (strategy
// adaptive, else null); out attack, rand_v, late uint8 [T, n_r, n_pool,
// n_rv], n_pool = n_rv * slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include "draws.cuh"

namespace {

using namespace qba_draws;

constexpr int kThreads = 256;
constexpr int kItems = 4096;  // entries (cells under broadcast) a block

struct Params {
  const int64_t* k_rounds;
  const int32_t* collude;
  const int32_t* v_sent;
  uint8_t* attack;
  uint8_t* rand_v;
  uint8_t* late;
  int n_r, r0, n_rounds, n_rv, slots, n_mod, w, strategy, broadcast, racy;
  float p32;
  int n_items, chunks;  // items a slab, blocks a slab
  uint32_t n_table;     // entries of a round's table (the legacy pairing)
};

template <bool kLegacy>
__global__ void __launch_bounds__(kThreads) attack_draws_kernel(Params P) {
  __shared__ uint32_t s_key[6];  // attack, late, adapt
  const int slab = int(blockIdx.x) / P.chunks;
  const int chunk = int(blockIdx.x) - slab * P.chunks;
  const int t = slab / P.n_r;
  const int r = P.r0 + (slab - t * P.n_r);
  if (threadIdx.x < 3) {
    const uint32_t tag = threadIdx.x == 0 ? kAttackTag
                       : threadIdx.x == 1 ? kLateTag : kAdaptTag;
    const Key trial{uint32_t(P.k_rounds[2 * size_t(t)]),
                    uint32_t(P.k_rounds[2 * size_t(t) + 1])};
    const Key k = fold_in(fold_in(trial, uint32_t(r)), tag);
    s_key[2 * threadIdx.x] = k.k0;
    s_key[2 * threadIdx.x + 1] = k.k1;
  }
  __syncthreads();
  const Key attack{s_key[0], s_key[1]}, late{s_key[2], s_key[3]};
  const Key adapt{s_key[4], s_key[5]};
  const int n_rv = P.n_rv;
  const size_t out0 = size_t(slab) * size_t(n_rv) * P.slots * n_rv;
  const bool late_phase = 2 * r > P.n_rounds;
  const int first = chunk * kItems;
  const int last = min(first + kItems, P.n_items);
  if (P.broadcast) {
    // A warp a cell, its lanes the receivers (reference strategy only).
    const int lane = int(threadIdx.x) & 31;
    for (int cell = first + int(threadIdx.x >> 5); cell < last;
         cell += kThreads / 32) {
      const uint32_t base = uint32_t(cell) * uint32_t(n_rv);
      BroadcastScan sc;
      for (int q0 = 0; q0 < n_rv; q0 += 32) {
        const int q = q0 + lane;
        const uint32_t i = base + uint32_t(q);
        const uint32_t b =
            q < n_rv ? bits_at<kLegacy>(attack, i, P.n_table) : 0u;
        int v;
        const int att = broadcast_step(b, q, n_rv, cell / P.slots, P.n_mod,
                                       q0 == 0, sc, &v);
        if (q >= n_rv) continue;
        const size_t o = out0 + i;
        P.attack[o] = uint8_t(att);
        P.rand_v[o] = uint8_t(v);
        P.late[o] =
            uint8_t(P.racy && late_at<kLegacy>(late, i, P.p32, P.n_table));
      }
    }
    return;
  }
  for (int item = first + int(threadIdx.x); item < last; item += kThreads) {
    const uint32_t i = uint32_t(item);
    const uint32_t b = bits_at<kLegacy>(attack, i, P.n_table);
    int v;
    if (P.strategy == kCollude) {
      v = P.collude[t];
    } else if (P.strategy == kAdaptive) {
      const int sender = item / n_rv / P.slots;
      v = adaptive_rand_v<kLegacy>(adapt, i,
                                   P.v_sent[size_t(t) * n_rv + sender], P.w,
                                   P.n_table);
    } else {
      v = raw_rand_v(b, P.n_mod);
    }
    const size_t o = out0 + i;
    P.attack[o] = uint8_t(attack_bits(b, P.strategy, late_phase));
    P.rand_v[o] = uint8_t(v);
    P.late[o] =
        uint8_t(P.racy && late_at<kLegacy>(late, i, P.p32, P.n_table));
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.  p32_bits is
// float32 p_late's bit pattern; legacy selects JAX's non-partitionable
// threefry mode.
extern "C" int qba_attack_draws(const void* k_rounds, const void* collude,
                                const void* v_sent, void* attack,
                                void* rand_v, void* late, int n_trials,
                                int n_r, int r0, int n_rounds, int n_rv,
                                int slots, int n_mod, int w, int strategy,
                                int broadcast, int racy, int p32_bits,
                                int legacy, void* stream) {
  if (n_trials <= 0) return 0;
  if (n_r < 1 || r0 < 1 || r0 + n_r - 1 > n_rounds || n_rv < 1 ||
      slots < 1 || n_mod < 1 || n_mod > 256 || w < 1 || w > 256 ||
      strategy < kReference || strategy > kSplit ||
      (broadcast && strategy != kReference) ||
      (strategy == kCollude && !collude) ||
      (strategy == kAdaptive && !v_sent))
    return int(cudaErrorInvalidValue);
  Params P;
  P.k_rounds = static_cast<const int64_t*>(k_rounds);
  P.collude = static_cast<const int32_t*>(collude);
  P.v_sent = static_cast<const int32_t*>(v_sent);
  P.attack = static_cast<uint8_t*>(attack);
  P.rand_v = static_cast<uint8_t*>(rand_v);
  P.late = static_cast<uint8_t*>(late);
  P.n_r = n_r;
  P.r0 = r0;
  P.n_rounds = n_rounds;
  P.n_rv = n_rv;
  P.slots = slots;
  P.n_mod = n_mod;
  P.w = w;
  P.strategy = strategy;
  P.broadcast = broadcast;
  P.racy = racy;
  std::memcpy(&P.p32, &p32_bits, sizeof(float));
  const long long n_pool = (long long)n_rv * slots;
  const long long items = broadcast ? n_pool : n_pool * n_rv;
  const long long chunks = (items + kItems - 1) / kItems;
  const long long blocks = (long long)n_trials * n_r * chunks;
  if (items > INT_MAX || blocks > INT_MAX ||
      (legacy && n_pool * n_rv >= 0xFFFFFFFFll))
    return int(cudaErrorInvalidValue);
  P.n_items = int(items);
  P.chunks = int(chunks);
  P.n_table = uint32_t(n_pool * n_rv);
  auto kernel = legacy ? attack_draws_kernel<true> : attack_draws_kernel<false>;
  kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P);
  return int(cudaGetLastError());
}
