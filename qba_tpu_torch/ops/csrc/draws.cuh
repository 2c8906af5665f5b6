// The attack draws of one round, one entry at a time: the device form of
// qba_tpu_torch/adversary/model.py :: sample_attacks_round on the
// threefry2x32 key tree of qba_tpu_torch/random.py (jax.random's), in both
// of JAX's threefry modes, bit for bit.  Its plain per-entry mirror is
// qba_tpu_torch/ops/attack_draws.py :: attack_draw_at_reference.
//
// A round's draws are the entries (cell, rv) of a [n_pool, n_rv] table,
// cell = sender * slots + slot, rv a receiver (n_rv the lieutenants).  Each
// entry hashes its flat index i = cell * n_rv + rv, once per stream:
//   attack  bits(fold_in(k_round, ATTACK_TAG), i): action bits 0-1, coin
//           bit 2, rand_v bits 3-26 mod n_parties + 1 (raw_attack_draws);
//   late    bits(fold_in(k_round, LATE_TAG), i) as a float32 uniform,
//           below p_late (delivery="racy" only);
//   adapt   bits(fold_in(k_round, ADAPT_TAG), i): the offset of the
//           sender's own order (strategy="adaptive" only);
// k_round = fold_in(k_rounds[t], r), fold_in(key, tag) the pair
// threefry2x32(key, (0, tag)) in either mode.  bits(key, i) is, in the
// partitionable mode (template flag kLegacy false), y0 ^ y1 of
// threefry2x32(key, (0, i)) (i < 2^32 here); in the legacy mode
// (jax_threefry_partitionable=False, kLegacy true) it depends on the
// table's size n = n_pool * n_rv: with h = ceil(n / 2), entry i < h is y0
// of threefry2x32(key, (i, i + h)) (the counter 0 where i + h == n, the
// odd size's pad) and entry i >= h is y1 of threefry2x32(key, (i - h, i)).
// Every stream's table has the same n.  One hash an entry in either mode.
// Under attack_scope="broadcast" (reference
// strategy only) an entry's forge, clear-P and clear-L are those of the
// receivers rv' <= rv of its cell other than the sender (the last forge's
// rand_v), and its drop is its own.
//
// All arithmetic is uint32_t; the rotates are funnel shifts.  The late
// compare is IEEE float32: build without fast-math flags.

#pragma once

#include <stdint.h>

namespace qba_draws {

// The fold_in tags (the port's copies, qba_tpu_torch/adversary/model.py).
constexpr uint32_t kAttackTag = 0x0AC7u;
constexpr uint32_t kLateTag = 0x17A7Eu;
constexpr uint32_t kAdaptTag = 0xADA7u;

// The effective-edit bits (model.py).
constexpr int kDropBit = 1, kForgeBit = 2, kClearPBit = 4, kClearLBit = 8,
              kForgePBit = 16;

// Strategy codes, in the order of model.py's STRATEGIES.
constexpr int kReference = 0, kCollude = 1, kAdaptive = 2, kSplit = 3;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// The threefry2x32 block function (20 rounds, key injections after every
// four), as random.py :: threefry2x32: about 80 32-bit operations.
__device__ __forceinline__ void threefry2x32(Key k, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0; x1 += k.k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k.k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2;   x1 += k.k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k.k0; x1 += k.k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k.k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2;   x1 += k.k0 + 5u;
}

// jax.random.fold_in(key, tag).
__device__ __forceinline__ Key fold_in(Key k, uint32_t tag) {
  uint32_t x0 = 0u, x1 = tag;
  threefry2x32(k, x0, x1);
  return Key{x0, x1};
}

// jax.random.bits(key, shape, uint32) at flat index i (< 2^32) of a table
// of n entries (n < 2^32 - 1, read by the legacy form only).
template <bool kLegacy = false>
__device__ __forceinline__ uint32_t bits_at(Key k, uint32_t i,
                                            uint32_t n = 0u) {
  if constexpr (kLegacy) {
    const uint32_t h = n - (n >> 1);
    const bool second = i >= h;
    uint32_t x0 = second ? i - h : i;
    uint32_t x1 = second ? i : (i + h == n ? 0u : i + h);
    threefry2x32(k, x0, x1);
    return second ? x1 : x0;
  } else {
    uint32_t x0 = 0u, x1 = i;
    threefry2x32(k, x0, x1);
    return x0 ^ x1;
  }
}

// jax.random.split(key, num)[j]: in the partitionable mode the pair
// threefry2x32(key, (0, j)); in the legacy mode words 2j and 2j + 1 of
// bits over iota(2 * num).
template <bool kLegacy = false>
__device__ __forceinline__ Key split_at(Key k, uint32_t j, uint32_t num) {
  if constexpr (kLegacy) {
    return Key{bits_at<true>(k, 2u * j, 2u * num),
               bits_at<true>(k, 2u * j + 1u, 2u * num)};
  } else {
    uint32_t x0 = 0u, x1 = j;
    threefry2x32(k, x0, x1);
    return Key{x0, x1};
  }
}

// jax.random.uniform(key, shape) in float32 at flat index i of a table of
// n entries: the word's 23 top bits as a float in [1, 2), minus one.
// Compared against a float32 p it is jax.random.bernoulli.
template <bool kLegacy = false>
__device__ __forceinline__ float uniform_at(Key k, uint32_t i,
                                            uint32_t n = 0u) {
  return __uint_as_float((bits_at<kLegacy>(k, i, n) >> 9) | 0x3F800000u) -
         1.0f;
}

// jax.random.randint(key, shape, 0, span) at flat index i of a table of n
// entries, from the key's halves (hi, lo) = split(key, 2): the high word
// scaled by 2^32 mod span plus the low one, each mod span, wrapping at 32
// bits as random.py :: randint masks.
template <bool kLegacy = false>
__device__ __forceinline__ uint32_t randint_at(Key hi, Key lo, uint32_t i,
                                               uint32_t span,
                                               uint32_t n = 0u) {
  const uint32_t m16 = 65536u % span;
  const uint32_t mult = uint32_t(uint64_t(m16) * m16 % span);
  const uint32_t off = (bits_at<kLegacy>(hi, i, n) % span) * mult +
                       bits_at<kLegacy>(lo, i, n) % span;
  return off % span;
}

// The raw forged order of an attack word: bits 3-26 mod n_parties + 1.
__device__ __forceinline__ int raw_rand_v(uint32_t b, int n_mod) {
  return int(((b >> 3) & 0xFFFFFFu) % uint32_t(n_mod));
}

// An entry's attack bits under the delivery scope: the strategy's law on
// its action (bits 0-1) and coin (bit 2).  late_phase is adaptive's
// 2 * round > n_rounds.
__device__ __forceinline__ int attack_bits(uint32_t b, int strategy,
                                           bool late_phase) {
  const int action = int(b & 3u), coin = int((b >> 2) & 1u);
  if (strategy == kAdaptive) {
    const int u3 = action * 2 + coin;
    if (late_phase)
      return u3 < 4 ? kForgeBit
           : u3 == 4 ? kDropBit
           : u3 == 5 ? kClearPBit
           : u3 == 6 ? kClearLBit : 0;
    return u3 < 4 ? kDropBit
         : u3 == 4 ? kClearPBit
         : u3 == 5 ? kClearLBit
         : u3 == 6 ? kForgeBit : 0;
  }
  if (strategy == kSplit)
    return action == 0 ? kForgePBit
         : action == 1 ? (kForgePBit | kForgeBit)
         : action == 2 ? kClearLBit
         : (coin == 0 ? kDropBit : 0);
  // reference, collude
  return action == 0 ? (coin == 0 ? kDropBit : 0)
       : action == 1 ? kForgeBit
       : action == 2 ? kClearPBit : kClearLBit;
}

// adaptive's forged order: an offset in [1, w) of the sender's own order
// v_sender, mod w (n: the table's size, as bits_at).
template <bool kLegacy = false>
__device__ __forceinline__ int adaptive_rand_v(Key adapt, uint32_t i,
                                               int v_sender, int w,
                                               uint32_t n = 0u) {
  const uint32_t m = uint32_t(w - 1 > 1 ? w - 1 : 1);
  const int offset =
      int((bits_at<kLegacy>(adapt, i, n) & 0xFFFFFFu) % m) + 1;
  return (v_sender + offset) % w;
}

// delivery="racy": jax.random.bernoulli(late_key, p_late) at i, the
// uniform's 23 top bits as a float in [1, 2) minus one, against float32
// p_late (n: the table's size, as bits_at).
template <bool kLegacy = false>
__device__ __forceinline__ bool late_at(Key late, uint32_t i, float p32,
                                        uint32_t n = 0u) {
  const float u =
      __uint_as_float((bits_at<kLegacy>(late, i, n) >> 9) | 0x3F800000u) -
      1.0f;
  return u < p32;
}

// Under attack_scope="broadcast", the scan of one cell's receivers by a
// whole warp, 32 receivers a step: every lane calls broadcast_step for
// each chunk c = 0, 1, ... in order (warp-uniform), lane j holding receiver
// q = 32 c + j and its attack word b (any b where q >= n).  The ballots
// give each lane the forges and clears of receivers <= q within the chunk;
// the carry holds those of the chunks before.
struct BroadcastScan {
  bool forge, clear_p, clear_l;
  int v;  // the last forge's raw order so far, else receiver 0's
};

// Receiver q's attack bits; *v is the raw order of the last forge up to q
// or, without one, that of receiver 0 (the plain table's gather).  `sc`
// is advanced past the chunk (set it up on the first, first = true).
__device__ __forceinline__ int broadcast_step(uint32_t b, int q, int n,
                                              int sender, int n_mod,
                                              bool first, BroadcastScan& sc,
                                              int* v) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = q & 31;
  const bool seen = q < n && q != sender;
  const uint32_t action = b & 3u;
  const unsigned f = __ballot_sync(kAll, seen && action == 1u);
  const unsigned cp = __ballot_sync(kAll, seen && action == 2u);
  const unsigned cl = __ballot_sync(kAll, seen && action == 3u);
  const int raw = raw_rand_v(b, n_mod);
  if (first) sc = BroadcastScan{false, false, false, __shfl_sync(kAll, raw, 0)};
  const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1u;
  const unsigned mine = f & upto;
  const int got = __shfl_sync(kAll, raw, mine ? 31 - __clz(int(mine)) : 0);
  *v = mine ? got : sc.v;
  const int att = ((b & 7u) == 0u ? kDropBit : 0) |
                  (mine || sc.forge ? kForgeBit : 0) |
                  ((cp & upto) || sc.clear_p ? kClearPBit : 0) |
                  ((cl & upto) || sc.clear_l ? kClearLBit : 0);
  if (f) {
    sc.forge = true;
    sc.v = __shfl_sync(kAll, raw, 31 - __clz(int(f)));
  }
  sc.clear_p |= cp != 0u;
  sc.clear_l |= cl != 0u;
  return att;
}

// Under attack_scope="broadcast", entry (cell, rv)'s attack bits, walking
// the receivers rv' = rv, rv - 1, ..., 0 of the cell (first flat index
// `base` = cell * n_rv) until the last forge and both clears are found;
// *rand_v is the last forge's raw order (left as it is without a forge).
// `own` is the entry's own attack word, bits_at(attack, base + rv, n).
template <bool kLegacy = false>
__device__ __forceinline__ int scanned_attack(Key attack, uint32_t base,
                                              int rv, int sender, uint32_t own,
                                              int n_mod, int* rand_v,
                                              uint32_t n = 0u) {
  const bool drop = (own & 7u) == 0u;  // action 0, coin 0
  bool forge = false, clear_p = false, clear_l = false;
  for (int q = rv; q >= 0; --q) {
    const uint32_t b =
        q == rv ? own : bits_at<kLegacy>(attack, base + uint32_t(q), n);
    if (q != sender) {
      const uint32_t action = b & 3u;
      if (!forge && action == 1u) {
        forge = true;
        *rand_v = raw_rand_v(b, n_mod);
      }
      clear_p |= action == 2u;
      clear_l |= action == 3u;
    }
    if (forge && clear_p && clear_l) break;
  }
  return (drop ? kDropBit : 0) | (forge ? kForgeBit : 0) |
         (clear_p ? kClearPBit : 0) | (clear_l ? kClearLBit : 0);
}

}  // namespace qba_draws
