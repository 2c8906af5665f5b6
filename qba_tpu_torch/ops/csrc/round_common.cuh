// Device code shared by the port's round kernels: fused_round.cu (one
// round per launch), tiled_round.cu (the round split at the accepted
// matrix into a verdict and a rebuild launch), trial_megakernel.cu
// (every round of a trial in one launch) and round_step.cu (one round
// over the dense mailbox, which shares the setup and phases A and B and
// rebuilds with rebuild_entry at fixed cells).
//
// A round over a compacted packet pool, as phases of one thread block
// per trial separated by __syncthreads() by the caller:
//   setup  zeroed verdicts, vi as 64-bit masks, the last live packet;
//   A      verdict of every live packet against every receiver
//          (the TPU's _verdict_block_accepts, round_kernel_tiled.py:119);
//   B      first accept per value into vi, and the winners' slots;
//   C      per-receiver offsets of the compacted successor pool;
//   D      rebuild of the live successor entries;
//   E      fill of the successor pool's dead tail.
// Each function takes the trial's pool pointers and the round's scalars,
// so that every kernel composes the phases it needs.  The phases are
// described in fused_round.cu.
//
// Layouts (one trial, contiguous): vals int8 [max_l, cap, S], lens
// int32 [cap, max_l], p int8 [cap, S], meta int32 [cap, 4] = (count, v,
// sent, cell), li int32 [n_rv, S], vi int32 [n_rv, w], honest int32
// [n_pool], draws uint8 [n_pool, n_glob]; n_pool = n_glob * slots.  A
// pool's capacity `cap` is its own: n_pool for a whole pool, n_rv * slots
// for the successor segment of a block that drains n_rv < n_glob
// receivers (the party-sharded kernels, where the block's receivers are
// the global receivers [r_off, r_off + n_rv)).  Cell ids are global.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qba {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDrop = 1, kForge = 2, kClearP = 4, kClearL = 8, kForgeP = 16;

// The round's static sizes.  The block drains the n_rv receivers
// [r_off, r_off + n_rv) of n_glob; the single-device kernels have
// r_off = 0 and n_glob = n_rv (make_dims).
struct Dims {
  int n_rv, slots, max_l, size_l, w;
  int r_off, n_glob;
  // Capacity of a whole pool (global cells), and of the block's own
  // successor segment.
  __host__ __device__ int n_pool() const { return n_glob * slots; }
  __host__ __device__ int n_out() const { return n_rv * slots; }
};

__host__ __device__ inline Dims make_dims(int n_rv, int slots, int max_l,
                                          int size_l, int w) {
  return Dims{n_rv, slots, max_l, size_l, w, 0, n_rv};
}

// The per-round kernels launch one block per (shard, trial), shard-major:
// block b is shard b / n_trials of trial b % n_trials, whose receivers
// are the global [start + shard * n_rv, ...).  The shard switch is a
// compile-time choice: the single-device instantiation (kSharded false)
// has one shard, r_off = 0 and n_glob = n_rv as constants, so its index
// arithmetic carries nothing of the shards.
template <bool kSharded>
struct BlockAt {
  int shard;
  size_t t;
  __device__ explicit BlockAt(int n_trials) {
    if constexpr (kSharded) {
      shard = int(blockIdx.x) / n_trials;
      t = size_t(int(blockIdx.x) - shard * n_trials);
    } else {
      shard = 0;
      t = blockIdx.x;
    }
  }
  // The block's round dims, from the launch's (n_rv the block's).
  __device__ Dims dims(const Dims& d, int start) const {
    Dims b = d;
    if constexpr (kSharded) {
      b.r_off = start + shard * d.n_rv;
    } else {
      b.r_off = 0;
      b.n_glob = d.n_rv;
    }
    return b;
  }
};

// Whether a launch needs the party-sharded instantiation: any that does
// not drain every receiver in one shard.
inline bool sharded_launch(int n_shards, int n_local, int n_glob) {
  return n_shards > 1 || n_local != n_glob;
}

// Index of the block's receiver rv's draw of cell `cell` in a
// [n_pool, n_glob] table whose pointer draws_at already moved to the
// block's first receiver's column.
__device__ inline size_t draw_index(const Dims& d, int cell, int rv) {
  return size_t(cell) * d.n_glob + rv;
}

// One trial's pool, as read and as written.  The layout of vals is a
// compile-time choice, so that each kernel indexes as if it knew no
// other: the compacted pools are row-major ([max_l, cap, S], `cap` the
// pool's capacity), the dense mailbox of round_step.cu packet-major
// ([n_pk, max_l, S], where cap is not read).
template <bool kPacketMajor>
struct PoolInT {
  const int8_t* vals;
  const int32_t* lens;
  const int8_t* p;
  const int32_t* meta;
  int cap;
  // Evidence row r of packet pk.
  __device__ const int8_t* row(int r, int pk, const Dims& d) const {
    return kPacketMajor
        ? vals + (size_t(pk) * d.max_l + r) * d.size_l
        : vals + (size_t(r) * cap + pk) * d.size_l;
  }
};
template <bool kPacketMajor>
struct PoolOutT {
  int8_t* vals;
  int32_t* lens;
  int8_t* p;
  int32_t* meta;
  int cap;
  __device__ int8_t* row(int r, int pk, const Dims& d) const {
    return kPacketMajor
        ? vals + (size_t(pk) * d.max_l + r) * d.size_l
        : vals + (size_t(r) * cap + pk) * d.size_l;
  }
  // The view of entries [first, cap): entry i of the result is entry
  // first + i of this pool, with the same row stride.
  __device__ PoolOutT from(int first, const Dims& d) const {
    return PoolOutT{vals + size_t(first) * d.size_l,
                    lens + size_t(first) * d.max_l,
                    p + size_t(first) * d.size_l, meta + size_t(first) * 4,
                    cap};
  }
};
using PoolIn = PoolInT<false>;
using PoolOut = PoolOutT<false>;

// A draw source: what the phases read of a round's draws, entry (cell,
// rv) by entry, rv the block's receiver.  draw(d, cell, rv, biz) gives
// the attack bits (0 for an honest sender, biz false) and, through
// rand_v(), the forged order, read only where the forge bit is set;
// is_late(d, cell, rv) the racy delivery's lateness.  The verdict, which
// reads a packet's draws for every receiver, first takes the cell's row
// (row(d, cell, biz), by the whole warp) and reads through it.  Draws is
// the stacked source: one trial's tables of one round, each [n_pool,
// n_glob] by mailbox cell, loaded where read, so its row is empty.  The
// trial megakernel's keyed entries hash their draws instead
// (HashedDraws, trial_megakernel.cu).
struct StackedDraw {
  int attack;
  const uint8_t* rv;
  __device__ int rand_v() const { return *rv; }
};

struct Draws {
  const uint8_t* attack;
  const uint8_t* rand_v;
  const uint8_t* late;
  __device__ StackedDraw draw(const Dims& d, int cell, int rv,
                              bool biz) const {
    const size_t di = draw_index(d, cell, rv);
    return StackedDraw{biz ? int(attack[di]) : 0, rand_v + di};
  }
  __device__ bool is_late(const Dims& d, int cell, int rv) const {
    return late[draw_index(d, cell, rv)] != 0;
  }
  struct Row {};
  __device__ Row row(const Dims&, int, bool) const { return Row{}; }
  __device__ StackedDraw draw(Row, const Dims& d, int cell, int rv,
                              bool biz) const {
    return draw(d, cell, rv, biz);
  }
  __device__ bool is_late(Row, const Dims& d, int cell, int rv) const {
    return is_late(d, cell, rv);
  }
};

__host__ __device__ inline size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

// Shared-memory layout, computed identically on host and device.
struct Smem {
  size_t ok, vi, pm, src, cnt, offs, misc, rows, prow, stage, total;
  __host__ __device__ Smem(const Dims& d) {
    size_t n_pool = size_t(d.n_pool());
    ok = 0;                                      // uint64 [n_pool]
    vi = ok + 8 * n_pool;                        // uint64 [n_rv]
    pm = vi + 8 * size_t(d.n_rv);                // uint64 [kWarps][size_l]
    src = pm + 8 * size_t(kWarps) * d.size_l;    // int32 [n_rv * slots]
    cnt = src + 4 * size_t(d.n_out());           // int32 [n_rv]
    offs = align8(cnt + 4 * size_t(d.n_rv));     // int32 [n_rv + 1]
    misc = align8(offs + 4 * size_t(d.n_rv + 1));  // int32 [8]
    rows = misc + 32;                            // int8 [kWarps][max_l*size_l]
    prow = rows + size_t(kWarps) * align8(size_t(d.max_l) * d.size_l);
    stage = align8(size_t(d.size_l));            // per-warp P row stride
    total = prow + size_t(kWarps) * stage;       // int8 [kWarps][size_l]
  }
};

// Typed views of the block's shared memory.
struct Shared {
  unsigned long long* ok_mask;  // per packet: mask of accepting receivers
  unsigned long long* vi_mask;  // per receiver: its accepted values
  int* src_list;                // per (receiver, slot): source packet
  int* k_cnt;                   // per receiver: its successor entries
  int* offs;                    // per receiver: first successor entry
  int* misc;                    // [0] n_scan, [1] overflow, [2..4] the
                                // party-sharded exchange (trial_megakernel.cu)
  unsigned char* raw;
  Smem L;
  __device__ Shared(unsigned char* smem_raw, const Dims& d)
      : raw(smem_raw), L(d) {
    ok_mask = reinterpret_cast<unsigned long long*>(raw + L.ok);
    vi_mask = reinterpret_cast<unsigned long long*>(raw + L.vi);
    src_list = reinterpret_cast<int*>(raw + L.src);
    k_cnt = reinterpret_cast<int*>(raw + L.cnt);
    offs = reinterpret_cast<int*>(raw + L.offs);
    misc = reinterpret_cast<int*>(raw + L.misc);
  }
};

__device__ inline unsigned long long warp_or64(unsigned long long x) {
  unsigned lo = __reduce_or_sync(kFull, unsigned(x));
  unsigned hi = __reduce_or_sync(kFull, unsigned(x >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ inline unsigned long long low_bits(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}

// Fill n bytes with `byte`, cooperatively over the block: bytes up to a
// 16-byte boundary, 16-byte stores, then the tail.
__device__ inline void block_fill(int8_t* dst, size_t n, int8_t byte) {
  uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  size_t head = ((16 - (a & 15)) & 15);
  if (head > n) head = n;
  for (size_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = byte;
  size_t n16 = (n - head) / 16;
  uint32_t b = uint8_t(byte);
  uint32_t word = b | (b << 8) | (b << 16) | (b << 24);
  uint4 v = make_uint4(word, word, word, word);
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x) d16[i] = v;
  for (size_t i = head + n16 * 16 + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = byte;
}

// ---- Setup (block): zero the verdicts of n_pool packets and the
// round's flags.  The caller synchronises before phase A. ----
__device__ inline void clear_round(const Shared& sh, int n_pool) {
  if (threadIdx.x == 0) { sh.misc[0] = 0; sh.misc[1] = 0; }
  for (int i = threadIdx.x; i < n_pool; i += kThreads) sh.ok_mask[i] = 0ull;
}

// vi int32 0/1 [n_rv, w] -> per-receiver masks, a warp per receiver.
__device__ inline void load_vi_mask(const Shared& sh, const int32_t* vi,
                                    const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < d.n_rv; r += kWarps) {
    unsigned long long m = 0ull;
    for (int x0 = 0; x0 < d.w; x0 += 32) {
      int x = x0 + lane;
      unsigned b = __ballot_sync(kFull, x < d.w && vi[size_t(r) * d.w + x] != 0);
      m |= static_cast<unsigned long long>(b) << x0;
    }
    if (lane == 0) sh.vi_mask[r] = m;
  }
}

// The per-receiver masks -> vi int32 0/1 [n_rv, w].
__device__ inline void store_vi(const Shared& sh, int32_t* o_vi,
                                const Dims& d) {
  for (int i = threadIdx.x; i < d.n_rv * d.w; i += kThreads) {
    const int r = i / d.w, x = i - r * d.w;
    o_vi[i] = int32_t((sh.vi_mask[r] >> x) & 1ull);
  }
}

// misc[0] = one past the last sent packet (the caller has zeroed it and
// synchronised; it synchronises again before reading).
__device__ inline void scan_extent(const Shared& sh, const int32_t* meta,
                                   int n_pool) {
  int last = 0;
  for (int i = threadIdx.x; i < n_pool; i += kThreads)
    if (meta[size_t(i) * 4 + 2] != 0) last = i + 1;
  if (last) atomicMax(&sh.misc[0], last);
}

// ---- Phase A: verdict, a warp per live packet. ----
// Writes ok_mask[pk] for every sent packet pk < n_scan.
template <class In, class Src>
__device__ inline void verdict_phase(const Shared& sh, const In& in,
                                     const int32_t* li,
                                     const int32_t* honest, const Src& dr,
                                     const Dims& d, int n_scan,
                                     int round_idx, int use_fp) {
  const int n_rv = d.n_rv, slots = d.slots, max_l = d.max_l;
  const int S = d.size_l, w = d.w, n_pool = d.n_pool();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int8_t* rows = reinterpret_cast<int8_t*>(sh.raw + sh.L.rows) +
                 size_t(warp) * align8(size_t(max_l) * S);
  int8_t* prow = reinterpret_cast<int8_t*>(sh.raw + sh.L.prow) +
                 size_t(warp) * sh.L.stage;
  unsigned long long* pm =
      reinterpret_cast<unsigned long long*>(sh.raw + sh.L.pm) +
      size_t(warp) * S;
  for (int pk = warp; pk < n_scan; pk += kWarps) {
    const int32_t* m = in.meta + size_t(pk) * 4;
    const int count = m[0], v = m[1], sent = m[2], cell = m[3];
    if (!sent || cell < 0 || cell >= n_pool) continue;
    const int cnt_v = count < 0 ? 0 : (count > max_l ? max_l : count);
    // Stage valid rows and P; presence masks and the row facts.
    bool oob = false, coll = false, lens_bad = false;
    unsigned long long pm_any = 0ull;
    for (int j = lane; j < S; j += 32) {
      unsigned long long pmj = 0ull;
      for (int r = 0; r < cnt_v; ++r) {
        int x = in.row(r, pk, d)[j];
        rows[r * S + j] = int8_t(x);
        if (x != -1) {
          if (x > w || x < 0) oob = true;
          if (x >= 0 && x < 64) pmj |= 1ull << x;
          for (int q = 0; q < r; ++q)
            if (rows[q * S + j] == x) coll = true;
        }
      }
      pm[j] = pmj;
      pm_any |= pmj;
      prow[j] = in.p[size_t(pk) * S + j] != 0;
    }
    const int len0 = in.lens[size_t(pk) * max_l];
    for (int r = lane; r < cnt_v; r += 32)
      if (in.lens[size_t(pk) * max_l + r] != len0) lens_bad = true;
    oob = __any_sync(kFull, oob);
    coll = __any_sync(kFull, coll);
    lens_bad = __any_sync(kFull, lens_bad);
    pm_any = warp_or64(pm_any);
    __syncwarp();

    const bool biz = honest[cell] == 0;
    const int sender = cell / slots - d.r_off;  // as a block receiver
    const unsigned long long valid_rows = low_bits(cnt_v);
    unsigned long long okbits = 0ull;
    const auto row = dr.row(d, cell, biz);
    for (int rv = 0; rv < n_rv; ++rv) {
      const auto dw = dr.draw(row, d, cell, rv, biz);
      const int att = dw.attack;
      if ((att & kDrop) || dr.is_late(row, d, cell, rv) || sender == rv)
        continue;
      const int v2 = (att & kForge) ? dw.rand_v() : v;
      const bool clear_p = att & kClearP, clear_l = att & kClearL;
      const bool forge_p = use_fp && (att & kForgeP);
      const int count_eff = clear_l ? 0 : count;
      // |L'| == round + 1 needs count_eff in {round, round + 1}.
      if (count_eff != round_idx && count_eff != round_idx + 1) continue;
      if (!clear_l) {
        const bool cont = v2 >= 0 && v2 < 64 && ((pm_any >> v2) & 1ull);
        if (cont || oob || coll || lens_bad) continue;
      }
      const int32_t* lir = li + size_t(rv) * S;
      int plen = 0;
      bool bad_own = false, own_coll = false;
      unsigned long long mis = 0ull;
      for (int j = lane; j < S; j += 32) {
        const bool pj = forge_p || (prow[j] && !clear_p);
        const int lij = lir[j];
        const int own = pj ? lij : -1;
        plen += pj;
        if (pj) {
          if (lij == v2 || lij > w || lij < 0) bad_own = true;
          if (lij >= 0 && lij < 64 && ((pm[j] >> lij) & 1ull)) own_coll = true;
        }
        for (int r = 0; r < cnt_v; ++r)
          if (rows[r * S + j] != own) mis |= 1ull << r;
      }
      plen = __reduce_add_sync(kFull, plen);
      bad_own = __any_sync(kFull, bad_own);
      own_coll = __any_sync(kFull, own_coll);
      mis = warp_or64(mis);
      const bool dup = !clear_l && ((~mis & valid_rows) != 0ull);
      const bool appended = !dup && count_eff < max_l;
      const int new_count = appended ? count_eff + 1 : count_eff;
      const bool cond1 = !appended || count_eff == 0 || plen == len0;
      const bool cond2 = !(appended && bad_own);
      const bool cond3 = !appended || clear_l || !own_coll;
      if (cond1 && cond2 && cond3 && new_count == round_idx + 1)
        okbits |= 1ull << rv;
    }
    if (lane == 0) sh.ok_mask[pk] = okbits;
    __syncwarp();
  }
}

// Slot allocation of one receiver's winners among 32 packets, in packet
// order: `cnt` counts the receiver's winners so far.
__device__ inline void assign_slots(const Shared& sh, int rv, int pk,
                                    bool win, unsigned winners, int& cnt,
                                    int slots) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  if (win) {
    const int slot = cnt + __popc(winners & lt_mask);
    if (slot < slots) sh.src_list[rv * slots + slot] = pk;
  }
  cnt += __popc(winners);
}

// A receiver's slot count and overflow flag, from its winner count.
__device__ inline void close_slots(const Shared& sh, int rv, int cnt,
                                   int slots) {
  if ((threadIdx.x & 31) == 0) {
    sh.k_cnt[rv] = cnt < slots ? cnt : slots;
    if (cnt > slots) atomicOr(&sh.misc[1], 1);
  }
}

// ---- Phase B: first accept per value, a warp per receiver. ----
// Updates vi_mask; with `rebroadcast`, fills src_list/k_cnt and raises
// misc[1] on overflow.  With `acc` non-null, writes the accepted matrix
// int32 0/1 [n_pool, n_rv] for its rows pk < n_scan.
template <class Src>
__device__ inline void dedup_phase(const Shared& sh, const int32_t* meta,
                                   const int32_t* honest, const Src& dr,
                                   const Dims& d, int n_scan,
                                   bool rebroadcast, int32_t* acc) {
  const int n_rv = d.n_rv, slots = d.slots, w = d.w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    unsigned long long vim = sh.vi_mask[rv];
    int cnt = 0;
    for (int base = 0; base < n_scan; base += 32) {
      const int pk = base + lane;
      bool cand = false;
      int v2 = -1;
      if (pk < n_scan && ((sh.ok_mask[pk] >> rv) & 1ull)) {
        const int32_t* m = meta + size_t(pk) * 4;
        const int cell = m[3];
        const auto dw = dr.draw(d, cell, rv, honest[cell] == 0);
        v2 = (dw.attack & kForge) ? dw.rand_v() : m[1];
        cand = v2 >= 0 && v2 < w && !((vim >> v2) & 1ull);
      }
      const unsigned peers = __match_any_sync(kFull, cand ? v2 : 64 + lane);
      const bool win = cand && lane == __ffs(peers) - 1;
      const unsigned winners = __ballot_sync(kFull, win);
      unsigned long long bit = win ? (1ull << v2) : 0ull;
      vim |= warp_or64(bit);
      if (acc != nullptr && pk < n_scan)
        acc[size_t(pk) * n_rv + rv] = int32_t(win);
      if (rebroadcast) assign_slots(sh, rv, pk, win, winners, cnt, slots);
    }
    if (lane == 0) sh.vi_mask[rv] = vim;
    close_slots(sh, rv, cnt, slots);
  }
}

// ---- Phase B from a given accepted matrix: the winners' slots, a warp
// per receiver over packets pk < n_rows. ----
__device__ inline void slots_from_acc(const Shared& sh, const int32_t* acc,
                                      const Dims& d, int n_rows,
                                      bool rebroadcast) {
  const int n_rv = d.n_rv, slots = d.slots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    int cnt = 0;
    if (rebroadcast) {
      for (int base = 0; base < n_rows; base += 32) {
        const int pk = base + lane;
        const bool win = pk < n_rows && acc[size_t(pk) * n_rv + rv] != 0;
        const unsigned winners = __ballot_sync(kFull, win);
        assign_slots(sh, rv, pk, win, winners, cnt, slots);
      }
    }
    close_slots(sh, rv, cnt, slots);
  }
}

// ---- Phase C: compacted destinations, receiver-major (thread 0; the
// caller synchronises and reads the total from offs[n_rv]). ----
__device__ inline void offsets_phase(const Shared& sh, int n_rv) {
  if (threadIdx.x == 0) {
    sh.offs[0] = 0;
    for (int r = 0; r < n_rv; ++r) sh.offs[r + 1] = sh.offs[r] + sh.k_cnt[r];
  }
}

// ---- Phase D, one destination (warp): successor entry `dst` is source
// packet `src` as receiver `rr` accepted it, rebroadcast in its slot
// `slot`.  Writes every field of the entry: rows r < max_l of vals, all
// of lens, P and meta. ----
template <class In, class Out, class Src>
__device__ inline void rebuild_entry(const In& in, const Out& out,
                                     const int32_t* li,
                                     const int32_t* honest, const Src& dr,
                                     const Dims& d, int dst, int rr, int slot,
                                     int src, int use_fp) {
  const int slots = d.slots, max_l = d.max_l;
  const int S = d.size_l;
  const int lane = threadIdx.x & 31;
  const int32_t* m = in.meta + size_t(src) * 4;
  const int count = m[0], cell = m[3];
  const auto dw = dr.draw(d, cell, rr, honest[cell] == 0);
  const int att = dw.attack;
  const int v2 = (att & kForge) ? dw.rand_v() : m[1];
  const bool clear_p = att & kClearP, clear_l = att & kClearL;
  const bool forge_p = use_fp && (att & kForgeP);
  const int cnt_v = count < 0 ? 0 : (count > max_l ? max_l : count);
  const int cnt_eff = clear_l ? 0 : count;
  const int32_t* lir = li + size_t(rr) * S;
  const int8_t* psrc = in.p + size_t(src) * S;
  int plen = 0;
  unsigned long long mis = 0ull;
  for (int j = lane; j < S; j += 32) {
    const bool pj = forge_p || (psrc[j] != 0 && !clear_p);
    const int own = pj ? lir[j] : -1;
    plen += pj;
    for (int r = 0; r < cnt_v; ++r)
      if (in.row(r, src, d)[j] != own) mis |= 1ull << r;
  }
  plen = __reduce_add_sync(kFull, plen);
  mis = warp_or64(mis);
  const bool dup = !clear_l && ((~mis & low_bits(cnt_v)) != 0ull);
  const int new_cnt = dup ? cnt_eff : (cnt_eff + 1 < max_l ? cnt_eff + 1 : max_l);
  for (int r = 0; r < max_l; ++r) {
    const bool is_new = !dup && r == cnt_eff;
    const bool keep = r < cnt_eff;
    int8_t* orow = out.row(r, dst, d);
    const int8_t* irow = in.row(r, src, d);
    for (int j = lane; j < S; j += 32) {
      int8_t x = -1;
      if (is_new) {
        const bool pj = forge_p || (psrc[j] != 0 && !clear_p);
        x = pj ? int8_t(lir[j]) : int8_t(-1);
      } else if (keep) {
        x = irow[j];
      }
      orow[j] = x;
    }
  }
  for (int r = lane; r < max_l; r += 32) {
    int32_t x = 0;
    if (!dup && r == cnt_eff) x = plen;
    else if (r < cnt_eff) x = in.lens[size_t(src) * max_l + r];
    out.lens[size_t(dst) * max_l + r] = x;
  }
  for (int j = lane; j < S; j += 32)
    out.p[size_t(dst) * S + j] =
        int8_t(forge_p || (psrc[j] != 0 && !clear_p));
  if (lane < 4) {
    const int32_t f[4] = {new_cnt, v2, 1, (d.r_off + rr) * slots + slot};
    out.meta[size_t(dst) * 4 + lane] = f[lane];
  }
}

// ---- Phase D: rebuild the live destinations dst < total of the
// compacted successor pool, a warp each. ----
template <class Src>
__device__ inline void rebuild_phase(const Shared& sh, const PoolIn& in,
                                     const PoolOut& out, const int32_t* li,
                                     const int32_t* honest, const Src& dr,
                                     const Dims& d, int total, int use_fp) {
  const int n_rv = d.n_rv, slots = d.slots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int dst = warp; dst < total; dst += kWarps) {
    int rr = 0;
    for (int r0 = 0; r0 < n_rv; r0 += 32) {
      const int r = r0 + lane;
      const unsigned hit = __ballot_sync(
          kFull, r < n_rv && sh.offs[r] <= dst && dst < sh.offs[r + 1]);
      if (hit) { rr = r0 + __ffs(hit) - 1; break; }
    }
    const int slot = dst - sh.offs[rr];
    rebuild_entry(in, out, li, honest, dr, d, dst, rr, slot,
                  sh.src_list[rr * slots + slot], use_fp);
  }
}

// ---- Phase E: the dead tail of the successor pool, entries >= total,
// as an empty pool holds it. ----
__device__ inline void fill_dead_tail(const PoolOut& out, const Dims& d,
                                      int total) {
  const int cap = out.cap, max_l = d.max_l, S = d.size_l;
  const size_t dead = size_t(cap - total);
  if (!dead) return;
  for (int r = 0; r < max_l; ++r)
    block_fill(out.vals + (size_t(r) * cap + total) * S, dead * S, -1);
  block_fill(reinterpret_cast<int8_t*>(out.lens + size_t(total) * max_l),
             dead * max_l * 4, 0);
  block_fill(out.p + size_t(total) * S, dead * S, 0);
  block_fill(reinterpret_cast<int8_t*>(out.meta + size_t(total) * 4),
             dead * 16, 0);
}

// Per-trial views of batched [T, ...] pool tensors of capacity `cap`,
// and of draw tensors.
__device__ inline PoolIn pool_at(const int8_t* vals, const int32_t* lens,
                                 const int8_t* p, const int32_t* meta,
                                 size_t t, int cap, const Dims& d) {
  const size_t c = cap, S = d.size_l, max_l = d.max_l;
  return PoolIn{vals + t * max_l * c * S, lens + t * c * max_l,
                p + t * c * S, meta + t * c * 4, cap};
}
__device__ inline PoolOut pool_at(int8_t* vals, int32_t* lens, int8_t* p,
                                  int32_t* meta, size_t t, int cap,
                                  const Dims& d) {
  const size_t c = cap, S = d.size_l, max_l = d.max_l;
  return PoolOut{vals + t * max_l * c * S, lens + t * c * max_l,
                 p + t * c * S, meta + t * c * 4, cap};
}
__device__ inline PoolIn as_in(const PoolOut& o) {
  return PoolIn{o.vals, o.lens, o.p, o.meta, o.cap};
}
// Slab `slab` of [.., n_pool, n_glob] draw tables (a trial, or a trial's
// round in the stacked layout), from the block's first receiver's column
// on (draw_index), so the receiver loops add no offset.
__device__ inline Draws draws_at(const uint8_t* attack, const uint8_t* rand_v,
                                 const uint8_t* late, size_t slab,
                                 const Dims& d) {
  const size_t base = slab * size_t(d.n_pool()) * d.n_glob + d.r_off;
  return Draws{attack + base, rand_v + base, late + base};
}

// Shared memory the kernels need, or a CUDA error: raises the kernel's
// dynamic limit past 48 KB where needed.
template <typename Kernel>
inline int prepare_smem(Kernel kernel, const Dims& d, size_t* smem) {
  *smem = Smem(d).total;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem));
    if (e != cudaSuccess) return int(e);
  }
  return 0;
}

// The kernels' shape limits: 64-bit masks over receivers, values and
// evidence rows; the block's receivers inside the global ones.
inline bool dims_ok(const Dims& d) {
  return d.n_rv >= 1 && d.n_glob <= 64 && d.w >= 1 && d.w <= 64 &&
         d.max_l >= 1 && d.max_l <= 64 && d.slots >= 1 && d.size_l >= 1 &&
         d.r_off >= 0 && d.r_off + d.n_rv <= d.n_glob;
}

// The launch dims of n_shards shards of n_local receivers from receiver
// `start` of n_glob (r_off holds `start`), or false where they do not fit.
inline bool launch_dims(int n_shards, int n_local, int n_glob, int start,
                        int slots, int max_l, int size_l, int w, Dims* d) {
  *d = Dims{n_local, slots, max_l, size_l, w, start, n_glob};
  return n_shards >= 1 && dims_ok(*d) &&
         start + n_shards * n_local <= n_glob;
}

}  // namespace qba
