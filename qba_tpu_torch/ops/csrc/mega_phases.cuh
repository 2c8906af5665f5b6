// The trial megakernel's own layout and phases (trial_megakernel.cu).  The
// per-round kernels keep round_common.cuh's phases and compacted pools;
// the megakernel, whose pools are private to its launch, keeps its pools,
// its shared memory and its phases here, so an edit here rebuilds and
// moves only the megakernel.
//
// Pools.  A pool is entry-major: entry i of a trial's pool is one
// contiguous MegaEntry of `bytes` bytes (a multiple of 16), so one packet's
// evidence, lens, P and meta are one span that a warp copies into shared
// memory with 16-byte asynchronous copies (cp.async), one memory latency a
// packet.  An entry holds meta int32 [4] = (count, v, sent, cell), lens
// int32 [max_l], P as bytes 0x00/0xFF over 4 * sw positions and the rows
// int8 [max_l][4 * sw]; sw = ceil(size_l / 4) words of four positions.
// The positions past size_l hold P 0x00 and row bytes 0xFF (-1), so word
// compares need no tail mask.  Only the fields a reader reads are written:
// meta, lens, P and the rows below count.
//
// Shared memory (MegaSmem): the block's verdicts and accepted sets, each
// live packet's cell and order (for the dedup), the cells' honesty bits,
// the slots, counts and offsets, the block's receivers' lists li as int8
// words [sw][n_rv + 1] (position-major: lanes over receivers read
// consecutive words; the pad word keeps a warp over one receiver's words
// off a single bank) with the words of their out-of-range positions (0xFF
// where li is not in [0, w]), and per warp kStages entry buffers, so that
// the next packets' copies are in flight while the current one is checked.
//
// Verdict (mega_verdict).  A warp a live packet, as before, but the
// packet's facts (out-of-range values, colliding rows, disagreeing lens,
// the values present) are computed once, lanes over the staged words, and
// the receivers run across lanes: lane group (lane / G) takes a receiver
// (two passes past 32 receivers), its G lanes split the packet's words,
// and each compares four positions a word (__vcmpeq4) against the staged
// rows.  One ballot a pass gives the packet's verdict bits.  G is 4 up to
// 8 receivers, 2 up to 16, else 1 (lane_group in round_common.cuh, which
// the per-round kernels' verdict shares with its other helpers;
// round_kernel_tiled.py keeps its mirror).
//
// Lists past int8.  A value of li outside [-128, 127] is stored truncated,
// the byte the rebuild writes into a row, as the plain version does; its
// receiver's bit in the block's `lossy` mask sends that receiver's checks
// through lossy_hit, which reads the list from global memory: a P
// position holding such a value matches no row and is out of range.
//
// MegaClock is the megakernel's phase clock (round_common.cuh's
// PhaseClock over the phases below; kClock switches it on): each phase
// holds warp 0's cycles between the block's barriers, summed over the
// trial's rounds.  The verdict's marks split warp 0's staging and receiver
// loops from its wait for the other warps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "round_common.cuh"

namespace qba {

// The megakernel's block: kMegaWarps warps (MEGA_WARPS in
// trial_megakernel.py), launch-bound to kMegaBlocks blocks an SM (at most
// 65536 / (kMegaThreads * kMegaBlocks) registers a thread).
constexpr int kMegaWarps = 16, kMegaThreads = 32 * kMegaWarps;
constexpr int kMegaBlocks = 2;
// Entry buffers a warp: the copies of the next kStages - 1 packets are in
// flight while one is checked.
constexpr int kStages = 2;

// The clock's phases, in the order of the int64 [.., kPhases] buffer.
enum MegaPhase {
  kPhGen,          // the gen entry's prologue (0 for the host-gen entries)
  kPhEntry,        // lists into shared memory, step 3a, pool A
  kPhClear,        // the round's start (its keys come from the round before)
  kPhStage,        // verdict: warp 0 waiting for its copies, packet facts
  kPhVerdict,      // verdict: warp 0's receiver passes
  kPhVerdictWait,  // verdict: warp 0 at the barrier
  kPhDedup,        // first accept per value
  kPhOffsets,      // successor offsets
  kPhExchange,     // the sharded entry's counts exchange
  kPhRebuild,      // warp 0 rebuilding its entries
  kPhWritten,      // pool_written: the barrier after the rebuild
  kPhExit,         // vi, decisions, overflow
  kPhases
};

template <bool kOn>
using MegaClock = PhaseClock<kOn, kPhases>;

// One pool entry's byte offsets.
struct MegaEntry {
  int sw, lens, p, rows, bytes;
  __host__ __device__ explicit MegaEntry(const Dims& d) {
    sw = (d.size_l + 3) / 4;
    lens = 16;
    p = lens + align16(4 * d.max_l);
    rows = p + align16(4 * sw);
    bytes = rows + align16(4 * sw * d.max_l);
  }
};

// Shared-memory layout, computed identically on host and device.  With
// `staged` false (entries too large for the warps' buffers) the verdict
// and rebuild read the entries where they lie in global memory.
struct MegaSmem {
  size_t ok, vi, info, hon, src, cnt, offs, misc, li, oor, stage, total;
  int ld;  // words a position row of li and oor: n_glob + 1
  __host__ __device__ MegaSmem(const Dims& d, bool staged) {
    const MegaEntry e(d);
    const size_t n_pool = size_t(d.n_pool());
    ld = d.n_glob + 1;
    ok = 0;                                           // uint64 [n_pool]
    vi = ok + 8 * n_pool;                             // uint64 [n_rv]
    info = vi + 8 * size_t(d.n_rv);                   // int32 [n_pool]
    hon = info + 4 * n_pool;                          // uint32 [n_pool/32]
    src = hon + 4 * ((n_pool + 31) / 32);             // int32 [n_rv*slots]
    cnt = src + 4 * size_t(d.n_out());                // int32 [n_rv]
    offs = cnt + 4 * size_t(d.n_rv);                  // int32 [n_rv + 1]
    misc = size_t(align16(int(offs + 4 * size_t(d.n_rv + 1))));  // int32 [8]
    li = misc + 32;                                   // uint32 [sw][ld]
    oor = li + 4 * size_t(e.sw) * ld;                 // uint32 [sw][ld]
    stage = size_t(align16(int(oor + 4 * size_t(e.sw) * ld)));
    total = stage + (staged ? size_t(kMegaWarps) * kStages * e.bytes : 0);
  }
};

// Typed views of the block's shared memory.  misc: [0] n_scan, [1]
// overflow, [2..4] the party-sharded exchange, [6..7] the lossy mask.
struct MegaShared {
  unsigned long long* ok_mask;  // per packet: mask of accepting receivers
  unsigned long long* vi_mask;  // per receiver: its accepted values
  int* info;                    // per packet: cell << 8 | order (0xFF: none)
  unsigned* hon;                // per cell: honest sender bit
  int* src_list;                // per (receiver, slot): source packet
  int* k_cnt;                   // per receiver: its successor entries
  int* offs;                    // per receiver: first successor entry
  int* misc;
  unsigned* li;                 // [sw][ld] list bytes
  unsigned* oor;                // [sw][ld] 0xFF where li is not in [0, w]
  unsigned char* stage;
  unsigned char* raw;
  MegaSmem L;
  MegaEntry E;
  __device__ MegaShared(unsigned char* smem_raw, const Dims& d, bool staged)
      : raw(smem_raw), L(d, staged), E(d) {
    ok_mask = reinterpret_cast<unsigned long long*>(raw + L.ok);
    vi_mask = reinterpret_cast<unsigned long long*>(raw + L.vi);
    info = reinterpret_cast<int*>(raw + L.info);
    hon = reinterpret_cast<unsigned*>(raw + L.hon);
    src_list = reinterpret_cast<int*>(raw + L.src);
    k_cnt = reinterpret_cast<int*>(raw + L.cnt);
    offs = reinterpret_cast<int*>(raw + L.offs);
    misc = reinterpret_cast<int*>(raw + L.misc);
    li = reinterpret_cast<unsigned*>(raw + L.li);
    oor = reinterpret_cast<unsigned*>(raw + L.oor);
    stage = raw + L.stage;
  }
  // Warp `warp`'s entry buffer b (0 .. kStages - 1).
  __device__ unsigned char* buf(int warp, int b) const {
    return stage + size_t(kStages * warp + b) * E.bytes;
  }
  // Where the warp reads entry `i` of `pool`: its buffer b, or the entry
  // itself when nothing is staged (a compile-time choice, so that staged
  // reads are shared-memory loads).
  template <bool kStaged>
  __device__ const unsigned char* entry(int warp, int b,
                                        const unsigned char* pool,
                                        int i) const {
    if constexpr (kStaged) return buf(warp, b);
    return pool + size_t(i) * E.bytes;
  }
  __device__ bool honest(int cell) const {
    return (hon[cell >> 5] >> (cell & 31)) & 1u;
  }
  __device__ unsigned long long lossy() const {
    return *reinterpret_cast<const unsigned long long*>(misc + 6);
  }
};

// The warp copies entry `src` of `pool` into buffer `dst` (16 bytes a lane
// at a time); the caller commits the group.
__device__ inline void stage_entry(unsigned char* dst,
                                   const unsigned char* pool, int src,
                                   int bytes) {
  const unsigned char* s = pool + size_t(src) * bytes;
  for (int c = threadIdx.x & 31; c < bytes / 16; c += 32)
    cp_async16(dst + 16 * c, s + 16 * c);
}

// The copy pipeline of a warp that reads entries src(0), src(1), ... of
// `pool`, a step at a time: start() issues the first kStages - 1 copies,
// next(i) the copy kStages - 1 steps ahead of step i and waits for step
// i's.  Without staging both do nothing.
template <bool kStaged, class SrcOf>
struct Pipeline {
  const MegaShared& sh;
  const unsigned char* pool;
  int warp, n;
  SrcOf src;
  __device__ void start() const {
    if constexpr (!kStaged) return;
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n) stage_entry(sh.buf(warp, i), pool, src(i), sh.E.bytes);
      cp_async_commit();
    }
  }
  __device__ void next(int i) const {
    if constexpr (!kStaged) return;
    const int ahead = i + kStages - 1;
    if (ahead < n)
      stage_entry(sh.buf(warp, ahead % kStages), pool, src(ahead),
                  sh.E.bytes);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
  }
};
template <bool kStaged, class SrcOf>
__device__ Pipeline<kStaged, SrcOf> pipeline(const MegaShared& sh,
                                             const unsigned char* pool,
                                             int warp, int n, SrcOf src) {
  return Pipeline<kStaged, SrcOf>{sh, pool, warp, n, src};
}

// ---- Entry: the trial's lists into shared memory (li words of every
// receiver of the trial, their out-of-range words and the lossy mask), the
// cells' honesty bits, and step 3a's verdict for the block's receivers, a
// warp a lieutenant (consistent unless a P position whose list value is
// not SENTINEL holds v, a value > w or < 0): vi = {v} for those that
// accept, k_cnt[rv] = whether rv accepts.  The caller synchronises. ----
__device__ inline void mega_entry(const MegaShared& sh, const uint8_t* p_rows,
                                  const int32_t* li_all,
                                  const int32_t* v_sent,
                                  const int32_t* honest, const Dims& d) {
  const int S = d.size_l, w = d.w, ld = sh.L.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_pool = d.n_pool();
  if (threadIdx.x < 2) sh.misc[6 + threadIdx.x] = 0;
  for (int c0 = warp * 32; c0 < n_pool; c0 += kMegaThreads) {
    const int c = c0 + lane;
    const unsigned b = __ballot_sync(kFull, c < n_pool && honest[c] != 0);
    if (lane == 0) sh.hon[c0 >> 5] = b;
  }
  __syncthreads();  // the lossy mask is zeroed
  unsigned char* lib = reinterpret_cast<unsigned char*>(sh.li);
  unsigned char* oob = reinterpret_cast<unsigned char*>(sh.oor);
  for (int g = warp; g < d.n_glob; g += kMegaWarps) {
    const int32_t* lir = li_all + size_t(g) * S;
    bool lossy = false;
    for (int j = lane; j < 4 * sh.E.sw; j += 32) {
      const size_t at = (size_t(j >> 2) * ld + g) * 4 + (j & 3);
      const int x = j < S ? lir[j] : -1;
      lib[at] = uint8_t(x);
      oob[at] = (j < S && (x < 0 || x > w)) ? 0xff : 0;
      if (x != int(int8_t(x))) lossy = true;
    }
    if (__any_sync(kFull, lossy) && lane == 0)
      atomicOr(reinterpret_cast<unsigned long long*>(sh.misc + 6), 1ull << g);
  }
  for (int rv = warp; rv < d.n_rv; rv += kMegaWarps) {
    const int v = v_sent[rv];
    const int32_t* lir = li_all + size_t(d.r_off + rv) * S;
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
}

// Step 3a's broadcasts into `pool` (entry-major), a warp a lieutenant
// that accepts, at entry base + offs[rv]: row 0 its own list under P,
// lens[0] = |P|, P, meta (1, v, 1, its slot-0 cell).
__device__ inline void mega_compact(const MegaShared& sh, unsigned char* pool,
                                    const uint8_t* p_rows,
                                    const int32_t* v_sent, const Dims& d,
                                    int base) {
  const int n_rv = d.n_rv, S = d.size_l, ld = sh.L.ld, sw = sh.E.sw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rv = warp; rv < n_rv; rv += kMegaWarps) {
    if (!sh.k_cnt[rv]) continue;
    unsigned char* e = pool + size_t(base + sh.offs[rv]) * sh.E.bytes;
    unsigned* pw = reinterpret_cast<unsigned*>(e + sh.E.p);
    unsigned* row = reinterpret_cast<unsigned*>(e + sh.E.rows);
    int plen = 0;
    for (int q = lane; q < sw; q += 32) {
      unsigned p4 = 0;
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * q + b;
        if (j < S && p_rows[size_t(rv) * S + j]) p4 |= 0xffu << (8 * b);
      }
      pw[q] = p4;
      row[q] = sh.li[q * ld + d.r_off + rv] | ~p4;
      plen += __popc(p4) >> 3;
    }
    plen = __reduce_add_sync(kFull, plen);
    int32_t* meta = reinterpret_cast<int32_t*>(e);
    if (lane == 0) reinterpret_cast<int32_t*>(e + sh.E.lens)[0] = plen;
    if (lane < 4) {
      const int32_t f[4] = {1, v_sent[rv], 1, (d.r_off + rv) * d.slots};
      meta[lane] = f[lane];
    }
  }
}

// ---- Phase A: verdict, a warp per live packet, receivers across lanes.
// The block takes packets first, first + step, ... (a cluster's blocks:
// their rank and the cluster's size) and checks each against the
// receivers [r_off, r_off + n_rv) of d, every receiver of the trial.
// li_all is the trial's lists.  Writes ok_mask[pk] (a bit per global
// receiver) and info[pk] for the block's packets pk < n_scan.  kStaged:
// whether the entries are staged through the warps' buffers (the layout
// the launch chose). ----
template <bool kStaged, class Src, class Clock>
__device__ inline void mega_verdict(const MegaShared& sh,
                                    const unsigned char* pool,
                                    const int32_t* li_all, const Src& dr,
                                    const Dims& d, int n_scan, int round_idx,
                                    int use_fp, Clock& clk, int first,
                                    int step) {
  const int n_rv = d.n_rv, slots = d.slots, max_l = d.max_l;
  const int S = d.size_l, w = d.w, n_pool = d.n_pool();
  const int sw = sh.E.sw, ld = sh.L.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = lane_group(n_rv), RP = 32 / G, g = lane % G;
  const bool vec = (sw & 3) == 0;  // rows of whole 16-byte chunks
  const unsigned long long lossy = sh.lossy();
  // The warp's packets: pk(i) = first + step * (warp + i * kMegaWarps).
  const int pk0 = first + step * warp, stride = step * kMegaWarps;
  const int n_mine = pk0 < n_scan ? (n_scan - pk0 + stride - 1) / stride : 0;
  const auto pipe = pipeline<kStaged>(sh, pool, warp, n_mine,
                             [=](int i) { return pk0 + i * stride; });
  pipe.start();
  for (int i = 0; i < n_mine; ++i) {
    const int pk = pk0 + i * stride;
    pipe.next(i);
    const unsigned char* e = sh.entry<kStaged>(warp, i % kStages, pool, pk);
    const int32_t* m = reinterpret_cast<const int32_t*>(e);
    const int count = m[0], v = m[1], sent = m[2], cell = m[3];
    unsigned long long okbits = 0ull;
    if (sent && cell >= 0 && cell < n_pool) {
      const int cnt_v = count < 0 ? 0 : (count > max_l ? max_l : count);
      const unsigned* P4 = reinterpret_cast<const unsigned*>(e + sh.E.p);
      const unsigned* R4 = reinterpret_cast<const unsigned*>(e + sh.E.rows);
      const int32_t* lens = reinterpret_cast<const int32_t*>(e + sh.E.lens);
      // The packet's facts, lanes over its (row, word) pairs.
      bool oob = false, coll = false, lens_bad = false;
      unsigned long long pm_any = 0ull;
      for (int i = lane; i < cnt_v * sw; i += 32) {
        const int r = i / sw, q = i - r * sw;
        const unsigned x4 = R4[i];
        for (int k = 0; k < 4; ++k) {
          const int x = int(int8_t(x4 >> (8 * k)));
          if (x == -1) continue;
          if (x > w || x < 0) oob = true;
          if (x >= 0 && x < 64) pm_any |= 1ull << x;
        }
        const unsigned set = ~__vcmpeq4(x4, 0xffffffffu);
        for (int r2 = 0; r2 < r; ++r2)
          if (__vcmpeq4(x4, R4[r2 * sw + q]) & set) coll = true;
      }
      const int len0 = lens[0];
      for (int r = lane; r < cnt_v; r += 32)
        if (lens[r] != len0) lens_bad = true;
      int plen_p = 0;
      for (int q = lane; q < sw; q += 32) plen_p += __popc(P4[q]) >> 3;
      oob = __any_sync(kFull, oob);
      coll = __any_sync(kFull, coll);
      lens_bad = __any_sync(kFull, lens_bad);
      pm_any = warp_or64(pm_any);
      plen_p = __reduce_add_sync(kFull, plen_p);
      clk.mark(kPhStage);

      const bool biz = !sh.honest(cell);
      const int sender = cell / slots - d.r_off;
      const unsigned long long valid_rows = low_bits(cnt_v);
      const auto row = dr.row(d, cell, biz);
      for (int k0 = 0; k0 < n_rv; k0 += RP) {
        const int rv = k0 + lane / G;
        bool act = rv < n_rv;
        int att = 0, v2 = v, count_eff = count;
        bool clear_p = false, clear_l = false, forge_p = false;
        if (act) {
          const auto dw = dr.draw(row, d, cell, rv, biz);
          att = dw.attack;
          if ((att & kDrop) || dr.is_late(row, d, cell, rv) || sender == rv) {
            act = false;
          } else {
            v2 = (att & kForge) ? dw.rand_v() : v;
            clear_p = att & kClearP;
            clear_l = att & kClearL;
            forge_p = use_fp && (att & kForgeP);
            count_eff = clear_l ? 0 : count;
            // |L'| == round + 1 needs count_eff in {round, round + 1}.
            if (count_eff != round_idx && count_eff != round_idx + 1) {
              act = false;
            } else if (!clear_l) {
              const bool cont = v2 >= 0 && v2 < 64 && ((pm_any >> v2) & 1ull);
              if (cont || oob || coll || lens_bad) act = false;
            }
          }
        }
        if (!__any_sync(kFull, act)) continue;
        // The receiver's words against the packet's rows: its G lanes take
        // chunks of four words in turn.  Per row, x = row ^ own is zero
        // where they agree; a row is a duplicate where x is zero at every
        // word, and a position collides (own value present in a row)
        // where x has a zero byte at an eligible position.
        const int rc = d.r_off + (act ? rv : 0);  // its list's column
        const bool v2_in = v2 >= 0 && v2 <= w;
        const unsigned v2w = uint8_t(v2) * 0x01010101u;
        unsigned long long mis = 0ull;
        bool bad_own = false;
        unsigned coll_w = 0u;
        for (int q0 = 4 * g; q0 < sw; q0 += 4 * G) {
          unsigned own[4], nel[4];
          for (int k = 0; k < 4; ++k) {
            const int q = q0 + k;
            own[k] = nel[k] = 0xffffffffu;
            if (q >= sw) continue;
            const unsigned li4 = sh.li[q * ld + rc];
            const unsigned oor4 = sh.oor[q * ld + rc];
            const unsigned p4 = forge_p ? valid_word(q, sw, S)
                                        : (clear_p ? 0u : P4[q]);
            own[k] = li4 | ~p4;
            const unsigned eqv = v2_in ? __vcmpeq4(li4, v2w) : 0u;
            if ((oor4 | eqv) & p4) bad_own = true;
            // Eligible: set in P, in [0, w] and below 64.
            nel[k] = ~(p4 & ~oor4 & ~__vcmpeq4(li4, 0x40404040u));
          }
          for (int r = 0; r < cnt_v; ++r) {
            unsigned row[4];
            if (vec) {
              const uint4 x = *reinterpret_cast<const uint4*>(R4 + r * sw + q0);
              row[0] = x.x; row[1] = x.y; row[2] = x.z; row[3] = x.w;
            } else {
              for (int k = 0; k < 4; ++k)
                row[k] = q0 + k < sw ? R4[r * sw + q0 + k] : own[k];
            }
            unsigned any = 0u;
            for (int k = 0; k < 4; ++k) {
              const unsigned x = row[k] ^ own[k], y = x | nel[k];
              any |= x;
              coll_w |= (y - 0x01010101u) & ~y & 0x80808080u;
            }
            if (any) mis |= 1ull << r;
          }
        }
        bool own_coll = coll_w != 0u;
        for (int o = G >> 1; o; o >>= 1) {
          mis |= __shfl_xor_sync(kFull, mis, o);
          bad_own |= __shfl_xor_sync(kFull, int(bad_own), o);
          own_coll |= __shfl_xor_sync(kFull, int(own_coll), o);
        }
        if (lossy) {
          bool hit = false;
          if (act && ((lossy >> (d.r_off + rv)) & 1ull))
            hit = lossy_hit(li_all, d.r_off + rv, d, e + sh.E.p, forge_p,
                            clear_p);
          if (hit) {
            mis = valid_rows;
            bad_own = true;
          }
        }
        const int plen = forge_p ? S : (clear_p ? 0 : plen_p);
        const bool dup = !clear_l && ((~mis & valid_rows) != 0ull);
        const bool appended = !dup && count_eff < max_l;
        const int new_count = appended ? count_eff + 1 : count_eff;
        const bool cond1 = !appended || count_eff == 0 || plen == len0;
        const bool cond2 = !(appended && bad_own);
        const bool cond3 = !appended || clear_l || !own_coll;
        const bool ok = act && cond1 && cond2 && cond3 &&
                        new_count == round_idx + 1;
        const unsigned bits =
            compress_lanes(__ballot_sync(kFull, ok && g == 0), G);
        okbits |= static_cast<unsigned long long>(bits) << (d.r_off + k0);
      }
      clk.mark(kPhVerdict);
    }
    if (lane == 0) {
      sh.ok_mask[pk] = okbits;
      sh.info[pk] = (cell << 8) | (v >= 0 && v < w ? v : 0xff);
    }
    __syncwarp();  // the buffer is refilled kStages packets on
  }
}

// ---- Phase B: first accept per value, a warp per receiver, reading each
// packet's cell and order from shared memory.  Updates vi_mask; with
// `rebroadcast`, fills src_list/k_cnt and raises misc[1] on overflow. ----
template <class Src>
__device__ inline void mega_dedup(const MegaShared& sh, const Src& dr,
                                  const Dims& d, int n_scan,
                                  bool rebroadcast) {
  const int n_rv = d.n_rv, slots = d.slots, w = d.w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int rv = warp; rv < n_rv; rv += kMegaWarps) {
    unsigned long long vim = sh.vi_mask[rv];
    int cnt = 0;
    for (int base = 0; base < n_scan; base += 32) {
      const int pk = base + lane;
      const bool hit =
          pk < n_scan && ((sh.ok_mask[pk] >> (d.r_off + rv)) & 1ull);
      if (!__any_sync(kFull, hit)) continue;
      bool cand = false;
      int v2 = -1;
      if (hit) {
        const int inf = sh.info[pk], cell = inf >> 8, v = inf & 0xff;
        const auto dw = dr.draw(d, cell, rv, !sh.honest(cell));
        v2 = (dw.attack & kForge) ? dw.rand_v() : (v == 0xff ? -1 : v);
        cand = v2 >= 0 && v2 < w && !((vim >> v2) & 1ull);
      }
      const unsigned peers = __match_any_sync(kFull, cand ? v2 : 64 + lane);
      const bool win = cand && lane == __ffs(peers) - 1;
      const unsigned winners = __ballot_sync(kFull, win);
      vim |= warp_or64(win ? (1ull << v2) : 0ull);
      if (!rebroadcast) continue;
      if (win) {
        const int slot = cnt + __popc(winners & lt_mask);
        if (slot < slots) sh.src_list[rv * slots + slot] = pk;
      }
      cnt += __popc(winners);
    }
    if (lane == 0) {
      sh.vi_mask[rv] = vim;
      sh.k_cnt[rv] = cnt < slots ? cnt : slots;
      if (cnt > slots) atomicOr(&sh.misc[1], 1);
    }
  }
}

// Successor entry dst's receiver and slot, and its source packet.
struct MegaDst {
  int rr, slot, src;
};
__device__ inline MegaDst mega_dst(const MegaShared& sh, int dst, int n_rv,
                                   int slots) {
  const int lane = threadIdx.x & 31;
  int rr = 0;
  for (int r0 = 0; r0 < n_rv; r0 += 32) {
    const int r = r0 + lane;
    const unsigned hit = __ballot_sync(
        kFull, r < n_rv && sh.offs[r] <= dst && dst < sh.offs[r + 1]);
    if (hit) { rr = r0 + __ffs(hit) - 1; break; }
  }
  const int slot = dst - sh.offs[rr];
  return MegaDst{rr, slot, sh.src_list[rr * slots + slot]};
}

// ---- Phase D: rebuild the live successor entries dst < total into
// `out` (entry dst of the block's segment), a warp each.  The source
// entry is copied into the warp's buffer (the next one's copy in flight)
// and turned into the successor there: the receiver's row appended to the
// kept rows, P, lens and meta.  kStaged as the verdict's. ----
template <bool kStaged, class Src, class Clock>
__device__ inline void mega_rebuild(const MegaShared& sh,
                                    const unsigned char* in,
                                    unsigned char* out, const Src& dr,
                                    const Dims& d, int total, int use_fp,
                                    Clock& clk) {
  const int n_rv = d.n_rv, slots = d.slots, max_l = d.max_l;
  const int S = d.size_l, sw = sh.E.sw, ld = sh.L.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The warp's destinations: dst(i) = warp + i * kMegaWarps.
  const int n_mine = warp < total ? (total - warp + kMegaWarps - 1) /
                                        kMegaWarps : 0;
  const auto pipe = pipeline<kStaged>(sh, in, warp, n_mine, [&](int i) {
    return mega_dst(sh, warp + i * kMegaWarps, n_rv, slots).src;
  });
  pipe.start();
  for (int i = 0; i < n_mine; ++i) {
    const int dst = warp + i * kMegaWarps;
    pipe.next(i);
    const MegaDst cur = mega_dst(sh, dst, n_rv, slots);
    const unsigned char* e =
        sh.entry<kStaged>(warp, i % kStages, in, cur.src);
    const int32_t* m = reinterpret_cast<const int32_t*>(e);
    const int32_t* lens = reinterpret_cast<const int32_t*>(e + sh.E.lens);
    const unsigned* P4 = reinterpret_cast<const unsigned*>(e + sh.E.p);
    const unsigned* R4 = reinterpret_cast<const unsigned*>(e + sh.E.rows);
    const int rr = cur.rr;
    const int count = m[0], cell = m[3];
    const auto dw = dr.draw(d, cell, rr, !sh.honest(cell));
    const int att = dw.attack;
    const int v2 = (att & kForge) ? dw.rand_v() : m[1];
    const bool clear_p = att & kClearP;
    const bool forge_p = use_fp && (att & kForgeP);
    // The verdict accepted (src, rr): |L'| = round + 1.  Every live packet
    // of round r holds r < max_l rows (step 3a's one, then each round's
    // successors r + 1), so the acceptance was an append, neither a
    // duplicate row (|L'| = r) nor a cleared L (|L'| = 1): the successor
    // keeps the source's rows and appends the receiver's own.
    const int kept = count;
    int plen = 0;
    for (int q = lane; q < sw; q += 32)
      plen += __popc(forge_p ? valid_word(q, sw, S)
                             : (clear_p ? 0u : P4[q])) >> 3;
    plen = __reduce_add_sync(kFull, plen);
    // The successor is assembled in the staged buffer over the source (its
    // kept rows are already in place), then goes out in 16-byte stores;
    // unstaged, it is written where it goes, the kept rows copied over.
    unsigned char* o = kStaged ? sh.buf(warp, i % kStages)
                               : out + size_t(dst) * sh.E.bytes;
    unsigned* oR4 = reinterpret_cast<unsigned*>(o + sh.E.rows);
    if constexpr (!kStaged) {
      if ((sw & 3) == 0) {
        for (int c = lane; c < kept * sw / 4; c += 32)
          reinterpret_cast<uint4*>(oR4)[c] =
              reinterpret_cast<const uint4*>(R4)[c];
      } else {
        for (int c = lane; c < kept * sw; c += 32) oR4[c] = R4[c];
      }
    }
    __syncwarp();  // every lane has read the source's P
    for (int q = lane; q < sw; q += 32) {
      const unsigned p4 = forge_p ? valid_word(q, sw, S)
                                  : (clear_p ? 0u : P4[q]);
      oR4[kept * sw + q] = sh.li[q * ld + d.r_off + rr] | ~p4;
      reinterpret_cast<unsigned*>(o + sh.E.p)[q] = p4;
    }
    for (int r = lane; r < max_l; r += 32) {
      const int x = r < kept ? lens[r] : (r == kept ? plen : 0);
      reinterpret_cast<int32_t*>(o + sh.E.lens)[r] = x;
    }
    if (lane < 4) {
      const int32_t f[4] = {kept + 1, v2, 1,
                            (d.r_off + rr) * slots + cur.slot};
      reinterpret_cast<int32_t*>(o)[lane] = f[lane];
    }
    if constexpr (kStaged) {
      __syncwarp();
      const int n16 = (sh.E.rows + (kept + 1) * 4 * sw + 15) / 16;
      uint4* g = reinterpret_cast<uint4*>(out + size_t(dst) * sh.E.bytes);
      for (int c = lane; c < n16; c += 32)
        g[c] = reinterpret_cast<const uint4*>(o)[c];
    }
    clk.mark(kPhRebuild);
    __syncwarp();  // the buffer is refilled kStages entries on
  }
}

}  // namespace qba
