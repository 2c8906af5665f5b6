// Device code of the port's per-round kernels: fused_round.cu (one round
// per launch), tiled_round.cu (the round split at the accepted matrix into
// a verdict and a rebuild launch) and round_step.cu (one round over the
// dense mailbox, which rebuilds with rebuild_entry at fixed cells).  The
// trial megakernel keeps its own layout and phases (mega_phases.cuh); it
// takes from here the round's sizes, the stacked draw source and the
// helpers both verdicts share (lane groups, word tests, cp.async, the
// phase clock, the offsets scan).
//
// A round over a packet pool, as phases of one thread block per (shard,
// trial) separated by __syncthreads() by the caller:
//   setup  vi as 64-bit masks, the cells' sent and honesty bits, the
//          block's lists as int8 words in shared memory; then the sent
//          cells as a list in cell order;
//   A      verdict of every listed packet against every receiver (the
//          TPU's _verdict_block_accepts, round_kernel_tiled.py:119): a
//          warp a packet, staged with cp.async one packet ahead, its facts
//          once, the receivers across lanes (verdict_phase);
//   B      first accept per value into vi, and the winners' slots (or,
//          for the tiled verdict, each packet's accepted receivers as
//          one mask, tiled_round.cu's store_acc);
//   C      per-receiver offsets of the compacted successor pool;
//   D      rebuild of the live successor entries;
//   E      fill of the successor pool's dead tail.
// Each function takes the trial's pool pointers and the round's scalars,
// so that every kernel composes the phases it needs.  The kernels'
// sources describe the rest.
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

// The per-round kernels' block: 8 warps (ROUND_WARPS in
// round_kernel_tiled.py).  16 were timed beside them on the H100: faster
// for the 33-party fused round alone, slower for the party-sharded and
// 11-party kernels, and their packet buffers leave no room past about 700
// positions (PERF.md).
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

// A phase clock of N phases: a compile-time switch (kOn) whose
// instantiations only the timing scripts launch.  Thread 0 of the block
// reads clock64() at each mark and adds the cycles since the previous
// mark to the phase named, so each phase holds warp 0's cycles between
// the block's barriers (its own work, then its wait at the barrier).
// store() adds them into the block's int64 [N] slot of the clock buffer.
// Off (kOn false) the clock is an empty struct whose calls compile to
// nothing.
template <bool kOn, int N>
struct PhaseClock {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void store(long long*) const {}
};

template <int N>
struct PhaseClock<true, N> {
  long long last, acc[N];
  __device__ void start() {
    for (int i = 0; i < N; ++i) acc[i] = 0;
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
      for (int i = 0; i < N; ++i) out[i] += acc[i];
  }
};

// The per-round kernels' clock phases, in the order of the int64 [..,
// kRoundPhases] buffer (ROUND_PHASES in round_kernel_tiled.py).
enum RoundPhase {
  kRpSetup,        // vi masks, the cells' bits, the lists (and the
                   // cluster's exchange of them, the tiled verdict)
  kRpList,         // the sent cells' list
  kRpStage,        // verdict: warp 0 staging its packets, packet facts
  kRpReceivers,    // verdict: warp 0's receiver passes
  kRpVerdictWait,  // verdict: warp 0 at the barrier
  kRpDedup,        // first accept per value, slots
  kRpOffsets,      // vi out, successor offsets, overflow flag
  kRpRebuild,      // warp 0 rebuilding its successor entries
  kRpFill,         // warp 0's share of the unsent or dead entries' fill
  kRoundPhases
};

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
  __device__ explicit BlockAt(int n_trials) : BlockAt(n_trials, blockIdx.x) {}
  // Of (shard, trial) block `block` (the tiled verdict's clusters run
  // several thread blocks a (shard, trial)).
  __device__ BlockAt(int n_trials, int block) {
    if constexpr (kSharded) {
      shard = block / n_trials;
      t = size_t(block - shard * n_trials);
    } else {
      shard = 0;
      t = size_t(block);
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
// is_late(d, cell, rv) the racy delivery's lateness.  The megakernel's
// verdict, which reads a packet's draws for every receiver, first takes
// the cell's row (row(d, cell, biz), by the whole warp) and reads through
// it.  Draws is the stacked source: one trial's tables of one round, each
// [n_pool, n_glob] by mailbox cell, loaded where read, so its row is
// empty.  The trial megakernel's keyed entries hash their draws instead
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

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// A block's part of a (shard, trial) whose round n_ranks blocks of a
// thread-block cluster split (the tiled verdict): block `rank` loads and
// dedups the receivers [lo(n_rv), hi(n_rv)), loads the cells' words
// [lo(n_words), hi(n_words)), and checks the list entries verdict_owner
// gives it.  The default is a whole round in one block.
struct Part {
  int rank = 0, n_ranks = 1;
  __device__ int lo(int n) const { return rank * n / n_ranks; }
  __device__ int hi(int n) const { return (rank + 1) * n / n_ranks; }
};

// ---- Helpers of the verdicts (this one and mega_phases.cuh's). ----

// Lanes a receiver in a verdict: 32 / G receivers a pass.  Mirrored by
// lane_group in round_kernel_tiled.py.
__host__ __device__ inline int lane_group(int n_rv) {
  return n_rv <= 8 ? 4 : (n_rv <= 16 ? 2 : 1);
}

// Gather the ballot bits of lanes 0, G, 2G, ... into bits 0, 1, 2, ...
__device__ inline unsigned compress_lanes(unsigned bits, int G) {
  if (G == 1) return bits;
  unsigned out = 0;
  for (int i = 0; i * G < 32; ++i) out |= ((bits >> (i * G)) & 1u) << i;
  return out;
}

// 0x80 in each byte where a and b agree, 0 elsewhere (exact per byte: no
// borrow crosses a byte).
__device__ inline unsigned byte_eq(unsigned a, unsigned b) {
  const unsigned z = a ^ b;
  return ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
}

// The last word's valid positions as a byte mask (words before it: all).
__device__ inline unsigned valid_word(int q, int sw, int size_l) {
  const int tail = size_l - 4 * (sw - 1);  // 1..4 positions
  return q < sw - 1 || tail == 4 ? 0xffffffffu : (1u << (8 * tail)) - 1u;
}

__device__ inline unsigned long long warp_or64(unsigned long long x) {
  unsigned lo = __reduce_or_sync(kFull, unsigned(x));
  unsigned hi = __reduce_or_sync(kFull, unsigned(x >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ inline unsigned long long low_bits(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}

// Whether a P position of receiver rv whose list value does not fit int8
// is set in this packet (P bytes p, or every position under forge_p, none
// under clear_p): such a position matches no row.  Reads li (int32
// [.., S], row rv) from global memory; only a receiver in the lossy mask
// calls it.
__device__ inline bool lossy_hit(const int32_t* li, int rv, const Dims& d,
                                 const unsigned char* p, bool forge_p,
                                 bool clear_p) {
  bool hit = false;
  for (int j = 0; j < d.size_l; ++j) {
    const int x = li[size_t(rv) * d.size_l + j];
    const bool pj = forge_p || (p[j] != 0 && !clear_p);
    if (pj && x != int(int8_t(x))) hit = true;
  }
  return hit;
}

// ---- Asynchronous copies (cp.async), a thread's own groups. ----
__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Phase C (warp 0): offs = the exclusive prefix of k_cnt over the
// block's n_rv <= 64 receivers, offs[n_rv] the total.  The caller
// synchronises. ----
__device__ inline void offsets_phase(int* offs, const int* k_cnt, int n_rv) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int a = lane < n_rv ? k_cnt[lane] : 0;
  int b = lane + 32 < n_rv ? k_cnt[lane + 32] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, a, o), y = __shfl_up_sync(kFull, b, o);
    if (lane >= o) { a += x; b += y; }
  }
  b += __shfl_sync(kFull, a, 31);
  if (lane == 0) offs[0] = 0;
  if (lane < n_rv) offs[lane + 1] = a;
  if (lane + 32 < n_rv) offs[lane + 33] = b;
}

// The largest dynamic shared memory of a block on this card (the H100's
// 227 KB).
constexpr int kSmemLimit = 232448;

// Shared-memory layout, computed identically on host and device (and by
// round_smem_bytes in round_kernel_tiled.py).  The accepted sets, slots
// (with `slots`: every kernel but the tiled verdict, which takes none),
// counts, offsets and flags first; with `verdict` (every kernel but the
// tiled rebuild) the verdict's parts: each warp's lossy receivers, the
// verdict and order of each cell, the cells' sent and honesty bits (a
// word per 32 cells), the sent cells' list, the block's lists li as int8
// words [sw][n_rv + 1] (position-major: lanes over receivers read
// consecutive words; the pad word keeps a warp over one receiver's words
// off a single bank) and their ineligibility words (round_setup), and
// per warp `stages`
// packet buffers of `buf` bytes: lens int32 [max_l], then P and the rows
// [max_l] as sw words of four positions, each part 16-aligned.  Two
// buffers a warp where they fit, else one.
struct Smem {
  size_t vi, src, cnt, offs, misc, lossy, ok, info, hon, sent, list, li, oor;
  size_t stage;
  size_t total;
  int sw, ld, bp, br, buf, stages;
  __host__ __device__ Smem(const Dims& d, bool verdict = true,
                           bool slots = true) {
    const size_t n_pool = size_t(d.n_pool()), chunks = (n_pool + 31) / 32;
    sw = (d.size_l + 3) / 4;
    ld = d.n_rv + 1;
    bp = align16(4 * d.max_l);
    br = bp + align16(4 * sw);
    buf = br + align16(4 * sw * d.max_l);
    vi = 0;                                           // uint64 [n_rv]
    src = vi + 8 * size_t(d.n_rv);                    // int32 [n_rv*slots]
    cnt = src + (slots ? 4 * size_t(d.n_out()) : 0);  // int32 [n_rv]
    offs = cnt + 4 * size_t(d.n_rv);                  // int32 [n_rv + 1]
    misc = size_t(align16(int(offs + 4 * size_t(d.n_rv + 1))));  // int32 [8]
    lossy = misc + 32;                                // uint64 [kWarps]
    ok = lossy + 8 * size_t(kWarps);                  // uint64 [n_pool]
    info = ok + 8 * n_pool;                           // int32 [n_pool]
    hon = info + 4 * n_pool;                          // uint32 [chunks]
    sent = hon + 4 * chunks;                          // uint32 [chunks]
    list = sent + 4 * chunks;                         // int32 [n_pool]
    li = list + 4 * n_pool;                           // uint32 [sw][ld]
    oor = li + 4 * size_t(sw) * ld;                   // uint32 [sw][ld]
    stage = size_t(align16(int(oor + 4 * size_t(sw) * ld)));
    stages = stage + size_t(kWarps) * 2 * buf <= size_t(kSmemLimit) ? 2 : 1;
    total = verdict ? stage + size_t(kWarps) * stages * buf : lossy;
  }
};

// Typed views of the block's shared memory.  misc: [0] the sent cells,
// [1] overflow, [6..7] the lossy mask.
struct Shared {
  unsigned long long* vi_mask;  // per receiver: its accepted values
  int* src_list;                // per (receiver, slot): source packet
  int* k_cnt;                   // per receiver: its successor entries
  int* offs;                    // per receiver: first successor entry
  int* misc;
  unsigned long long* lossy_w;  // per warp: receivers whose lists it read
                                // past int8
  unsigned long long* ok_mask;  // per cell: mask of accepting receivers
                                // (after a pruning dedup: of the winners)
  int* info;                    // per cell: cell << 8 | order (0xFF: none)
  unsigned* hon;                // per cell: honest sender bit
  unsigned* sent;               // per cell: sent bit
  int* list;                    // the sent cells, in cell order
  unsigned* li;                 // [sw][ld] list bytes
  unsigned* oor;                // [sw][ld] 0xFF where li is not in [0, w],
                                // 0x7F where it is 64 (in range, not
                                // eligible), else 0
  unsigned char* raw;
  Smem L;
  __device__ Shared(unsigned char* smem_raw, const Dims& d,
                    bool verdict = true, bool slots = true)
      : raw(smem_raw), L(d, verdict, slots) {
    vi_mask = reinterpret_cast<unsigned long long*>(raw + L.vi);
    src_list = reinterpret_cast<int*>(raw + L.src);
    k_cnt = reinterpret_cast<int*>(raw + L.cnt);
    offs = reinterpret_cast<int*>(raw + L.offs);
    misc = reinterpret_cast<int*>(raw + L.misc);
    lossy_w = reinterpret_cast<unsigned long long*>(raw + L.lossy);
    ok_mask = reinterpret_cast<unsigned long long*>(raw + L.ok);
    info = reinterpret_cast<int*>(raw + L.info);
    hon = reinterpret_cast<unsigned*>(raw + L.hon);
    sent = reinterpret_cast<unsigned*>(raw + L.sent);
    list = reinterpret_cast<int*>(raw + L.list);
    li = reinterpret_cast<unsigned*>(raw + L.li);
    oor = reinterpret_cast<unsigned*>(raw + L.oor);
  }
  // Warp `warp`'s packet buffer b.
  __device__ unsigned char* buf(int warp, int b) const {
    return raw + L.stage + size_t(L.stages * warp + b) * L.buf;
  }
  __device__ bool honest(int cell) const {
    return (hon[cell >> 5] >> (cell & 31)) & 1u;
  }
  __device__ unsigned long long lossy() const {
    return *reinterpret_cast<const unsigned long long*>(misc + 6);
  }
};

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

// vi int32 0/1 [n_rv, w] -> per-receiver masks of the receivers [r0,
// r1), a warp per receiver: each warp loads all its receivers' words
// before it ballots, so their loads are in flight together.
__device__ inline void load_vi_mask(const Shared& sh, const int32_t* vi,
                                    const Dims& d, int r0, int r1) {
  constexpr int kR = (64 + kWarps - 1) / kWarps;  // receivers a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x[kR][2];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = r0 + warp + k * kWarps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 32 * h + lane;
      x[k][h] = r < r1 && c < d.w ? vi[size_t(r) * d.w + c] : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = r0 + warp + k * kWarps;
    const unsigned lo = __ballot_sync(kFull, x[k][0] != 0);
    const unsigned hi = __ballot_sync(kFull, x[k][1] != 0);
    if (lane == 0 && r < r1)
      sh.vi_mask[r] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
}

// The per-receiver masks of the part's receivers -> their rows of vi
// int32 0/1 [n_rv, w].
__device__ inline void store_vi(const Shared& sh, int32_t* o_vi,
                                const Dims& d, Part part = Part{}) {
  for (int i = part.lo(d.n_rv) * d.w + threadIdx.x;
       i < part.hi(d.n_rv) * d.w; i += kThreads) {
    const int r = i / d.w, x = i - r * d.w;
    o_vi[i] = int32_t((sh.vi_mask[r] >> x) & 1ull);
  }
}

// ---- Setup (block), step 1: the round's flags, vi as masks, the cells'
// sent and honesty bits (a ballot a word of 32 cells, four words a warp
// at a time), and the block's lists li as int8 words with their
// ineligibility words (0xFF where li is not in [0, w], 0x7F where it is
// 64: in range but no position of a value mask; a nonzero byte is
// ineligible, bit 7 out of range), a thread a position, each warp noting
// the receivers whose lists hold a value past int8.  The loads of each
// part are in flight together.  Of a split round (Part), the block loads
// its receivers' vi and lists and its words of cells; the tiled verdict
// gathers the rest from the cluster.  The caller synchronises. ----
__device__ inline void round_setup(const Shared& sh, const int32_t* meta,
                                   const int32_t* honest, const int32_t* vi,
                                   const int32_t* li, const Dims& d,
                                   Part part = Part{}) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_pool = d.n_pool(), n_words = (n_pool + 31) / 32;
  const int r0 = part.lo(d.n_rv), r1 = part.hi(d.n_rv);
  if (threadIdx.x < 8) sh.misc[threadIdx.x] = 0;
  load_vi_mask(sh, vi, d, r0, r1);
  // The cells of the words [lo(n_words), hi(n_words)): four words a
  // warp at a time.
  const int c_hi = 32 * part.hi(n_words);
  const int c_end = c_hi < n_pool ? c_hi : n_pool;
  for (int c0 = 32 * (part.lo(n_words) + warp); c0 < c_end;
       c0 += 4 * kThreads) {
    bool s[4], h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k * kThreads + lane;
      s[k] = c < c_end && meta[size_t(c) * 4 + 2] != 0;
      h[k] = c < c_end && honest[c] != 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned sb = __ballot_sync(kFull, s[k]);
      const unsigned hb = __ballot_sync(kFull, h[k]);
      const int c = c0 + k * kThreads;
      if (lane == 0 && c < c_end) {
        sh.sent[c >> 5] = sb;
        sh.hon[c >> 5] = hb;
      }
    }
  }
  // Position j of receiver rv is element rv * 4 sw + j, j < 4 sw.
  const int S = d.size_l, ld = sh.L.ld, row = 4 * sh.L.sw;
  const int n = r1 * row;
  unsigned char* lib = reinterpret_cast<unsigned char*>(sh.li);
  unsigned char* oob = reinterpret_cast<unsigned char*>(sh.oor);
  unsigned long long lossy = 0ull;
  for (int e0 = r0 * row + threadIdx.x; e0 < n; e0 += 4 * kThreads) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kThreads, rv = e / row, j = e - rv * row;
      x[k] = e < n && j < S ? li[size_t(rv) * S + j] : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kThreads, rv = e / row, j = e - rv * row;
      if (e >= n) continue;
      const size_t at = (size_t(j >> 2) * ld + rv) * 4 + (j & 3);
      lib[at] = uint8_t(x[k]);
      oob[at] = j >= S ? 0 : (x[k] < 0 || x[k] > d.w) ? 0xff
                                                     : (x[k] == 64 ? 0x7f : 0);
      if (x[k] != int(int8_t(x[k]))) lossy |= 1ull << rv;
    }
  }
  lossy = warp_or64(lossy);
  if (lane == 0) sh.lossy_w[warp] = lossy;
}

// ---- Setup, step 2: the sent cells as a list in cell order (list[0,
// misc[0])), a warp a word of cells, each counting the words before its
// own; the block's lossy mask (misc[6..7]) from the warps'.  The caller
// synchronises. ----
__device__ inline void list_sent(const Shared& sh, const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_words = (d.n_pool() + 31) / 32;
  for (int c = warp; c < n_words; c += kWarps) {
    int before = 0;
    for (int c2 = lane; c2 < c; c2 += 32) before += __popc(sh.sent[c2]);
    before = __reduce_add_sync(kFull, before);
    const unsigned bits = sh.sent[c];
    if ((bits >> lane) & 1u)
      sh.list[before + __popc(bits & ((1u << lane) - 1u))] = 32 * c + lane;
    if (c == n_words - 1 && lane == 0) sh.misc[0] = before + __popc(bits);
  }
  if (threadIdx.x == 0) {
    unsigned long long m = 0ull;
    for (int k = 0; k < kWarps; ++k) m |= sh.lossy_w[k];
    *reinterpret_cast<unsigned long long*>(sh.misc + 6) = m;
  }
}

// The warp copies packet pk's lens [0, max(cnt_v, 1)), P and its rows r <
// cnt_v (never a row past count) into buffer `buf` (Smem's packet
// layout): with cp.async where P and each row are whole 16-byte chunks
// (vec: S a multiple of 16 and the pool 16-aligned), else with plain loads
// that pad the positions past S (P 0, rows 0xFF = -1), so that word
// compares need no tail mask.  P is copied as the pool holds it (bytes
// 0/1); the caller commits the group.
template <class In>
__device__ inline void stage_packet(unsigned char* buf, const Smem& L,
                                    const In& in, int pk, int cnt_v,
                                    const Dims& d, bool vec) {
  const int lane = threadIdx.x & 31, S = d.size_l, sw = L.sw;
  const int32_t* lens = in.lens + size_t(pk) * d.max_l;
  for (int r = lane; r < (cnt_v > 0 ? cnt_v : 1); r += 32)
    cp_async4(buf + 4 * r, lens + r);
  const int8_t* p = in.p + size_t(pk) * S;
  if (vec) {
    const int n16 = S >> 4;
    for (int c = lane; c < n16; c += 32)
      cp_async16(buf + L.bp + 16 * c, p + 16 * c);
    for (int i = lane; i < cnt_v * n16; i += 32) {
      const int r = i / n16, c = i - r * n16;
      cp_async16(buf + L.br + r * S + 16 * c, in.row(r, pk, d) + 16 * c);
    }
    return;
  }
  unsigned* P4 = reinterpret_cast<unsigned*>(buf + L.bp);
  unsigned* R4 = reinterpret_cast<unsigned*>(buf + L.br);
  for (int i = lane; i < (cnt_v + 1) * sw; i += 32) {
    const int r = i / sw - 1, q = i - (r + 1) * sw;  // r = -1: P
    const int8_t* src = r < 0 ? p : in.row(r, pk, d);
    unsigned x = 0u;
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      const unsigned b = j < S ? uint8_t(src[j]) : (r < 0 ? 0u : 0xffu);
      x |= b << (8 * k);
    }
    if (r < 0) P4[q] = x;
    else R4[r * sw + q] = x;
  }
}

// A packet's draws for the lanes' receivers: per pass p (receivers p * 32
// / G + lane / G), attack | late << 8 | rand_v << 16, each byte of the
// cell's row of the [n_pool, n_glob] tables (lanes over receivers read
// consecutive bytes); 0 past the block's receivers or for a cell outside
// the pool, and an honest sender's attack and order 0.
__device__ inline void packet_draws(unsigned (&out)[2], const Draws& dr,
                                    const Shared& sh, const Dims& d,
                                    int cell, int G) {
  const int lane = threadIdx.x & 31;
  const bool in = cell >= 0 && cell < d.n_pool();
  const bool biz = in && !sh.honest(cell);
  for (int p = 0; p < 2; ++p) {
    const int rv = p * (32 / G) + lane / G;
    unsigned x = 0u;
    if (in && rv < d.n_rv) {
      const size_t di = draw_index(d, cell, rv);
      x = unsigned(dr.late[di]) << 8;
      if (biz) x |= unsigned(dr.attack[di]) | unsigned(dr.rand_v[di]) << 16;
    }
    out[p] = x;
  }
}

// Which of n_ranks blocks splitting the list checks list entry i.
__device__ inline int verdict_owner(int i, int n_ranks) {
  return (i / kWarps) % n_ranks;
}

// ---- Phase A: verdict, a warp per sent cell of the list (list[warp],
// list[warp + kWarps], ...), receivers across lanes.  Writes ok_mask[pk]
// (a bit per block receiver) and info[pk] for every listed cell pk.  Of
// a split round (Part), block `rank` takes the runs of kWarps entries i
// with (i / kWarps) % n_ranks == rank (verdict_owner).
//
// Each warp stages its next packet into its other buffer with cp.async
// while it checks the current one, its meta two packets ahead and its
// draws one ahead in registers, so that no global load waits in the loop.
// The packet's facts (out-of-range values, colliding rows, disagreeing
// lens, the values present) are computed once, lanes over the staged
// words.  The receivers then run across lanes: lane group (lane / G)
// takes a receiver (two passes past 32 receivers), its G lanes split the
// packet's words, and each compares four positions a word (__vcmpeq4)
// against the staged rows.  One ballot a pass gives the packet's verdict
// bits.  A receiver in the lossy mask (a list value past int8) also checks
// its list in global memory (lossy_hit). ----
template <class In, class Clock>
__device__ inline void verdict_phase(const Shared& sh, const In& in,
                                     const int32_t* li, const Draws& dr,
                                     const Dims& d, int n_sent,
                                     int round_idx, int use_fp, Clock& clk,
                                     Part part = Part{}) {
  const int n_rv = d.n_rv, slots = d.slots, max_l = d.max_l;
  const int S = d.size_l, w = d.w, n_pool = d.n_pool();
  const int sw = sh.L.sw, ld = sh.L.ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = lane_group(n_rv), RP = 32 / G, g = lane % G;
  const bool vec4 = (sw & 3) == 0;  // rows of whole 16-byte chunks
  const bool vec = (S & 15) == 0 &&
                   ((reinterpret_cast<uintptr_t>(in.vals) |
                     reinterpret_cast<uintptr_t>(in.p)) & 15) == 0;
  const bool two = sh.L.stages == 2;
  const unsigned long long lossy = sh.lossy();
  const int first = part.rank * kWarps + warp;
  const int stride = part.n_ranks * kWarps;
  const int n_mine =
      first < n_sent ? (n_sent - first + stride - 1) / stride : 0;
  const auto pk_of = [&](int i) { return sh.list[first + i * stride]; };
  const auto meta_of = [&](int i) {
    return i < n_mine
               ? *reinterpret_cast<const int4*>(in.meta + size_t(pk_of(i)) * 4)
               : make_int4(0, 0, 0, -1);
  };
  const auto rows_of = [&](int count) {
    return count < 0 ? 0 : (count > max_l ? max_l : count);
  };
  int4 m0 = meta_of(0), m1 = meta_of(1);
  unsigned dc[2], dn[2];
  packet_draws(dc, dr, sh, d, m0.w, G);
  if (two && n_mine > 0)
    stage_packet(sh.buf(warp, 0), sh.L, in, pk_of(0), rows_of(m0.x), d, vec);
  cp_async_commit();
  for (int i = 0; i < n_mine; ++i) {
    const int pk = pk_of(i), b = two ? (i & 1) : 0;
    if (two) {
      if (i + 1 < n_mine)
        stage_packet(sh.buf(warp, b ^ 1), sh.L, in, pk_of(i + 1),
                     rows_of(m1.x), d, vec);
    } else {
      stage_packet(sh.buf(warp, 0), sh.L, in, pk, rows_of(m0.x), d, vec);
    }
    cp_async_commit();
    const int4 m2 = meta_of(i + 2);
    packet_draws(dn, dr, sh, d, m1.w, G);
    if (two) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncwarp();
    const int count = m0.x, v = m0.y, cell = m0.w;
    unsigned long long okbits = 0ull;
    if (cell >= 0 && cell < n_pool) {
      unsigned char* e = sh.buf(warp, b);
      const int32_t* lens = reinterpret_cast<const int32_t*>(e);
      unsigned* P4 = reinterpret_cast<unsigned*>(e + sh.L.bp);
      const unsigned* R4 = reinterpret_cast<const unsigned*>(e + sh.L.br);
      const int cnt_v = rows_of(count);
      // The packet's facts, lanes over its words, the rows in turn, in
      // byte-parallel word arithmetic (byte_eq, borrow-free sums): values
      // out of range, the packet's order present in a row (where some
      // receiver forges its order, every value present: pm_any), rows
      // that collide (hold one value at one position), lens that
      // disagree; P to bytes 0x00/0xFF in place.
      const bool forged =
          __any_sync(kFull, ((dc[0] | dc[1]) & unsigned(kForge)) != 0u);
      const bool v_in = v >= 0 && v < 64;
      const unsigned v4 = uint8_t(v) * 0x01010101u;
      const unsigned above_w = 0x7f7f7f7fu - uint8_t(w) * 0x01010101u;
      unsigned oob_w = 0u, coll_w = 0u, cont_w = 0u;
      unsigned long long pm_any = 0ull;
      for (int q = lane; q < sw; q += 32) {
        for (int r = 0; r < cnt_v; ++r) {
          const unsigned x4 = R4[r * sw + q];
          const unsigned unset = byte_eq(x4, 0xffffffffu);
          // Negative other than the sentinel -1, or above w.
          oob_w |= (x4 & 0x80808080u & ~unset) |
                   (((x4 & 0x7f7f7f7fu) + above_w) & ~x4 & 0x80808080u);
          cont_w |= byte_eq(x4, v4);
          if (forged) {
            for (int c = 0; c < 4; ++c) {
              const int x = int(int8_t(x4 >> (8 * c)));
              if (x >= 0 && x < 64) pm_any |= 1ull << x;
            }
          }
          // A zero byte of z: an earlier row holds this row's value there.
          const unsigned keep = unset >> 7;
          for (int r2 = 0; r2 < r; ++r2) {
            const unsigned z = (x4 ^ R4[r2 * sw + q]) | keep;
            coll_w |= (z - 0x01010101u) & ~z & 0x80808080u;
          }
        }
      }
      bool lens_bad = false;
      const int len0 = lens[0];
      for (int r = lane; r < cnt_v; r += 32)
        if (lens[r] != len0) lens_bad = true;
      int plen_p = 0;
      for (int q = lane; q < sw; q += 32) {
        const unsigned p4 = __vcmpne4(P4[q], 0u);
        P4[q] = p4;
        plen_p += __popc(p4) >> 3;
      }
      const bool oob = __any_sync(kFull, oob_w != 0u);
      const bool coll = __any_sync(kFull, coll_w != 0u);
      const bool cont_v = __any_sync(kFull, cont_w != 0u) && v_in;
      lens_bad = __any_sync(kFull, lens_bad);
      if (forged) pm_any = warp_or64(pm_any);
      plen_p = __reduce_add_sync(kFull, plen_p);
      __syncwarp();
      clk.mark(kRpStage);

      const int sender = cell / slots - d.r_off;  // as a block receiver
      const unsigned long long valid_rows = low_bits(cnt_v);
      for (int k0 = 0; k0 < n_rv; k0 += RP) {
        const int rv = k0 + lane / G;
        const unsigned dw = k0 == 0 ? dc[0] : dc[1];
        const int att = int(dw & 0xffu);
        bool act = rv < n_rv;
        int v2 = v, count_eff = count;
        bool clear_p = false, clear_l = false, forge_p = false;
        if (act) {
          if ((att & kDrop) || ((dw >> 8) & 0xffu) || sender == rv) {
            act = false;
          } else {
            v2 = (att & kForge) ? int(dw >> 16) : v;
            clear_p = att & kClearP;
            clear_l = att & kClearL;
            forge_p = use_fp && (att & kForgeP);
            count_eff = clear_l ? 0 : count;
            // |L'| == round + 1 needs count_eff in {round, round + 1}.
            if (count_eff != round_idx && count_eff != round_idx + 1) {
              act = false;
            } else if (!clear_l) {
              // Without a forging receiver every v2 is the packet's v.
              const bool cont =
                  forged ? v2 >= 0 && v2 < 64 && ((pm_any >> v2) & 1ull)
                         : cont_v;
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
        const int rc = act ? rv : 0;  // its list's column
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
            const unsigned eqv = v2_in ? byte_eq(li4, v2w) : 0u;
            if (((oor4 & 0x80808080u) | eqv) & p4) bad_own = true;
            // Eligible (nel zero): set in P, in [0, w] and below 64.
            nel[k] = ~p4 | oor4;
          }
          for (int r = 0; r < cnt_v; ++r) {
            unsigned row[4];
            if (vec4) {
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
        if (lossy && act && ((lossy >> rv) & 1ull) &&
            lossy_hit(li, rv, d, e + sh.L.bp, forge_p, clear_p)) {
          mis = valid_rows;
          bad_own = true;
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
        okbits |= static_cast<unsigned long long>(bits) << k0;
      }
      clk.mark(kRpReceivers);
    }
    if (lane == 0) {
      sh.ok_mask[pk] = okbits;
      sh.info[pk] = (cell << 8) | (v >= 0 && v < w ? v : 0xff);
    }
    __syncwarp();  // the buffer is refilled two packets on
    m0 = m1;
    m1 = m2;
    dc[0] = dn[0];
    dc[1] = dn[1];
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

// ---- Phase B: first accept per value, a warp per receiver, over the
// listed cells list[0, n), each one's verdict, cell and order read from
// shared memory.  Updates vi_mask; with `rebroadcast`, fills
// src_list/k_cnt and raises misc[1] on overflow.  With `prune`, clears
// the receiver's bit in each listed cell's verdict mask where the verdict
// accepted but the value was not new (already in vi, or taken by an
// earlier packet): ok_mask[pk] then holds the packet's winners, the tiled
// verdict's accepted mask.  Each warp clears only its receivers' bits,
// with a 32-bit atomicAnd on the word's half, so the other warps' reads
// of their own bits are unaffected.  Of a split round (Part), the block
// dedups its receivers. ----
__device__ inline void dedup_phase(const Shared& sh, const Draws& dr,
                                   const Dims& d, int n, bool rebroadcast,
                                   bool prune = false, Part part = Part{}) {
  const int slots = d.slots, w = d.w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rv = part.lo(d.n_rv) + warp; rv < part.hi(d.n_rv);
       rv += kWarps) {
    unsigned long long vim = sh.vi_mask[rv];
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int pk = i < n ? sh.list[i] : 0;
      const bool hit = i < n && ((sh.ok_mask[pk] >> rv) & 1ull);
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
      if (prune && hit && !win)
        atomicAnd(reinterpret_cast<unsigned*>(sh.ok_mask + pk) + (rv >> 5),
                  ~(1u << (rv & 31)));
      if (rebroadcast) assign_slots(sh, rv, pk, win, winners, cnt, slots);
    }
    if (lane == 0) sh.vi_mask[rv] = vim;
    close_slots(sh, rv, cnt, slots);
  }
}

// ---- Phase B from the accepted masks (store_acc's words): the winners'
// slots of the block's receivers, a warp for receivers warp, warp +
// kWarps, ...: over packets pk < n_rows in chunks of 32, a lane a packet,
// each lane's word read once for all the warp's receivers (coalesced),
// a ballot of bit rv a receiver.  Chunks without a set bit are skipped.
// ----
__device__ inline void slots_from_acc(const Shared& sh,
                                      const unsigned long long* acc,
                                      const Dims& d, int n_rows,
                                      bool rebroadcast) {
  constexpr int kR = (64 + kWarps - 1) / kWarps;  // receivers a warp
  const int n_rv = d.n_rv, slots = d.slots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cnt[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) cnt[k] = 0;
  for (int base = 0; rebroadcast && base < n_rows; base += 32) {
    const int pk = base + lane;
    const unsigned long long word = pk < n_rows ? acc[pk] : 0ull;
    if (!__any_sync(kFull, word != 0ull)) continue;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int rv = warp + k * kWarps;
      if (rv < n_rv) {
        const bool win = (word >> rv) & 1ull;
        const unsigned winners = __ballot_sync(kFull, win);
        if (winners) assign_slots(sh, rv, pk, win, winners, cnt[k], slots);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int rv = warp + k * kWarps;
    if (rv < n_rv) close_slots(sh, rv, cnt[k], slots);
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

// Shared memory the kernels need (Smem, with or without the verdict's
// parts), or a CUDA error: raises the kernel's dynamic limit past 48 KB
// where needed.
template <typename Kernel>
inline int prepare_smem(Kernel kernel, const Dims& d, size_t* smem,
                        bool verdict = true, bool slots = true) {
  *smem = Smem(d, verdict, slots).total;
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
