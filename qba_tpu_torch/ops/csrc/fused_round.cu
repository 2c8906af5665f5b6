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
//   A. verdict: a warp per live pool packet stages the packet's valid
//      evidence rows, its P row and a per-position 64-bit value-presence
//      mask (w <= 64) in shared memory, computes the receiver-independent
//      facts (out-of-range entries, row-length mismatch, colliding row
//      pairs), then walks the receivers: the corruption flags come from
//      the cell's draws, cheap rejections exit early, and the own-row
//      terms (dup row, own length, bad own value, own-row collision by one
//      bit test per P-position) are lane-parallel over list positions.
//      The result is a 64-bit mask of accepting receivers per packet.
//   B. dedup: a warp per receiver walks the packets in order, 32 at a
//      time; __match_any_sync finds the first candidate per order value
//      and the receiver's accepted set is a 64-bit mask, so the walk is
//      exactly the sequential first-accept of v not in Vi.  Winners get
//      their outgoing slot in the same walk.
//   C. per-receiver offsets of the compacted successor pool.
//   D. rebuild: a warp per destination copies its source packet's rows
//      and appends the receiver's own row with the keep/dup algebra, while
//      the rest of the block fills the dead tail of the successor pool.
// Only integer compares and direct indexed loads: no matrix unit, so the
// TPU's one-hot bf16 gathers and their exactness bound have no analog.
//
// Bound on this card: bytes.  Per trial and round the kernel must read
// the live packets' valid rows, lens, P and meta, their cells' draws
// (3 bytes per receiver), li and vi, and write the whole successor pool
// (int8 vals/P, int32 lens/meta) and vi; at 33 parties / sizeL 64 / 10
// dishonest the pool write alone is ~1.7 MB per trial.  The design reads
// each live input byte once into shared memory or L1, skips dead packets
// entirely, and writes the dead tail with 16-byte stores.
//
// Layouts (trial-major, contiguous): vals int8 [T, max_l, n_pool, S],
// lens int32 [T, n_pool, max_l], p int8 [T, n_pool, S], meta int32
// [T, n_pool, 4] = (count, v, sent, cell), li int32 [T, n_rv, S], vi
// int32 [T, n_rv, w], honest int32 [T, n_pool], draws uint8
// [T, n_pool, n_rv]; n_pool = n_rv * slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDrop = 1, kForge = 2, kClearP = 4, kClearL = 8, kForgeP = 16;

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
  int n_rv, slots, max_l, size_l, w, n_dis, round_idx, use_fp;
};

__host__ __device__ inline size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

// Shared-memory layout, computed identically on host and device.
struct Smem {
  size_t ok, vi, pm, src, cnt, offs, misc, rows, prow, stage, total;
  __host__ __device__ Smem(int n_rv, int slots, int max_l, int size_l) {
    size_t n_pool = size_t(n_rv) * slots;
    ok = 0;                                    // uint64 [n_pool]
    vi = ok + 8 * n_pool;                      // uint64 [n_rv]
    pm = vi + 8 * size_t(n_rv);                // uint64 [kWarps][size_l]
    src = pm + 8 * size_t(kWarps) * size_l;    // int32 [n_rv * slots]
    cnt = src + 4 * n_pool;                    // int32 [n_rv]
    offs = align8(cnt + 4 * size_t(n_rv));     // int32 [n_rv + 1]
    misc = align8(offs + 4 * size_t(n_rv + 1));  // int32 [4]
    rows = misc + 16;                          // int8 [kWarps][max_l*size_l]
    prow = rows + size_t(kWarps) * align8(size_t(max_l) * size_l);
    stage = align8(size_t(size_l));            // per-warp P row stride
    total = prow + size_t(kWarps) * stage;     // int8 [kWarps][size_l]
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
__device__ void block_fill(int8_t* dst, size_t n, int8_t byte) {
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

__global__ void __launch_bounds__(kThreads)
fused_round_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_rv = P.n_rv, slots = P.slots, max_l = P.max_l;
  const int S = P.size_l, w = P.w;
  const int n_pool = n_rv * slots;
  const Smem L(n_rv, slots, max_l, S);
  unsigned long long* ok_mask =
      reinterpret_cast<unsigned long long*>(smem_raw + L.ok);
  unsigned long long* vi_mask =
      reinterpret_cast<unsigned long long*>(smem_raw + L.vi);
  int* src_list = reinterpret_cast<int*>(smem_raw + L.src);
  int* k_cnt = reinterpret_cast<int*>(smem_raw + L.cnt);
  int* offs = reinterpret_cast<int*>(smem_raw + L.offs);
  int* misc = reinterpret_cast<int*>(smem_raw + L.misc);  // n_scan, ovf

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t t = blockIdx.x;
  const int8_t* vals = P.vals + t * size_t(max_l) * n_pool * S;
  const int32_t* lens = P.lens + t * size_t(n_pool) * max_l;
  const int8_t* pp = P.p + t * size_t(n_pool) * S;
  const int32_t* meta = P.meta + t * size_t(n_pool) * 4;
  const int32_t* li = P.li + t * size_t(n_rv) * S;
  const int32_t* vi = P.vi + t * size_t(n_rv) * w;
  const int32_t* honest = P.honest + t * size_t(n_pool);
  const size_t dbase = t * size_t(n_pool) * n_rv;
  const uint8_t* attack = P.attack + dbase;
  const uint8_t* rand_v = P.rand_v + dbase;
  const uint8_t* late = P.late + dbase;
  int8_t* o_vals = P.o_vals + t * size_t(max_l) * n_pool * S;
  int32_t* o_lens = P.o_lens + t * size_t(n_pool) * max_l;
  int8_t* o_p = P.o_p + t * size_t(n_pool) * S;
  int32_t* o_meta = P.o_meta + t * size_t(n_pool) * 4;
  int32_t* o_vi = P.o_vi + t * size_t(n_rv) * w;

  // ---- Setup: zeroed verdicts, vi as masks, the last live packet. ----
  if (threadIdx.x == 0) { misc[0] = 0; misc[1] = 0; }
  for (int i = threadIdx.x; i < n_pool; i += kThreads) ok_mask[i] = 0ull;
  for (int r = warp; r < n_rv; r += kWarps) {
    unsigned long long m = 0ull;
    for (int x0 = 0; x0 < w; x0 += 32) {
      int x = x0 + lane;
      unsigned b = __ballot_sync(kFull, x < w && vi[size_t(r) * w + x] != 0);
      m |= static_cast<unsigned long long>(b) << x0;
    }
    if (lane == 0) vi_mask[r] = m;
  }
  __syncthreads();
  {
    int last = 0;
    for (int i = threadIdx.x; i < n_pool; i += kThreads)
      if (meta[size_t(i) * 4 + 2] != 0) last = i + 1;
    if (last) atomicMax(&misc[0], last);
  }
  __syncthreads();
  const int n_scan = misc[0];

  // ---- Phase A: verdict, a warp per live packet. ----
  int8_t* rows = reinterpret_cast<int8_t*>(smem_raw + L.rows) +
                 size_t(warp) * align8(size_t(max_l) * S);
  int8_t* prow = reinterpret_cast<int8_t*>(smem_raw + L.prow) +
                 size_t(warp) * L.stage;
  unsigned long long* pm =
      reinterpret_cast<unsigned long long*>(smem_raw + L.pm) +
      size_t(warp) * S;
  for (int pk = warp; pk < n_scan; pk += kWarps) {
    const int32_t* m = meta + size_t(pk) * 4;
    const int count = m[0], v = m[1], sent = m[2], cell = m[3];
    if (!sent || cell < 0 || cell >= n_pool) continue;
    const int cnt_v = count < 0 ? 0 : (count > max_l ? max_l : count);
    // Stage valid rows and P; presence masks and the row facts.
    bool oob = false, coll = false, lens_bad = false;
    unsigned long long pm_any = 0ull;
    for (int j = lane; j < S; j += 32) {
      unsigned long long pmj = 0ull;
      for (int r = 0; r < cnt_v; ++r) {
        int x = vals[(size_t(r) * n_pool + pk) * S + j];
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
      prow[j] = pp[size_t(pk) * S + j] != 0;
    }
    const int len0 = lens[size_t(pk) * max_l];
    for (int r = lane; r < cnt_v; r += 32)
      if (lens[size_t(pk) * max_l + r] != len0) lens_bad = true;
    oob = __any_sync(kFull, oob);
    coll = __any_sync(kFull, coll);
    lens_bad = __any_sync(kFull, lens_bad);
    pm_any = warp_or64(pm_any);
    __syncwarp();

    const bool biz = honest[cell] == 0;
    const int sender = cell / slots;
    const unsigned long long valid_rows = low_bits(cnt_v);
    unsigned long long okbits = 0ull;
    for (int rv = 0; rv < n_rv; ++rv) {
      const size_t d = size_t(cell) * n_rv + rv;
      const int att = biz ? attack[d] : 0;
      if ((att & kDrop) || late[d] != 0 || sender == rv) continue;
      const int v2 = (att & kForge) ? int(rand_v[d]) : v;
      const bool clear_p = att & kClearP, clear_l = att & kClearL;
      const bool forge_p = P.use_fp && (att & kForgeP);
      const int count_eff = clear_l ? 0 : count;
      // |L'| == round + 1 needs count_eff in {round, round + 1}.
      if (count_eff != P.round_idx && count_eff != P.round_idx + 1) continue;
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
      if (cond1 && cond2 && cond3 && new_count == P.round_idx + 1)
        okbits |= 1ull << rv;
    }
    if (lane == 0) ok_mask[pk] = okbits;
    __syncwarp();
  }
  __syncthreads();

  // ---- Phase B: first accept per value, a warp per receiver. ----
  const bool rebroadcast = P.round_idx <= P.n_dis;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int rv = warp; rv < n_rv; rv += kWarps) {
    unsigned long long vim = vi_mask[rv];
    int cnt = 0;
    for (int base = 0; base < n_scan; base += 32) {
      const int pk = base + lane;
      bool cand = false;
      int v2 = -1;
      if (pk < n_scan && ((ok_mask[pk] >> rv) & 1ull)) {
        const int32_t* m = meta + size_t(pk) * 4;
        const int cell = m[3];
        const size_t d = size_t(cell) * n_rv + rv;
        const bool forged = honest[cell] == 0 && (attack[d] & kForge);
        v2 = forged ? int(rand_v[d]) : m[1];
        cand = v2 >= 0 && v2 < w && !((vim >> v2) & 1ull);
      }
      const unsigned peers = __match_any_sync(kFull, cand ? v2 : 64 + lane);
      const bool win = cand && lane == __ffs(peers) - 1;
      const unsigned winners = __ballot_sync(kFull, win);
      unsigned long long bit = win ? (1ull << v2) : 0ull;
      vim |= warp_or64(bit);
      if (rebroadcast) {
        if (win) {
          const int slot = cnt + __popc(winners & lt_mask);
          if (slot < slots) src_list[rv * slots + slot] = pk;
        }
        cnt += __popc(winners);
      }
    }
    for (int x = lane; x < w; x += 32)
      o_vi[size_t(rv) * w + x] = int32_t((vim >> x) & 1ull);
    if (lane == 0) {
      k_cnt[rv] = cnt < slots ? cnt : slots;
      if (cnt > slots) atomicOr(&misc[1], 1);
    }
  }
  __syncthreads();

  // ---- Phase C: compacted destinations, receiver-major. ----
  if (threadIdx.x == 0) {
    offs[0] = 0;
    for (int r = 0; r < n_rv; ++r) offs[r + 1] = offs[r] + k_cnt[r];
    P.o_ovf[t] = misc[1];
  }
  __syncthreads();
  const int total = offs[n_rv];

  // ---- Phase D: rebuild the live destinations, a warp each. ----
  for (int dst = warp; dst < total; dst += kWarps) {
    int rr = 0;
    for (int r0 = 0; r0 < n_rv; r0 += 32) {
      const int r = r0 + lane;
      const unsigned hit = __ballot_sync(
          kFull, r < n_rv && offs[r] <= dst && dst < offs[r + 1]);
      if (hit) { rr = r0 + __ffs(hit) - 1; break; }
    }
    const int slot = dst - offs[rr];
    const int src = src_list[rr * slots + slot];
    const int32_t* m = meta + size_t(src) * 4;
    const int count = m[0], cell = m[3];
    const size_t d = size_t(cell) * n_rv + rr;
    const int att = honest[cell] == 0 ? attack[d] : 0;
    const int v2 = (att & kForge) ? int(rand_v[d]) : m[1];
    const bool clear_p = att & kClearP, clear_l = att & kClearL;
    const bool forge_p = P.use_fp && (att & kForgeP);
    const int cnt_v = count < 0 ? 0 : (count > max_l ? max_l : count);
    const int cnt_eff = clear_l ? 0 : count;
    const int32_t* lir = li + size_t(rr) * S;
    int plen = 0;
    unsigned long long mis = 0ull;
    for (int j = lane; j < S; j += 32) {
      const bool pj = forge_p || (pp[size_t(src) * S + j] != 0 && !clear_p);
      const int own = pj ? lir[j] : -1;
      plen += pj;
      for (int r = 0; r < cnt_v; ++r)
        if (vals[(size_t(r) * n_pool + src) * S + j] != own) mis |= 1ull << r;
    }
    plen = __reduce_add_sync(kFull, plen);
    mis = warp_or64(mis);
    const bool dup = !clear_l && ((~mis & low_bits(cnt_v)) != 0ull);
    const int new_cnt = dup ? cnt_eff : (cnt_eff + 1 < max_l ? cnt_eff + 1 : max_l);
    for (int r = 0; r < max_l; ++r) {
      const bool is_new = !dup && r == cnt_eff;
      const bool keep = r < cnt_eff;
      int8_t* orow = o_vals + (size_t(r) * n_pool + dst) * S;
      const int8_t* irow = vals + (size_t(r) * n_pool + src) * S;
      for (int j = lane; j < S; j += 32) {
        int8_t x = -1;
        if (is_new) {
          const bool pj = forge_p || (pp[size_t(src) * S + j] != 0 && !clear_p);
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
      else if (r < cnt_eff) x = lens[size_t(src) * max_l + r];
      o_lens[size_t(dst) * max_l + r] = x;
    }
    for (int j = lane; j < S; j += 32)
      o_p[size_t(dst) * S + j] =
          int8_t(forge_p || (pp[size_t(src) * S + j] != 0 && !clear_p));
    if (lane < 4) {
      const int32_t f[4] = {new_cnt, v2, 1, rr * slots + slot};
      o_meta[size_t(dst) * 4 + lane] = f[lane];
    }
  }

  // ---- Phase E: the dead tail of the successor pool. ----
  const size_t dead = size_t(n_pool - total);
  if (dead) {
    for (int r = 0; r < max_l; ++r)
      block_fill(o_vals + (size_t(r) * n_pool + total) * S, dead * S, -1);
    block_fill(reinterpret_cast<int8_t*>(o_lens + size_t(total) * max_l),
               dead * max_l * 4, 0);
    block_fill(o_p + size_t(total) * S, dead * S, 0);
    block_fill(reinterpret_cast<int8_t*>(o_meta + size_t(total) * 4),
               dead * 16, 0);
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launch that was accepted.
extern "C" int qba_fused_round(
    const void* vals, const void* lens, const void* p, const void* meta,
    const void* li, const void* vi, const void* honest, const void* attack,
    const void* rand_v, const void* late, void* o_vals, void* o_lens,
    void* o_p, void* o_meta, void* o_vi, void* o_ovf, int n_trials,
    int n_rv, int slots, int max_l, int size_l, int w, int n_dis,
    int round_idx, int use_fp, void* stream) {
  if (n_trials <= 0) return 0;
  if (n_rv < 1 || n_rv > 64 || w < 1 || w > 64 || max_l < 1 || max_l > 64 ||
      slots < 1 || size_l < 1)
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
  prm.n_rv = n_rv;
  prm.slots = slots;
  prm.max_l = max_l;
  prm.size_l = size_l;
  prm.w = w;
  prm.n_dis = n_dis;
  prm.round_idx = round_idx;
  prm.use_fp = use_fp;
  const size_t smem = Smem(n_rv, slots, max_l, size_l).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_round_kernel<<<n_trials, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
