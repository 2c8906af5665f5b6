// The GF(2) measurement sweep of one shot's stabilizer tableau, as one
// device function run by one warp: sweep_shot.  Shared by the standalone
// sweep kernel (gf2_sweep.cu) and the gen entry of the trial megakernel
// (trial_megakernel.cu), so that the two generation paths are
// bit-identical by construction.
//
// Replaces the JAX sweep qba_tpu/gf2/symplectic.py :: gf2_measure_sweep
// (line 121), which runs on the TPU inside the megakernel's gen=True
// prologue (qba_tpu/ops/trial_megakernel.py:232-324) and as XLA on the
// host path.  The plain PyTorch version it is held against is
// qba_tpu_torch/gf2/symplectic.py :: gf2_measure_sweep.
//
// The algebra is gf2_measure_sweep's.  Rows 0..n-1 of the tableau are
// destabilizers, n..2n-1 stabilizers; row i holds x and z as W packed
// 32-bit words and its phase bit r.  Here the words are stored word-major,
// x[k][i] for word k of row i ([W][2n]), so that the loads a step makes
// most, one word of every row, are consecutive across the lanes.  Per
// qubit a = 0..n-1:
//   random (some stabilizer row has x_a = 1): the first such row p is
//     the pivot; every other row h with x_a = 1 takes r_h ^= r_p ^
//     parity(z_h & x_p), x_h ^= x_p, z_h ^= z_p; destabilizer p - n
//     becomes the old row p; row p becomes Z_a with the coin as its sign;
//     the bit is the coin.
//   deterministic: the bit is sum_i s_i r_{n+i} + sum_{i<j} z_{n+i} .
//     x_{n+j} (mod 2) over the destabilizers s with x_a = 1, the packed
//     prefix form of qba_tpu/gf2/linalg.py:103: a running XOR of the
//     selected z rows, ANDed with each next selected x row, folded into
//     a lane-local parity.
//
// What the TPU forced, which Hopper does not: Pallas has no per-shot
// branch, so the TPU computes both branches for every shot and selects.
// Here one warp owns one shot and branches for real: a deterministic
// step never runs the 2n x W rank-1 update.  Lanes stride the rows for
// the x_a test, a ballot finds has_stab and the first pivot, and the
// words of the running prefix are spread across the lanes.
//
// Bound on this card: operations.  A random step tests 2n rows and
// updates the rows with x_a set (about 5 W word operations each); a
// deterministic step tests n rows and folds the selected ones (3 W
// each).  At 33 parties (n = 204, W = 7) a shot is some 1e4 to 1e6 word
// operations depending on how many rows each pivot touches, against a
// few hundred bytes of operands.  The warp's steps are serial and each
// waits on a ballot and on its tableau's memory, which only many
// resident warps hide.  So the standalone kernel keeps the tableau in
// shared memory only where every warp an SM can run gets a slot (up to
// 11 parties) and in per-warp global scratch past that (22,848 B of x
// and z at 33 parties, 110,880 B at 65), and the megakernel's gen entry
// always in global scratch, which leaves its three blocks per SM; the
// pointers are generic, so one function serves both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qba_gf2 {

constexpr unsigned kFullMask = 0xffffffffu;
// The deterministic branch keeps its running prefix in registers: W words
// over 32 lanes, at most kMaxWordChunks words a lane (n <= 4096 qubits).
constexpr int kMaxWordChunks = 4;
constexpr int kMaxWords = 32 * kMaxWordChunks;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// One shot's tableau: x and z [W][2n] words (word-major), r [2n] bytes,
// bits [n] bytes (the outcome of each qubit before readout flips).
struct ShotTab {
  uint32_t* x;
  uint32_t* z;
  uint8_t* r;
  uint8_t* bits;
};

__host__ __device__ inline size_t shot_bytes(int n, int w) {
  return align16(size_t(2) * 2 * n * w * 4 + size_t(2) * n + n);
}

__device__ inline ShotTab shot_tab(unsigned char* base, int n, int w) {
  ShotTab t;
  t.x = reinterpret_cast<uint32_t*>(base);
  t.z = t.x + size_t(2) * n * w;
  t.r = reinterpret_cast<uint8_t*>(t.z + size_t(2) * n * w);
  t.bits = t.r + 2 * n;
  return t;
}

// The warp copies a family's static tableau (word-major, [W][2n]) and the
// shot's phases in.
__device__ inline void load_shot(const ShotTab& t, int n, int w,
                                 const uint32_t* x0, const uint32_t* z0,
                                 const uint8_t* r) {
  const int lane = threadIdx.x & 31;
  const int words = 2 * n * w;
  for (int i = lane; i < words; i += 32) {
    t.x[i] = x0[i];
    t.z[i] = z0[i];
  }
  for (int i = lane; i < 2 * n; i += 32) t.r[i] = r[i] & 1;
  __syncwarp();
}

__device__ inline unsigned word_par(uint32_t v) { return __popc(v) & 1u; }

// Measures qubits 0..n-1 in place; t.bits[a] receives each outcome.
// Called by all 32 lanes of a warp, with warp-uniform arguments.
__device__ inline void sweep_shot(const ShotTab& t, int n, int w,
                                  const uint8_t* coins) {
  const int lane = threadIdx.x & 31;
  const size_t rows = size_t(2) * n;  // the stride between words
  uint32_t* x = t.x;
  uint32_t* z = t.z;
  uint8_t* r = t.r;
  for (int a = 0; a < n; ++a) {
    const int wa = a >> 5;
    const uint32_t ba = 1u << (a & 31);
    const uint32_t* xa = x + wa * rows;  // word wa of every row
    // The pivot: the first stabilizer row with x_a = 1, or -1.
    int p = -1;
    for (int c = 0; c < n && p < 0; c += 32) {
      const int i = c + lane;
      const unsigned m = __ballot_sync(kFullMask, i < n && (xa[n + i] & ba));
      if (m) p = n + c + __ffs(m) - 1;
    }
    int bit;
    if (p >= 0) {
      const uint8_t rp = r[p];
      const uint8_t coin = coins[a] & 1;
      for (int h = lane; h < 2 * n; h += 32) {
        if (h == p || !(xa[h] & ba)) continue;
        uint32_t par = 0;
        for (int k = 0; k < w; ++k) par ^= z[k * rows + h] & x[k * rows + p];
        r[h] ^= rp ^ uint8_t(word_par(par));
        for (int k = 0; k < w; ++k) {
          x[k * rows + h] ^= x[k * rows + p];
          z[k * rows + h] ^= z[k * rows + p];
        }
      }
      __syncwarp();
      // Row surgery: the pivot retires to destabilizer p - n, and row p
      // becomes +/- Z_a signed by the coin.
      for (int k = lane; k < w; k += 32) {
        x[k * rows + p - n] = x[k * rows + p];
        z[k * rows + p - n] = z[k * rows + p];
        x[k * rows + p] = 0;
        z[k * rows + p] = k == wa ? ba : 0u;
      }
      if (lane == 0) {
        r[p - n] = rp;
        r[p] = coin;
      }
      bit = coin;
    } else {
      uint32_t pre[kMaxWordChunks] = {0u, 0u, 0u, 0u};
      uint32_t acc = 0;
      unsigned phase = 0;
      for (int c = 0; c < n; c += 32) {
        const int i = c + lane;
        const bool s = i < n && (xa[i] & ba);
        unsigned m = __ballot_sync(kFullMask, s);
        phase ^= __popc(__ballot_sync(kFullMask, s && (r[n + i] & 1)));
        while (m) {
          const size_t row = n + c + __ffs(m) - 1;
          m &= m - 1;
#pragma unroll
          for (int j = 0; j < kMaxWordChunks; ++j) {
            const int k = lane + 32 * j;
            if (k < w) {
              acc ^= pre[j] & x[k * rows + row];
              pre[j] ^= z[k * rows + row];
            }
          }
        }
      }
      bit = int((phase ^ __popc(__ballot_sync(kFullMask, word_par(acc))))
                & 1u);
    }
    if (lane == 0) t.bits[a] = uint8_t(bit);
    __syncwarp();
  }
}

}  // namespace qba_gf2
