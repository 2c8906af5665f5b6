// The GF(2) measurement sweep of one shot as one device function run by
// one warp: shot_bits.  Shared by the standalone sweep kernel
// (gf2_sweep.cu) and the gen entry of the trial megakernel
// (trial_megakernel.cu), so that the two generation paths are
// bit-identical by construction.
//
// Replaces the JAX sweep qba_tpu/gf2/symplectic.py :: gf2_measure_sweep
// (line 121), which runs on the TPU inside the megakernel's gen=True
// prologue (qba_tpu/ops/trial_megakernel.py:232-324) and as XLA on the
// host path.  The plain PyTorch version it is held against is
// qba_tpu_torch/gf2/symplectic.py :: gf2_measure_sweep, the serial sweep.
//
// The function.  The sweep's pivots, row operations and selections read
// the tableau's x and z bits only, and those evolve from the family's
// static tableau whatever the shot's phases r and coins are; the phases
// change affinely over GF(2).  So a shot's outcome bits are an affine map
// of its own inputs, fixed per family:
//   bits = A_f . [r ; coins] + c_f   (mod 2),
// A_f [n, 3n], c_f [n].  The host runs the sweep once a family with each
// phase carried as a symbolic affine form (qba_tpu_torch/gf2/affine.py ::
// gf2_affine_map) and hands the kernel the map; the serial sweep of 2n
// rows per qubit becomes one bit-packed product per shot.  The TPU, which
// has no per-shot branch, computes both branches of every step for every
// shot and selects; Hopper needs neither: no step runs at all.
//
// Table layout (ops/gf2_sweep.py :: sweep_tables): a family's map is
// uint32 words [wt][n_pad], word-major so that the lanes of a warp read
// consecutive outputs: word k of qubit q's row at [k][q].  Words 0..wr-1
// hold the coefficients of the 2n phases (bit j of word k: phase 32k+j),
// words wr..wr+wc-1 those of the n coins, and word wt-1 the constant in
// bit 0, read against an input word of 1.  n_pad rounds n up to 32.
//
// The warp's work per shot: each input word is one ballot over 32 bytes
// of r or coins (warp-uniform in every lane); lane l owns outputs 32c+l
// for kChunks chunks c at a time and folds (row word & input word) into
// a register per chunk; the outcome is its parity.  An input word of 0
// skips its row words.
//
// Bound on this card: per shot 2 n wt word operations (an AND and an XOR
// a row word) and n parities, against 4n + 1 bytes in (phases, coins,
// readout flips, family) and 4n out (int32 bits): at 33 parties (n =
// 204, wt = 21) 8,772 operations and 1,633 bytes a shot, level at
// 64 integer operations a clock an SM and 3.35 TB/s.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qba_gf2 {

constexpr unsigned kFullMask = 0xffffffffu;

// A family's table: n qubits, wr phase words, wc coin words, wt words a
// row (the constant's too), n_pad outputs a word.
struct AffineDims {
  int n, wr, wc, wt, n_pad;
};

__host__ __device__ inline AffineDims affine_dims(int n) {
  const int wr = (2 * n + 31) / 32, wc = (n + 31) / 32;
  return AffineDims{n, wr, wc, wr + wc + 1, (n + 31) / 32 * 32};
}

// Word k of the shot's input [r ; coins ; 1], in every lane.
__device__ inline uint32_t input_word(const AffineDims& d, int k,
                                      const uint8_t* r,
                                      const uint8_t* coins) {
  const int lane = threadIdx.x & 31;
  if (k < d.wr) {
    const int i = 32 * k + lane;
    return __ballot_sync(kFullMask, i < 2 * d.n && (r[i] & 1));
  }
  if (k < d.wr + d.wc) {
    const int i = 32 * (k - d.wr) + lane;
    return __ballot_sync(kFullMask, i < d.n && (coins[i] & 1));
  }
  return 1u;
}

// One shot's outcomes at qubits 32 (c0 + c) + lane, c < kChunks: bit[c]
// is 0/1, XOR the readout flip (mflip null: none), 0 past n.  tab is the
// shot's family's table; r, coins and mflip its rows.  Called by all 32
// lanes of a warp with warp-uniform arguments.
template <int kChunks>
__device__ inline void shot_bits(const uint32_t* tab, const AffineDims& d,
                                 const uint8_t* r, const uint8_t* coins,
                                 const uint8_t* mflip, int c0,
                                 unsigned (&bit)[kChunks]) {
  const int lane = threadIdx.x & 31;
  uint32_t acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = 0u;
  const uint32_t* col = tab + 32 * c0 + lane;
#pragma unroll 4
  for (int k = 0; k < d.wt; ++k) {
    const uint32_t v = input_word(d, k, r, coins);
    if (v == 0u) continue;
    const uint32_t* row = col + size_t(k) * d.n_pad;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (32 * (c0 + c) < d.n_pad) acc[c] ^= row[32 * c] & v;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = 32 * (c0 + c) + lane;
    unsigned b = __popc(acc[c]) & 1u;
    if (mflip && q < d.n) b ^= mflip[q] & 1u;
    bit[c] = q < d.n ? b : 0u;
  }
}

}  // namespace qba_gf2
