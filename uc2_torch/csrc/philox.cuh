// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 constants) and the attention dropout mask drawn
// from it. uc2_torch/ops/philox.py is the same code on tensors; the CPU
// tests hold it to Random123's known answers, and chip_smoke.py holds the
// kernels' masks to it bit for bit.
//
// The mask of score (batch b, head h, query i, key j) of a launch over
// heads h0 .. h0 + n - 1 of n_tot (h0 = 0, n_tot = n for a whole layer) is
// word j % 4 of philox4x32_10((j / 4, i, b * n_tot + h0 + h, 0), (seed, 0)),
// kept when the word is >= the threshold floor(rate * 2^32). It depends on
// the seed and the score's global index only, never on a tile, so the
// forward and the backward kernel draw the same mask. The training FFN
// block's output mask (ffn_keep_bits4) is keyed the same way on the global
// (row, column) of its [rows, H] output.
#pragma once

#include <stdint.h>

namespace uc2 {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep bits of the scores of query i against keys 4 * grp .. 4 * grp + 3 of
// head index bh = b * n_tot + h0 + h: bit r is set when key 4 * grp + r is
// kept.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t seed, uint32_t thresh,
                                               uint32_t grp, uint32_t i,
                                               uint32_t bh) {
  const uint4 w = philox4x32_10(make_uint4(grp, i, bh, 0u), seed, 0u);
  return (uint32_t)(w.x >= thresh) | ((uint32_t)(w.y >= thresh) << 1) |
         ((uint32_t)(w.z >= thresh) << 2) | ((uint32_t)(w.w >= thresh) << 3);
}

// Keep bits of output row `row`, columns 4 * grp .. 4 * grp + 3, of the
// training FFN block's [rows, H] output dropout: counter (grp, row, 0, 1),
// key (seed, 0); counter word 3 = 1 keeps this stream apart from the
// attention scores'. Bit r is set when column 4 * grp + r is kept.
__device__ __forceinline__ uint32_t ffn_keep_bits4(uint32_t seed, uint32_t thresh,
                                                   uint32_t grp, uint32_t row) {
  const uint4 w = philox4x32_10(make_uint4(grp, row, 0u, 1u), seed, 0u);
  return (uint32_t)(w.x >= thresh) | ((uint32_t)(w.y >= thresh) << 1) |
         ((uint32_t)(w.z >= thresh) << 2) | ((uint32_t)(w.w >= thresh) << 3);
}

}  // namespace uc2
