// Per-pair keep mask for in-kernel inverted pair dropout (Philox4x32-10).
//
// Replaces the TPU kernel helper rnet/kernels/pairwise.py::_pair_mask, which
// seeded the TPU's own generator with (step seed, b, i-tile, j-tile) and so
// drew a mask that depends on the kernel's tiling. Here the bits of pair
// p = i*nj + j of sample b are the first word of Philox4x32-10 (Salmon et
// al., SC'11) with
//
//     counter = (p, b, 0, 0),  key = (seed & 0xffffffff, seed >> 32)
//
// so the mask depends on (seed, b, i, j) alone: the forward kernel, the
// backward kernel, the mask kernel and the plain torch version
// (rnet_torch/kernels/pairwise.py::pair_mask_reference) all draw the same
// bits whatever their blocking. A pair is kept iff (bits >> 8) < thr, where
// the wrapper sets thr = ceil(keep * 2^24) with keep rounded to fp32: the
// same test as (bits >> 8) * 2^-24 < keep, done in integers so that every
// version agrees exactly. A kept pair's activation row (or its gradient) is
// scaled by inv_keep = fp32(1 / keep); a dropped one by 0.

#pragma once

#include <stdint.h>

namespace rnet {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// First output word of Philox4x32-10 at counter (c0, c1, 0, 0), key (k0, k1).
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2);
    const uint32_t lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c0;
}

// Whether pair p of sample b is kept under `seed` and threshold `thr`.
__device__ __forceinline__ bool pair_kept(uint64_t seed, uint32_t p, uint32_t b, uint32_t thr) {
  return (philox_word(p, b, (uint32_t)seed, (uint32_t)(seed >> 32)) >> 8) < thr;
}

}  // namespace rnet
