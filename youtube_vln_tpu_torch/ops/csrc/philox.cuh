// Philox4x32-10 dropout bits of the attention kernels (Hopper, sm_90a).
//
// keep(seed, stream, i, j, direction): word 0 of Philox4x32-10 with
// counter (i, j, stream, direction) and key (seed_lo, seed_hi), kept when
// it is at least the threshold rate * 2^32.  ops/philox.py computes the
// same function in plain torch; the forward and backward kernels, which
// tile differently, recompute the same bit for every (row, key).
#pragma once

#include <stdint.h>

namespace vln_philox {

__device__ __forceinline__ uint32_t word0(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3,
                                          uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// The dropout settings of one attention problem.
struct Dropout {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // keep when the draw is >= threshold
  uint32_t direction;  // 0: B1 and B2 text->vision; 1: B2 vision->text
  float keep_scale;    // 1 / (1 - rate)
  int enabled;
};

__device__ __forceinline__ bool keep(const Dropout& d, uint32_t stream,
                                     uint32_t i, uint32_t j) {
  return word0(i, j, stream, d.direction, d.seed_lo, d.seed_hi) >= d.threshold;
}

}  // namespace vln_philox
