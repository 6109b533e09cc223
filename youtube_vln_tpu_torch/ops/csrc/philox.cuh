// Philox4x32-10 dropout bits of the attention and epilogue kernels
// (Hopper, sm_90a).
//
// Attention (attention_fwd.cu, attention_bwd.cu): keep(seed, stream, i, j,
// direction) is word 0 of Philox4x32-10 with counter (i, j, stream,
// direction) and key (seed_lo, seed_hi), kept when it is at least the
// threshold rate * 2^32.  The forward and backward kernels, which tile
// differently, recompute the same bit for every (row, key).
//
// Epilogue (epilogue.cu): element (row, col) of an [N, D] input is kept
// when word (col % 4) of Philox4x32-10 with counter (row, col / 4, 0,
// EPILOGUE_DIRECTION) and the same key is at least the threshold; one
// Philox call serves four neighbouring columns.  Direction 2 keeps these
// counters apart from the attention ones (directions 0 and 1).
//
// ops/philox.py computes both functions in plain torch, so a kernel and its
// plain version drop the same entries.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vln_philox {

constexpr uint32_t EPILOGUE_DIRECTION = 2;

__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1,
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
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word0(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3,
                                          uint32_t k0, uint32_t k1) {
  return philox4(c0, c1, c2, c3, k0, k1).x;
}

// The dropout settings of one attention problem or epilogue call.
struct Dropout {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // keep when the draw is >= threshold
  uint32_t direction;  // 0: B1 and B2 text->vision; 1: B2 vision->text;
                       // EPILOGUE_DIRECTION: B5/B6
  float keep_scale;    // 1 / (1 - rate)
  int enabled;
};

__device__ __forceinline__ bool keep(const Dropout& d, uint32_t stream,
                                     uint32_t i, uint32_t j) {
  return word0(i, j, stream, d.direction, d.seed_lo, d.seed_hi) >= d.threshold;
}

// Keep bits of columns 4*group .. 4*group + 3 of row ``row`` (epilogue),
// bit c for column 4*group + c.
__device__ __forceinline__ uint32_t keep4(const Dropout& d, uint32_t row,
                                          uint32_t group) {
  const uint4 w = philox4(row, group, 0u, EPILOGUE_DIRECTION, d.seed_lo,
                          d.seed_hi);
  return (uint32_t)(w.x >= d.threshold) | ((uint32_t)(w.y >= d.threshold) << 1) |
         ((uint32_t)(w.z >= d.threshold) << 2) |
         ((uint32_t)(w.w >= d.threshold) << 3);
}

}  // namespace vln_philox
