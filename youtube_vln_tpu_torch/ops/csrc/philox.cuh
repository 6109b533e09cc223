// Philox4x32-10 dropout bits of the attention and epilogue kernels
// (Hopper, sm_90a).
//
// Attention (attention_fwd.cu, attention_bwd.cu): one Philox4x32-10 call
// serves a 2 x 2 group of (query row, key) entries, and all four of its
// words are used.  The group of (i, j) holds rows {i0, i0 + 8} and keys
// {j0, j0 + 1}, with i0 = i with bit 3 cleared and j0 = j with bit 0
// cleared; its counter is
//   (c0, c1, c2, c3) = ((i >> 4) * 8 + (i & 7), j >> 1, stream, direction)
// under the key (seed_lo, seed_hi), and (i, j) reads word
// 2 * ((i >> 3) & 1) + (j & 1): x (i0, j0), y (i0, j0 + 1), z (i0 + 8, j0),
// w (i0 + 8, j0 + 1).  The entry is kept when its word is at least the
// threshold rate * 2^32.  ``stream`` is the global row b * H + h of the
// problem (global_stream): a launch of B rows and heads_local heads holds
// block bh = b_local * heads_local + h_local, whose global stream is
//   offset + b_local * heads_total + head0 + h_local,
// with Dropout::offset the first stream of this process's rows of a
// data-parallel batch (rank * B * heads_total, 0 in one process) and
// head0 the first head of its shard of the heads under tensor parallelism
// (model rank * heads_local, 0 without).  A shard, of rows, of heads or of
// both, so draws the entries of the whole problem's mask that it holds;
// with heads_total = heads_local and head0 = 0 the stream is offset + bh.
// The group is exactly what one thread holds of an
// m16n8 mma.sync accumulator (rows {r, r + 8} x keys {2c, 2c + 1}), so the
// bf16 forward and the dQ pass draw one call per fragment; the dK/dV pass
// computes the transposed scores and permutes its rows through ldmatrix
// so that its fragments hold the same groups (attention_bwd.cu).  The bit
// is a pure function of (seed, stream, i, j, direction): every tile of the
// forward and of both backward passes recomputes the same mask.
//
// Epilogue (epilogue.cu): element (row, col) of an [N, D] input is kept
// when word (col % 4) of Philox4x32-10 with counter (offset + row, col / 4,
// 0, EPILOGUE_DIRECTION) and the same key is at least the threshold, the
// offset being the shard's first global row as above; one
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

// The dropout settings of one attention problem or epilogue call.
struct Dropout {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // keep when the draw is >= threshold
  uint32_t direction;  // 0: B1 and B2 text->vision; 1: B2 vision->text;
                       // EPILOGUE_DIRECTION: B5/B6
  float keep_scale;    // 1 / (1 - rate)
  int enabled;
  uint32_t offset;     // first global stream (B1-B4) or row (B5/B6) of the
                       // launch: rank * (its streams or rows) under DDP
  uint32_t heads_total;  // B1-B4: heads of the whole problem
  uint32_t head0;        // B1-B4: first head of the launch's shard
};

// The global stream of block bh of a launch with ``heads`` heads per row,
// computed once per block.
__device__ __forceinline__ uint32_t global_stream(const Dropout& d, int bh,
                                                  int heads) {
  return d.offset + (uint32_t)(bh / heads) * d.heads_total + d.head0 +
         (uint32_t)(bh % heads);
}

// bit k set when word k of w is at least the threshold
__device__ __forceinline__ uint32_t kept4(uint4 w, uint32_t threshold) {
  return (uint32_t)(w.x >= threshold) | ((uint32_t)(w.y >= threshold) << 1) |
         ((uint32_t)(w.z >= threshold) << 2) | ((uint32_t)(w.w >= threshold) << 3);
}

// Keep bits of the attention group holding (i, j) of global stream
// ``stream`` (global_stream): bit 0 (i0, j0), bit 1 (i0, j0 + 1), bit 2
// (i0 + 8, j0), bit 3 (i0 + 8, j0 + 1).
__device__ __forceinline__ uint32_t keep_group(const Dropout& d, uint32_t stream,
                                               uint32_t i, uint32_t j) {
  return kept4(philox4(((i >> 4) << 3) | (i & 7u), j >> 1, stream,
                       d.direction, d.seed_lo, d.seed_hi), d.threshold);
}

// The keep bit of one attention entry (the f32 parity kernels).
__device__ __forceinline__ bool keep(const Dropout& d, uint32_t stream,
                                     uint32_t i, uint32_t j) {
  return (keep_group(d, stream, i, j) >> (((i >> 2) & 2u) | (j & 1u))) & 1u;
}

// Keep bits of columns 4*group .. 4*group + 3 of row ``row`` (epilogue),
// bit c for column 4*group + c.
__device__ __forceinline__ uint32_t keep4(const Dropout& d, uint32_t row,
                                          uint32_t group) {
  return kept4(philox4(d.offset + row, group, 0u, EPILOGUE_DIRECTION,
                       d.seed_lo, d.seed_hi), d.threshold);
}

}  // namespace vln_philox
