// What the row kernels of epilogue.cu (B5/B6) and layer_norm.cu share
// (Hopper, sm_90a): the per-lane layout of a row of at most MAX_D values,
// its 16-byte loads and stores as f32, the warp-shuffle sum, and the
// deterministic column sum that turns a backward's per-block partials of
// dw and db into dw and db.
//
// A warp holds a row of [N, D] (bf16 or f32): lane l holds the 16-byte
// chunks l, l + 32, ... of it, VEC values each (8 bf16 or 4 f32), NCH
// chunks and N = NCH x VEC values at D = MAX_D.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace vln_rows {

constexpr int MAX_D = 1024;
constexpr float LN_EPS = 1e-12f;
constexpr int WARPS = 8;              // a block of the one-warp-per-row kernels
constexpr int THREADS = WARPS * 32;

template <typename T>
struct Traits {
  static constexpr int VEC = 16 / sizeof(T);            // values per 16 B
  static constexpr int NCH = MAX_D / (VEC * 32);        // 16 B chunks per lane
  static constexpr int N = NCH * VEC;                   // values per lane
};

// a 16-byte word of T values as floats (4 f32 or 8 bf16)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h2[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// the 16-byte chunk at p as VEC floats
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// w[col .. col + VEC) into f (f32, 16-byte loads)
template <int VEC>
__device__ __forceinline__ void load_param(const float* w, int col, float* f) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) load_vec(w + col + i, f + i);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The column sum of a backward's partials, run by a block of
// 32 x CS_GROUPS threads on the grid column_sum_grid(d): out[col] = sum
// over r < n_parts of part[r, col], r in a fixed order.  A block takes 32
// columns; row group g sums rows g, g + CS_GROUPS, ..., and the groups are
// summed in order through shared memory.  blockIdx.y picks dw_part -> dw
// (0) or db_part -> db (1).  No float atomics: the sums do not depend on
// the order in which blocks run.
constexpr int CS_GROUPS = 32;
constexpr int CS_THREADS = 32 * CS_GROUPS;

inline dim3 column_sum_grid(int d) { return dim3((d + 31) / 32, 2); }

__device__ __forceinline__ void column_sum(const float* dw_part, const float* db_part,
                                           float* dw, float* db, int n_parts, int d) {
  __shared__ float s[CS_GROUPS][33];
  const int tx = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const float* part = blockIdx.y == 0 ? dw_part : db_part;
  float acc = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int r = grp; r < n_parts; r += CS_GROUPS) acc += part[(long long)r * d + col];
  }
  s[grp][tx] = acc;
  __syncthreads();
  if (grp == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < CS_GROUPS; ++g) total += s[g][tx];
    (blockIdx.y == 0 ? dw : db)[col] = total;
  }
}

}  // namespace vln_rows
