// Fused dropout + residual + LayerNorm epilogue kernels of the PyTorch/CUDA
// port (Hopper, sm_90a).
//
// Replaces two Pallas TPU kernels of youtube_vln_tpu/ops/epilogue.py:
//   B5  _epi_fwd_kernel (:43)  out = LN(dropout(h) + res) per row of [N, D]
//   B6  _epi_bwd_kernel (:61)  dh, dres, dw, db of B5 for the output grad do
//
// Per row (epilogue.py:43-95):
//   h'   = keep ? h * keep_scale : 0, rounded to h's type
//   y    = float(h' + res), the sum rounded to h's type first
//   mean, var of y in f32; rstd = 1 / sqrt(var + 1e-12); yh = (y - mean) rstd
//   out  = w yh + b (f32), cast to h's type                          (B5)
//   dyh  = do w;  dy = rstd (dyh - mean(dyh) - yh mean(dyh yh))
//   dres = dy;  dh = keep ? dy * keep_scale : 0;  dw = sum do yh;  db = sum do
// keep is the Philox mask of philox.cuh (keep4: counter (row, col / 4, 0, 2)),
// a pure function of (row, column) under the call's seed, so B6 replays
// B5's mask without storing it.  B6 recomputes y, mean and rstd from h and
// res, as the TPU kernel does: it saves nothing beyond h and res.
//
// What bounds it on an H100 (per launch at the pretraining vision sites,
// N = 56 * 808 = 45,248 rows, D = 1024, bf16; HBM 3.35 TB/s): B5 moves
// 3 N D x 2 B = 278 MB (83 us), B6 5 N D x 2 B = 463 MB (138 us); about 10
// and 20 operations per element are far below the card's rates.  Both are
// memory-bound, so the design reads each input once and writes each output
// once:
//   * one warp per row (8 warps, 8 rows per block); a lane holds its
//     D / 32 values in registers, loaded with 16-byte vector loads (8 bf16
//     or 4 f32), so the row is read from device memory once;
//   * mean and variance (two passes over the registers) and the two means
//     of B6 are warp-shuffle sums in f32: no shared memory on the row path;
//   * dw and db are column sums over all N rows.  Blocks run in parallel in
//     no order, so the TPU kernel's running sum across its sequential grid
//     becomes two stages without float atomics, deterministic for a given
//     grid: each B6 block walks rows blockIdx.x * 8 + warp, stepping by
//     gridDim.x * 8, keeps per-lane column partials in registers, sums its
//     8 warps in a fixed order through shared memory into one row of
//     [n_blocks, D] f32 partials, and a second kernel (column_sum_kernel)
//     sums those rows in a fixed order.
// D is any multiple of 128 up to 1024; any N >= 1.
//
// C interface (loaded with ctypes by ops/_build.py): vln_epilogue_fwd and
// vln_epilogue_bwd return cudaGetLastError() after their launches.  The
// kernels allocate nothing and launch on the caller's stream; the caller
// allocates the partials [n_blocks, D] f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

// One epilogue call (outside the unnamed namespace: the exported C entry
// points take it).  Rows are contiguous [N, D]; mirrored by
// ops/epilogue.py (_Epilogue).
struct Epilogue {
  const void* h;     // [N, D]
  const void* res;   // [N, D], the type of h
  const float* w;    // [D] LayerNorm weight
  const float* b;    // [D] LayerNorm bias (B5)
  const void* dout;  // [N, D] output gradient (B6)
  void* out;         // [N, D] (B5)
  void* dh;          // [N, D] (B6)
  void* dres;        // [N, D] (B6)
  float* dw_part;    // [n_blocks, D] (B6)
  float* db_part;    // [n_blocks, D] (B6)
  float* dw;         // [D] (B6)
  float* db;         // [D] (B6)
  int n_rows, d, n_blocks;
  vln_philox::Dropout dropout;
};

namespace {

constexpr int WARPS = 8;              // one row per warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 1024;
constexpr float LN_EPS = 1e-12f;

template <typename T>
struct Traits {
  static constexpr int VEC = 16 / sizeof(T);            // values per 16 B
  static constexpr int NCH = MAX_D / (VEC * 32);        // 16 B chunks per lane
  static constexpr int N = NCH * VEC;                   // values per lane
};

__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Loads row ``row`` of h and res and returns, for this lane's chunks,
// y = float(round(h' + res)) with h' the dropped and rescaled h, the keep
// bits of each chunk (bit i for value i), and (mean, rstd) of the row.
// Values past D are 0 and excluded from the statistics.
template <typename T>
__device__ __forceinline__ float2 row_input(const Epilogue& p, int row, int lane,
                                            float (&y)[Traits<T>::N],
                                            uint32_t (&kbits)[Traits<T>::NCH]) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH;
  const int n_chunks = p.d / VEC;
  const long long base = (long long)row * p.d;
  const T* h = static_cast<const T*>(p.h) + base;
  const T* r = static_cast<const T*>(p.res) + base;
  const vln_philox::Dropout& dr = p.dropout;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    float* yc = y + c * VEC;
    if (chunk < n_chunks) {
      float hv[VEC], rv[VEC];
      load_vec(h + chunk * VEC, hv);
      load_vec(r + chunk * VEC, rv);
      uint32_t bits = (1u << VEC) - 1u;
      if (dr.enabled) {
        bits = 0u;
#pragma unroll
        for (int g = 0; g < VEC / 4; ++g)
          bits |= vln_philox::keep4(dr, (uint32_t)row, (uint32_t)(chunk * (VEC / 4) + g))
                  << (4 * g);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          hv[i] = ((bits >> i) & 1u) ? round_t<T>(hv[i] * dr.keep_scale) : 0.f;
      }
      kbits[c] = bits;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        yc[i] = round_t<T>(hv[i] + rv[i]);
        sum += yc[i];
      }
    } else {
      kbits[c] = 0u;
#pragma unroll
      for (int i = 0; i < VEC; ++i) yc[i] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / (float)p.d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < n_chunks) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float t = y[c * VEC + i] - mean;
        sq += t * t;
      }
    }
  }
  const float var = warp_sum(sq) / (float)p.d;
  return make_float2(mean, 1.0f / sqrtf(var + LN_EPS));
}

// w[col .. col + VEC) into f (f32, 16-byte loads)
template <int VEC>
__device__ __forceinline__ void load_param(const float* w, int col, float* f) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) load_vec(w + col + i, f + i);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) epilogue_fwd_kernel(Epilogue p) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= p.n_rows) return;  // no block-wide synchronisation below
  float y[Traits<T>::N];
  uint32_t kbits[NCH];
  const float2 stats = row_input<T>(p, row, lane, y, kbits);
  const int n_chunks = p.d / VEC;
  T* out = static_cast<T*>(p.out) + (long long)row * p.d;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      float wv[VEC], bv[VEC], o[VEC];
      load_param<VEC>(p.w, chunk * VEC, wv);
      load_param<VEC>(p.b, chunk * VEC, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = wv[i] * ((y[c * VEC + i] - stats.x) * stats.y) + bv[i];
      store_vec(out + chunk * VEC, o);
    }
  }
}

// One B6 block's column partial of ``acc``: its 8 warps summed in warp
// order through shared memory into row blockIdx.x of ``part``.
template <typename T>
__device__ __forceinline__ void block_partial(const Epilogue& p,
                                              const float (&acc)[Traits<T>::N],
                                              float (*red)[MAX_D], float* part) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < p.d / VEC) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[warp][chunk * VEC + i] = acc[c * VEC + i];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < p.d; col += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][col];
    part[(long long)blockIdx.x * p.d + col] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) epilogue_bwd_kernel(Epilogue p) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH, NV = Traits<T>::N;
  __shared__ float red[WARPS][MAX_D];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_chunks = p.d / VEC;
  float dw_acc[NV], db_acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) dw_acc[i] = db_acc[i] = 0.f;

  for (int row = blockIdx.x * WARPS + warp; row < p.n_rows;
       row += gridDim.x * WARPS) {
    float yh[NV], g[NV];
    uint32_t kbits[NCH];
    const float2 stats = row_input<T>(p, row, lane, yh, kbits);
    const long long base = (long long)row * p.d;
    const T* dout = static_cast<const T*>(p.dout) + base;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
        float wv[VEC], dov[VEC];
        load_param<VEC>(p.w, chunk * VEC, wv);
        load_vec(dout + chunk * VEC, dov);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          yh[k] = (yh[k] - stats.x) * stats.y;
          dw_acc[k] += dov[i] * yh[k];
          db_acc[k] += dov[i];
          g[k] = dov[i] * wv[i];  // d yhat
          s1 += g[k];
          s2 += g[k] * yh[k];
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)p.d;
    const float m2 = warp_sum(s2) / (float)p.d;
    T* dh = static_cast<T*>(p.dh) + base;
    T* dres = static_cast<T*>(p.dres) + base;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
        float dy[VEC], dhv[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          dy[i] = stats.y * (g[k] - m1 - yh[k] * m2);
          dhv[i] = dy[i];
          if (p.dropout.enabled)
            dhv[i] = ((kbits[c] >> i) & 1u) ? dy[i] * p.dropout.keep_scale : 0.f;
        }
        store_vec(dres + chunk * VEC, dy);
        store_vec(dh + chunk * VEC, dhv);
      }
    }
  }

  block_partial<T>(p, dw_acc, red, p.dw_part);
  block_partial<T>(p, db_acc, red, p.db_part);
}

// out[col] = sum over r of part[r, col], r in a fixed order: 32 columns
// per block, 8 row groups summed through shared memory.  blockIdx.y picks
// dw (0) or db (1).
__global__ void __launch_bounds__(THREADS) column_sum_kernel(Epilogue p) {
  __shared__ float s[WARPS][33];
  const int tx = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const float* part = blockIdx.y == 0 ? p.dw_part : p.db_part;
  float acc = 0.f;
  if (col < p.d)
    for (int r = grp; r < p.n_blocks; r += WARPS) acc += part[(long long)r * p.d + col];
  s[grp][tx] = acc;
  __syncthreads();
  if (grp == 0 && col < p.d) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < WARPS; ++g) t += s[g][tx];
    (blockIdx.y == 0 ? p.dw : p.db)[col] = t;
  }
}

bool valid(const Epilogue& p) {
  return p.n_rows >= 1 && p.d >= 128 && p.d <= MAX_D && p.d % 128 == 0;
}

}  // namespace

// B5.  is_bf16 selects bf16 (1) or f32 (0) for h, res and out.
extern "C" int vln_epilogue_fwd(const Epilogue* p, int is_bf16, void* stream) {
  if (!valid(*p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p->n_rows + WARPS - 1) / WARPS;
  if (is_bf16)
    epilogue_fwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(*p);
  else
    epilogue_fwd_kernel<float><<<blocks, THREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// B6: the row pass over p->n_blocks blocks, then the column sums of dw, db.
extern "C" int vln_epilogue_bwd(const Epilogue* p, int is_bf16, void* stream) {
  if (!valid(*p) || p->n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    epilogue_bwd_kernel<__nv_bfloat16><<<p->n_blocks, THREADS, 0, s>>>(*p);
  else
    epilogue_bwd_kernel<float><<<p->n_blocks, THREADS, 0, s>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  column_sum_kernel<<<dim3((p->d + 31) / 32, 2), THREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
