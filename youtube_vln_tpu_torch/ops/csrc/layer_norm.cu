// LayerNorm kernels of the PyTorch/CUDA port (Hopper, sm_90a): the TF-style
// LayerNorm of youtube_vln_tpu/models/layers.py:63 (layer_norm) at every
// LayerNorm site that the B5/B6 epilogue (epilogue.cu) does not take.
//
// Per row of x [N, D] (bf16 or f32; w, b [D] f32):
//   mean, var of x in f32; rstd = 1 / sqrt(var + 1e-12); xh = (x - mean) rstd
//   y  = w xh + b in f32, rounded once to x's type                 (forward)
//   g  = dy w;  dx = rstd (g - mean(g) - xh mean(g xh)) in x's type
//   dw = sum over the rows of dy xh;  db = sum of dy, in f32      (backward)
// The backward recomputes mean and rstd from x, the same sums in the
// forward's order: nothing but x is saved for it.
//
// What bounds it on an H100 (per launch at the 30RS vision sites, N = 16 x
// 6 x 808 = 77,568 rows, D = 1024, bf16; HBM 3.35 TB/s): the forward moves
// 2 N D x 2 B = 318 MB (95 us), the backward 3 N D x 2 B = 477 MB (142 us);
// about 8 and 14 operations per element are far below the card's rates.
// Both are memory-bound, so each reads every input once and writes every
// output once.
//
// Forward: one warp per row (8 warps, 8 rows per block); a lane holds the
// 16-byte chunks lane, lane + 32, ... of its row (D / 32 values) in
// registers; mean and variance are two passes over them, each a
// warp-shuffle sum.
//
// Backward: the same lanes and chunks; a lane keeps its columns' weights and
// dw/db partials in registers, and its row of x and dy as the loaded 16-byte
// words (bf16 stays packed: 16 + 16 registers a row, not 64).  The grid is
// one wave of resident blocks (vln_layer_norm_bwd_wave); warp w of block
// k walks the rows 8 k + w, stepping by 8 gridDim.x.  Per row: (sum x, sum
// g), then, with the mean known, (sum (x - mean)^2, sum g (x - mean)), which
// gives rstd and mean(g xh) = rstd sum g (x - mean) / D without
// cancellation; then dx and the partials.  dw and db are column sums over
// all N rows, deterministic for a given grid and without float atomics: the
// block sums its warps in warp order through shared memory into one row of
// [n_blocks, D] f32 partials, and layer_norm_param_sum_kernel sums those
// rows in a fixed order (rows.cuh column_sum, as B6's column_sum_kernel
// does; the kernel keeps a name of its own, so a trace tells the two
// apart).  The lane layout, loads, stores and warp sums are rows.cuh's,
// shared with B5/B6.  D is any multiple of 8 up to 1024; any N >= 1.
//
// C interface (loaded with ctypes by ops/_build.py): vln_layer_norm_fwd and
// vln_layer_norm_bwd return cudaGetLastError() after their launches; the
// kernels allocate nothing and launch on the caller's stream; the caller
// allocates the partials [n_blocks, D] f32, n_blocks at most the wave that
// vln_layer_norm_bwd_wave reports.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

// One LayerNorm call (outside the unnamed namespace: the exported C entry
// points take it).  Rows are contiguous [N, D]; mirrored by
// ops/layer_norm.py (_LayerNormCall).
struct LayerNormCall {
  const void* x;     // [N, D]
  const float* w;    // [D] weight
  const float* b;    // [D] bias (forward)
  const void* dy;    // [N, D] output gradient, the type of x (backward)
  void* y;           // [N, D] (forward)
  void* dx;          // [N, D] (backward)
  float* dw_part;    // [n_blocks, D] (backward)
  float* db_part;    // [n_blocks, D] (backward)
  float* dw;         // [D] (backward)
  float* db;         // [D] (backward)
  int n_rows, d, n_blocks;
};

namespace {

using namespace vln_rows;

template <typename T>
__global__ void __launch_bounds__(THREADS) layer_norm_fwd_kernel(LayerNormCall p) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= p.n_rows) return;  // no block-wide synchronisation below
  const int n_chunks = p.d / VEC;
  const long long base = (long long)row * p.d;
  const T* x = static_cast<const T*>(p.x) + base;
  float v[Traits<T>::N];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      load_vec(x + chunk * VEC, v + c * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[c * VEC + i];
    }
  }
  const float mean = warp_sum(sum) / (float)p.d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < n_chunks) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c * VEC + i] -= mean;
        sq += v[c * VEC + i] * v[c * VEC + i];
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)p.d + LN_EPS);
  T* y = static_cast<T*>(p.y) + base;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      float wv[VEC], bv[VEC], o[VEC];
      load_param<VEC>(p.w, chunk * VEC, wv);
      load_param<VEC>(p.b, chunk * VEC, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = wv[i] * (v[c * VEC + i] * rstd) + bv[i];
      store_vec(y + chunk * VEC, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) layer_norm_bwd_kernel(LayerNormCall p) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH, N = Traits<T>::N;
  __shared__ float red[WARPS][MAX_D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = p.d / VEC;
  const T* const xs = static_cast<const T*>(p.x);
  const T* const dys = static_cast<const T*>(p.dy);

  float wv[N], dw[N], db[N];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      load_param<VEC>(p.w, chunk * VEC, wv + c * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) wv[c * VEC + i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) dw[k] = db[k] = 0.f;

  for (int row = blockIdx.x * WARPS + warp; row < p.n_rows; row += gridDim.x * WARPS) {
    const long long base = (long long)row * p.d;
    uint4 xr[NCH], gr[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
        xr[c] = *reinterpret_cast<const uint4*>(xs + base + chunk * VEC);
        gr[c] = *reinterpret_cast<const uint4*>(dys + base + chunk * VEC);
      }
    }
    // pass 1: sum x (the forward's order) and sum g, g = dy w
    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (lane + 32 * c < n_chunks) {
        float xv[VEC], dyv[VEC];
        unpack<T>(xr[c], xv);
        unpack<T>(gr[c], dyv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sx += xv[i];
          sg += dyv[i] * wv[c * VEC + i];
        }
      }
    }
    const float mean = warp_sum(sx) / (float)p.d;
    sg = warp_sum(sg);
    // pass 2: sum (x - mean)^2 (the forward's order) and sum g (x - mean)
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (lane + 32 * c < n_chunks) {
        float xv[VEC], dyv[VEC];
        unpack<T>(xr[c], xv);
        unpack<T>(gr[c], dyv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float t = xv[i] - mean;
          sq += t * t;
          sgx += dyv[i] * wv[c * VEC + i] * t;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)p.d + LN_EPS);
    const float m1 = sg / (float)p.d;                       // mean of g
    const float m2 = rstd * warp_sum(sgx) / (float)p.d;     // mean of g xh
    // pass 3: dx = rstd (g - m1 - xh m2); the partials of dw and db
    T* dx = static_cast<T*>(p.dx) + base;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
        float xv[VEC], dyv[VEC], o[VEC];
        unpack<T>(xr[c], xv);
        unpack<T>(gr[c], dyv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          const float xh = (xv[i] - mean) * rstd;
          o[i] = rstd * (dyv[i] * wv[k] - m1 - xh * m2);
          dw[k] += dyv[i] * xh;
          db[k] += dyv[i];
        }
        store_vec(dx + chunk * VEC, o);
      }
    }
  }

  // the block's partials, its warps summed in warp order: dw, then db
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* acc = which == 0 ? dw : db;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) red[warp][chunk * VEC + i] = acc[c * VEC + i];
      }
    }
    __syncthreads();
    float* part = which == 0 ? p.dw_part : p.db_part;
    for (int col = threadIdx.x; col < p.d; col += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][col];
      part[(long long)blockIdx.x * p.d + col] = s;
    }
    __syncthreads();
  }
}

// dw and db from the backward's partials (rows.cuh column_sum)
__global__ void __launch_bounds__(CS_THREADS) layer_norm_param_sum_kernel(LayerNormCall p) {
  column_sum(p.dw_part, p.db_part, p.dw, p.db, p.n_blocks, p.d);
}

bool valid(const LayerNormCall& p) {
  return p.n_rows >= 1 && p.d >= 8 && p.d <= MAX_D && p.d % 8 == 0;
}

// one wave of the backward's resident blocks on the current device: the
// occupancy query times the SMs
template <typename T>
cudaError_t bwd_wave(int* out) {
  int dev = 0, blocks = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, layer_norm_bwd_kernel<T>,
                                                        THREADS, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *out = blocks * sms;
  return err;
}

}  // namespace

// The forward.  is_bf16 selects bf16 (1) or f32 (0) for x and y.
extern "C" int vln_layer_norm_fwd(const LayerNormCall* p, int is_bf16, void* stream) {
  if (!valid(*p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p->n_rows + WARPS - 1) / WARPS;
  if (is_bf16)
    layer_norm_fwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(*p);
  else
    layer_norm_fwd_kernel<float><<<blocks, THREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// The backward's resident blocks on the whole current device, bf16 (1) or
// f32 (0), into *out.  Returns a CUDA error code.
extern "C" int vln_layer_norm_bwd_wave(int is_bf16, int* out) {
  return static_cast<int>(is_bf16 ? bwd_wave<__nv_bfloat16>(out) : bwd_wave<float>(out));
}

// The backward: the row pass over p->n_blocks blocks, then the column sums
// of dw and db.
extern "C" int vln_layer_norm_bwd(const LayerNormCall* p, int is_bf16, void* stream) {
  if (!valid(*p) || p->n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    layer_norm_bwd_kernel<__nv_bfloat16><<<p->n_blocks, THREADS, 0, s>>>(*p);
  else
    layer_norm_bwd_kernel<float><<<p->n_blocks, THREADS, 0, s>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_param_sum_kernel<<<column_sum_grid(p->d), CS_THREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
