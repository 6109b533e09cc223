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
// keep is the Philox mask of philox.cuh (keep4: counter (offset + row, col / 4,
// 0, 2), offset the launch's first global row under data parallelism), a
// pure function of (row, column) under the call's seed, so B6 replays
// B5's mask without storing it.  B6 recomputes y, mean and rstd from h and
// res, as the TPU kernel does: it saves nothing beyond h and res.
//
// What bounds it on an H100 (per launch at the pretraining vision sites,
// N = 56 * 808 = 45,248 rows, D = 1024, bf16; HBM 3.35 TB/s): B5 moves
// 3 N D x 2 B = 278 MB (83 us), B6 5 N D x 2 B = 463 MB (138 us); about 10
// and 20 operations per element are far below the card's rates.  Both are
// memory-bound, so each reads every input once and writes every output
// once, and B6 has to keep enough bytes in flight to fill the memory pipe
// while it spends about 22 integer instructions per element on the mask.
//
// B5: one warp per row (8 warps, 8 rows per block); a lane holds its D / 32
// values in registers, loaded with 16-byte vector loads (8 bf16 or 4 f32);
// mean and variance (two passes over the registers) are warp-shuffle sums.
//
// B6: one row per group of B6_ROW_WARPS = 4 warps (128 threads), 4 groups
// per 512-thread block.  A thread owns the same 8 columns (one 16 B
// chunk of bf16, two of f32) of every row it touches, so its live state is
// 8 values of the row plus 8 weights and the 8 + 8 dw/db column partials;
// __launch_bounds__(512, 2) caps it at 64 registers, and 2 blocks, 32 of
// the SM's 64 warps, are resident (one warp per row, as in B5, would hold
// 32 columns and their partials in each lane: 168 registers, 8 warps per
// SM).  The f32 instance stages twice the bytes a row and fits one block
// per SM.  Per row:
//   * the group's h, res and do chunks arrive through a private cp.async
//     ring of B6_STAGES = 3 stages in shared memory (a thread copies
//     and reads only its own 16 B slots, so cp.async.wait_group orders
//     them and no barrier is needed): two later rows are in flight while
//     this one's Philox bits (drawn before the wait: they depend only on
//     the coordinates), sums and stores run, and w is read once per
//     thread, not per row;
//   * two float2 exchanges: (sum y, sum g) with g = do w, then, with the
//     mean known, (sum (y - mean)^2, sum g (y - mean)), which gives the
//     variance and mean(g yhat) = rstd sum g (y - mean) / D without
//     cancellation.  Each is a warp-shuffle sum, then the group's 4 warps
//     in warp order through shared memory behind a named barrier of the
//     group's 128 threads;
//   * dw and db are column sums over all N rows, deterministic for a given
//     grid and without float atomics: each thread keeps its columns'
//     partials in registers over the rows of its group (blockIdx.x * 4 +
//     group, stepping by gridDim.x * 4), the block sums its 4 groups in a
//     fixed order through shared memory into one row of [n_blocks, D] f32
//     partials, and a second kernel (column_sum_kernel) sums those rows in
//     a fixed order.
// The grid is one wave: n_blocks is the resident blocks per SM that the
// occupancy query reports (vln_epilogue_bwd_layout) times the SMs, or
// fewer when the rows need fewer.  B5 and B6 share the per-chunk code
// (chunk_keep, chunk_y), so B6 rebuilds exactly the y and the mask of B5.
// D is any multiple of 128 up to 1024; any N >= 1.
//
// C interface (loaded with ctypes by ops/_build.py): vln_epilogue_fwd and
// vln_epilogue_bwd return cudaGetLastError() after their launches.  The
// kernels allocate nothing and launch on the caller's stream; the caller
// allocates the partials [n_blocks, D] f32.  vln_epilogue_bwd_layout
// reports B6's layout and occupancy on the current device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "philox.cuh"
#include "rows.cuh"

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

using namespace vln_rows;

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// The keep bits of 16 B chunk ``chunk`` (VEC values) of row ``row``, bit i
// for value i: keep4 of the chunk's groups of 4 columns; all set without
// dropout.
template <int VEC>
__device__ __forceinline__ uint32_t chunk_keep(const vln_philox::Dropout& dr, int row,
                                               int chunk) {
  if (!dr.enabled) return (1u << VEC) - 1u;
  uint32_t bits = 0u;
#pragma unroll
  for (int g = 0; g < VEC / 4; ++g)
    bits |= vln_philox::keep4(dr, (uint32_t)row, (uint32_t)(chunk * (VEC / 4) + g)) << (4 * g);
  return bits;
}

// y = float(round(h' + res)) of one chunk; hv becomes h' = round(h
// keep_scale) where ``bits`` keeps the value and 0 where it drops it
template <typename T>
__device__ __forceinline__ void chunk_y(const vln_philox::Dropout& dr, uint32_t bits,
                                        float* hv, const float* rv, float* y) {
  constexpr int VEC = Traits<T>::VEC;
  if (dr.enabled) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      hv[i] = ((bits >> i) & 1u) ? round_t<T>(hv[i] * dr.keep_scale) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) y[i] = round_t<T>(hv[i] + rv[i]);
}

// Loads row ``row`` of h and res (B5) and returns, for this lane's chunks,
// y = float(round(h' + res)) with h' the dropped and rescaled h, and
// (mean, rstd) of the row.  Values past D are 0 and excluded from the
// statistics.
template <typename T>
__device__ __forceinline__ float2 row_input(const Epilogue& p, int row, int lane,
                                            float (&y)[Traits<T>::N]) {
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
      const uint32_t bits = chunk_keep<VEC>(dr, row, chunk);
      chunk_y<T>(dr, bits, hv, rv, yc);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += yc[i];
    } else {
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

template <typename T>
__global__ void __launch_bounds__(THREADS) epilogue_fwd_kernel(Epilogue p) {
  constexpr int VEC = Traits<T>::VEC, NCH = Traits<T>::NCH;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= p.n_rows) return;  // no block-wide synchronisation below
  float y[Traits<T>::N];
  const float2 stats = row_input<T>(p, row, lane, y);
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


// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------
constexpr int B6_ROW_WARPS = 4;     // warps per row (a group)
constexpr int B6_ROWS = 4;          // rows (groups) per block
constexpr int B6_STAGES = 3;        // rows of a group in the cp.async ring
constexpr int B6_MIN_BLOCKS = 2;    // blocks per SM the registers are capped for
constexpr int B6_ROW_THREADS = 32 * B6_ROW_WARPS;
constexpr int B6_THREADS = B6_ROWS * B6_ROW_THREADS;

template <typename T>
struct B6Layout {
  static constexpr int VEC = 16 / sizeof(T);            // values per 16 B
  static constexpr int NV = MAX_D / B6_ROW_THREADS;      // values per thread
  static constexpr int NCH = NV / VEC;                   // 16 B chunks per operand
  static_assert(NCH >= 1 && NCH * VEC == NV, "whole 16-byte chunks per thread");
  // the ring: [group][stage][h, res, do][chunk][thread] x 16 B
  static constexpr int GROUP_SLOTS = B6_STAGES * 3 * NCH * B6_ROW_THREADS;
  static constexpr int RING_BYTES = B6_ROWS * GROUP_SLOTS * 16;
  // after the row loop, the block's column partials: [dw, db][group][MAX_D]
  static constexpr int RED_BYTES = 2 * B6_ROWS * MAX_D * 4;
  static constexpr int SMEM_BYTES = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

// the barrier of one B6 group: named barrier 1 + group over its threads
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(B6_ROW_THREADS) : "memory");
}

// (sum a, sum b) over the threads of a B6 group: warp shuffles, then the
// group's warps in warp order through ``slot`` (a float2 per warp), so every
// thread of the group gets the same two sums
__device__ __forceinline__ float2 group_sum2(float a, float b, float2* slot, int group) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int t = threadIdx.x % B6_ROW_THREADS;
  if (t % 32 == 0) slot[t / 32] = make_float2(a, b);
  group_sync(group);
  float2 s = slot[0];
#pragma unroll
  for (int w = 1; w < B6_ROW_WARPS; ++w) {
    s.x += slot[w].x;
    s.y += slot[w].y;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(B6_THREADS, B6_MIN_BLOCKS)
    epilogue_bwd_kernel(Epilogue p) {
  using L = B6Layout<T>;
  constexpr int VEC = L::VEC, NCH = L::NCH, NV = L::NV;
  extern __shared__ __align__(16) unsigned char smem[];
  // the two exchanges of a row; writing one again is ordered after every
  // read of it by the barrier of the other
  __shared__ float2 xch[B6_ROWS][2][B6_ROW_WARPS];
  const int group = threadIdx.x / B6_ROW_THREADS, t = threadIdx.x % B6_ROW_THREADS;
  const int n_chunks = p.d / VEC;
  const vln_philox::Dropout& dr = p.dropout;
  const T* const src[3] = {static_cast<const T*>(p.h), static_cast<const T*>(p.res),
                           static_cast<const T*>(p.dout)};
  // this thread's 16 B slot of (stage, operand, chunk): only this thread
  // writes and reads it, so cp.async.wait_group alone orders the two
  uint4* const ring = reinterpret_cast<uint4*>(smem) + group * L::GROUP_SLOTS + t;
  auto slot = [&](int stage, int x, int c) {
    return ring + ((stage * 3 + x) * NCH + c) * B6_ROW_THREADS;
  };
  auto read = [&](int stage, int x, int c, float* f) {
    load_vec(reinterpret_cast<const T*>(slot(stage, x, c)), f);
  };

  float wv[NV], dw[NV], db[NV];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = t + B6_ROW_THREADS * c;
    if (chunk < n_chunks) {
      load_param<VEC>(p.w, chunk * VEC, wv + c * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) wv[c * VEC + i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) dw[k] = db[k] = 0.f;

  const int first = blockIdx.x * B6_ROWS + group, step = gridDim.x * B6_ROWS;
  // starts the copies of row ``row`` (none past the last row) into
  // ``stage``: one commit group per call
  auto fetch = [&](int row, int stage) {
    if (row < p.n_rows) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int chunk = t + B6_ROW_THREADS * c;
        if (chunk < n_chunks) {
          const long long off = (long long)row * p.d + chunk * VEC;
#pragma unroll
          for (int x = 0; x < 3; ++x) vln_mma::cp_async16(slot(stage, x, c), src[x] + off, 16);
        }
      }
    }
    vln_mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < B6_STAGES - 1; ++s) fetch(first + s * step, s);

  int stage = 0;
  for (int row = first; row < p.n_rows; row += step) {
    fetch(row + (B6_STAGES - 1) * step, (stage + B6_STAGES - 1) % B6_STAGES);
    // the keep bits depend only on (row, column): drawn while the copies fly
    uint32_t kbits[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = t + B6_ROW_THREADS * c;
      kbits[c] = chunk < n_chunks ? chunk_keep<VEC>(dr, row, chunk) : 0u;
    }
    vln_mma::cp_async_wait<B6_STAGES - 1>();

    // pass 1: y = float(round(h' + res)); sums of y and of g = do w
    float y[NV];
    float sy = 0.f, sg = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (t + B6_ROW_THREADS * c < n_chunks) {
        float hv[VEC], rv[VEC], dov[VEC];
        read(stage, 0, c, hv);
        read(stage, 1, c, rv);
        read(stage, 2, c, dov);
        chunk_y<T>(dr, kbits[c], hv, rv, y + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          sy += y[k];
          sg += dov[i] * wv[k];
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) y[c * VEC + i] = 0.f;
      }
    }
    const float2 s1 = group_sum2(sy, sg, xch[group][0], group);
    const float mean = s1.x / (float)p.d;

    // pass 2: y -= mean; sums of y^2 and of g y
    float sq = 0.f, sgy = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (t + B6_ROW_THREADS * c < n_chunks) {
        float dov[VEC];
        read(stage, 2, c, dov);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          y[k] -= mean;
          sq += y[k] * y[k];
          sgy += dov[i] * wv[k] * y[k];
        }
      }
    }
    const float2 s2 = group_sum2(sq, sgy, xch[group][1], group);
    const float rstd = 1.0f / sqrtf(s2.x / (float)p.d + LN_EPS);
    const float m1 = s1.y / (float)p.d;         // mean of g
    const float m2 = rstd * s2.y / (float)p.d;  // mean of g yhat

    // pass 3: dres = dy = rstd (g - m1 - yhat m2), dh = dy where kept
    T* dh = static_cast<T*>(p.dh) + (long long)row * p.d;
    T* dres = static_cast<T*>(p.dres) + (long long)row * p.d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = t + B6_ROW_THREADS * c;
      if (chunk < n_chunks) {
        float dov[VEC], dy[VEC], dhv[VEC];
        read(stage, 2, c, dov);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          const float yh = y[k] * rstd;
          dy[i] = rstd * (dov[i] * wv[k] - m1 - yh * m2);
          dhv[i] = dy[i];
          if (dr.enabled) dhv[i] = ((kbits[c] >> i) & 1u) ? dy[i] * dr.keep_scale : 0.f;
          dw[k] += dov[i] * yh;
          db[k] += dov[i];
        }
        store_vec(dres + chunk * VEC, dy);
        store_vec(dh + chunk * VEC, dhv);
      }
    }
    stage = (stage + 1) % B6_STAGES;
  }

  // the block's partials: its groups summed in group order
  vln_mma::cp_async_wait<0>();
  __syncthreads();  // every group is done with the ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = t + B6_ROW_THREADS * c;
    if (chunk < n_chunks) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        red[group * MAX_D + chunk * VEC + i] = dw[c * VEC + i];
        red[(B6_ROWS + group) * MAX_D + chunk * VEC + i] = db[c * VEC + i];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < p.d; col += B6_THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int g = 0; g < B6_ROWS; ++g) {
      a += red[g * MAX_D + col];
      b += red[(B6_ROWS + g) * MAX_D + col];
    }
    p.dw_part[(long long)blockIdx.x * p.d + col] = a;
    p.db_part[(long long)blockIdx.x * p.d + col] = b;
  }
}

// dw and db from B6's partials (rows.cuh column_sum)
__global__ void __launch_bounds__(CS_THREADS) column_sum_kernel(Epilogue p) {
  column_sum(p.dw_part, p.db_part, p.dw, p.db, p.n_blocks, p.d);
}

bool valid(const Epilogue& p) {
  return p.n_rows >= 1 && p.d >= 128 && p.d <= MAX_D && p.d % 128 == 0;
}

constexpr int MAX_DEVICES = 64;

// B6's shared-memory attributes, set once per device (they hold for the
// device's context); a device past MAX_DEVICES sets them at every call
template <typename T>
cudaError_t configure_bwd() {
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(epilogue_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B6Layout<T>::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(epilogue_bwd_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < MAX_DEVICES) configured[dev] = true;
  return err;
}

template <typename T>
cudaError_t launch_bwd(const Epilogue& p, cudaStream_t s) {
  cudaError_t err = configure_bwd<T>();
  if (err != cudaSuccess) return err;
  epilogue_bwd_kernel<T><<<p.n_blocks, B6_THREADS, B6Layout<T>::SMEM_BYTES, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
int bwd_layout(int* out) {
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = configure_bwd<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, epilogue_bwd_kernel<T>, B6_THREADS, B6Layout<T>::SMEM_BYTES);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, epilogue_bwd_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int layout[] = {B6_ROWS, B6_THREADS, blocks, B6Layout<T>::SMEM_BYTES,
                        attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 6; ++i) out[i] = layout[i];
  return 0;
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
  cudaError_t err = is_bf16 ? launch_bwd<__nv_bfloat16>(*p, s) : launch_bwd<float>(*p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  column_sum_kernel<<<column_sum_grid(p->d), CS_THREADS, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// B6's layout for bf16 (1) or f32 (0) on the current device, into out[6]:
// rows per block, threads per block, the resident blocks per SM that the
// occupancy query reports, dynamic shared memory per block (B), registers
// per thread and local memory per thread (B; stack and spills).  Returns a
// CUDA error code.
extern "C" int vln_epilogue_bwd_layout(int is_bf16, int* out) {
  return is_bf16 ? bwd_layout<__nv_bfloat16>(out) : bwd_layout<float>(out);
}
