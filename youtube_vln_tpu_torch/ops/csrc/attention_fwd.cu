// Forward attention kernels of the PyTorch/CUDA port (Hopper, sm_90a).
//
// Replaces two Pallas TPU kernels of youtube_vln_tpu/ops/attention.py:
//   B1  _fwd_kernel     (:48)   out  = softmax(q k^T / sqrt(D) + key_bias) v
//   B2  _bi_fwd_kernel  (:288)  ctx1 = softmax(q2 k1^T / sqrt(D) + vbias) v1
//                               ctx2 = softmax(q1 k2^T / sqrt(D) + tbias) v2
// Both are the same computation on one or two (query, key/value) problems,
// so one kernel serves both: the grid's x axis holds the query tiles of
// problem 0 followed by those of problem 1 (B1 passes an empty problem 1),
// and B2 runs both directions in ONE launch as the TPU kernel does.
//
// What bounds it on an H100 (bf16, per launch at the beam-eval geometry,
// B*H = 30*8 = 240, D = 128; tensor-core peak 989 TFLOP/s, HBM 3.35 TB/s):
//   B1 S_q = S_kv = 808: 4*240*808*808*128 = 80.2 GFLOP (81 us) against
//      4*240*808*128*2 B = 199 MB of q/k/v/out (59 us): operation-bound.
//   B2 60 <-> 808: 8*240*60*808*128 = 11.9 GFLOP (12 us) against
//      (4*808 + 4*60)*240*128*2 B = 213 MB (64 us): memory-bound.
//
// Design.  The TPU kernel keeps the whole S_q x S_kv f32 score tile in VMEM
// (808 x 808 x 4 B = 2.6 MB); one SM has 227 KB of shared memory.  So the
// key/value axis is tiled with an online softmax (running row max m and
// row sum l, flash-attention style), and nothing of size S_q x S_kv ever
// reaches device memory:
//   * one block of 4 warps per (b*h, 64-row query tile); each warp owns 16
//     query rows, so the softmax of a row never leaves its warp;
//   * the Q tile and each 64-row K and V tile are staged in shared memory
//     with 16-byte loads; q, k, v and out are read and written through
//     their strides (last dim contiguous), so the transposed views of
//     split_heads / merge_heads need no copy;
//   * bf16: Q K^T and P V run on the tensor cores (WMMA 16x16x16, f32
//     accumulators); the f32 path (parity) multiplies on the CUDA cores
//     in full f32;
//   * scores, softmax statistics and the output accumulator stay in f32.
// Not yet used: wgmma, TMA and a pipelined K/V ring (later work).
//
// Training.  With dropout enabled the Philox mask of philox.cuh (a pure
// function of seed, stream b*H + h, query row, key and direction, so the
// backward kernels of attention_bwd.cu replay it tile by tile) multiplies
// the unnormalised exp(s - m) that meets V, scaled by 1 / (1 - rate); the
// running sum l sums the probabilities BEFORE dropout, because the TPU
// kernel normalises first and drops second (attention.py:54-61).  When
// the problem carries an lse pointer the kernel writes the f32 row
// statistic LSE = m + log(l) per query row ([B*H, s_q]) for the backward.
// With dropout off and no lse pointer (eval) the arithmetic is unchanged.
//
// Edges.  Keys past S_kv are excluded with -inf (they never see the
// -10000 bias); every key tile holds at least one real key, so the running
// max stays finite.  A row whose real keys all carry -10000 therefore
// comes out as the same near-uniform softmax the plain version gives.  The
// key bias is [B, S_kv] f32, indexed by b = bh / H.
//
// C interface (loaded with ctypes by ops/_build.py): vln_attention_fwd
// returns cudaGetLastError() after the launch.  The kernel allocates
// nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

using namespace nvcuda;

// One attention problem (outside the unnamed namespace: the exported C
// entry point takes it): queries [B, H, s_q, D] over keys/values
// [B, H, s_kv, D]; element strides in units of the element type.  The
// layout is mirrored by ops/attention.py (_Problem).
struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, s_kv] additive key bias
  void* o;            // [B, H, s_q, D], strided like q
  float* lse;         // [B*H, s_q] row log-sum-exp, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int s_q, s_kv;
  vln_philox::Dropout dropout;
};

namespace {

constexpr int BM = 64;             // query rows per block
constexpr int BN = 64;             // keys per key/value tile
constexpr int WARPS = 4;           // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int KP = D + 16 / sizeof(T);  // q/k/v row stride (16 B pad)
  static constexpr int SP = BN + 4;              // f32 score row stride
  static constexpr int PP = BN + 8;              // bf16 probability row stride
  static constexpr int OP = D + 4;               // f32 output row stride
  static constexpr int q = 0;
  static constexpr int k = align128(q + BM * KP * (int)sizeof(T));
  static constexpr int v = align128(k + BN * KP * (int)sizeof(T));
  static constexpr int s = align128(v + BN * KP * (int)sizeof(T));
  static constexpr int p = align128(s + BM * SP * 4);
  static constexpr int o = align128(p + (kBf16 ? BM * PP * 2 : 0));
  static constexpr int stats = align128(o + BM * OP * 4);
  static constexpr int bytes = stats + 3 * BM * 4;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a [n, D] matrix into shared memory, zero past n
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, long long stride, int row0,
                          int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * Layout<T, D>::KP + c * VEC) = val;
  }
}

// raw scores of the warp's 16 rows: sS[r0:r0+16, 0:64] = Q K^T
template <typename T, int D>
__device__ void tile_scores(const T* sQ, const T* sK, float* sS, int r0,
                            int lane) {
  using Lay = Layout<T, D>;
  if constexpr (Lay::kBf16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(a, sQ + r0 * Lay::KP + kk * 16, Lay::KP);
        // K stored row-major [key][d] is K^T in column-major order
        wmma::load_matrix_sync(b, sK + j * 16 * Lay::KP + kk * 16, Lay::KP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * Lay::SP + j * 16, acc, Lay::SP,
                              wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const float* qr = sQ + (r0 + r) * Lay::KP;
      for (int c = lane; c < BN; c += 32) {
        const float* kr = sK + c * Lay::KP;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        sS[(r0 + r) * Lay::SP + c] = acc;
      }
    }
  }
}

// sO[r0:r0+16, :] += P V for the warp's 16 rows
template <typename T, int D>
__device__ void tile_pv(const float* sS, const __nv_bfloat16* sP, const T* sV,
                        float* sO, int r0, int lane) {
  using Lay = Layout<T, D>;
  if constexpr (Lay::kBf16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int nb = 0; nb < D / 16; ++nb) {
      float* out = sO + r0 * Lay::OP + nb * 16;
      wmma::load_matrix_sync(acc, out, Lay::OP, wmma::mem_row_major);
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::load_matrix_sync(a, sP + r0 * Lay::PP + kk * 16, Lay::PP);
        wmma::load_matrix_sync(b, sV + kk * 16 * Lay::KP + nb * 16, Lay::KP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(out, acc, Lay::OP, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const float* pr = sS + (r0 + r) * Lay::SP;
      for (int c = lane; c < D; c += 32) {
        float acc = sO[(r0 + r) * Lay::OP + c];
        for (int kk = 0; kk < BN; ++kk)
          acc = fmaf(pr[kk], sV[kk * Lay::KP + c], acc);
        sO[(r0 + r) * Lay::OP + c] = acc;
      }
    }
  }
}

template <typename T, int D>
__device__ void attend_tile(const Problem& p, int heads, int bh, int tile,
                            float scale, unsigned char* smem) {
  using Lay = Layout<T, D>;
  T* sQ = reinterpret_cast<T*>(smem + Lay::q);
  T* sK = reinterpret_cast<T*>(smem + Lay::k);
  T* sV = reinterpret_cast<T*>(smem + Lay::v);
  float* sS = reinterpret_cast<float*>(smem + Lay::s);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p);
  float* sO = reinterpret_cast<float*>(smem + Lay::o);
  float* sM = reinterpret_cast<float*>(smem + Lay::stats);  // running max
  float* sL = sM + BM;                                       // running sum
  float* sA = sL + BM;                                       // rescale factor

  const int b = bh / heads, h = bh % heads;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* bias = p.bias + (long long)b * p.s_kv;
  const int q0 = tile * BM;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first row

  for (int i = lane; i < 16 * D; i += 32) sO[(r0 + i / D) * Lay::OP + i % D] = 0.0f;
  if (lane < 16) {
    sM[r0 + lane] = -INFINITY;
    sL[r0 + lane] = 0.0f;
  }
  load_tile<T, D>(sQ, q, p.q_ss, q0, p.s_q);

  for (int k0 = 0; k0 < p.s_kv; k0 += BN) {
    __syncthreads();  // the previous tile's K/V are consumed; Q is loaded
    load_tile<T, D>(sK, k, p.k_ss, k0, p.s_kv);
    load_tile<T, D>(sV, v, p.v_ss, k0, p.s_kv);
    __syncthreads();
    tile_scores<T, D>(sQ, sK, sS, r0, lane);
    __syncwarp();

    const int n_valid = min(BN, p.s_kv - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float x[BN / 32];
      float mx = -INFINITY;
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        // scale, then add the bias, each rounded (no FMA), as the TPU
        // kernel and the plain version do
        x[j] = c < n_valid
                   ? __fadd_rn(__fmul_rn(sS[row * Lay::SP + c], scale), bias[k0 + c])
                   : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: n_valid >= 1
      float sum = 0.0f;
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        const float e = expf(x[j] - m_new);  // 0 for keys past s_kv
        float pe = e;                        // the share that meets V
        if (p.dropout.enabled)
          pe = vln_philox::keep(p.dropout, bh, q0 + row, k0 + c)
                   ? e * p.dropout.keep_scale
                   : 0.0f;
        if constexpr (Lay::kBf16)
          sP[row * Lay::PP + c] = __float2bfloat16(pe);
        else
          sS[row * Lay::SP + c] = pe;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read sM[row]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
        sA[row] = alpha;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int row = r0 + i / D;
      sO[row * Lay::OP + i % D] *= sA[row];
    }
    __syncwarp();
    tile_pv<T, D>(sS, sP, sV, sO, r0, lane);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int row = r0 + i / D, c = i % D;
    if (q0 + row < p.s_q)
      o[(q0 + row) * p.o_ss + c] = from_float<T>(sO[row * Lay::OP + c] / sL[row]);
  }
  if (p.lse != nullptr && lane < 16 && q0 + r0 + lane < p.s_q)
    p.lse[(long long)bh * p.s_q + q0 + r0 + lane] =
        sM[r0 + lane] + logf(sL[r0 + lane]);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(Problem p0, Problem p1, int tiles0, int heads,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // block-uniform branch: the first tiles0 query tiles belong to problem 0
  if ((int)blockIdx.x < tiles0)
    attend_tile<T, D>(p0, heads, blockIdx.y, blockIdx.x, scale, smem);
  else
    attend_tile<T, D>(p1, heads, blockIdx.y, blockIdx.x - tiles0, scale, smem);
}

template <typename T, int D>
cudaError_t launch(const Problem& p0, const Problem& p1, int batch, int heads,
                   cudaStream_t stream) {
  const int bytes = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int tiles0 = (p0.s_q + BM - 1) / BM;
  const int tiles1 = (p1.s_q + BM - 1) / BM;
  const dim3 grid(tiles0 + tiles1, batch * heads);
  attention_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      p0, p1, tiles0, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Runs problem p0 and, when p1->s_q > 0, problem p1 in one launch (B2:
// p0 is text -> vision, dropout direction 0; p1 vision -> text, 1).
// is_bf16 selects bf16 (1) or f32 (0) for q/k/v/out; head_dim is 64 or 128.
extern "C" int vln_attention_fwd(const Problem* p0, const Problem* p1,
                                 int batch, int heads, int head_dim,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && head_dim == 128)
    err = launch<__nv_bfloat16, 128>(*p0, *p1, batch, heads, s);
  else if (is_bf16 && head_dim == 64)
    err = launch<__nv_bfloat16, 64>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 128)
    err = launch<float, 128>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 64)
    err = launch<float, 64>(*p0, *p1, batch, heads, s);
  return static_cast<int>(err);
}
