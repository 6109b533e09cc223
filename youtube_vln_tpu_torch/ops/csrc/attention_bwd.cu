// Backward attention kernels of the PyTorch/CUDA port (Hopper, sm_90a).
//
// Replaces two Pallas TPU kernels of youtube_vln_tpu/ops/attention.py:
//   B3  _bwd_kernel     (:67)   dq, dk, dv of B1 (one problem)
//   B4  _bi_bwd_kernel  (:324)  the same for both directions of B2
// With P = softmax(q k^T / sqrt(D) + key_bias), P~ = P after dropout
// (mask of philox.cuh, scaled by 1 / (1 - rate)) and O = P~ v:
//   dV = P~^T dO
//   dP = mask * (dO V^T) / (1 - rate)
//   dS = P o (dP - Delta) / sqrt(D),   Delta = rowsum(dO o O)
//   dQ = dS K,   dK = dS^T Q;   the key bias gets no gradient.
// Delta equals the TPU kernel's rowsum(P o dP) (:96): dP there already has
// the mask and the scale undone, so rowsum(P o dP) = rowsum(P~ o dO V^T)
// = rowsum(dO o O).
//
// What bounds it on an H100 (bf16, at the fine-tuning geometry B*H =
// 96*8 = 768, D = 128; tensor-core peak 989 TFLOP/s, HBM 3.35 TB/s):
//   B3 808 x 808: 10*768*808^2*128 = 642 GFLOP (0.65 ms; the products S,
//      dP, dV, dQ and dK at 2 FLOP/MAC) against
//      8*768*808*128*2 B = 1.27 GB (0.38 ms): operation-bound.
//   B4 60 <-> 808: 95 GFLOP against 1.36 GB (0.41 ms): memory-bound.
//
// Design (flash-attention-2 style, deterministic, no atomics).  The TPU
// kernel keeps a whole S_q x S_kv tile in VMEM; an SM has 227 KB, so:
//   1. a pre-pass (delta_kernel) computes Delta per query row in f32 from
//      the O the forward returned;
//   2. key-tile-major blocks: one block per (b*h, 64-key tile) walks every
//      64-row query tile, recomputes S, P = exp(S - LSE) from the forward's
//      row statistic, replays the mask, and accumulates dV and dK for its
//      keys in shared memory;
//   3. query-tile-major blocks: one block per (b*h, 64-row query tile)
//      walks every key tile and accumulates dQ.
// Passes 2 and 3 share one launch: the grid's x axis holds the key tiles
// of problem 0 and 1, then the query tiles of problem 0 and 1 (B3 passes
// an empty problem 1, B4 runs both directions).  Each block owns the rows
// it writes, so no two blocks write one element.  4 warps per block; each
// warp owns 16 rows of every product: query rows for S, dP and dQ, key rows
// for dV and dK.  bf16: the products run on the tensor cores (WMMA
// 16x16x16, f32 accumulators); f32 (parity): on the CUDA cores in full
// f32.  Not yet used: wgmma, TMA, register-resident accumulators and a
// second block per SM (the bf16 layout takes 187 KB of shared memory).
//
// Edges.  Query rows past s_q and keys past s_kv get P = dS = 0 (their
// tiles are zero-filled and never written back), so they contribute
// nothing; a row whose real keys all carry -10000 (a padded candidate)
// keeps its near-uniform P.  q, k, v, o, dO and the gradients are read and
// written through their strides (last dim contiguous).
//
// C interface (loaded with ctypes by ops/_build.py): vln_attention_bwd
// returns cudaGetLastError() after its two launches.  The caller allocates
// the gradients and the Delta scratch; the kernel allocates nothing and
// launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

using namespace nvcuda;

// One backward problem (mirrored by ops/attention.py _BwdProblem): queries
// [B, H, s_q, D] over keys/values [B, H, s_kv, D], the forward's output o
// and row statistic lse [B*H, s_q], the output gradient dout; writes dq,
// dk, dv (strided like q, k, v) and the scratch delta [B*H, s_q].
struct BwdProblem {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, s_kv] additive key bias
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int s_q, s_kv;
  vln_philox::Dropout dropout;
};

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // f32 rows are unpadded to fit the f32 instance in one SM
  static constexpr int KP = kBf16 ? D + 8 : D;        // staged row stride
  static constexpr int SP = kBf16 ? BN + 4 : BN + 1;  // f32 S / dP row stride
  static constexpr int PP = BN + 8;                   // bf16 P~ / dS row stride
  static constexpr int AP = kBf16 ? D + 4 : D;        // f32 accumulator stride
  // P~ and dS: own bf16 buffers for the tensor cores, in place over S and
  // dP in f32
  static constexpr int PTP = kBf16 ? PP : SP;
  static constexpr int tile = BM * KP * (int)sizeof(T);
  static constexpr int q = 0;
  static constexpr int dout = align128(q + tile);
  static constexpr int k = align128(dout + tile);
  static constexpr int v = align128(k + tile);
  static constexpr int s = align128(v + tile);
  static constexpr int dp = align128(s + BM * SP * 4);
  static constexpr int pt = align128(dp + BM * SP * 4);
  static constexpr int ds = align128(pt + (kBf16 ? BM * PP * 2 : 0));
  static constexpr int acc0 = align128(ds + (kBf16 ? BM * PP * 2 : 0));
  static constexpr int acc1 = align128(acc0 + BM * AP * 4);
  static constexpr int stats = align128(acc1 + BM * AP * 4);
  static constexpr int bytes = stats + 2 * BM * 4;
  static_assert(bytes <= 232448, "shared memory of one H100 block");
};

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + 64) of a [n, D] matrix into shared memory (row stride
// KP), zero past n
template <typename T, int D, int KP>
__device__ void load_tile(T* dst, const T* src, long long stride, int row0,
                          int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * KP + c * VEC) = val;
  }
}

// One warp's 16-row strip of a product: C[16 x N] (= or +=) A[16 x K] B[K x N].
// A(r, k) is A[r * lda + k] when A_ROW, else A[k * lda + r]; B(k, n) is
// B[k * ldb + n] when B_ROW, else B[n * ldb + k].  C is f32 in shared memory.
template <typename T, int N, int K, bool ACC, bool A_ROW, bool B_ROW>
__device__ void strip_mm(float* C, int ldc, const T* A, int lda, const T* B,
                         int ldb, int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using LA = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
    using LB = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int nb = 0; nb < N / 16; ++nb) {
      if (ACC)
        wmma::load_matrix_sync(acc, C + nb * 16, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::load_matrix_sync(a, A_ROW ? A + kk * 16 : A + kk * 16 * lda, lda);
        wmma::load_matrix_sync(
            b, B_ROW ? B + kk * 16 * ldb + nb * 16 : B + nb * 16 * ldb + kk * 16,
            ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + nb * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    static_assert((K & (K - 1)) == 0, "K is a power of two");
    for (int r = 0; r < 16; ++r) {
      for (int n = lane; n < N; n += 32) {
        float acc = ACC ? C[r * ldc + n] : 0.0f;
        for (int k0 = 0; k0 < K; ++k0) {
          // B^T rows are unpadded (stride a multiple of 32 words): each lane
          // starts at its own k so the lanes hit 32 different banks
          const int kk = B_ROW ? k0 : (k0 + lane) & (K - 1);
          acc = fmaf(A_ROW ? A[r * lda + kk] : A[kk * lda + r],
                     B_ROW ? B[kk * ldb + n] : B[n * ldb + kk], acc);
        }
        C[r * ldc + n] = acc;
      }
    }
  }
}

// P~ and dS of the warp's 16 query rows of the [64 x 64] tile at (q0, k0)
// from the raw scores in sS and dO V^T in sdP.  bf16: P~ to sPt (when
// WANT_PT) and dS to sDS; f32: in place, P~ over sS and dS over sdP.
template <typename T, int D, bool WANT_PT>
__device__ void probs_and_grads(const BwdProblem& p, int bh, int heads,
                                int q0, int k0, float scale, float* sS,
                                float* sdP, T* sPt, T* sDS, const float* sLse,
                                const float* sDelta, int r0, int lane) {
  using Lay = Layout<T, D>;
  const float* bias = p.bias + (long long)(bh / heads) * p.s_kv;
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const bool row_ok = q0 + row < p.s_q;
    for (int c = lane; c < BN; c += 32) {
      float pt = 0.0f, ds = 0.0f;
      if (row_ok && k0 + c < p.s_kv) {
        // scale, then add the bias, each rounded (no FMA), as the forward
        const float s = __fadd_rn(__fmul_rn(sS[row * Lay::SP + c], scale),
                                  bias[k0 + c]);
        const float pr = expf(s - sLse[row]);
        float dp = sdP[row * Lay::SP + c];
        pt = pr;
        if (p.dropout.enabled) {
          const bool kept = vln_philox::keep(p.dropout, bh, q0 + row, k0 + c);
          pt = kept ? pr * p.dropout.keep_scale : 0.0f;
          dp = kept ? dp * p.dropout.keep_scale : 0.0f;
        }
        ds = pr * (dp - sDelta[row]) * scale;
      }
      if constexpr (Lay::kBf16) {
        if (WANT_PT) sPt[row * Lay::PTP + c] = __float2bfloat16(pt);
        sDS[row * Lay::PTP + c] = __float2bfloat16(ds);
      } else {
        if (WANT_PT) sS[row * Lay::SP + c] = pt;
        sdP[row * Lay::SP + c] = ds;
      }
    }
  }
}

// LSE and Delta of query rows [q0, q0 + 64) into shared memory
__device__ void load_stats(const BwdProblem& p, int bh, int q0, float* sLse,
                           float* sDelta) {
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const bool ok = q0 + i < p.s_q;
    const long long at = (long long)bh * p.s_q + q0 + i;
    sLse[i] = ok ? p.lse[at] : 0.0f;
    sDelta[i] = ok ? p.delta[at] : 0.0f;
  }
}

template <typename T, int D>
struct Smem {
  T *q, *dout, *k, *v, *pt, *ds;
  float *s, *dp, *acc0, *acc1, *lse, *delta;
  __device__ explicit Smem(unsigned char* smem) {
    using Lay = Layout<T, D>;
    q = reinterpret_cast<T*>(smem + Lay::q);
    dout = reinterpret_cast<T*>(smem + Lay::dout);
    k = reinterpret_cast<T*>(smem + Lay::k);
    v = reinterpret_cast<T*>(smem + Lay::v);
    s = reinterpret_cast<float*>(smem + Lay::s);
    dp = reinterpret_cast<float*>(smem + Lay::dp);
    // f32: P~ and dS live in place over S and dP (never read through
    // these pointers)
    pt = reinterpret_cast<T*>(smem + (Lay::kBf16 ? Lay::pt : Lay::s));
    ds = reinterpret_cast<T*>(smem + (Lay::kBf16 ? Lay::ds : Lay::dp));
    acc0 = reinterpret_cast<float*>(smem + Lay::acc0);
    acc1 = reinterpret_cast<float*>(smem + Lay::acc1);
    lse = reinterpret_cast<float*>(smem + Lay::stats);
    delta = lse + BM;
  }
};

// the f32 path multiplies out of sS / sdP; the bf16 path out of sPt / sDS
template <typename T, int D>
__device__ __forceinline__ const T* pt_operand(const Smem<T, D>& sm) {
  if constexpr (Layout<T, D>::kBf16) return sm.pt;
  else return reinterpret_cast<const T*>(sm.s);
}
template <typename T, int D>
__device__ __forceinline__ const T* ds_operand(const Smem<T, D>& sm) {
  if constexpr (Layout<T, D>::kBf16) return sm.ds;
  else return reinterpret_cast<const T*>(sm.dp);
}

// zero a [64, D] f32 accumulator (stride AP)
template <typename T, int D>
__device__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS)
    acc[(i / D) * Layout<T, D>::AP + i % D] = 0.0f;
}

// rows [row0, row0 + 64) of an accumulator to a strided [n, D] output
template <typename T, int D>
__device__ void store_acc(T* dst, long long stride, const float* acc, int row0,
                          int n) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D, c = i % D;
    if (row0 + r < n)
      dst[(row0 + r) * stride + c] = from_float<T>(acc[r * Layout<T, D>::AP + c]);
  }
}

// key-tile-major pass: dK and dV of keys [k0, k0 + 64)
template <typename T, int D>
__device__ void dkdv_tile(const BwdProblem& p, int heads, int bh, int tile,
                          float scale, unsigned char* smem) {
  using Lay = Layout<T, D>;
  const Smem<T, D> sm(smem);
  const int b = bh / heads, h = bh % heads;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int k0 = tile * BN;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows

  zero_acc<T, D>(sm.acc0);  // dK
  zero_acc<T, D>(sm.acc1);  // dV
  load_tile<T, D, Lay::KP>(sm.k, k, p.k_ss, k0, p.s_kv);
  load_tile<T, D, Lay::KP>(sm.v, v, p.v_ss, k0, p.s_kv);
  for (int q0 = 0; q0 < p.s_q; q0 += BM) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, D, Lay::KP>(sm.q, q, p.q_ss, q0, p.s_q);
    load_tile<T, D, Lay::KP>(sm.dout, dout, p.do_ss, q0, p.s_q);
    load_stats(p, bh, q0, sm.lse, sm.delta);
    __syncthreads();
    // S = Q K^T and dO V^T for the warp's query rows
    strip_mm<T, BN, D, false, true, false>(sm.s + r0 * Lay::SP, Lay::SP,
                                           sm.q + r0 * Lay::KP, Lay::KP, sm.k,
                                           Lay::KP, lane);
    strip_mm<T, BN, D, false, true, false>(sm.dp + r0 * Lay::SP, Lay::SP,
                                           sm.dout + r0 * Lay::KP, Lay::KP,
                                           sm.v, Lay::KP, lane);
    __syncwarp();
    probs_and_grads<T, D, true>(p, bh, heads, q0, k0, scale, sm.s, sm.dp,
                                sm.pt, sm.ds, sm.lse, sm.delta, r0, lane);
    __syncthreads();  // every query row of P~ and dS is ready
    // dV += P~^T dO and dK += dS^T Q for the warp's key rows
    strip_mm<T, D, BM, true, false, true>(sm.acc1 + r0 * Lay::AP, Lay::AP,
                                          pt_operand(sm) + r0, Lay::PTP,
                                          sm.dout, Lay::KP, lane);
    strip_mm<T, D, BM, true, false, true>(sm.acc0 + r0 * Lay::AP, Lay::AP,
                                          ds_operand(sm) + r0, Lay::PTP, sm.q,
                                          Lay::KP, lane);
  }
  __syncthreads();
  store_acc<T, D>(static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss,
                  sm.acc0, k0, p.s_kv);
  store_acc<T, D>(static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss,
                  sm.acc1, k0, p.s_kv);
}

// query-tile-major pass: dQ of query rows [q0, q0 + 64)
template <typename T, int D>
__device__ void dq_tile(const BwdProblem& p, int heads, int bh, int tile,
                        float scale, unsigned char* smem) {
  using Lay = Layout<T, D>;
  const Smem<T, D> sm(smem);
  const int b = bh / heads, h = bh % heads;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int q0 = tile * BM;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;

  zero_acc<T, D>(sm.acc0);  // dQ
  load_tile<T, D, Lay::KP>(sm.q, q, p.q_ss, q0, p.s_q);
  load_tile<T, D, Lay::KP>(sm.dout, dout, p.do_ss, q0, p.s_q);
  load_stats(p, bh, q0, sm.lse, sm.delta);
  for (int k0 = 0; k0 < p.s_kv; k0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, D, Lay::KP>(sm.k, k, p.k_ss, k0, p.s_kv);
    load_tile<T, D, Lay::KP>(sm.v, v, p.v_ss, k0, p.s_kv);
    __syncthreads();
    strip_mm<T, BN, D, false, true, false>(sm.s + r0 * Lay::SP, Lay::SP,
                                           sm.q + r0 * Lay::KP, Lay::KP, sm.k,
                                           Lay::KP, lane);
    strip_mm<T, BN, D, false, true, false>(sm.dp + r0 * Lay::SP, Lay::SP,
                                           sm.dout + r0 * Lay::KP, Lay::KP,
                                           sm.v, Lay::KP, lane);
    __syncwarp();
    probs_and_grads<T, D, false>(p, bh, heads, q0, k0, scale, sm.s, sm.dp,
                                 sm.pt, sm.ds, sm.lse, sm.delta, r0, lane);
    __syncwarp();
    // dQ += dS K for the warp's query rows
    strip_mm<T, D, BN, true, true, true>(sm.acc0 + r0 * Lay::AP, Lay::AP,
                                         ds_operand(sm) + r0 * Lay::PTP,
                                         Lay::PTP, sm.k, Lay::KP, lane);
  }
  __syncthreads();
  store_acc<T, D>(static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss,
                  sm.acc0, q0, p.s_q);
}

__host__ __device__ inline int tiles(int n, int t) { return (n + t - 1) / t; }

// Delta = rowsum(dO o O) in f32, one warp per query row; the grid's x axis
// holds the row groups of problem 0, then those of problem 1
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(BwdProblem p0, BwdProblem p1, int groups0, int heads) {
  const bool first = (int)blockIdx.x < groups0;
  const BwdProblem& p = first ? p0 : p1;
  const int group = first ? blockIdx.x : blockIdx.x - groups0;
  const int row = group * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.s_q) return;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
                  row * p.do_ss;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(dout[c]), to_float(o[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[(long long)bh * p.s_q + row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(BwdProblem p0, BwdProblem p1, int kv0, int kv1, int qt0,
                     int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // block-uniform branches: key tiles of p0, p1, then query tiles of p0, p1
  const int x = blockIdx.x, bh = blockIdx.y;
  if (x < kv0)
    dkdv_tile<T, D>(p0, heads, bh, x, scale, smem);
  else if (x < kv0 + kv1)
    dkdv_tile<T, D>(p1, heads, bh, x - kv0, scale, smem);
  else if (x < kv0 + kv1 + qt0)
    dq_tile<T, D>(p0, heads, bh, x - kv0 - kv1, scale, smem);
  else
    dq_tile<T, D>(p1, heads, bh, x - kv0 - kv1 - qt0, scale, smem);
}

template <typename T, int D>
cudaError_t launch(const BwdProblem& p0, const BwdProblem& p1, int batch,
                   int heads, cudaStream_t stream) {
  const int groups0 = tiles(p0.s_q, WARPS), groups1 = tiles(p1.s_q, WARPS);
  delta_kernel<T, D><<<dim3(groups0 + groups1, batch * heads), THREADS, 0,
                       stream>>>(p0, p1, groups0, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bytes = Layout<T, D>::bytes;
  err = cudaFuncSetAttribute(attention_bwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // an empty problem 1 (s_q = s_kv = 0) adds no tiles
  const int kv0 = tiles(p0.s_kv, BN), kv1 = p1.s_q > 0 ? tiles(p1.s_kv, BN) : 0;
  const int qt0 = tiles(p0.s_q, BM), qt1 = tiles(p1.s_q, BM);
  const dim3 grid(kv0 + kv1 + qt0 + qt1, batch * heads);
  attention_bwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      p0, p1, kv0, kv1, qt0, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Runs problem p0 and, when p1->s_q > 0, problem p1 (B4: p0 is text ->
// vision, dropout direction 0; p1 vision -> text, 1).  is_bf16 selects bf16
// (1) or f32 (0) for q/k/v/o/dO and the gradients; head_dim is 64 or 128.
extern "C" int vln_attention_bwd(const BwdProblem* p0, const BwdProblem* p1,
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
