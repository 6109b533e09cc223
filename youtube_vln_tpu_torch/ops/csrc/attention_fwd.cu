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
// What bounds it on an H100 (bf16, D = 128; tensor-core peak 989 TFLOP/s,
// HBM 3.35 TB/s; 4 FLOP per (query, key, d) for Q K^T and P V):
//   B1 eval, B*H = 30*8 = 240, 808 x 808: 80.2 GFLOP (0.081 ms) against
//      199 MB of q/k/v/out (0.059 ms): operation-bound.
//   B1 train, B*H = 96*8 = 768, 808 x 808: 257 GFLOP (0.260 ms) against
//      636 MB (0.190 ms): operation-bound.
//   B2 60 <-> 808 (train shape): 95 GFLOP against 686 MB (0.205 ms):
//      memory-bound.
//
// Design of the bf16 instances (the main path), flash-attention-2 style.
// The TPU kernel keeps the whole S_q x S_kv f32 score tile in VMEM (808 x
// 808 x 4 B = 2.6 MB); one SM has 227 KB of shared memory, so the key axis
// is tiled with an online softmax and nothing of size S_q x S_kv leaves
// the registers:
//   * one block of 4 warps per (b*h, 64-row query tile); each warp owns 16
//     query rows, and its Q fragments stay in registers for the whole key
//     loop;
//   * S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate; mma.cuh),
//     K fragments through ldmatrix, V through ldmatrix.trans;
//   * scores, the running max m and the running sum l stay in registers: a
//     thread holds rows {r, r + 8} x keys {2c, 2c + 1} of each 8-key
//     n-tile, so a row's max reduces over the 4 lanes that share it (two
//     __shfl_xor_sync steps); each lane keeps a partial l, summed once at
//     the end;
//   * P goes from the f32 accumulators straight into the bf16 A fragments
//     of P V (the C layout of two n-tiles is the A layout of one k-step);
//     the 16 x D output accumulator stays in registers and is normalised
//     once at the end;
//   * K and V (and the key bias) come through a 2-stage ring filled by
//     cp.async: tile j + 1 is in flight while tile j is computed;
//   * shared memory: Q + 2 x (K, V) tiles at a 16-byte padded row stride
//     (ldmatrix without bank conflicts) = 87,552 B at D = 128 (46,592 B at
//     D = 64), so two blocks fit on an SM (__launch_bounds__(128, 2)).
// ptxas -v (sm_90a, CUDA 12.8): 252 registers a thread at D = 128 (181 at
// D = 64), no stack and no spills; the occupancy query
// (vln_attention_fwd_blocks_per_sm) reports 2 blocks, 8 warps, per SM at
// both head dims.  The f32 instances: 76 registers, 1 block per SM at
// D = 128.
// Left for later: wgmma from shared memory, TMA loads with mbarriers,
// warp specialisation (a producer warp and consumer warpgroups), a
// persistent grid.
//
// The f32 instances are the parity route, off the main path: they stage
// Q, K, V, the scores and the output in shared memory and multiply on the
// CUDA cores in full f32 (one block per SM).
//
// Training.  With dropout enabled the Philox mask of philox.cuh multiplies
// the unnormalised exp(s - m) that meets V, scaled by 1 / (1 - rate); the
// running sum l sums the probabilities BEFORE dropout, because the TPU
// kernel normalises first and drops second (attention.py:54-61).  The
// bf16 instances draw one Philox call per fragment of 2 rows x 2 keys and
// use its four words (keep_group); the mask is a pure function of (seed,
// global stream b*H + h, query row, key, direction), so the backward
// kernels of attention_bwd.cu replay it tile by tile.  A block computes its
// global stream once (global_stream): a launch on a shard of the rows or of
// the heads draws that shard's entries of the whole problem's mask.  When the problem carries an lse
// pointer the kernel writes the f32 row statistic LSE = m + log(l) per
// query row ([B*H, s_q]) for the backward.
//
// Edges.  Keys past S_kv are excluded with -inf (they never see the
// -10000 bias); every key tile holds at least one real key, so the running
// max stays finite.  A row whose real keys all carry -10000 therefore
// comes out as the same near-uniform softmax the plain version gives.  The
// key bias is [B, S_kv] f32, indexed by b = bh / H.  q, k, v and out are
// read and written through their strides (last dim contiguous), so the
// transposed views of split_heads / merge_heads need no copy.
//
// C interface (loaded with ctypes by ops/_build.py): vln_attention_fwd
// returns cudaGetLastError() after the launch.  The kernel allocates
// nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "philox.cuh"

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

using bf16 = __nv_bfloat16;
using namespace vln_mma;

constexpr int BM = 64;             // query rows per block
constexpr int BN = 64;             // keys per key/value tile
constexpr int WARPS = 4;           // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: registers, mma.sync and a cp.async ring
// ---------------------------------------------------------------------------
template <int D>
struct Ring {
  static constexpr int RS = row_stride<D>();
  static constexpr int TILE = BM * RS;  // elements of one staged tile
  static constexpr int STAGES = 2;
  // Q, then K and V of each stage, then the key bias of each stage
  static constexpr int k = TILE;
  static constexpr int v = k + STAGES * TILE;
  static constexpr int tiles_bytes = (v + STAGES * TILE) * 2;
  static constexpr int bytes = tiles_bytes + STAGES * BN * 4;
};

// key tile j (keys [k0, k0 + 64)) into ring stage s
template <int D>
__device__ __forceinline__ void load_kv(const Problem& p, const bf16* k,
                                        const bf16* v, const float* bias,
                                        bf16* sring, float* sbias, int k0,
                                        int s) {
  using R = Ring<D>;
  load_rows_async<D, BN, THREADS>(sring + R::k + s * R::TILE, k, p.k_ss, k0,
                                  p.s_kv);
  load_rows_async<D, BN, THREADS>(sring + R::v + s * R::TILE, v, p.v_ss, k0,
                                  p.s_kv);
  if (threadIdx.x < BN) {
    const bool ok = k0 + (int)threadIdx.x < p.s_kv;
    cp_async4(sbias + s * BN + threadIdx.x, bias + (ok ? k0 + threadIdx.x : 0),
              ok ? 4 : 0);
  }
  cp_async_commit();
}

template <int D>
__device__ void attend_tile_bf16(const Problem& p, int heads, int bh, int tile,
                                 float scale, unsigned char* smem) {
  using R = Ring<D>;
  constexpr int RS = R::RS;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  float* sbias = reinterpret_cast<float*>(smem + R::tiles_bytes);

  const int b = bh / heads, h = bh % heads;
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* bias = p.bias + (long long)b * p.s_kv;
  const int q0 = tile * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + warp * 16 + g;  // the thread's rows: row, row + 8
  const int n_tiles = (p.s_kv + BN - 1) / BN;

  load_rows_async<D, BM, THREADS>(sQ, q, p.q_ss, q0, p.s_q);
  load_kv<D>(p, k, v, bias, sQ, sbias, 0, 0);  // commits Q with tile 0

  uint32_t qf[D / 16][4];  // the warp's Q rows as A fragments
  float acc[D / 8][4];     // 16 x D output, unnormalised
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows row, row + 8
  float l[2] = {0.0f, 0.0f};            // this lane's share of the sums

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN, st = j & 1;
    if (j + 1 < n_tiles) {
      load_kv<D>(p, k, v, bias, sQ, sbias, k0 + BN, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                            kk * 16 + (lane >> 4) * 8);
    }
    const bf16* sK = sQ + R::k + st * R::TILE;
    const bf16* sV = sQ + R::v + st * R::TILE;
    const float* sb = sbias + st * BN;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, then add the bias, each rounded (no FMA), as the TPU kernel
    // and the plain version do; keys past s_kv are -inf
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        const float kb = k0 + c < p.s_kv ? sb[c] : -INFINITY;
        s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), kb);
        s[n][2 + e] = __fadd_rn(__fmul_rn(s[n][2 + e], scale), kb);
        mx[0] = fmaxf(mx[0], s[n][e]);
        mx[1] = fmaxf(mx[1], s[n][2 + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));  // finite
      const float alpha = exp_e(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // P = exp(S - m), summed before dropout; the share that meets V after
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = exp_e(s[n][i] - m[i >> 1]);
      l[0] += s[n][0] + s[n][1];
      l[1] += s[n][2] + s[n][3];
      if (p.dropout.enabled) {
        // bit i of the group is accumulator element i
        const uint32_t bits =
            vln_philox::keep_group(p.dropout, stream, row, k0 + n * 8 + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = (bits >> i) & 1u ? s[n][i] * p.dropout.keep_scale : 0.0f;
      }
    }

    // O += P V: P's k-step kk is n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int qi = row + 8 * r;
    if (qi >= p.s_q) continue;
    const float inv = 1.0f / l[r];
    bf16* orow = o + (long long)qi * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.s_q + qi] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// f32 (parity): shared-memory tiles, CUDA cores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int KP = D + 4;   // q/k/v row stride (16 B pad)
  static constexpr int SP = BN + 4;  // score row stride
  static constexpr int OP = D + 4;   // output row stride
  static constexpr int q = 0;
  static constexpr int k = align128(q + BM * KP * 4);
  static constexpr int v = align128(k + BN * KP * 4);
  static constexpr int s = align128(v + BN * KP * 4);
  static constexpr int o = align128(s + BM * SP * 4);
  static constexpr int stats = align128(o + BM * OP * 4);
  static constexpr int bytes = stats + 3 * BM * 4;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// rows [row0, row0 + 64) of a [n, D] f32 matrix into shared memory, zero past n
template <int D>
__device__ void load_tile_f32(float* dst, const float* src, long long stride,
                              int row0, int n) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * Layout<D>::KP + c * 4) = val;
  }
}

template <int D>
__device__ void attend_tile_f32(const Problem& p, int heads, int bh, int tile,
                                float scale, unsigned char* smem) {
  using Lay = Layout<D>;
  float* sQ = reinterpret_cast<float*>(smem + Lay::q);
  float* sK = reinterpret_cast<float*>(smem + Lay::k);
  float* sV = reinterpret_cast<float*>(smem + Lay::v);
  float* sS = reinterpret_cast<float*>(smem + Lay::s);
  float* sO = reinterpret_cast<float*>(smem + Lay::o);
  float* sM = reinterpret_cast<float*>(smem + Lay::stats);  // running max
  float* sL = sM + BM;                                       // running sum
  float* sA = sL + BM;                                       // rescale factor

  const int b = bh / heads, h = bh % heads;
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* bias = p.bias + (long long)b * p.s_kv;
  const int q0 = tile * BM;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first row

  for (int i = lane; i < 16 * D; i += 32) sO[(r0 + i / D) * Lay::OP + i % D] = 0.0f;
  if (lane < 16) {
    sM[r0 + lane] = -INFINITY;
    sL[r0 + lane] = 0.0f;
  }
  load_tile_f32<D>(sQ, q, p.q_ss, q0, p.s_q);

  for (int k0 = 0; k0 < p.s_kv; k0 += BN) {
    __syncthreads();  // the previous tile's K/V are consumed; Q is loaded
    load_tile_f32<D>(sK, k, p.k_ss, k0, p.s_kv);
    load_tile_f32<D>(sV, v, p.v_ss, k0, p.s_kv);
    __syncthreads();
    for (int r = 0; r < 16; ++r) {  // raw scores of the warp's rows
      const float* qr = sQ + (r0 + r) * Lay::KP;
      for (int c = lane; c < BN; c += 32) {
        const float* kr = sK + c * Lay::KP;
        float a = 0.0f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sS[(r0 + r) * Lay::SP + c] = a;
      }
    }
    __syncwarp();

    const int n_valid = min(BN, p.s_kv - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float x[BN / 32];
      float mx = -INFINITY;
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        // scale, then add the bias, each rounded (no FMA)
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
          pe = vln_philox::keep(p.dropout, stream, q0 + row, k0 + c)
                   ? e * p.dropout.keep_scale
                   : 0.0f;
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
    for (int r = 0; r < 16; ++r) {  // sO += P V for the warp's rows
      const float* pr = sS + (r0 + r) * Lay::SP;
      for (int c = lane; c < D; c += 32) {
        float a = sO[(r0 + r) * Lay::OP + c];
        for (int kk = 0; kk < BN; ++kk) a = fmaf(pr[kk], sV[kk * Lay::KP + c], a);
        sO[(r0 + r) * Lay::OP + c] = a;
      }
    }
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int row = r0 + i / D, c = i % D;
    if (q0 + row < p.s_q) o[(q0 + row) * p.o_ss + c] = sO[row * Lay::OP + c] / sL[row];
  }
  if (p.lse != nullptr && lane < 16 && q0 + r0 + lane < p.s_q)
    p.lse[(long long)bh * p.s_q + q0 + r0 + lane] = sM[r0 + lane] + logf(sL[r0 + lane]);
}

// ---------------------------------------------------------------------------
// kernel and launch
// ---------------------------------------------------------------------------
template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

template <typename T, int D>
constexpr int kSmemBytes = kBf16<T> ? Ring<D>::bytes : Layout<D>::bytes;

template <typename T, int D>
__device__ __forceinline__ void attend(const Problem& p, int heads, int bh,
                                       int tile, float scale,
                                       unsigned char* smem) {
  if constexpr (kBf16<T>)
    attend_tile_bf16<D>(p, heads, bh, tile, scale, smem);
  else
    attend_tile_f32<D>(p, heads, bh, tile, scale, smem);
}

// bf16: two blocks per SM (registers capped at 255 a thread)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, kBf16<T> ? 2 : 1)
attention_fwd_kernel(Problem p0, Problem p1, int tiles0, int heads,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // block-uniform branch: the first tiles0 query tiles belong to problem 0
  if ((int)blockIdx.x < tiles0)
    attend<T, D>(p0, heads, blockIdx.y, blockIdx.x, scale, smem);
  else
    attend<T, D>(p1, heads, blockIdx.y, blockIdx.x - tiles0, scale, smem);
}

template <typename T, int D>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<T, D>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
cudaError_t launch(const Problem& p0, const Problem& p1, int batch, int heads,
                   cudaStream_t stream) {
  cudaError_t err = configure<T, D>();
  if (err != cudaSuccess) return err;
  const int tiles0 = (p0.s_q + BM - 1) / BM;
  const int tiles1 = (p1.s_q + BM - 1) / BM;
  const dim3 grid(tiles0 + tiles1, batch * heads);
  attention_fwd_kernel<T, D><<<grid, THREADS, kSmemBytes<T, D>, stream>>>(
      p0, p1, tiles0, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
int blocks_per_sm() {
  int n = -1;
  if (configure<T, D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attention_fwd_kernel<T, D>, THREADS, kSmemBytes<T, D>) != cudaSuccess)
    return -1;
  return n;
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
    err = launch<bf16, 128>(*p0, *p1, batch, heads, s);
  else if (is_bf16 && head_dim == 64)
    err = launch<bf16, 64>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 128)
    err = launch<float, 128>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 64)
    err = launch<float, 64>(*p0, *p1, batch, heads, s);
  return static_cast<int>(err);
}

// Blocks of the kernel instance that fit on one SM (occupancy query), or
// -1 for an instance that does not exist or a failed query.
extern "C" int vln_attention_fwd_blocks_per_sm(int head_dim, int is_bf16) {
  if (is_bf16 && head_dim == 128) return blocks_per_sm<bf16, 128>();
  if (is_bf16 && head_dim == 64) return blocks_per_sm<bf16, 64>();
  if (!is_bf16 && head_dim == 128) return blocks_per_sm<float, 128>();
  if (!is_bf16 && head_dim == 64) return blocks_per_sm<float, 64>();
  return -1;
}

// Dynamic shared memory of one block of the kernel instance in bytes, or
// -1 for an instance that does not exist.
extern "C" int vln_attention_fwd_smem_bytes(int head_dim, int is_bf16) {
  if (is_bf16 && head_dim == 128) return kSmemBytes<bf16, 128>;
  if (is_bf16 && head_dim == 64) return kSmemBytes<bf16, 64>;
  if (!is_bf16 && head_dim == 128) return kSmemBytes<float, 128>;
  if (!is_bf16 && head_dim == 64) return kSmemBytes<float, 64>;
  return -1;
}
