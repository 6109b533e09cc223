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
//   2. dK/dV pass: one block per (b*h, 64-key tile) walks every 64-row
//      query tile, recomputes S and P = exp(S - LSE) from the forward's row
//      statistic, replays the mask, and accumulates dV and dK for its keys;
//   3. dQ pass: one block per (b*h, 64-row query tile) walks every key tile
//      and accumulates dQ.
// Passes 2 and 3 share one launch: the grid's x axis holds the key tiles
// of problem 0 and 1, then the query tiles of problem 0 and 1 (B3 passes
// an empty problem 1, B4 runs both directions).  Each block owns the rows
// it writes, so no two blocks write one element.  The split recomputes S
// and dO V^T in both passes (7 products where 5 would do) and buys
// determinism without float atomics.
//
// The bf16 instances (the main path) run every product on the tensor
// cores with mma.sync.m16n8k16 (mma.cuh) and keep every product in
// registers; no accumulator passes through shared memory:
//   * dK/dV pass, 4 warps x 16 keys: K and V stay in shared memory for the
//     block's life; Q, dO, LSE and Delta of the query tiles come through a
//     2-stage cp.async ring.  Each warp computes the TRANSPOSED tiles
//     S^T = K Q^T and (dO V^T)^T = V dO^T, 16 queries at a time, so P~^T
//     and dS^T are born in the accumulator layout that is the A operand of
//     dV += P~^T dO and dK += dS^T Q: no staging of P~ or dS.  dV and dK
//     (2 x 16 x D f32 per warp) accumulate in registers and are written
//     once.
//   * The transposed pass draws the same Philox groups as the forward
//     (rows {i, i + 8} x keys {2c, 2c + 1}, philox.cuh): ldmatrix takes
//     one row address per lane, so the warp's 16 key rows are read in the
//     order 0, 2, .., 14, 1, 3, .., 15 and each 16-query block in the
//     order 0, 8, 1, 9, .., 7, 15.  A thread then holds keys {2c, 2c + 1}
//     x queries {i, i + 8}: one Philox call per 4 entries.  The B operands
//     of dV and dK (dO and Q through ldmatrix.trans) take the same query
//     order.
//   * dQ pass, 4 warps x 16 query rows: Q and dO stay in shared memory; K,
//     V and the key bias come through a 2-stage cp.async ring; S and dO V^T
//     in the forward's layout (one Philox call per fragment), dS into the
//     A fragments of dQ += dS K, dQ in registers.
//   * shared memory: 6 tiles of 64 rows at a 16-byte padded row stride
//     plus 2 x 128 floats = 105,472 B at D = 128 (56,320 B at D = 64), so
//     two blocks fit on an SM (__launch_bounds__(128, 2), at most 255
//     registers a thread).
// ptxas -v (sm_90a, CUDA 12.8): 251 registers a thread at D = 128 (227 at
// D = 64), no stack and no spills (dK and dV alone hold 128 f32 a thread
// at D = 128); the occupancy query (vln_attention_bwd_blocks_per_sm)
// reports 2 blocks, 8 warps, per SM at both head dims.  delta_kernel: 26
// registers.
// Left for later: wgmma, TMA loads with mbarriers, warp specialisation.
//
// The f32 instances are the parity route, off the main path: they stage
// every tile, S, dP and the accumulators in shared memory and multiply on
// the CUDA cores in full f32 (one block per SM), drawing the same mask one
// entry at a time.
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
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "philox.cuh"

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

using bf16 = __nv_bfloat16;
using namespace vln_mma;

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QC = 16;  // queries per register step of the dK/dV pass
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: registers, mma.sync and cp.async rings
// ---------------------------------------------------------------------------
template <int D>
struct Ring {
  static constexpr int RS = row_stride<D>();
  static constexpr int TILE = BM * RS;  // elements of one staged tile
  // tiles 0, 1: the resident pair (dK/dV pass: K, V; dQ pass: Q, dO);
  // tiles 2 + s, 4 + s: stage s of the streamed pair (Q, dO; K, V)
  static constexpr int tiles_bytes = 6 * TILE * 2;
  // per stage 128 floats: LSE and Delta of a query tile (dK/dV pass) or
  // the key bias of a key tile (dQ pass)
  static constexpr int bytes = tiles_bytes + 2 * 128 * 4;
};

// the query row a lane's ldmatrix address reads at position p of a
// 16-query block of the dK/dV pass: 0, 8, 1, 9, .., 7, 15, so that
// accumulator columns {2t, 2t + 1} of n-tile n hold queries 4n + t and
// 4n + t + 8
__device__ __forceinline__ int query_order(int p) {
  return 8 * (p & 1) + 4 * (p >> 3) + ((p >> 1) & 3);
}

template <int D>
__device__ void dkdv_tile_bf16(const BwdProblem& p, int heads, int bh, int tile,
                               float scale, unsigned char* smem) {
  using R = Ring<D>;
  constexpr int RS = R::RS, TILE = R::TILE;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sK + 2 * TILE;   // stage s at sQ + s * TILE
  bf16* sDO = sK + 4 * TILE;  // stage s at sDO + s * TILE
  float* sstat = reinterpret_cast<float*>(smem + R::tiles_bytes);

  const int b = bh / heads, h = bh % heads;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + (long long)bh * p.s_q;
  const float* delta = p.delta + (long long)bh * p.s_q;
  const int k0 = tile * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // accumulator rows g and g + 8 hold keys key and key + 1
  const int key = k0 + warp * 16 + 2 * g;
  const float* bias = p.bias + (long long)b * p.s_kv;
  const float kb[2] = {key < p.s_kv ? bias[key] : -INFINITY,
                       key + 1 < p.s_kv ? bias[key + 1] : -INFINITY};
  const int n_tiles = (p.s_q + BM - 1) / BM;

  // ldmatrix rows of this lane: A (K, V) in the permuted key order, B (Q,
  // dO) in the permuted query order, plain and transposed
  const int a_row = warp * 16 + 2 * (lane & 7) + ((lane >> 3) & 1);
  const int a_col = (lane >> 4) * 8;
  const int b_row = query_order((lane & 7) + (lane >> 4) * 8);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int bt_row = query_order((lane & 7) + ((lane >> 3) & 1) * 8);
  const int bt_col = (lane >> 4) * 8;

  auto load_queries = [&](int q0, int s) {
    load_rows_async<D, BM, THREADS>(sQ + s * TILE, q, p.q_ss, q0, p.s_q);
    load_rows_async<D, BM, THREADS>(sDO + s * TILE, dout, p.do_ss, q0, p.s_q);
    const int i = threadIdx.x % BM;
    const bool ok = q0 + i < p.s_q;
    cp_async4(sstat + s * 128 + threadIdx.x,
              (threadIdx.x < BM ? lse : delta) + (ok ? q0 + i : 0), ok ? 4 : 0);
    cp_async_commit();
  };

  load_rows_async<D, BN, THREADS>(sK, k, p.k_ss, k0, p.s_kv);
  load_rows_async<D, BN, THREADS>(sV, v, p.v_ss, k0, p.s_kv);
  load_queries(0, 0);  // commits K and V with query tile 0

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * BM, st = j & 1;
    if (j + 1 < n_tiles) {
      load_queries(q0 + BM, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs = sQ + st * TILE;
    const bf16* DOs = sDO + st * TILE;
    const float* lse_s = sstat + st * 128;
    const float* delta_s = lse_s + BM;

#pragma unroll 1
    for (int half = 0; half < BM / QC; ++half) {
      // S^T = K Q^T and (dO V^T)^T = V dO^T: 16 keys x QC queries
      float sT[QC / 8][4], dpT[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sT[n][i] = dpT[n][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + a_row * RS + kk * 16 + a_col);
        ldsm_x4(va, sV + a_row * RS + kk * 16 + a_col);
#pragma unroll
        for (int nb = 0; nb < QC / 16; ++nb) {
          const int r = half * QC + nb * 16 + b_row;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, Qs + r * RS + kk * 16 + b_col);
          ldsm_x4(ob, DOs + r * RS + kk * 16 + b_col);
          mma_bf16(sT[2 * nb], ka, qb[0], qb[1]);
          mma_bf16(sT[2 * nb + 1], ka, qb[2], qb[3]);
          mma_bf16(dpT[2 * nb], va, ob[0], ob[1]);
          mma_bf16(dpT[2 * nb + 1], va, ob[2], ob[3]);
        }
      }

      // element i of n-tile n: key + (i >> 1), query qa + 8 (i & 1)
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        const int qi = half * QC + (n >> 1) * 16 + 4 * (n & 1) + t;  // in the tile
        const int qa = q0 + qi;
        uint32_t bits = 0xFu;
        if (p.dropout.enabled) {
          // group bits (query, key): 0 (qa, key), 1 (qa, key + 1),
          // 2 (qa + 8, key), 3 (qa + 8, key + 1) -> element order
          const uint32_t gb = vln_philox::keep_group(p.dropout, bh, qa, key);
          bits = (gb & 9u) | ((gb & 2u) << 1) | ((gb & 4u) >> 1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          // scale, then add the bias, each rounded (no FMA), as the forward
          const float s = __fadd_rn(__fmul_rn(sT[n][i], scale), kb[i >> 1]);
          const float pr = qa + 8 * e < p.s_q ? exp_e(s - lse_s[qi + 8 * e]) : 0.0f;
          float pt = pr, dp = dpT[n][i];
          if (p.dropout.enabled) {
            const bool kept = (bits >> i) & 1u;
            pt = kept ? pr * p.dropout.keep_scale : 0.0f;
            dp = kept ? dp * p.dropout.keep_scale : 0.0f;
          }
          sT[n][i] = pt;
          dpT[n][i] = pr * (dp - delta_s[qi + 8 * e]) * scale;
        }
      }

      // dV += P~^T dO and dK += dS^T Q; k-step nb is n-tiles 2nb, 2nb + 1
#pragma unroll
      for (int nb = 0; nb < QC / 16; ++nb) {
        const uint32_t pa[4] = {pack_bf16(sT[2 * nb][0], sT[2 * nb][1]),
                                pack_bf16(sT[2 * nb][2], sT[2 * nb][3]),
                                pack_bf16(sT[2 * nb + 1][0], sT[2 * nb + 1][1]),
                                pack_bf16(sT[2 * nb + 1][2], sT[2 * nb + 1][3])};
        const uint32_t da[4] = {pack_bf16(dpT[2 * nb][0], dpT[2 * nb][1]),
                                pack_bf16(dpT[2 * nb][2], dpT[2 * nb][3]),
                                pack_bf16(dpT[2 * nb + 1][0], dpT[2 * nb + 1][1]),
                                pack_bf16(dpT[2 * nb + 1][2], dpT[2 * nb + 1][3])};
        const int r = half * QC + nb * 16 + bt_row;
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, DOs + r * RS + dp * 16 + bt_col);
          ldsm_x4_t(qb, Qs + r * RS + dp * 16 + bt_col);
          mma_bf16(dv[2 * dp], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * dp + 1], pa, ob[2], ob[3]);
          mma_bf16(dk[2 * dp], da, qb[0], qb[1]);
          mma_bf16(dk[2 * dp + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh + 2 * t;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key + r >= p.s_kv) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (key + r) * p.dk_ss + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (key + r) * p.dv_ss + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
__device__ void dq_tile_bf16(const BwdProblem& p, int heads, int bh, int tile,
                             float scale, unsigned char* smem) {
  using R = Ring<D>;
  constexpr int RS = R::RS, TILE = R::TILE;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + TILE;
  bf16* sK = sQ + 2 * TILE;  // stage s at sK + s * TILE
  bf16* sV = sQ + 4 * TILE;  // stage s at sV + s * TILE
  float* sbias = reinterpret_cast<float*>(smem + R::tiles_bytes);

  const int b = bh / heads, h = bh % heads;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias = p.bias + (long long)b * p.s_kv;
  const int q0 = tile * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + warp * 16 + g;  // the thread's rows: row, row + 8
  const int n_tiles = (p.s_kv + BN - 1) / BN;
  float lse[2], delta[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = row + 8 * r < p.s_q;
    const long long at = (long long)bh * p.s_q + (ok[r] ? row + 8 * r : 0);
    lse[r] = p.lse[at];
    delta[r] = p.delta[at];
  }

  auto load_keys = [&](int k0, int s) {
    load_rows_async<D, BN, THREADS>(sK + s * TILE, k, p.k_ss, k0, p.s_kv);
    load_rows_async<D, BN, THREADS>(sV + s * TILE, v, p.v_ss, k0, p.s_kv);
    if (threadIdx.x < BN) {
      const bool in = k0 + (int)threadIdx.x < p.s_kv;
      cp_async4(sbias + s * 128 + threadIdx.x, bias + (in ? k0 + threadIdx.x : 0),
                in ? 4 : 0);
    }
    cp_async_commit();
  };

  load_rows_async<D, BM, THREADS>(sQ, q, p.q_ss, q0, p.s_q);
  load_rows_async<D, BM, THREADS>(sDO, dout, p.do_ss, q0, p.s_q);
  load_keys(0, 0);  // commits Q and dO with key tile 0

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN, st = j & 1;
    if (j + 1 < n_tiles) {
      load_keys(k0 + BN, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sK + st * TILE;
    const bf16* Vs = sV + st * TILE;
    const float* sb = sbias + st * 128;

    // S = Q K^T and dO V^T for the warp's 16 rows x 64 keys
    float s[BN / 8][4], dpr[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dpr[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, sQ + a_row * RS + kk * 16 + a_col);
      ldsm_x4(oa, sDO + a_row * RS + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, Ks + r * RS + c);
        ldsm_x4(vf, Vs + r * RS + c);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dpr[2 * np], oa, vf[0], vf[1]);
        mma_bf16(dpr[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    // dS into s; element i of n-tile n: row + 8 (i >> 1), key c + (i & 1)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const uint32_t bits =
          p.dropout.enabled ? vln_philox::keep_group(p.dropout, bh, row, k0 + c) : 0xFu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, e = i & 1;
        const float kb = k0 + c + e < p.s_kv ? sb[c + e] : -INFINITY;
        const float sc = __fadd_rn(__fmul_rn(s[n][i], scale), kb);
        const float pr = ok[r] ? exp_e(sc - lse[r]) : 0.0f;
        float dp = dpr[n][i];
        if (p.dropout.enabled)
          dp = (bits >> i) & 1u ? dp * p.dropout.keep_scale : 0.0f;
        s[n][i] = pr * (dp - delta[r]) * scale;
      }
    }

    // dQ += dS K: dS's k-step kk is n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t kf[4];
        ldsm_x4_t(kf, Ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * dp], da, kf[0], kf[1]);
        mma_bf16(dq[2 * dp + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqp + (row + 8 * r) * p.dq_ss + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32 (parity): shared-memory tiles, CUDA cores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Layout {
  // rows are unpadded to fit the f32 instance in one SM
  static constexpr int KP = D;       // staged row stride
  static constexpr int SP = BN + 1;  // S / dP row stride
  static constexpr int AP = D;       // accumulator stride
  static constexpr int tile = BM * KP * 4;
  static constexpr int q = 0;
  static constexpr int dout = align128(q + tile);
  static constexpr int k = align128(dout + tile);
  static constexpr int v = align128(k + tile);
  static constexpr int s = align128(v + tile);
  static constexpr int dp = align128(s + BM * SP * 4);
  static constexpr int acc0 = align128(dp + BM * SP * 4);
  static constexpr int acc1 = align128(acc0 + BM * AP * 4);
  static constexpr int stats = align128(acc1 + BM * AP * 4);
  static constexpr int bytes = stats + 2 * BM * 4;
  static_assert(bytes <= 232448, "shared memory of one H100 block");
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// rows [row0, row0 + 64) of a [n, D] f32 matrix into shared memory (row
// stride D), zero past n
template <int D>
__device__ void load_tile_f32(float* dst, const float* src, long long stride,
                              int row0, int n) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * D + c * 4) = val;
  }
}

// One warp's 16-row strip of a product: C[16 x N] (= or +=) A[16 x K] B[K x N].
// A(r, k) is A[r * lda + k] when A_ROW, else A[k * lda + r]; B(k, n) is
// B[k * ldb + n] when B_ROW, else B[n * ldb + k].  C is f32 in shared memory.
template <int N, int K, bool ACC, bool A_ROW, bool B_ROW>
__device__ void strip_mm(float* C, int ldc, const float* A, int lda,
                         const float* B, int ldb, int lane) {
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

// P~ over sS and dS over sdP for the warp's 16 query rows of the [64 x 64]
// tile at (q0, k0), from the raw scores in sS and dO V^T in sdP
template <int D>
__device__ void probs_and_grads(const BwdProblem& p, int bh, int heads, int q0,
                                int k0, float scale, float* sS, float* sdP,
                                const float* sLse, const float* sDelta, int r0,
                                int lane) {
  using Lay = Layout<D>;
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
      sS[row * Lay::SP + c] = pt;
      sdP[row * Lay::SP + c] = ds;
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

template <int D>
struct Smem {
  float *q, *dout, *k, *v, *s, *dp, *acc0, *acc1, *lse, *delta;
  __device__ explicit Smem(unsigned char* smem) {
    using Lay = Layout<D>;
    q = reinterpret_cast<float*>(smem + Lay::q);
    dout = reinterpret_cast<float*>(smem + Lay::dout);
    k = reinterpret_cast<float*>(smem + Lay::k);
    v = reinterpret_cast<float*>(smem + Lay::v);
    s = reinterpret_cast<float*>(smem + Lay::s);
    dp = reinterpret_cast<float*>(smem + Lay::dp);
    acc0 = reinterpret_cast<float*>(smem + Lay::acc0);
    acc1 = reinterpret_cast<float*>(smem + Lay::acc1);
    lse = reinterpret_cast<float*>(smem + Lay::stats);
    delta = lse + BM;
  }
};

// zero a [64, D] f32 accumulator
template <int D>
__device__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS) acc[i] = 0.0f;
}

// rows [row0, row0 + 64) of an accumulator to a strided [n, D] output
template <int D>
__device__ void store_acc(float* dst, long long stride, const float* acc,
                          int row0, int n) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D, c = i % D;
    if (row0 + r < n) dst[(row0 + r) * stride + c] = acc[r * Layout<D>::AP + c];
  }
}

// key-tile-major pass: dK and dV of keys [k0, k0 + 64)
template <int D>
__device__ void dkdv_tile_f32(const BwdProblem& p, int heads, int bh, int tile,
                              float scale, unsigned char* smem) {
  using Lay = Layout<D>;
  const Smem<D> sm(smem);
  const int b = bh / heads, h = bh % heads;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int k0 = tile * BN;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows

  zero_acc<D>(sm.acc0);  // dK
  zero_acc<D>(sm.acc1);  // dV
  load_tile_f32<D>(sm.k, k, p.k_ss, k0, p.s_kv);
  load_tile_f32<D>(sm.v, v, p.v_ss, k0, p.s_kv);
  for (int q0 = 0; q0 < p.s_q; q0 += BM) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_f32<D>(sm.q, q, p.q_ss, q0, p.s_q);
    load_tile_f32<D>(sm.dout, dout, p.do_ss, q0, p.s_q);
    load_stats(p, bh, q0, sm.lse, sm.delta);
    __syncthreads();
    // S = Q K^T and dO V^T for the warp's query rows
    strip_mm<BN, D, false, true, false>(sm.s + r0 * Lay::SP, Lay::SP,
                                        sm.q + r0 * Lay::KP, Lay::KP, sm.k,
                                        Lay::KP, lane);
    strip_mm<BN, D, false, true, false>(sm.dp + r0 * Lay::SP, Lay::SP,
                                        sm.dout + r0 * Lay::KP, Lay::KP, sm.v,
                                        Lay::KP, lane);
    __syncwarp();
    probs_and_grads<D>(p, bh, heads, q0, k0, scale, sm.s, sm.dp, sm.lse,
                       sm.delta, r0, lane);
    __syncthreads();  // every query row of P~ and dS is ready
    // dV += P~^T dO and dK += dS^T Q for the warp's key rows
    strip_mm<D, BM, true, false, true>(sm.acc1 + r0 * Lay::AP, Lay::AP,
                                       sm.s + r0, Lay::SP, sm.dout, Lay::KP,
                                       lane);
    strip_mm<D, BM, true, false, true>(sm.acc0 + r0 * Lay::AP, Lay::AP,
                                       sm.dp + r0, Lay::SP, sm.q, Lay::KP,
                                       lane);
  }
  __syncthreads();
  store_acc<D>(static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss,
               sm.acc0, k0, p.s_kv);
  store_acc<D>(static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss,
               sm.acc1, k0, p.s_kv);
}

// query-tile-major pass: dQ of query rows [q0, q0 + 64)
template <int D>
__device__ void dq_tile_f32(const BwdProblem& p, int heads, int bh, int tile,
                            float scale, unsigned char* smem) {
  using Lay = Layout<D>;
  const Smem<D> sm(smem);
  const int b = bh / heads, h = bh % heads;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int q0 = tile * BM;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;

  zero_acc<D>(sm.acc0);  // dQ
  load_tile_f32<D>(sm.q, q, p.q_ss, q0, p.s_q);
  load_tile_f32<D>(sm.dout, dout, p.do_ss, q0, p.s_q);
  load_stats(p, bh, q0, sm.lse, sm.delta);
  for (int k0 = 0; k0 < p.s_kv; k0 += BN) {
    __syncthreads();  // the previous key tile is consumed
    load_tile_f32<D>(sm.k, k, p.k_ss, k0, p.s_kv);
    load_tile_f32<D>(sm.v, v, p.v_ss, k0, p.s_kv);
    __syncthreads();
    strip_mm<BN, D, false, true, false>(sm.s + r0 * Lay::SP, Lay::SP,
                                        sm.q + r0 * Lay::KP, Lay::KP, sm.k,
                                        Lay::KP, lane);
    strip_mm<BN, D, false, true, false>(sm.dp + r0 * Lay::SP, Lay::SP,
                                        sm.dout + r0 * Lay::KP, Lay::KP, sm.v,
                                        Lay::KP, lane);
    __syncwarp();
    probs_and_grads<D>(p, bh, heads, q0, k0, scale, sm.s, sm.dp, sm.lse,
                       sm.delta, r0, lane);
    __syncwarp();
    // dQ += dS K for the warp's query rows
    strip_mm<D, BN, true, true, true>(sm.acc0 + r0 * Lay::AP, Lay::AP,
                                      sm.dp + r0 * Lay::SP, Lay::SP, sm.k,
                                      Lay::KP, lane);
  }
  __syncthreads();
  store_acc<D>(static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss,
               sm.acc0, q0, p.s_q);
}

// ---------------------------------------------------------------------------
// kernels and launch
// ---------------------------------------------------------------------------
__host__ __device__ inline int tiles(int n, int t) { return (n + t - 1) / t; }

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

template <typename T, int D>
constexpr int kSmemBytes = kBf16<T> ? Ring<D>::bytes : Layout<D>::bytes;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 x) { return __bfloat162float(x); }

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
__device__ __forceinline__ void dkdv(const BwdProblem& p, int heads, int bh,
                                     int tile, float scale, unsigned char* smem) {
  if constexpr (kBf16<T>)
    dkdv_tile_bf16<D>(p, heads, bh, tile, scale, smem);
  else
    dkdv_tile_f32<D>(p, heads, bh, tile, scale, smem);
}

template <typename T, int D>
__device__ __forceinline__ void dq(const BwdProblem& p, int heads, int bh,
                                   int tile, float scale, unsigned char* smem) {
  if constexpr (kBf16<T>)
    dq_tile_bf16<D>(p, heads, bh, tile, scale, smem);
  else
    dq_tile_f32<D>(p, heads, bh, tile, scale, smem);
}

// bf16: two blocks per SM (registers capped at 255 a thread)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, kBf16<T> ? 2 : 1)
attention_bwd_kernel(BwdProblem p0, BwdProblem p1, int kv0, int kv1, int qt0,
                     int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // block-uniform branches: key tiles of p0, p1, then query tiles of p0, p1
  const int x = blockIdx.x, bh = blockIdx.y;
  if (x < kv0)
    dkdv<T, D>(p0, heads, bh, x, scale, smem);
  else if (x < kv0 + kv1)
    dkdv<T, D>(p1, heads, bh, x - kv0, scale, smem);
  else if (x < kv0 + kv1 + qt0)
    dq<T, D>(p0, heads, bh, x - kv0 - kv1, scale, smem);
  else
    dq<T, D>(p1, heads, bh, x - kv0 - kv1 - qt0, scale, smem);
}

template <typename T, int D>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<T, D>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(attention_bwd_kernel<T, D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
cudaError_t launch(const BwdProblem& p0, const BwdProblem& p1, int batch,
                   int heads, cudaStream_t stream) {
  const int groups0 = tiles(p0.s_q, WARPS), groups1 = tiles(p1.s_q, WARPS);
  delta_kernel<T, D><<<dim3(groups0 + groups1, batch * heads), THREADS, 0,
                       stream>>>(p0, p1, groups0, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = configure<T, D>();
  if (err != cudaSuccess) return err;
  // an empty problem 1 (s_q = s_kv = 0) adds no tiles
  const int kv0 = tiles(p0.s_kv, BN), kv1 = p1.s_q > 0 ? tiles(p1.s_kv, BN) : 0;
  const int qt0 = tiles(p0.s_q, BM), qt1 = tiles(p1.s_q, BM);
  const dim3 grid(kv0 + kv1 + qt0 + qt1, batch * heads);
  attention_bwd_kernel<T, D><<<grid, THREADS, kSmemBytes<T, D>, stream>>>(
      p0, p1, kv0, kv1, qt0, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
int blocks_per_sm() {
  int n = -1;
  if (configure<T, D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attention_bwd_kernel<T, D>, THREADS, kSmemBytes<T, D>) != cudaSuccess)
    return -1;
  return n;
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
    err = launch<bf16, 128>(*p0, *p1, batch, heads, s);
  else if (is_bf16 && head_dim == 64)
    err = launch<bf16, 64>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 128)
    err = launch<float, 128>(*p0, *p1, batch, heads, s);
  else if (!is_bf16 && head_dim == 64)
    err = launch<float, 64>(*p0, *p1, batch, heads, s);
  return static_cast<int>(err);
}

// Blocks of the backward kernel instance that fit on one SM (occupancy
// query), or -1 for an instance that does not exist or a failed query.
extern "C" int vln_attention_bwd_blocks_per_sm(int head_dim, int is_bf16) {
  if (is_bf16 && head_dim == 128) return blocks_per_sm<bf16, 128>();
  if (is_bf16 && head_dim == 64) return blocks_per_sm<bf16, 64>();
  if (!is_bf16 && head_dim == 128) return blocks_per_sm<float, 128>();
  if (!is_bf16 && head_dim == 64) return blocks_per_sm<float, 64>();
  return -1;
}

// Dynamic shared memory of one block of the backward kernel instance in
// bytes, or -1 for an instance that does not exist.
extern "C" int vln_attention_bwd_smem_bytes(int head_dim, int is_bf16) {
  if (is_bf16 && head_dim == 128) return kSmemBytes<bf16, 128>;
  if (is_bf16 && head_dim == 64) return kSmemBytes<bf16, 64>;
  if (!is_bf16 && head_dim == 128) return kSmemBytes<float, 128>;
  if (!is_bf16 && head_dim == 64) return kSmemBytes<float, 64>;
  return -1;
}
