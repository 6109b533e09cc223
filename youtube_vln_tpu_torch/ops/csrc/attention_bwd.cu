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
// Three routes, chosen by the caller from the shapes it sees
// (ops/attention.py bwd_route); each call is one delta_kernel launch and
// one attention_bwd_kernel launch.  All are deterministic: no float
// atomics, every sum in a fixed order.
//
// The wgmma route (bf16, D = 128, every problem with at least 128
// queries or keys: B3 at 808 x 808 and B4 at 60 <-> 808 on the main path;
// on an H100 80GB HBM3 at the fine-tuning shape, 2.90 ms and 1.26 ms
// against the two-pass route's 7.35 and 1.65).  One key-major pass,
// written for Hopper:
//   * delta_kernel computes Delta per query row and writes LSE and Delta
//     per 64-row query tile into ``stats`` (padded with +inf and 0, so
//     rows past s_q come out P = dS = 0), and zeroes the dQ counters;
//   * attention_bwd_kernel<128>: a block of 384 threads per (b*h, 128-key
//     tile).  Warpgroup 0 drops to 24 registers (setmaxnreg): one thread
//     streams Q and dO (TMA, 128-byte swizzle, two 64-column boxes each)
//     and LSE / Delta (a bulk copy) through a 2-stage mbarrier ring, one
//     thread sums dQ.  Warpgroups 1 and 2 (240 registers) own 64 keys
//     each; K and V stay in shared memory, in a row order that puts a
//     Philox group's key pair on a lane's two accumulator rows.  Per query
//     tile a consumer runs S^T = K Q^T and (dO V^T)^T = V dO^T (wgmma
//     m64n64k16, both operands from shared memory), draws the tile's keep
//     bits while they run (one Philox call per 4 entries, the forward's
//     groups; the only place the mask is drawn), forms P, P~ and dS in
//     registers, writes dS^T to shared memory, then dV += P~^T dO and
//     dK += dS^T Q (m64n128k16, A from registers, B MN-major) and its half
//     of dQ = dS K over the block's 128 keys (m64n64k16, both operands
//     MN-major): 5 products, dK and dV in registers until the end.
//   * dQ is summed over the key tiles in key-tile order, without atomics'
//     run-to-run order: per (b*h, query tile) a counter says how many key
//     tiles have added.  The consumers hand their f32 part to the dQ
//     thread through shared memory; it waits until the counter equals its
//     key tile, then stores (tile 0) or adds (a bulk f32 reduce) the part
//     into the sum in ``dq_acc``, waits for the writes and counts its
//     tile.  The last key tile's consumers add the sum to their part and
//     write dQ in bf16.  A block only waits on the block before it in the
//     grid, which the hardware schedules first.
//   Bound: operations.  What it does about them: the products run
//   asynchronously beside the exp, mask and Philox work; no global loads
//   in the consumers' loop; 5 products, not 7, and one draw of each mask
//   bit.  ptxas -v (sm_90a, CUDA 12.8): 168 registers at launch
//   (setmaxnreg moves them), no stack, no spills; one block of 384
//   threads per SM (198,704 B of shared memory).
//
// The two-pass route (bf16 otherwise: D = 64, or short on both sides),
// flash-attention-2 style.  The TPU kernel keeps a whole S_q x
// S_kv tile in VMEM; an SM has 227 KB, so:
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
// and dO V^T in both passes (7 products where 5 would do).
//
// The two-pass bf16 instances run every product on the tensor cores with
// mma.sync.m16n8k16 (mma.cuh) and keep every product in registers; no
// accumulator passes through shared memory:
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
// ptxas -v (sm_90a, CUDA 12.8): 255 registers a thread at D = 128 (214 at
// D = 64), no stack and no spills (dK and dV alone hold 128 f32 a thread
// at D = 128); the occupancy query (vln_attention_bwd_blocks_per_sm)
// reports 2 blocks, 8 warps, per SM at both head dims.  delta_kernel: 28
// registers.
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
// the gradients and the scratch (Delta, or the wgmma route's stats, dQ sum
// and counters); the kernels allocate nothing and launch on the caller's
// stream.  The wgmma route encodes its tensor maps on the host at each
// call (cuTensorMapEncodeTiled, reached through the runtime).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
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
  // scratch of the wgmma route (null on the others), per (b*h, 64-row
  // query tile): LSE then Delta, 64 f32 each, padded past s_q with +inf
  // and 0; the f32 sum of dQ over the key tiles so far (64 x 128); the
  // number of key tiles in that sum
  float* stats;
  float* dq_acc;
  unsigned* dq_ready;
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
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
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
          const uint32_t gb = vln_philox::keep_group(p.dropout, stream, qa, key);
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
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
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
          p.dropout.enabled ? vln_philox::keep_group(p.dropout, stream, row, k0 + c) : 0xFu;
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
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
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
          const bool kept = vln_philox::keep(p.dropout, stream, q0 + row, k0 + c);
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
// holds the row groups of problem 0, then those of problem 1.  On the
// wgmma route (p.stats set) it covers the padded rows of every 64-row
// query tile: it writes the tile's LSE and Delta into p.stats, pads them,
// and zeroes the tile's dq_ready counters.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(BwdProblem p0, BwdProblem p1, int groups0, int heads) {
  const bool first = (int)blockIdx.x < groups0;
  const BwdProblem& p = first ? p0 : p1;
  const int group = first ? blockIdx.x : blockIdx.x - groups0;
  const int row = group * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_rows = p.stats ? tiles(p.s_q, BM) * BM : p.s_q;
  if (row >= n_rows) return;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  float acc = 0.0f;
  if (row < p.s_q) {
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
                    row * p.do_ss;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(to_float(dout[c]), to_float(o[c]), acc);
    acc = warp_sum(acc);
  }
  if (lane != 0) return;
  if (!p.stats) {
    p.delta[(long long)bh * p.s_q + row] = acc;
    return;
  }
  const long long tile = (long long)bh * tiles(p.s_q, BM) + row / BM;
  float* st = p.stats + tile * 2 * BM;
  st[row % BM] = row < p.s_q ? p.lse[(long long)bh * p.s_q + row] : INFINITY;
  st[BM + row % BM] = acc;
  if (row % BM == 0) p.dq_ready[tile] = 0;
}

// ---------------------------------------------------------------------------
// bf16 at D = 128, the wgmma route: one key-major pass, warp-specialised
// ---------------------------------------------------------------------------
namespace wg {

constexpr int D = 128;
constexpr int QT = BM;             // query rows a tile
constexpr int KT = 128;            // keys a block, 64 a consumer warpgroup
constexpr int STAGES = 2;          // query tiles in flight
constexpr int THREADS = 384;       // the producer warpgroup, then two consumers
constexpr int HALF = 64 * 128;     // bytes of 64 rows x 64 bf16: one swizzle atom wide
constexpr int TILE = 2 * HALF;     // 64 rows x D bf16, as two halves of 64 columns
constexpr int STAT = 2 * QT * 4;   // LSE and Delta of a query tile
constexpr int TX = 2 * TILE + STAT;  // bytes that complete a stage
constexpr int DQ = QT * D * 4;     // a query tile's f32 dQ part
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int k = 0;                      // [warpgroup][TILE], rows permuted
  static constexpr int v = k + 2 * TILE;           // the same
  static constexpr int q = v + 2 * TILE;           // [stage][TILE]
  static constexpr int dout = q + STAGES * TILE;   // [stage][TILE]
  static constexpr int ds = dout + STAGES * TILE;  // [2][128 keys x 64 queries]
  static constexpr int dq = ds + 2 * TILE;         // f32 [warpgroup][8][128 lanes][4]
  static constexpr int stats = dq + DQ;            // [stage][STAT]
  static constexpr int full = stats + STAGES * STAT;     // mbarriers, [stage]
  static constexpr int empty = full + STAGES * 8;        // [stage]
  static constexpr int dq_full = empty + STAGES * 8;
  static constexpr int dq_empty = dq_full + 8;
  static constexpr int bytes = dq_empty + 8 + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "shared memory of one H100 block");
};

// byte offset of 16-byte chunk ``chunk`` of row ``row`` in a 128-byte
// swizzled tile
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// the key (of a warpgroup's 64) that row r of its K and V tiles holds: each
// 16-row block holds keys 0, 2, .., 14, then 1, 3, .., 15, so accumulator
// rows g and g + 8 of a lane hold keys 2g and 2g + 1, one Philox group's
// pair (philox.cuh)
__device__ __forceinline__ int row_key(int r) {
  return (r & ~15) + 2 * (r & 7) + ((r >> 3) & 1);
}

// the warpgroup's 64 rows of K or V from key k0 into a swizzled tile in
// row_key order (cp.async by its 128 threads), zero past n
__device__ __forceinline__ void load_keys(unsigned char* dst, const bf16* src,
                                          long long stride, int k0, int n) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int c = tid + it * 128;  // 64 rows x 16 chunks of 16 bytes
    const int r = c >> 4, half = (c >> 3) & 1, chunk = c & 7;
    const int key = k0 + row_key(r);
    const bool ok = key < n;
    cp_async16(dst + half * HALF + sw128(r, chunk),
               src + (ok ? (long long)key * stride : 0LL) + half * 64 + chunk * 8,
               ok ? 16 : 0);
  }
}

// keep bits of a lane's 32 elements of the S^T accumulator at query tile
// q0: bit n for element n, whose rows hold keys key, key + 1 and whose
// columns queries q0 + 8 (n >> 2) + 2t + (n & 1).  The group of (m, e)
// holds queries i = q0 + 16m + 2t + e and i + 8: its bit k lands on
// element 8m + e + 2k.
__device__ __forceinline__ uint32_t keep_bits(const vln_philox::Dropout& d,
                                              uint32_t stream, int q0, int key,
                                              int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t gb = vln_philox::keep_group(d, stream, q0 + 16 * m + 2 * t + e, key);
      bits |= ((gb & 1u) | ((gb & 2u) << 1) | ((gb & 4u) << 2) | ((gb & 8u) << 3))
              << (8 * m + e);
    }
  return bits;
}

// One thread streams the query tiles of (b, h) through the ring: Q and dO
// by TMA (two 64-column boxes each), LSE and Delta by a bulk copy.
__device__ void producer(const BwdProblem& p, const CUtensorMap* mq,
                         const CUtensorMap* mdo, int heads, int bh,
                         unsigned char* smem, uint64_t* full, uint64_t* empty) {
  using namespace vln_hopper;
  const int b = bh / heads, h = bh % heads, n_qt = tiles(p.s_q, QT);
  prefetch_map(mq);
  prefetch_map(mdo);
  const float* stats = p.stats + (long long)bh * n_qt * 2 * QT;
  for (int i = 0; i < n_qt; ++i) {
    const int st = i % STAGES;
    mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], TX);
    unsigned char* sq = smem + Smem::q + st * TILE;
    unsigned char* sdo = smem + Smem::dout + st * TILE;
    tma_load_4d(sq, mq, &full[st], 0, i * QT, h, b);
    tma_load_4d(sq + HALF, mq, &full[st], 64, i * QT, h, b);
    tma_load_4d(sdo, mdo, &full[st], 0, i * QT, h, b);
    tma_load_4d(sdo + HALF, mdo, &full[st], 64, i * QT, h, b);
    bulk_load(smem + Smem::stats + st * STAT, stats + i * 2 * QT, STAT, &full[st]);
  }
}

// dQ summed over the key tiles in the order 0, 1, .., n_kt - 1, per query
// tile: the consumers of key tile j < n_kt - 1 put their f32 part in
// shared memory; one thread waits until j tiles have added, stores (j = 0)
// or adds (a bulk f32 reduce) the part into the tile's sum in p.dq_acc,
// and counts itself once the writes are complete.  Key tile n_kt - 1
// finishes in its consumers (finish_dq).
__device__ void dq_writer(const BwdProblem& p, int bh, int j, int n_kt,
                          unsigned char* smem, uint64_t* dq_full, uint64_t* dq_empty) {
  using namespace vln_hopper;
  if (j + 1 == n_kt) return;
  const int n_qt = tiles(p.s_q, QT);
  for (int i = 0; i < n_qt; ++i) {
    const long long slot = (long long)bh * n_qt + i;
    unsigned* ready = p.dq_ready + slot;
    float* sum = p.dq_acc + slot * (DQ / 4);
    mbar_wait(dq_full, i & 1);
    if (j > 0)
      while (ld_acquire(ready) != (unsigned)j) {
      }
    fence_async_global();
    if (j == 0)
      bulk_store(sum, smem + Smem::dq, DQ);
    else
      bulk_add_f32(sum, smem + Smem::dq, DQ);
    bulk_commit();
    bulk_wait_read();
    mbar_arrive(dq_empty);  // the consumers may write the next part
    bulk_wait();
    fence_async_global();
    st_release(ready, j + 1);
  }
}

// key tile n_kt - 1: waits until the other tiles have added, adds its part
// to the sum and writes dQ (columns [64 wg, 64 wg + 64) of query tile qi)
// in bf16.  ``dq`` is the m64n64 accumulator (rows queries); the sum keeps
// the register order of wgmma's accumulator, [warpgroup][8][lane][4].
__device__ __forceinline__ void finish_dq(const BwdProblem& p, int heads, int bh,
                                          int qi, int j, int wg, float (&dq)[32]) {
  using namespace vln_hopper;
  const int wt = threadIdx.x % 128;
  const long long slot = (long long)bh * tiles(p.s_q, QT) + qi;
  if (j > 0) {
    if (wt == 0)
      while (ld_acquire(p.dq_ready + slot) != (unsigned)j) {
      }
    named_sync(2 + wg, 128);
    const float4* sum = reinterpret_cast<const float4*>(p.dq_acc + slot * (DQ / 4)) +
                        wg * 1024 + wt;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 a = __ldcg(sum + r * 128);
      dq[4 * r] = a.x + dq[4 * r];
      dq[4 * r + 1] = a.y + dq[4 * r + 1];
      dq[4 * r + 2] = a.z + dq[4 * r + 2];
      dq[4 * r + 3] = a.w + dq[4 * r + 3];
    }
  }
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const int b = bh / heads, h = bh % heads;
  const int row = qi * QT + 16 * warp + g;  // the lane's rows: row, row + 8
  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + 64 * wg + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= p.s_q) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqp + (row + 8 * r) * p.dq_ss + n * 8) =
          __floats2bfloat162_rn(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
  }
}

// A consumer warpgroup: keys [k0 + 64 wg, + 64) of key tile j against every
// query tile.  Per tile: S^T = K Q^T and (dO V^T)^T = V dO^T on wgmma; P =
// exp(S - LSE), the mask, dS; dS^T into shared
// memory for both warpgroups; dV += P~^T dO and dK += dS^T Q with A from
// registers; this warpgroup's half of dQ = dS K over the block's 128 keys,
// handed to the dQ writer (or finished here on the last key tile).
__device__ void consumer(const BwdProblem& p, int heads, int bh, int j, int n_kt,
                         float scale, unsigned char* smem, uint64_t* full,
                         uint64_t* empty, uint64_t* dq_full, uint64_t* dq_empty) {
  using namespace vln_hopper;
  const int wg = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = bh / heads, h = bh % heads, n_qt = tiles(p.s_q, QT);
  const int kw = j * KT + 64 * wg;           // the warpgroup's first key
  const int key = kw + 16 * warp + 2 * g;    // accumulator rows g, g + 8: key, key + 1
  unsigned char* sK = smem + Smem::k;
  unsigned char* sV = smem + Smem::v;
  load_keys(sK + wg * TILE, static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh,
            p.k_ss, kw, p.s_kv);
  load_keys(sV + wg * TILE, static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh,
            p.v_ss, kw, p.s_kv);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  named_sync(2 + wg, 128);

  const float* bias = p.bias + (long long)b * p.s_kv;
  const float kb[2] = {key < p.s_kv ? bias[key] : -INFINITY,
                       key + 1 < p.s_kv ? bias[key + 1] : -INFINITY};
  const uint32_t stream = vln_philox::global_stream(p.dropout, bh, heads);
  const bool drop = p.dropout.enabled;
  const float keep_scale = p.dropout.keep_scale;

  float dv[64], dk[64];
#pragma unroll
  for (int n = 0; n < 64; ++n) dv[n] = dk[n] = 0.0f;
  const unsigned char* kA = sK + wg * TILE;
  const unsigned char* vA = sV + wg * TILE;

  for (int i = 0; i < n_qt; ++i) {
    const int st = i % STAGES;
    const unsigned char* sq = smem + Smem::q + st * TILE;
    const unsigned char* sdo = smem + Smem::dout + st * TILE;
    const float* stat = reinterpret_cast<const float*>(smem + Smem::stats + st * STAT);
    unsigned char* sds = smem + Smem::ds + (i & 1) * TILE;
    mbar_wait(&full[st], (i / STAGES) & 1);

    // S^T and (dO V^T)^T: 64 keys x 64 queries over D, both operands K-major
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * HALF + (kk & 3) * 32;
      wgmma_64x64<0, 0>(s, desc_sw128(kA + off, 16, 1024), desc_sw128(sq + off, 16, 1024),
                        kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * HALF + (kk & 3) * 32;
      wgmma_64x64<0, 0>(dp, desc_sw128(vA + off, 16, 1024),
                        desc_sw128(sdo + off, 16, 1024), kk);
    }
    wgmma_commit();
    // the tile's keep bits while the products run (Philox is pure ALU work;
    // drawn here it overlaps them better than during the later products)
    const uint32_t bits = drop ? keep_bits(p.dropout, stream, i * QT, key, t) : 0xFFFFFFFFu;

    // P: scale, then add the bias, each rounded (no FMA), as the forward;
    // rows past s_q carry LSE = +inf and come out 0
    wgmma_wait<1>();
    hold(s);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(stat + 8 * n + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = __fadd_rn(__fmul_rn(s[4 * n + r], scale), kb[r >> 1]);
        s[4 * n + r] = exp_e(x - ((r & 1) ? l.y : l.x));
      }
    }
    // P~ and dS as bf16 A fragments: pa[2n], pa[2n + 1] hold rows g, g + 8
    // of n-tile n, so k-step kk is pa[4kk .. 4kk + 3]
    wgmma_wait<0>();
    hold(dp);
    uint32_t pa[16], da[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(stat + QT + 8 * n + 2 * t);
      float pt[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = s[4 * n + r];
        float d = dp[4 * n + r];
        pt[r] = pr;
        if (drop) {
          const bool kept = (bits >> (4 * n + r)) & 1u;
          pt[r] = kept ? pr * keep_scale : 0.0f;
          d = kept ? d * keep_scale : 0.0f;
        }
        ds[r] = pr * (d - ((r & 1) ? dl.y : dl.x)) * scale;
      }
      pa[2 * n] = pack_bf16(pt[0], pt[1]);
      pa[2 * n + 1] = pack_bf16(pt[2], pt[3]);
      da[2 * n] = pack_bf16(ds[0], ds[1]);
      da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dS^T rows (keys, this warpgroup's 64 after the other's) x 64 queries
    const int r0 = 64 * wg + 16 * warp + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(sds + sw128(r0, n) + 4 * t) = da[2 * n];
      *reinterpret_cast<uint32_t*>(sds + sw128(r0 + 8, n) + 4 * t) = da[2 * n + 1];
    }
    fence_async_smem();
    named_sync(1, 256);  // both halves of dS^T are in

    // dV += P~^T dO, dK += dS^T Q: A from registers, B (dO, Q) MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_64x128_rs<1>(dv, pa + 4 * kk, desc_sw128(sdo + kk * 2048, HALF, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_64x128_rs<1>(dk, da + 4 * kk, desc_sw128(sq + kk * 2048, HALF, 1024), 1);
    wgmma_commit();
    // dQ[:, 64 wg ..] = dS K over the block's 128 keys: A = dS^T in shared
    // memory and B = this warpgroup's half of K, both MN-major
    float dq[32];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_64x64<1, 1>(dq, desc_sw128(sds + kk * 2048, TILE, 1024),
                        desc_sw128(sK + (kk >> 2) * TILE + wg * HALF + (kk & 3) * 2048,
                                   TILE, 1024),
                        kk);
    wgmma_commit();
    wgmma_wait<0>();
    hold(dv);
    hold(dk);
    hold(dq);
    hold(pa);
    hold(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage is consumed
    if (j + 1 == n_kt) {
      finish_dq(p, heads, bh, i, j, wg, dq);
      continue;
    }
    mbar_wait(dq_empty, (i & 1) ^ 1);
    float4* part = reinterpret_cast<float4*>(smem + Smem::dq) + wg * 1024 + wt;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r * 128] = make_float4(dq[4 * r], dq[4 * r + 1], dq[4 * r + 2], dq[4 * r + 3]);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(dq_full);
  }

  // element 4n + r: key + (r >> 1), column 8n + 2t + (r & 1)
  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh + 2 * t;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key + r >= p.s_kv) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (key + r) * p.dk_ss + n * 8) =
          __floats2bfloat162_rn(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (key + r) * p.dv_ss + n * 8) =
          __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

}  // namespace wg

// The wgmma route's backward: a block per (b*h, 128-key tile) of problem 0,
// then of problem 1.  Warpgroup 0 gives its registers up: a thread of warp
// 0 loads, a thread of warp 1 sums dQ; warpgroups 1 and 2 consume.  The maps are the bf16
// rows of q and dO of each problem (wg_rows_map).
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap q0, const __grid_constant__ CUtensorMap do0,
                     const __grid_constant__ CUtensorMap q1, const __grid_constant__ CUtensorMap do1,
                     BwdProblem p0, BwdProblem p1, int kv0, int heads, float scale) {
  static_assert(D == wg::D, "the wgmma route runs at D = 128");
  using namespace vln_hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bool first = (int)blockIdx.x < kv0;
  const BwdProblem& p = first ? p0 : p1;
  const int j = first ? blockIdx.x : blockIdx.x - kv0;
  const int n_kt = first ? kv0 : gridDim.x - kv0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wg::Smem::full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + wg::Smem::empty);
  uint64_t* dq_full = reinterpret_cast<uint64_t*>(smem + wg::Smem::dq_full);
  uint64_t* dq_empty = reinterpret_cast<uint64_t*>(smem + wg::Smem::dq_empty);
  if (threadIdx.x == 0) {
    for (int s = 0; s < wg::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the loads' bytes
      mbar_init(&empty[s], 8);  // a lane of each consumer warp
    }
    mbar_init(dq_full, 8);
    mbar_init(dq_empty, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 4) {
    regs_dec<wg::PRODUCER_REGS>();
    if (warp == 0 && lane == 0)
      wg::producer(p, first ? &q0 : &q1, first ? &do0 : &do1, heads, blockIdx.y, smem,
                   full, empty);
    else if (warp == 1 && lane == 0)
      wg::dq_writer(p, blockIdx.y, j, n_kt, smem, dq_full, dq_empty);
  } else {
    regs_inc<wg::CONSUMER_REGS>();
    wg::consumer(p, heads, blockIdx.y, j, n_kt, scale, smem, full, empty, dq_full,
                 dq_empty);
  }
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

// ---- the wgmma route ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link to libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the rows of a [batch, heads, s, 128] bf16 operand (element strides ss,
// sh, sb) as a 4-d tensor map (d, s, h, b) of 64 x 64 boxes, 128-byte
// swizzle, zero past s
bool wg_rows_map(CUtensorMap* map, const void* base, int s, int heads, int batch,
                 long long ss, long long sh, long long sb) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)wg::D, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  // a dimension of size 1 is never stepped: any stride of 16 bytes does
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2,
                                 heads > 1 ? (cuuint64_t)sh * 2 : 16,
                                 batch > 1 ? (cuuint64_t)sb * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)wg::QT, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t configure_wgmma() {
  return cudaFuncSetAttribute(attention_bwd_kernel<wg::D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              wg::Smem::bytes);
}

// delta_kernel over the padded query tiles, then one attention_bwd_kernel
// over the 128-key tiles of both problems (problem 1 empty for B3)
cudaError_t launch_wgmma(const BwdProblem& p0, const BwdProblem& p1, int batch,
                         int heads, cudaStream_t stream) {
  const int groups0 = tiles(p0.s_q, BM) * BM / WARPS;
  const int groups1 = p1.s_q > 0 ? tiles(p1.s_q, BM) * BM / WARPS : 0;
  delta_kernel<bf16, wg::D><<<dim3(groups0 + groups1, batch * heads), THREADS, 0,
                              stream>>>(p0, p1, groups0, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const BwdProblem* ps[2] = {&p0, p1.s_q > 0 ? &p1 : &p0};
  for (int i = 0; i < 2; ++i) {
    const BwdProblem& p = *ps[i];
    if (!wg_rows_map(&maps[2 * i], p.q, p.s_q, heads, batch, p.q_ss, p.q_sh, p.q_sb) ||
        !wg_rows_map(&maps[2 * i + 1], p.dout, p.s_q, heads, batch, p.do_ss, p.do_sh,
                     p.do_sb))
      return cudaErrorInvalidValue;
  }
  err = configure_wgmma();
  if (err != cudaSuccess) return err;
  const int kv0 = tiles(p0.s_kv, wg::KT), kv1 = p1.s_q > 0 ? tiles(p1.s_kv, wg::KT) : 0;
  attention_bwd_kernel<wg::D><<<dim3(kv0 + kv1, batch * heads), wg::THREADS,
                                wg::Smem::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p0, p1, kv0, heads,
      1.0f / sqrtf((float)wg::D));
  return cudaGetLastError();
}

}  // namespace

// Runs problem p0 and, when p1->s_q > 0, problem p1 (B4: p0 is text ->
// vision, dropout direction 0; p1 vision -> text, 1).  is_bf16 selects bf16
// (1) or f32 (0) for q/k/v/o/dO and the gradients; head_dim is 64 or 128.
// A bf16 launch at head_dim 128 whose problems carry the wgmma route's
// scratch (stats set) takes that route; the caller chooses it
// (ops/attention.py bwd_route).
extern "C" int vln_attention_bwd(const BwdProblem* p0, const BwdProblem* p1,
                                 int batch, int heads, int head_dim,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && head_dim == 128 && p0->stats)
    err = launch_wgmma(*p0, *p1, batch, heads, s);
  else if (is_bf16 && head_dim == 128)
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

// Blocks of the wgmma route's kernel that fit on one SM, or -1 for a failed
// query, and its dynamic shared memory in bytes.
extern "C" int vln_attention_bwd_wgmma_blocks_per_sm() {
  int n = -1;
  if (configure_wgmma() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_bwd_kernel<wg::D>,
                                                    wg::THREADS,
                                                    wg::Smem::bytes) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int vln_attention_bwd_wgmma_smem_bytes() { return wg::Smem::bytes; }
