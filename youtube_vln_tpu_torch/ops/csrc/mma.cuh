// Warp-level tensor-core and copy primitives of the bf16 attention kernels
// (attention_fwd.cu, attention_bwd.cu; Hopper, sm_90a), as inline PTX; the
// epilogue backward (epilogue.cu) uses the cp.async ones.
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), lane = 4 * g + t:
//   A 16x16 row-major, 4 registers of 2 bf16: (g, 2t..2t+1), (g + 8, 2t..),
//     (g, 2t + 8..), (g + 8, 2t + 8..);
//   B 16x8, 2 registers: (k 2t..2t+1, n g), (k 2t + 8.., n g);
//   C/D 16x8 f32: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The C layout of two neighbouring n-tiles is the A layout of one k-step,
// so a score tile becomes the A operand of the next product in registers
// (pack_bf16).  ldmatrix.x4 loads four 8x8 b16 matrices; lane l gives the
// shared-memory address of row l % 8 of matrix l / 8, so a kernel may hand
// the rows in any order.  cp.async.cg copies 16 bytes from global to shared
// memory without passing through registers, zero-filling what the source
// size leaves out.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vln_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 matrices, lane l holding row l / 4, columns 2 (l % 4) .. + 1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// the same, transposed: lane l holds rows 2 (l % 4) .. + 1 of column l / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// c += a b for one 16x8x16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; zero when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// e^x as 2^(x log2 e): one multiply and the ex2 unit, where expf adds a
// range reduction (relative error a few 1e-7 for the |x| < 30 of a
// softmax, far below bf16's 4e-3)
__device__ __forceinline__ float exp_e(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Shared-memory row stride (elements) of a staged [rows, D] bf16 tile: 16
// bytes of padding put the 8 rows an ldmatrix reads in 8 distinct bank
// groups.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// rows [row0, row0 + ROWS) of a [n, D] bf16 matrix (row stride ``stride``
// elements, 16-byte aligned rows) into shared memory with cp.async, zero
// past n; every thread of the block takes part
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int n) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int c = (int)threadIdx.x + it * THREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool ok = row0 + r < n;
    // a row past n reads nothing; its address stays inside the matrix
    cp_async16(dst + r * row_stride<D>() + col,
               src + (ok ? (long long)(row0 + r) * stride : 0LL) + col,
               ok ? 16 : 0);
  }
}

}  // namespace vln_mma
