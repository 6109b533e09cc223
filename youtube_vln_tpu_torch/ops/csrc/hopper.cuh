// Hopper primitives of the warp-specialised attention backward
// (attention_bwd.cu; sm_90a only), as inline PTX:
//   * mbarriers: a phase completes when its expected arrivals and its
//     expected bytes (TMA) are in; try_wait.parity spins on one phase;
//   * TMA: one thread copies a box of a tensor map (4-d, 128-byte swizzle)
//     or a contiguous run of bytes from global to shared memory, and the
//     copy completes bytes on an mbarrier;
//   * wgmma: a warpgroup's asynchronous 64-row product, B (and A unless it
//     comes from registers) read from shared memory through a descriptor;
//   * named barriers, register reallocation (setmaxnreg), the proxy fence
//     between ordinary shared-memory stores and wgmma's reads of them, and
//     acquire / release of a global counter.
//
// Shared-memory operands use the 128-byte swizzle, the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B: a tile is rows of 128 bytes (64 bf16),
// 16-byte chunk c of row r stored at chunk c ^ (r % 8), on a 1024-byte
// aligned base.  A K-major operand (the reduction dimension contiguous)
// takes 8-row groups at SBO = 1024 bytes and steps along K by 32 bytes
// inside a row; an MN-major one (imm-trans = 1, bf16 only) takes 8-row
// groups along K at SBO = 1024 and 64-element atoms along M or N at LBO.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace vln_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` of TMA traffic this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// spins until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------
// the box of ``map`` at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global: ``bytes`` stored, or added element-wise as f32 (each
// element one rounded add, in the order the adds are issued); both
// complete through the thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed bulk groups have read their shared-memory sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the committed bulk groups have completed, their writes included
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's global accesses through the async proxy (bulk
// copies) against its ordinary ones
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- warpgroup MMA ---------------------------------------------------------
// descriptor of a 128-byte-swizzled shared-memory operand at ``p``
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins a register across the asynchronous product that reads or writes it:
// after wgmma_wait, the compiler may neither read an accumulator early nor
// reuse an A operand's register while the product is in flight
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hold(x[i]);
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hold(x[i]);
}

// d (+)= A B for a 64 x 64 x 16 step, A and B in shared memory; TA / TB
// set: A / B MN-major.  d: the m64n64 f32 accumulator, element 4j + r of
// lane 4g + t of warp w at row 16w + g + 8 (r >> 1), column 8j + 2t + (r & 1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B for a 64 x 128 x 16 step, A from registers (the mma.sync A
// fragment of the warp's 16 rows: {row g, k 2t..2t+1}, {g + 8, 2t..},
// {g, 2t + 8..}, {g + 8, 2t + 8..}), B in shared memory, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64], const uint32_t* a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "%70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// ---- synchronisation -------------------------------------------------------
// barrier ``id`` (1-15; 0 is __syncthreads) over ``threads`` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ordinary shared-memory stores before it are seen by wgmma after it
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// publishes ``v`` after every write of the block that a named barrier has
// ordered before this thread's (the fence is cumulative)
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}

}  // namespace vln_hopper
