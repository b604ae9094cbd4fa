// Hopper (sm_90a) building blocks in raw PTX, shared by the flash-attention
// kernels: mbarriers, TMA tile loads, the wgmma shared-memory descriptor
// for 128-byte-swizzled tiles, the wgmma products (A from shared memory or
// from registers) and setmaxnreg; and, on the host, the TMA tensor maps.
//
// Tile layout. Every bf16 tile a kernel reads is brought in by TMA with
// the 128-byte swizzle, as panels of 64 columns: a tile of R rows and d
// columns is d / 64 panels of R rows x 128 bytes, one after the other;
// inside a panel the 16-byte chunk j of row r sits at chunk j ^ (r % 8).
// Each panel starts on a 1024-byte boundary. The same panel serves two
// ways:
//  * K-major: the product's reduction index runs along the row (Q and K
//    in Q K^T). desc_kmajor(); a k step of 16 columns is +32 bytes inside
//    the panel, and panel (16 kk) / 64 holds step kk.
//  * MN-major: the reduction index runs down the rows (V in P V, whose
//    reduction is over keys). desc_mnmajor() with the transpose bit set
//    on the product; a k step of 16 rows is +2048 bytes, and the N
//    columns of one product walk the panels panel_bytes apart.
// A mismatch between the TMA swizzle and the descriptor gives wrong
// numbers, not a fault: chip_smoke.py holds every kernel against its
// plain version.
//
// Fragments (PTX ISA, wgmma .m64nNk16, f32 accumulator): warp w of the
// warpgroup owns rows 16w .. 16w + 15; lane = 4g + c holds, for each
// 8-column block j, d[4j + 0, 1] = row 16w + g, columns 8j + 2c, + 1 and
// d[4j + 2, 3] = row 16w + g + 8, the same columns. The A fragment of
// a register-A product has the mma.sync m16n8k16 A layout, so the
// accumulator blocks 2kc and 2kc + 1 are the A operand of reduction
// columns [16kc, 16kc + 16) of the next product (acc_to_a in
// mma_common.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. No bound on the
// spin: a trap here (to turn a hang into a failed launch) makes ptxas
// spill the wgmma accumulators and run the products one at a time.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  while (!mbar_try_wait(a, parity)) {
  }
}

// Stage and phase of a ring of NS stages. The consumer waits on a stage's
// full barrier with parity(); the producer waits on its empty barrier
// with parity() ^ 1, which passes at once on the first round, when every
// stage is free.
template <int NS>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t parity() const { return phase; }
  __device__ __forceinline__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1u;  // the phase flip
    }
  }
};

// -------------------------------------------------------------------- TMA
// Tile loads into shared memory that complete on `bar` (complete_tx).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor (PTX ISA "matrix descriptor"): start
// address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride
// byte offset >> 4 in 32-45, layout 1 (128-byte swizzle) in 62-63. Every
// operand here has 8-row groups 1024 bytes apart, so the high word is one
// constant and a descriptor is carried as its low word: a step along a
// tile is a 32-bit add (the address field stays below 2^14, so it does
// not carry), and the products build the 64-bit value in PTX.
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);

// K-major operand at p (the leading offset is unused by a swizzled
// K-major layout and set to 1)
__device__ __forceinline__ uint32_t desc_kmajor(const void* p) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (1u << 16);
}

// MN-major operand at p (use with the transpose bit): 64-column panels
// panel_bytes apart
__device__ __forceinline__ uint32_t desc_mnmajor(const void* p,
                                                 uint32_t panel_bytes) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | ((panel_bytes >> 4) << 16);
}

// the descriptor `bytes` further on (a multiple of 16)
__device__ __forceinline__ uint32_t desc_add(uint32_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The warpgroup index, broadcast from lane 0 so the compiler knows it is
// the same across the warp and keeps what derives from it (descriptors,
// barrier addresses) in uniform registers.
__device__ __forceinline__ int warpgroup_idx() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the commit and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The m64nNk16 bf16 products with f32 accumulators; N is set by the size
// of the accumulator array (N / 2 floats a thread); da and db are
// descriptors' low words. TB is the transpose bit of B: 0 for a K-major
// B, 1 for an MN-major one. The _first forms overwrite d (its old values
// are not read, so they need not stay live), the others add to it.
// D = A B, m64n32k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint32_t da,
                                              uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "setp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, da, db, p, 1, 1, 0, %20;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(0), "n"(TB));
}

// D += A B, m64n32k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint32_t da,
                                        uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "setp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, da, db, p, 1, 1, 0, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(1), "n"(TB));
}

// D = A B, m64n64k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint32_t da,
                                              uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(0), "n"(TB));
}

// D += A B, m64n64k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t da,
                                        uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(1), "n"(TB));
}

// D = A B, m64n128k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint32_t da,
                                              uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p, 1, 1, 0, %68;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(0), "n"(TB));
}

// D += A B, m64n128k16; A [64 x 16] and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint32_t da,
                                        uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p, 1, 1, 0, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(1), "n"(TB));
}

// D += A B, m64n128k16; A [64 x 16] from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%68, %69};\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, db, p, 1, 1, %71;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(kDescHi),
        "r"(1), "n"(TB));
}


// 2^x by the SFU (ex2.approx.ftz: ~2 ulp, results below 2^-126 flush to
// 0), without exp2f's denormal handling around it
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- setmaxnreg
// Moves registers between warpgroups: every warp of the warpgroup runs it.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------- host
// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, T, H, D] tensor with (batch, seq, head) strides
// in elements and unit stride over D, as the rank-4 (D, H, T, B) tensor;
// a box is one 64-column panel of `rows` rows of one (batch, head),
// 128-byte swizzled; rows at or past T come in as zeros (the partial
// last tile of a T that the tile does not divide). The caller guarantees
// a 16-byte aligned base and strides that are multiples of 8 elements.
inline cudaError_t map_bthd(CUtensorMap* map, const void* base, int B, int T,
                            int H, int D, long long sb, long long st,
                            long long sh, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of an f32 [R, T] tensor with row stride ld (lse, Delta as
// [B*H, T]; TMA needs ld % 4 == 0, so for T % 4 != 0 the rows are
// padded); a box is `cols` consecutive values of one row, unswizzled, and
// columns at or past T come in as zeros.
inline cudaError_t map_rows_f32(CUtensorMap* map, const void* base, int R,
                                int T, int ld, int cols) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, 1};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 1024-byte aligned start of dynamic shared memory (the swizzle pattern
// is a function of the shared address); the kernels ask for 1 KB more.
__device__ __forceinline__ unsigned char* smem_align1k(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace
