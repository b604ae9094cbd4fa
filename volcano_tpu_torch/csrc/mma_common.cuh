// Helpers shared by the flash-attention kernels: bf16 packing, the
// two-term bf16 split of an f32 value, the mma.sync m16n8k16 product and
// the quad reductions.
//
// mma.sync m16n8k16 fragment layout (PTX ISA): lane = 4*g + c. A thread
// holds rows g and g+8 of the 16-row A and C tiles; of A, columns 2c, 2c+1
// (registers 0, 1) and 2c+8, 2c+9 (registers 2, 3); of B, rows 2c, 2c+1
// and 2c+8, 2c+9 of column g; of C, columns 2c, 2c+1 of rows g (0, 1) and
// g+8 (2, 3). So the C tiles 2kc and 2kc+1 of a product are exactly the A
// fragment of reduction columns [16kc, 16kc + 16) of the next product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_u16(unsigned short lo,
                                             unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// x0, x1 -> (hi, lo) bf16 pairs with x ~= hi + lo
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(l0, l1);
}

// Two f32 values as one bf16x2 register, each rounded to nearest
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (one bf16 term) of reduction columns [16kc, 16kc + 16)
// taken from the f32 accumulator tiles acc[2kc] and acc[2kc + 1].
__device__ __forceinline__ void acc_to_a(const float* t0, const float* t1,
                                         uint32_t* a) {
  a[0] = bf16x2(t0[0], t0[1]);
  a[1] = bf16x2(t0[2], t0[3]);
  a[2] = bf16x2(t1[0], t1[1]);
  a[3] = bf16x2(t1[2], t1[3]);
}

// The same as hi and lo terms (x ~= hi + lo).
__device__ __forceinline__ void acc_to_a(const float* t0, const float* t1,
                                         uint32_t* ah, uint32_t* al) {
  split_bf16(t0[0], t0[1], ah[0], al[0]);
  split_bf16(t0[2], t0[3], ah[1], al[1]);
  split_bf16(t1[0], t1[1], ah[2], al[2]);
  split_bf16(t1[2], t1[3], ah[3], al[3]);
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a bf16
// tile in shared memory with row pitch ld (elements).
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int ld,
                                       int r0, int c0, int g, int c,
                                       uint32_t* a) {
  const __nv_bfloat16* x = tile + (r0 + g) * ld + c0 + 2 * c;
  a[0] = *reinterpret_cast<const uint32_t*>(x);
  a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(x + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * ld + 8);
}

// D[16x8] += A[16x16] * B[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  mma_bf16(c, a, b[0], b[1]);
}

// B fragment whose n index runs over the rows [n0, n0 + 8) of a bf16 tile
// and whose reduction index over its columns [k0, k0 + 16): read along
// the rows, 32 bits at a time (K in Q K^T).
__device__ __forceinline__ void b_rows(const __nv_bfloat16* tile, int ld,
                                       int n0, int k0, int g, int c,
                                       uint32_t* b) {
  const __nv_bfloat16* x = tile + (n0 + g) * ld + k0 + 2 * c;
  b[0] = *reinterpret_cast<const uint32_t*>(x);
  b[1] = *reinterpret_cast<const uint32_t*>(x + 8);
}

// B fragment whose reduction index runs over the rows [k0, k0 + 16) of a
// bf16 tile and whose n index over its columns [n0, n0 + 8): read down
// the columns, 16 bits at a time (V in P V).
__device__ __forceinline__ void b_cols(const unsigned short* tile, int ld,
                                       int k0, int n0, int g, int c,
                                       uint32_t* b) {
  const unsigned short* x = tile + (k0 + 2 * c) * ld + n0 + g;
  b[0] = pack_u16(x[0], x[ld]);
  b[1] = pack_u16(x[8 * ld], x[9 * ld]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [r0, r0 + rows) of one (batch, head) of a bf16 [B, T, H, D]
// tensor (row stride st elements, 16-byte aligned) into a shared tile of
// pitch ld (a multiple of 8), 16 bytes a thread.
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int rows,
                                          int tid, int nthreads) {
  constexpr int CH = D / 8;
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, col = (i % CH) * 8;
    *reinterpret_cast<uint4*>(&dst[r * ld + col]) =
        *reinterpret_cast<const uint4*>(&src[(r0 + r) * st + col]);
  }
}

// The same for f32 into a tile of odd pitch ld, one value a thread.
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, long long st,
                                          int r0, int rows, int tid,
                                          int nthreads) {
  for (int i = tid; i < rows * D; i += nthreads)
    dst[(i / D) * ld + i % D] = src[(r0 + i / D) * st + i % D];
}

}  // namespace
