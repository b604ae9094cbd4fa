// Helpers shared by the flash-attention kernels: bf16 packing, the
// conversion of f32 wgmma accumulators into bf16 A fragments, the quad
// reductions and the f32 kernels' row copies.
//
// The A fragment of an m64nNk16 register-A wgmma has the mma.sync
// m16n8k16 A layout (PTX ISA): lane = 4*g + c holds rows g and g+8 of its
// warp's 16, columns 2c, 2c+1 (registers 0, 1) and 2c+8, 2c+9 (registers
// 2, 3). An f32 accumulator block j holds, in the same lane, columns
// 8j + 2c, + 1 of rows g (0, 1) and g + 8 (2, 3). So the accumulator
// blocks 2kc and 2kc+1 of a product are exactly the A fragment of
// reduction columns [16kc, 16kc + 16) of the next product.

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

// Two f32 values as one bf16x2 register, each rounded to nearest
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragment of reduction columns [16kc, 16kc + 16) taken from
// the f32 accumulator blocks acc[2kc] and acc[2kc + 1].
__device__ __forceinline__ void acc_to_a(const float* t0, const float* t1,
                                         uint32_t* a) {
  a[0] = bf16x2(t0[0], t0[1]);
  a[1] = bf16x2(t0[2], t0[3]);
  a[2] = bf16x2(t1[0], t1[1]);
  a[3] = bf16x2(t1[2], t1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [r0, r0 + rows) of one (batch, head) of an f32 [B, T, H, D]
// tensor (row stride st elements) into a shared tile of odd pitch ld, one
// value a thread.
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, long long st,
                                          int r0, int rows, int tid,
                                          int nthreads) {
  for (int i = tid; i < rows * D; i += nthreads)
    dst[(i / D) * ld + i % D] = src[(r0 + i / D) * st + i % D];
}

}  // namespace
