// Helpers shared by the flash-attention kernels: bf16 packing, the
// conversion of f32 wgmma accumulators into bf16 A fragments, the quad
// reductions, and the tiles of the CUDA-core kernels.
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

// ------------------------------------------------ the CUDA-core kernels
// The f32 kernels at every head dim, and the bf16 ones at d > 256, work on
// f32 tiles of 32 rows in shared memory, 128 columns at a time: a block
// owns one 128-column panel of its output and sums its scores over the
// 128-column chunks of d.
constexpr int kSimtRows = 32;
constexpr int kSimtThreads = 128;
constexpr int kPanel = 128;
constexpr int kPanelLd = kPanel + 1;  // odd pitch: no bank conflicts down a column

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Columns [c0, c0 + 128) of rows [r0, r0 + 32) of one (batch, head) of a
// [B, T, H, D] tensor (row stride st elements) into an f32 tile of pitch
// kPanelLd, one value a thread; rows at or past T come in as zeros.
template <typename E>
__device__ __forceinline__ void load_panel(float* dst, const E* src,
                                           long long st, int r0, int c0,
                                           int T, int tid) {
  for (int i = tid; i < kSimtRows * kPanel; i += kSimtThreads) {
    const int r = i / kPanel, col = i % kPanel;
    dst[r * kPanelLd + col] =
        r0 + r < T ? to_f32(src[(long long)(r0 + r) * st + c0 + col]) : 0.f;
  }
}

}  // namespace
