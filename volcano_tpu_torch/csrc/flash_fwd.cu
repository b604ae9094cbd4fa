// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: volcano_tpu/workloads/ops/flash_attention.py:_flash_kernel
// (launched by _flash_bh on the TPU grid (b*h, t/block_q)).
//
// What it computes, as the TPU kernel does: per (batch, head) and q row,
// causal or full softmax attention with an online softmax over k tiles,
// all in f32 -- scale rsqrt(d), masked scores -1e30, masked p exactly 0,
// running max m, running sum l, out = acc / (l == 0 ? 1 : l) in the input
// dtype, and lse = m + log l (f32) for the backward kernels.
//
// What bounds it: at the serving shape (b*h = 128, t = 2048, d = 128,
// bf16, causal) the work is 4*b*h*d*t(t+1)/2 = 1.4e11 FLOP against
// 4 * 67 MB of q/k/v/out, about 510 FLOP per byte, above the H100's
// ~295 FLOP/byte ridge: it is bound by the tensor cores' operations.
//
// What the design does about it:
//  * The TPU kernel keeps a head's whole K/V row in VMEM. Hopper has at
//    most 227 KB of shared memory a block, so here one block of 4 warps
//    owns 64 q rows of one (batch, head) and streams 64-row K/V tiles
//    through shared memory; the TPU's sequential grid dimension becomes
//    the k-tile loop inside the block. Causal k tiles past the diagonal
//    are skipped, and the heaviest q tiles are launched first.
//  * bf16: the two products run on the tensor cores (mma.sync m16n8k16,
//    f32 accumulation). QK^T of bf16 values is exact in f32, so S is the
//    f32 product of the upcast inputs up to summation order. P is f32;
//    it enters PV as a two-term bf16 split (P = hi + lo), which keeps 16
//    of f32's 24 significant bits (relative error <= 2^-17, 1/256 of the
//    bf16 rounding of out) at the cost of a second PV product.
//  * f32: CUDA-core FMAs in full f32 (a tensor-core path would need TF32,
//    whose 10-bit mantissa misses the f32 tolerance). 32-row tiles.
//  * q/k/v are read in their [b, t, h, d] layout through the strides the
//    caller passes, so no transposes; out is written [b, t, h, d]
//    contiguous and lse [b, h, t] f32.
// Simple first: no TMA, no wgmma, no pipelining of the tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, T, H;
  int causal;
};

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- bf16
// One block: 4 warps, 64 q rows (16 a warp). mma fragment layout
// (PTX m16n8k16): lane = 4*g + c; a thread holds rows g and g+8 of its
// warp's 16 rows, and columns 2c, 2c+1 (+8) of each 8-wide n tile.
constexpr int kMmaRows = 64;
constexpr int kMmaThreads = 128;

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * kMmaRows * (D + 8) * 2;  // Q, K, V tiles, rows padded by 8
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16_kernel(const FwdParams p) {
  constexpr int BQ = kMmaRows, BK = kMmaRows, LD = D + 8;
  constexpr int NT = BK / 8;   // n tiles of S
  constexpr int DT = D / 8;    // n tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * BQ;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            bi * p.v_sb + hi * p.v_sh;

  for (int i = tid; i < BQ * CH; i += kMmaThreads) {
    const int r = i / CH, col = (i % CH) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * LD + col]) =
        *reinterpret_cast<const uint4*>(&qg[(q0 + r) * p.q_st + col]);
  }

  const float scale = 1.0f / sqrtf((float)D);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.T / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * CH; i += kMmaThreads) {
      const int r = i / CH, col = (i % CH) * 8;
      *reinterpret_cast<uint4*>(&Ks[r * LD + col]) =
          *reinterpret_cast<const uint4*>(&kg[(k0 + r) * p.k_st + col]);
      *reinterpret_cast<uint4*>(&Vs[r * LD + col]) =
          *reinterpret_cast<const uint4*>(&vg[(k0 + r) * p.v_st + col]);
    }
    __syncthreads();

    // S = Q K^T (f32)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const __nv_bfloat16* qa = &Qs[(warp * 16 + g) * LD + kc * 16 + 2 * c];
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kb = &Ks[(j * 8 + g) * LD + kc * 16 + 2 * c];
        mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // scale, mask, online softmax (rows row0: e = 0,1; row1: e = 2,3)
    float mb[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (p.causal && k0 + j * 8 + 2 * c + (e & 1) > (e < 2 ? row0 : row1))
          x = kNegInf;
        s[j][e] = x;
        mb[e >> 1] = fmaxf(mb[e >> 1], x);
      }
    }
    float mn[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m[r], quad_max(mb[r]));
      corr[r] = expf(m[r] - mn[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pv = x <= kNegInf / 2 ? 0.f : expf(x - mn[e >> 1]);
        s[j][e] = pv;
        ls[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(ls[r]);
      m[r] = mn[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V, P as hi + lo bf16; the S accumulator tiles 2kc, 2kc+1
    // are exactly the A fragment of keys [16kc, 16kc + 16)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ah[0], al[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ah[1], al[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ah[3], al[3]);
      const unsigned short* vb = &Vu[(kc * 16 + 2 * c) * LD + g];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const unsigned short* vj = vb + j * 8;
        const uint32_t b0 = pack_u16(vj[0], vj[LD]);
        const uint32_t b1 = pack_u16(vj[8 * LD], vj[9 * LD]);
        mma_bf16(o[j], ah, b0, b1);
        mma_bf16(o[j], al, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
  const float l0 = l[0] == 0.f ? 1.f : l[0];
  const float l1 = l[1] == 0.f ? 1.f : l[1];
  const long long ob0 = ((long long)(bi * p.T + row0) * p.H + hi) * D;
  const long long ob1 = ((long long)(bi * p.T + row1) * p.H + hi) * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(&og[ob0 + col]) = pack_bf16(
        __float2bfloat16_rn(o[j][0] / l0), __float2bfloat16_rn(o[j][1] / l0));
    *reinterpret_cast<uint32_t*>(&og[ob1 + col]) = pack_bf16(
        __float2bfloat16_rn(o[j][2] / l1), __float2bfloat16_rn(o[j][3] / l1));
  }
  if (c == 0) {
    p.lse[(long long)bh * p.T + row0] = m[0] + logf(l0);
    p.lse[(long long)bh * p.T + row1] = m[1] + logf(l1);
  }
}

// ----------------------------------------------------------------- f32
// One block: 128 threads, 32 q rows; a quad of 4 threads shares a row.
// Thread (r, c) computes S columns c + 4i and O columns c + 4j.
constexpr int kSimtRows = 32;
constexpr int kSimtThreads = 128;

template <int D>
constexpr int simt_smem_bytes() {
  // Q [32][D+1], K [32][D+1], V [32][D], P [32][33]
  return 4 * (2 * kSimtRows * (D + 1) + kSimtRows * D +
              kSimtRows * (kSimtRows + 1));
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
    flash_fwd_f32_kernel(const FwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = D + 1, LP = BK + 1;
  constexpr int NS = BK / 4, NO = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LQ;
  float* Vs = Ks + BK * LQ;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * BQ, row = q0 + r;
  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  for (int i = tid; i < BQ * D; i += kSimtThreads)
    Qs[(i / D) * LQ + i % D] = qg[(q0 + i / D) * p.q_st + i % D];

  const float scale = 1.0f / sqrtf((float)D);
  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.T / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += kSimtThreads) {
      const int kr = i / D, col = i % D;
      Ks[kr * LQ + col] = kg[(k0 + kr) * p.k_st + col];
      Vs[kr * D + col] = vg[(k0 + kr) * p.v_st + col];
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r * LQ + dd];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = fmaf(qv, Ks[(c + 4 * i) * LQ + dd], s[i]);
    }
    float mb = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = s[i] * scale;
      if (p.causal && k0 + c + 4 * i > row) x = kNegInf;
      s[i] = x;
      mb = fmaxf(mb, x);
    }
    const float mn = fmaxf(m, quad_max(mb));
    const float corr = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float pv = s[i] <= kNegInf / 2 ? 0.f : expf(s[i] - mn);
      Ps[r * LP + c + 4 * i] = pv;
      ls += pv;
    }
    l = l * corr + quad_sum(ls);
    m = mn;
    __syncwarp();  // the row's P comes from the 4 lanes of this quad
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float pv = Ps[r * LP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j)
        o[j] = fmaf(pv, Vs[kk * D + c + 4 * j], o[j]);
    }
  }

  float* og = static_cast<float*>(p.out) +
              ((long long)(bi * p.T + row) * p.H + hi) * D;
  const float sl = l == 0.f ? 1.f : l;
#pragma unroll
  for (int j = 0; j < NO; ++j) og[c + 4 * j] = o[j] / sl;
  if (c == 0) p.lse[(long long)bh * p.T + row] = m + logf(sl);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int rows, int threads, int smem,
                   const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.T / rows, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: [B, T, H, D] with the given (batch, seq, head) strides in
// elements and unit stride over D; out: [B, T, H, D] contiguous in the
// input dtype; lse: [B, H, T] f32. dtype: 0 = f32, 1 = bf16. The caller
// guarantees D in {128, 256}, T % 64 == 0 and 16-byte aligned rows.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vtp_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int H,
                             int D, int dtype, int causal, long long q_sb,
                             long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, void* stream) {
  FwdParams p{q,    k,    v,    out,  static_cast<float*>(lse),
              q_sb, q_st, q_sh, k_sb, k_st,
              k_sh, v_sb, v_st, v_sh, B,
              T,    H,    causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_bf16_kernel<128>, kMmaRows, kMmaThreads,
                  mma_smem_bytes<128>(), p, s);
  if (dtype == 1 && D == 256)
    return launch(flash_fwd_bf16_kernel<256>, kMmaRows, kMmaThreads,
                  mma_smem_bytes<256>(), p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_f32_kernel<128>, kSimtRows, kSimtThreads,
                  simt_smem_bytes<128>(), p, s);
  if (dtype == 0 && D == 256)
    return launch(flash_fwd_f32_kernel<256>, kSimtRows, kSimtThreads,
                  simt_smem_bytes<256>(), p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* vtp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
