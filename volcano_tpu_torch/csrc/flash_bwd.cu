// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// a dQ kernel and a dK/dV kernel.
//
// Replaces: volcano_tpu/workloads/ops/flash_attention.py:_bwd_dq_kernel
// (TPU grid (b*h, t/block_q_bwd)) and :_bwd_dkv_kernel (TPU grid
// (b*h, t/block_k_bwd)), both launched by _flash_bh_bwd.
//
// What they compute, as the TPU kernels do, all in f32: with
// scale = rsqrt(d), S = scale * Q K^T (masked scores -1e30),
// P = exp(S - lse) with masked p exactly 0, dP = dO V^T and
// dS = P o (dP - Delta), where lse [b, h, t] is what the forward kernel
// wrote and Delta = rowsum(dO o O) [b, h, t] comes from the wrapper (a
// torch op, as the reference computes it in jnp outside its kernels):
//   vtp_flash_bwd_dq:   dQ = scale * dS K
//   vtp_flash_bwd_dkv:  dK = scale * dS^T Q,  dV = P^T dO
//
// What bounds them: at the training shape (b*h = 128, t = 2048, d = 128,
// bf16, causal) dQ does 3 products of 2d FLOP (S, dP, dQ) and dK/dV 4 (S,
// dP, dV, dK) per unmasked (q, k) pair, over b*h*t(t+1)/2 pairs: 2.06e11
// and 2.75e11 FLOP against 5 and 6 tensors of 67 MB moved, 600-700 FLOP a
// byte, above the H100's ~295 FLOP/byte ridge: both are operation-bound.
//
// What the design does about it:
//  * As on the TPU, one block owns one q tile (dQ) or one k tile (dK/dV)
//    of one (batch, head) and nothing is shared between blocks: no
//    atomics, no reduction across blocks, sums in a fixed order. The TPU's
//    sequential grid axis becomes the tile loop inside the block. Causal
//    tiles past the diagonal are skipped and the heaviest tiles start
//    first: the last q tiles for dQ, the first k tiles for dK/dV.
//  * bf16: all products run on the tensor cores (mma.sync m16n8k16, f32
//    accumulation). The dK/dV warp owns 16 k rows, so it computes the
//    transposed products S^T = K Q^T and dP^T = V dO^T directly, and the
//    accumulator tiles of P^T and dS^T are the A operands of dV += P^T dO
//    and dK += dS^T Q, with no trip through shared memory (the forward's
//    reuse of P). lse and Delta, indexed by column there, are staged per
//    q tile in shared memory. P and dS are f32 and enter their products
//    as two bf16 terms (hi + lo, 16 significant bits), so the kernels
//    agree with the f32 plain version to one bf16 rounding of their
//    outputs; that costs 4/3 (dQ) and 3/2 (dK/dV) of the needed tensor
//    work.
//  * Registers: a dK/dV warp carries two 16 x d f32 accumulators (128
//    registers a thread at d = 128), so its q tile is 32 rows: S^T and
//    dP^T add 32 registers, not 64. At d = 256 the accumulators alone
//    would fill the register file: 8 warps share a block, each owning
//    half of d's output columns for 16 rows, and the pair of warps on the
//    same rows both compute S and dP (in both kernels).
//  * B operands read along the reduction index (K in dQ, dO and Q in
//    dK/dV) are gathered with 16-bit shared loads, as V in the forward.
//  * f32: CUDA-core FMAs in full f32 (TF32 would miss the f32 tolerance),
//    32-row tiles, a quad of threads per row.
//  * q/k/v/dO are read in their [b, t, h, d] layout by stride; dQ/dK/dV
//    are written [b, t, h, d] contiguous.
// Simple first: no TMA, no wgmma, no pipelining of the tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int B, T, H;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, long long sb,
                                         long long sh, int bi, int hi) {
  return static_cast<const T*>(base) + bi * sb + hi * sh;
}

// element offset of row r of (bi, hi) in a contiguous [B, T, H, D] output
__device__ __forceinline__ long long out_row(const BwdParams& p, int bi,
                                             int hi, int r, int d) {
  return (((long long)bi * p.T + r) * p.H + hi) * d;
}

// ---------------------------------------------------------------- bf16
// A block has 128 * NSPLIT threads: warp w owns tile rows
// [16 (w % 4), 16 (w % 4) + 16) and output columns [DW (w / 4), + DW).
constexpr int kMmaTile = 64;  // q rows of a dQ block, k rows of a dK/dV block

template <int D, int BK>
constexpr int dq_bf16_smem() {
  return (2 * kMmaTile + 2 * BK) * (D + 8) * 2;  // Q, dO, K, V tiles
}

template <int D, int BK, int NSPLIT>
__global__ void __launch_bounds__(128 * NSPLIT)
    flash_bwd_dq_bf16_kernel(const BwdParams p) {
  constexpr int BQ = kMmaTile, LD = D + 8, NT = BK / 8;
  constexpr int DW = D / NSPLIT, DT = DW / 8, NTH = 128 * NSPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const unsigned short* Ku = reinterpret_cast<const unsigned short*>(Ks);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * DW;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * BQ;
  const __nv_bfloat16* qg =
      head<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, bi, hi);
  const __nv_bfloat16* kg =
      head<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, bi, hi);
  const __nv_bfloat16* vg =
      head<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, bi, hi);
  const __nv_bfloat16* og =
      head<__nv_bfloat16>(p.dout, p.o_sb, p.o_sh, bi, hi);
  copy_rows<D>(Qs, LD, qg, p.q_st, q0, BQ, tid, NTH);
  copy_rows<D>(dOs, LD, og, p.o_st, q0, BQ, tid, NTH);

  const float scale = 1.0f / sqrtf((float)D);
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const long long rb = (long long)bh * p.T;
  const float lse[2] = {p.lse[rb + row0], p.lse[rb + row1]};
  const float dlt[2] = {p.delta[rb + row0], p.delta[rb + row1]};
  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  const int n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.T / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    copy_rows<D>(Ks, LD, kg, p.k_st, k0, BK, tid, NTH);
    copy_rows<D>(Vs, LD, vg, p.v_st, k0, BK, tid, NTH);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (f32)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], ad[4], b[2];
      load_a(Qs, LD, wr, kc * 16, g, c, a);
      load_a(dOs, LD, wr, kc * 16, g, c, ad);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b_rows(Ks, LD, j * 8, kc * 16, g, c, b);
        mma_bf16(s[j], a, b);
        b_rows(Vs, LD, j * 8, kc * 16, g, c, b);
        mma_bf16(dp[j], ad, b);
      }
    }

    // dS = P o (dP - Delta) with P = exp(scale S - lse), masked p exactly
    // 0 (rows row0: e = 0, 1; row1: e = 2, 3), kept in s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = p.causal && k0 + j * 8 + 2 * c + (e & 1) >
                                            (e < 2 ? row0 : row1);
        const float pv =
            masked ? 0.f : expf(s[j][e] * scale - lse[e >> 1]);
        s[j][e] = pv * (dp[j][e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K, dS as hi + lo bf16, K read down its columns
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ah[4], al[4], b[2];
      acc_to_a(s[2 * kc], s[2 * kc + 1], ah, al);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        b_cols(Ku, LD, kc * 16, wc + j * 8, g, c, b);
        mma_bf16(dq[j], ah, b);
        mma_bf16(dq[j], al, b);
      }
    }
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq);
  const long long ob0 = out_row(p, bi, hi, row0, D);
  const long long ob1 = out_row(p, bi, hi, row1, D);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = wc + j * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(&dqg[ob0 + col]) =
        pack_bf16(__float2bfloat16_rn(dq[j][0] * scale),
                  __float2bfloat16_rn(dq[j][1] * scale));
    *reinterpret_cast<uint32_t*>(&dqg[ob1 + col]) =
        pack_bf16(__float2bfloat16_rn(dq[j][2] * scale),
                  __float2bfloat16_rn(dq[j][3] * scale));
  }
}

template <int D, int BQ>
constexpr int dkv_bf16_smem() {
  // K, V, Q, dO tiles, then lse and Delta of the q tile
  return (2 * kMmaTile + 2 * BQ) * (D + 8) * 2 + 2 * BQ * 4;
}

template <int D, int BQ, int NSPLIT>
__global__ void __launch_bounds__(128 * NSPLIT)
    flash_bwd_dkv_bf16_kernel(const BwdParams p) {
  constexpr int BK = kMmaTile, LD = D + 8, NT = BQ / 8;
  constexpr int DW = D / NSPLIT, DT = DW / 8, NTH = 128 * NSPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD);
  float* dlt_s = lse_s + BQ;
  const unsigned short* Qu = reinterpret_cast<const unsigned short*>(Qs);
  const unsigned short* dOu = reinterpret_cast<const unsigned short*>(dOs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * DW;
  const int kt = blockIdx.x;  // heaviest causal tiles (the first) first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int k0 = kt * BK;
  const __nv_bfloat16* qg =
      head<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, bi, hi);
  const __nv_bfloat16* kg =
      head<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, bi, hi);
  const __nv_bfloat16* vg =
      head<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, bi, hi);
  const __nv_bfloat16* og =
      head<__nv_bfloat16>(p.dout, p.o_sb, p.o_sh, bi, hi);
  copy_rows<D>(Ks, LD, kg, p.k_st, k0, BK, tid, NTH);
  copy_rows<D>(Vs, LD, vg, p.v_st, k0, BK, tid, NTH);

  const float scale = 1.0f / sqrtf((float)D);
  const int krow0 = k0 + wr + g, krow1 = krow0 + 8;
  const long long rb = (long long)bh * p.T;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // q tiles from the one holding the diagonal (start_q of the TPU kernel)
  const int qt0 = p.causal ? k0 / BQ : 0;
  for (int qt = qt0; qt < p.T / BQ; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile is consumed
    copy_rows<D>(Qs, LD, qg, p.q_st, q0, BQ, tid, NTH);
    copy_rows<D>(dOs, LD, og, p.o_st, q0, BQ, tid, NTH);
    if (tid < BQ)
      lse_s[tid] = p.lse[rb + q0 + tid];
    else if (tid < 2 * BQ)
      dlt_s[tid - BQ] = p.delta[rb + q0 + tid - BQ];
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (f32); rows are keys, columns queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], av[4], b[2];
      load_a(Ks, LD, wr, kc * 16, g, c, a);
      load_a(Vs, LD, wr, kc * 16, g, c, av);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b_rows(Qs, LD, j * 8, kc * 16, g, c, b);
        mma_bf16(s[j], a, b);
        b_rows(dOs, LD, j * 8, kc * 16, g, c, b);
        mma_bf16(dp[j], av, b);
      }
    }

    // P^T (kept in s) and dS^T (kept in dp); lse and Delta by column
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * c + (e & 1);
        const bool masked =
            p.causal && q0 + qc < (e < 2 ? krow0 : krow1);
        const float pv =
            masked ? 0.f : expf(s[j][e] * scale - lse_s[qc]);
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - dlt_s[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, A as hi + lo bf16, dO and Q read
    // down their columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ph[4], pl[4], dh[4], dl[4], b[2];
      acc_to_a(s[2 * kc], s[2 * kc + 1], ph, pl);
      acc_to_a(dp[2 * kc], dp[2 * kc + 1], dh, dl);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        b_cols(dOu, LD, kc * 16, wc + j * 8, g, c, b);
        mma_bf16(dv[j], ph, b);
        mma_bf16(dv[j], pl, b);
        b_cols(Qu, LD, kc * 16, wc + j * 8, g, c, b);
        mma_bf16(dk[j], dh, b);
        mma_bf16(dk[j], dl, b);
      }
    }
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv);
  const long long ob0 = out_row(p, bi, hi, krow0, D);
  const long long ob1 = out_row(p, bi, hi, krow1, D);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = wc + j * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(&dkg[ob0 + col]) =
        pack_bf16(__float2bfloat16_rn(dk[j][0] * scale),
                  __float2bfloat16_rn(dk[j][1] * scale));
    *reinterpret_cast<uint32_t*>(&dkg[ob1 + col]) =
        pack_bf16(__float2bfloat16_rn(dk[j][2] * scale),
                  __float2bfloat16_rn(dk[j][3] * scale));
    *reinterpret_cast<uint32_t*>(&dvg[ob0 + col]) = pack_bf16(
        __float2bfloat16_rn(dv[j][0]), __float2bfloat16_rn(dv[j][1]));
    *reinterpret_cast<uint32_t*>(&dvg[ob1 + col]) = pack_bf16(
        __float2bfloat16_rn(dv[j][2]), __float2bfloat16_rn(dv[j][3]));
  }
}

// ----------------------------------------------------------------- f32
// One block: 128 threads, 32 rows; a quad of 4 threads shares a row.
// Thread (r, c) computes the row's S and dP at columns c + 4i and its
// outputs at columns c + 4j.
constexpr int kSimtRows = 32;
constexpr int kSimtThreads = 128;

template <int D>
constexpr int dq_f32_smem() {
  // Q, dO, K, V [32][D+1], dS [32][33]
  return 4 * (4 * kSimtRows * (D + 1) + kSimtRows * (kSimtRows + 1));
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = D + 1, LP = BK + 1;
  constexpr int NS = BK / 4, NO = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LQ;
  float* Ks = dOs + BQ * LQ;
  float* Vs = Ks + BK * LQ;
  float* dSs = Vs + BK * LQ;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * BQ, row = q0 + r;
  const float* qg = head<float>(p.q, p.q_sb, p.q_sh, bi, hi);
  const float* kg = head<float>(p.k, p.k_sb, p.k_sh, bi, hi);
  const float* vg = head<float>(p.v, p.v_sb, p.v_sh, bi, hi);
  const float* og = head<float>(p.dout, p.o_sb, p.o_sh, bi, hi);
  copy_rows<D>(Qs, LQ, qg, p.q_st, q0, BQ, tid, kSimtThreads);
  copy_rows<D>(dOs, LQ, og, p.o_st, q0, BQ, tid, kSimtThreads);

  const float scale = 1.0f / sqrtf((float)D);
  const long long rb = (long long)bh * p.T;
  const float lse = p.lse[rb + row], dlt = p.delta[rb + row];
  float dq[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j] = 0.f;

  const int n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.T / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    copy_rows<D>(Ks, LQ, kg, p.k_st, k0, BK, tid, kSimtThreads);
    copy_rows<D>(Vs, LQ, vg, p.v_st, k0, BK, tid, kSimtThreads);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r * LQ + dd], ov = dOs[r * LQ + dd];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = fmaf(qv, Ks[(c + 4 * i) * LQ + dd], s[i]);
        dp[i] = fmaf(ov, Vs[(c + 4 * i) * LQ + dd], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool masked = p.causal && k0 + c + 4 * i > row;
      const float pv = masked ? 0.f : expf(s[i] * scale - lse);
      dSs[r * LP + c + 4 * i] = pv * (dp[i] - dlt);
    }
    __syncwarp();  // the row's dS comes from the 4 lanes of this quad
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dSs[r * LP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j)
        dq[j] = fmaf(ds, Ks[kk * LQ + c + 4 * j], dq[j]);
    }
  }

  float* dqg = static_cast<float*>(p.dq) + out_row(p, bi, hi, row, D);
#pragma unroll
  for (int j = 0; j < NO; ++j) dqg[c + 4 * j] = dq[j] * scale;
}

template <int D>
constexpr int dkv_f32_smem() {
  // K, V, Q, dO [32][D+1], lse and Delta [32], P^T and dS^T [32][33]
  return 4 * (4 * kSimtRows * (D + 1) + 2 * kSimtRows +
              2 * kSimtRows * (kSimtRows + 1));
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dkv_f32_kernel(const BwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = D + 1, LP = BQ + 1;
  constexpr int NS = BQ / 4, NO = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LQ;
  float* Qs = Vs + BK * LQ;
  float* dOs = Qs + BQ * LQ;
  float* lse_s = dOs + BQ * LQ;
  float* dlt_s = lse_s + BQ;
  float* Ps = dlt_s + BQ;
  float* dSs = Ps + BK * LP;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int k0 = kt * BK, krow = k0 + r;
  const float* qg = head<float>(p.q, p.q_sb, p.q_sh, bi, hi);
  const float* kg = head<float>(p.k, p.k_sb, p.k_sh, bi, hi);
  const float* vg = head<float>(p.v, p.v_sb, p.v_sh, bi, hi);
  const float* og = head<float>(p.dout, p.o_sb, p.o_sh, bi, hi);
  copy_rows<D>(Ks, LQ, kg, p.k_st, k0, BK, tid, kSimtThreads);
  copy_rows<D>(Vs, LQ, vg, p.v_st, k0, BK, tid, kSimtThreads);

  const float scale = 1.0f / sqrtf((float)D);
  const long long rb = (long long)bh * p.T;
  float dk[NO], dv[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dk[j] = dv[j] = 0.f;

  const int qt0 = p.causal ? k0 / BQ : 0;
  for (int qt = qt0; qt < p.T / BQ; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    copy_rows<D>(Qs, LQ, qg, p.q_st, q0, BQ, tid, kSimtThreads);
    copy_rows<D>(dOs, LQ, og, p.o_st, q0, BQ, tid, kSimtThreads);
    if (tid < BQ)
      lse_s[tid] = p.lse[rb + q0 + tid];
    else if (tid < 2 * BQ)
      dlt_s[tid - BQ] = p.delta[rb + q0 + tid - BQ];
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float kv = Ks[r * LQ + dd], vv = Vs[r * LQ + dd];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = fmaf(kv, Qs[(c + 4 * i) * LQ + dd], s[i]);
        dp[i] = fmaf(vv, dOs[(c + 4 * i) * LQ + dd], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qc = c + 4 * i;
      const bool masked = p.causal && q0 + qc < krow;
      const float pv = masked ? 0.f : expf(s[i] * scale - lse_s[qc]);
      Ps[r * LP + qc] = pv;
      dSs[r * LP + qc] = pv * (dp[i] - dlt_s[qc]);
    }
    __syncwarp();  // the row's P^T and dS^T come from this quad
    for (int qq = 0; qq < BQ; ++qq) {
      const float pv = Ps[r * LP + qq], ds = dSs[r * LP + qq];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        dv[j] = fmaf(pv, dOs[qq * LQ + c + 4 * j], dv[j]);
        dk[j] = fmaf(ds, Qs[qq * LQ + c + 4 * j], dk[j]);
      }
    }
  }

  const long long ob = out_row(p, bi, hi, krow, D);
  float* dkg = static_cast<float*>(p.dk) + ob;
  float* dvg = static_cast<float*>(p.dv) + ob;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    dkg[c + 4 * j] = dk[j] * scale;
    dvg[c + 4 * j] = dv[j];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int rows, int threads, int smem,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.T / rows, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      int B, int T, int H, int causal, const long long* st) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_sb = st[0], p.q_st = st[1], p.q_sh = st[2];
  p.k_sb = st[3], p.k_st = st[4], p.k_sh = st[5];
  p.v_sb = st[6], p.v_st = st[7], p.v_sh = st[8];
  p.o_sb = st[9], p.o_st = st[10], p.o_sh = st[11];
  p.B = B, p.T = T, p.H = H;
  p.causal = causal;
  return p;
}

}  // namespace

// q/k/v/dout: [B, T, H, D] with the given (batch, seq, head) strides in
// elements (q, k, v, dout in that order) and unit stride over D; lse and
// delta: [B, H, T] f32 contiguous; outputs: [B, T, H, D] contiguous in the
// input dtype. dtype: 0 = f32, 1 = bf16. The caller guarantees D in
// {128, 256}, T % 64 == 0 and 16-byte aligned rows. Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int vtp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int T,
                                int H, int D, int dtype, int causal,
                                const long long* strides, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, T, H, causal,
                            strides);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dq_bf16_kernel<128, 64, 1>, kMmaTile, 128,
                  dq_bf16_smem<128, 64>(), p, s);
  if (dtype == 1 && D == 256)
    return launch(flash_bwd_dq_bf16_kernel<256, 64, 2>, kMmaTile, 256,
                  dq_bf16_smem<256, 64>(), p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dq_f32_kernel<128>, kSimtRows, kSimtThreads,
                  dq_f32_smem<128>(), p, s);
  if (dtype == 0 && D == 256)
    return launch(flash_bwd_dq_f32_kernel<256>, kSimtRows, kSimtThreads,
                  dq_f32_smem<256>(), p, s);
  return cudaErrorInvalidValue;
}

extern "C" int vtp_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int T, int H,
                                 int D, int dtype, int causal,
                                 const long long* strides, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, T, H, causal,
                            strides);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dkv_bf16_kernel<128, 32, 1>, kMmaTile, 128,
                  dkv_bf16_smem<128, 32>(), p, s);
  if (dtype == 1 && D == 256)
    return launch(flash_bwd_dkv_bf16_kernel<256, 32, 2>, kMmaTile, 256,
                  dkv_bf16_smem<256, 32>(), p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dkv_f32_kernel<128>, kSimtRows, kSimtThreads,
                  dkv_f32_smem<128>(), p, s);
  if (dtype == 0 && D == 256)
    return launch(flash_bwd_dkv_f32_kernel<256>, kSimtRows, kSimtThreads,
                  dkv_f32_smem<256>(), p, s);
  return cudaErrorInvalidValue;
}
