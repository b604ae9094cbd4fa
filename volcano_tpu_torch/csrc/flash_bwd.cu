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
// What bounds them on an H100: at the training shape (b*h = 128,
// t = 2048, d = 128, bf16, causal) dQ does 3 products of 2d FLOP (S, dP,
// dQ) and dK/dV 4 (S, dP, dV, dK) per unmasked (q, k) pair, over
// b*h*t(t+1)/2 pairs: 2.06e11 and 2.75e11 FLOP against 5 and 6 tensors of
// 67 MB moved, 600-700 FLOP a byte, above the card's ~295 FLOP/byte
// ridge: both are bound by the tensor cores' rate, 0.209 and 0.278 ms at
// 989 TFLOP/s.
//
// Both kernels: as on the TPU, one block owns one q tile (dQ) or one k
// tile (dK/dV) of one (batch, head) and nothing is shared between blocks:
// no atomics, no reduction across blocks, sums in a fixed order. The
// TPU's sequential grid axis becomes the tile loop inside the block.
// Causal tiles past the diagonal are skipped and the heaviest tiles start
// first: the last q tiles for dQ, the first k tiles for dK/dV. P and dS
// are f32; dQ feeds dS to its product as two bf16 terms (hi + lo, 16
// significant bits, 4/3 of the needed tensor work), dK/dV feeds P and dS
// as one bf16 term each, which holds the same bf16 tolerance at every
// case of chip_smoke.py (errors of both variants: PERF.md).
//
// dK/dV, bf16 (wgmma + TMA, warp-specialised):
//  * A block of 384 threads: two consumer warpgroups and one producer
//    warpgroup, of which one thread issues every load; setmaxnreg gives
//    the consumers 232 registers and the producer 40. At d = 128 the block
//    owns 128 k rows, 64 a consumer warpgroup; at d = 256 the two dK + dV
//    accumulators of 64 rows would not fit one warpgroup, so the block
//    owns 64 k rows and each consumer warpgroup half of d's output
//    columns, both computing the same S^T and dP^T.
//  * TMA brings K and V in once and streams (Q, dO, lse, Delta) q tiles of
//    64 rows through a ring of 3 (d = 128) or 2 (d = 256) stages with full
//    and empty mbarriers, starting from the tile that holds the diagonal
//    (start_q of the TPU kernel). A consumer skips a tile wholly above its
//    own k rows.
//  * S^T = K Q^T and dP^T = V dO^T are wgmmas with both operands in
//    shared memory (K-major), so a consumer's rows are keys and lse and
//    Delta are read by column from the staged q tile.
//  * dV += P^T dO and dK += dS^T Q take A from registers (the converted
//    S^T / dS^T accumulators) and B = dO or Q from shared memory with the
//    transpose bit: the 128-byte-swizzled tile serves both products, with
//    no gathers.
//  * Registers: dK and dV are 128 f32 a consumer thread (64 rows x 128
//    columns each), S^T and dP^T 64 more; their bf16 fragments replace
//    them 16 columns at a time before the second pair of products. That
//    fits the consumers' 232 registers without a spill, as ptxas reports
//    in chip_smoke.py, as long as nothing in the consumer path traps (see
//    mbar_wait in hopper_common.cuh).
//  * What it gives up: no overlap inside a warpgroup of its elementwise
//    work with its products; dK and dV written from registers, not
//    through a TMA store.
//
// dQ, bf16 (mma.sync, not yet redesigned): a block of 4 warps (8 at
// d = 256, splitting d's output columns) owns 64 q rows and loads K/V
// tiles with plain 16-byte loads between __syncthreads(); K is gathered
// down its columns with 16-bit shared loads.
//
// f32, both kernels: CUDA-core FMAs in full f32 (TF32 would miss the f32
// tolerance), 32-row tiles, a quad of threads per row; only the parity
// checks use them.
//
// q/k/v/dO are read in their [b, t, h, d] layout by stride; dQ/dK/dV are
// written [b, t, h, d] contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
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
// dQ: a block has 128 * NSPLIT threads: warp w owns tile rows
// [16 (w % 4), 16 (w % 4) + 16) and output columns [DW (w / 4), + DW).
constexpr int kMmaTile = 64;  // q rows of a dQ block

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

// dK/dV: 384 threads, warpgroups 0 and 1 consume, warpgroup 2 produces.
constexpr int kDkvThreads = 384;
constexpr int kDkvQRows = 64;  // q rows of a stage
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvTile {
  static constexpr int NSPLIT = D / 128;   // warpgroups sharing k rows
  static constexpr int BK = 128 / NSPLIT;  // k rows of a block
  static constexpr int NS = D == 128 ? 3 : 2;
  static constexpr int KV_BYTES = BK * D * 2;         // K or V
  static constexpr int QT_BYTES = kDkvQRows * D * 2;  // Q or dO of a stage
  static constexpr int ROW_BYTES = kDkvQRows * 4;     // lse or Delta
  static constexpr int ST_OFF = 2 * KV_BYTES;
  static constexpr int ROW_OFF = ST_OFF + 2 * NS * QT_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 2 * NS * ROW_BYTES;
  // 1 KB of slack for the 1024-byte alignment, then the barriers
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * NS) * 8;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_lse,
                              const __grid_constant__ CUtensorMap tm_dlt,
                              const BwdParams p) {
  using Tile = DkvTile<D>;
  constexpr int BK = Tile::BK, BQ = kDkvQRows, NS = Tile::NS, NP = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = smem_align1k(smem_raw);
  unsigned char* Vs = Ks + Tile::KV_BYTES;
  unsigned char* Qs = Ks + Tile::ST_OFF;      // stage s: + s * QT_BYTES
  unsigned char* dOs = Qs + NS * Tile::QT_BYTES;
  float* lse_s = reinterpret_cast<float*>(Ks + Tile::ROW_OFF);  // [NS][BQ]
  float* dlt_s = lse_s + NS * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ks + Tile::BAR_OFF);
  uint64_t* full = kv_full + 1;  // [NS]: the stage's q tile landed
  uint64_t* empty = full + NS;   // [NS]: both consumers are done with it

  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int k0 = blockIdx.x * BK;  // heaviest causal tiles (the first) first
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_qt = p.T / BQ - qt0;
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(kv_full, 2 * Tile::KV_BYTES);
      for (int pn = 0; pn < NP; ++pn) {
        tma_load_4d(Ks + pn * BK * 128, &tm_k, kv_full, 64 * pn, hi, k0, bi);
        tma_load_4d(Vs + pn * BK * 128, &tm_v, kv_full, 64 * pn, hi, k0, bi);
      }
      Ring<NS> ring;
      for (int it = 0; it < n_qt; ++it, ring.advance()) {
        const int q0 = (qt0 + it) * BQ;
        mbar_wait(&empty[ring.stage], ring.parity() ^ 1u);
        uint64_t* bar = &full[ring.stage];
        mbar_arrive_expect_tx(bar, 2 * Tile::QT_BYTES + 2 * Tile::ROW_BYTES);
        unsigned char* qs = Qs + ring.stage * Tile::QT_BYTES;
        unsigned char* dos = dOs + ring.stage * Tile::QT_BYTES;
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_4d(qs + pn * BQ * 128, &tm_q, bar, 64 * pn, hi, q0, bi);
          tma_load_4d(dos + pn * BQ * 128, &tm_do, bar, 64 * pn, hi, q0, bi);
        }
        tma_load_2d(lse_s + ring.stage * BQ, &tm_lse, bar, q0, bh);
        tma_load_2d(dlt_s + ring.stage * BQ, &tm_dlt, bar, q0, bh);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const int rw = Tile::NSPLIT == 1 ? wg : 0;  // 64-row block of K and V
    const int cw = Tile::NSPLIT == 1 ? 0 : wg;  // 128-column block of dK, dV
    const int kw0 = k0 + 64 * rw;
    const int krow0 = kw0 + 16 * warp + g, krow1 = krow0 + 8;
    const float scale = 1.0f / sqrtf((float)D);
    const float sl2 = scale * kLog2e;
    float dk[64], dv[64], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t da_k = desc_kmajor(Ks + rw * 64 * 128);
    const uint32_t da_v = desc_kmajor(Vs + rw * 64 * 128);

    mbar_wait(kv_full, 0);
    Ring<NS> ring;
    for (int it = 0; it < n_qt; ++it, ring.advance()) {
      const int q0 = (qt0 + it) * BQ;
      mbar_wait(&full[ring.stage], ring.parity());
      if (!p.causal || q0 + BQ - 1 >= kw0) {
        unsigned char* qs = Qs + ring.stage * Tile::QT_BYTES;
        unsigned char* dos = dOs + ring.stage * Tile::QT_BYTES;
        const uint32_t db_q = desc_kmajor(qs), db_do = desc_kmajor(dos);

        // S^T = K Q^T, then dP^T = V dO^T: rows keys, columns queries;
        // each accumulator's products are one commit group
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // step kk: panel kk / 4, +32 bytes a step inside the panel
          const uint32_t a = (kk / 4) * BK * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          if (kk == 0)
            wgmma_ss_first<0>(st, desc_add(da_k, a), desc_add(db_q, b));
          else
            wgmma_ss<0>(st, desc_add(da_k, a), desc_add(db_q, b));
        }
        wgmma_commit();
        fence_regs(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * BK * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          if (kk == 0)
            wgmma_ss_first<0>(dpt, desc_add(da_v, a), desc_add(db_do, b));
          else
            wgmma_ss<0>(dpt, desc_add(da_v, a), desc_add(db_do, b));
        }
        wgmma_commit();
        fence_regs(dpt);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T with lse and Delta by column, then their bf16 A
        // fragments, 16 q columns [16kc, 16kc + 16) at a time so the f32
        // values of a chunk die as its fragments are made
        const float* lse = lse_s + ring.stage * BQ;
        const float* dlt = dlt_s + ring.stage * BQ;
        uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
          for (int j = 2 * kc; j < 2 * kc + 2; ++j) {
            // this thread's columns of block j: 8j + 2c and 8j + 2c + 1
            const float2 lj =
                *reinterpret_cast<const float2*>(&lse[8 * j + 2 * c]);
            const float2 dj =
                *reinterpret_cast<const float2*>(&dlt[8 * j + 2 * c]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e, qc = 8 * j + 2 * c + (e & 1);
              const bool masked =
                  p.causal && q0 + qc < ((e & 2) ? krow1 : krow0);
              const float lv = (e & 1) ? lj.y : lj.x;
              const float pv =
                  masked ? 0.f : exp2_approx(fmaf(st[i], sl2, -lv * kLog2e));
              st[i] = pv;
              dpt[i] = pv * (dpt[i] - ((e & 1) ? dj.y : dj.x));
            }
          }
          acc_to_a(&st[8 * kc], &st[8 * kc + 4], ap[kc]);
          acc_to_a(&dpt[8 * kc], &dpt[8 * kc + 4], ad[kc]);
        }

        // dV += P^T dO and dK += dS^T Q: 16 q rows a step (+2048 bytes),
        // the warpgroup's 128 columns (two panels, BQ * 128 bytes apart)
        const uint32_t db_dot =
            desc_mnmajor(dos + cw * 2 * BQ * 128, BQ * 128);
        const uint32_t db_qt = desc_mnmajor(qs + cw * 2 * BQ * 128, BQ * 128);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          wgmma_rs<1>(dv, ap[kc], desc_add(db_dot, kc * 2048));
        }
        wgmma_commit();
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          wgmma_rs<1>(dk, ad[kc], desc_add(db_qt, kc * 2048));
        }
        wgmma_commit();
        fence_regs(dk);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
      mbar_arrive(&empty[ring.stage]);
    }

    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk);
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv);
    const long long ob0 = out_row(p, bi, hi, krow0, D);
    const long long ob1 = out_row(p, bi, hi, krow1, D);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * cw + 8 * j + 2 * c;
      *reinterpret_cast<uint32_t*>(&dkg[ob0 + col]) =
          pack_bf16(__float2bfloat16_rn(dk[4 * j] * scale),
                    __float2bfloat16_rn(dk[4 * j + 1] * scale));
      *reinterpret_cast<uint32_t*>(&dkg[ob1 + col]) =
          pack_bf16(__float2bfloat16_rn(dk[4 * j + 2] * scale),
                    __float2bfloat16_rn(dk[4 * j + 3] * scale));
      *reinterpret_cast<uint32_t*>(&dvg[ob0 + col]) = pack_bf16(
          __float2bfloat16_rn(dv[4 * j]), __float2bfloat16_rn(dv[4 * j + 1]));
      *reinterpret_cast<uint32_t*>(&dvg[ob1 + col]) =
          pack_bf16(__float2bfloat16_rn(dv[4 * j + 2]),
                    __float2bfloat16_rn(dv[4 * j + 3]));
    }
  }
}

template <int D>
cudaError_t launch_dkv_bf16(const BwdParams& p, cudaStream_t stream) {
  using Tile = DkvTile<D>;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  cudaError_t err = map_bthd(&tq, p.q, p.B, p.T, p.H, D, p.q_sb, p.q_st,
                             p.q_sh, kDkvQRows);
  if (err == cudaSuccess)
    err = map_bthd(&tk, p.k, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                   Tile::BK);
  if (err == cudaSuccess)
    err = map_bthd(&tv, p.v, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                   Tile::BK);
  if (err == cudaSuccess)
    err = map_bthd(&tdo, p.dout, p.B, p.T, p.H, D, p.o_sb, p.o_st, p.o_sh,
                   kDkvQRows);
  if (err == cudaSuccess)
    err = map_rows_f32(&tl, p.lse, p.B * p.H, p.T, kDkvQRows);
  if (err == cudaSuccess)
    err = map_rows_f32(&td, p.delta, p.B * p.H, p.T, kDkvQRows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.T / Tile::BK, p.B * p.H);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kDkvThreads, Tile::SMEM, stream>>>(
      tq, tk, tv, tdo, tl, td, p);
  return cudaGetLastError();
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
// {128, 256}, T % 128 == 0, 16-byte aligned starts and (batch, seq, head)
// strides that are multiples of 16 bytes. Each returns
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
  if (dtype == 1 && D == 128) return launch_dkv_bf16<128>(p, s);
  if (dtype == 1 && D == 256) return launch_dkv_bf16<256>(p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dkv_f32_kernel<128>, kSimtRows, kSimtThreads,
                  dkv_f32_smem<128>(), p, s);
  if (dtype == 0 && D == 256)
    return launch(flash_bwd_dkv_f32_kernel<256>, kSimtRows, kSimtThreads,
                  dkv_f32_smem<256>(), p, s);
  return cudaErrorInvalidValue;
}
