// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// a dQ kernel and a dK/dV kernel.
//
// Replaces: volcano_tpu/workloads/ops/flash_attention.py:_bwd_dq_kernel
// (TPU grid (b*h, t/block_q_bwd)) and :_bwd_dkv_kernel (TPU grid
// (b*h, t/block_k_bwd)), both launched by _flash_bh_bwd, and the jnp
// Delta that _flash_bh_bwd computes before them.
//
// What they compute, as the TPU kernels do, all in f32: with
// scale = rsqrt(d), S = scale * Q K^T (masked scores -1e30),
// P = exp(S - lse) with masked p exactly 0, dP = dO V^T and
// dS = P o (dP - Delta), where lse [b, h, t] is what the forward kernel
// wrote and Delta = rowsum(dO o O) [b, h, t]:
//   vtp_flash_bwd_dq:   dQ = scale * dS K, and Delta, which it writes
//   vtp_flash_bwd_dkv:  dK = scale * dS^T Q,  dV = P^T dO, on that Delta
//
// What bounds them on an H100: at the training shape (b*h = 128,
// t = 2048, d = 128, bf16, causal) dQ does 3 products of 2d FLOP (S, dP,
// dQ) and dK/dV 4 (S, dP, dV, dK) per unmasked (q, k) pair, over
// b*h*t(t+1)/2 pairs: 2.06e11 and 2.75e11 FLOP against 6 tensors of
// 67 MB moved each (dQ: q, k, v, dO, O read, dq written; dK/dV: q, k, v,
// dO read, dk, dv written), 500-700 FLOP a byte, above the card's ~295
// FLOP/byte ridge: both are bound by the tensor cores' rate, 0.209 and
// 0.278 ms at 989 TFLOP/s.
//
// Both kernels: as on the TPU, one block owns one q tile (dQ) or one k
// tile (dK/dV) of one (batch, head) and nothing is shared between blocks:
// no atomics, no reduction across blocks, sums in a fixed order. The
// TPU's sequential grid axis becomes the tile loop inside the block.
// Causal tiles past the diagonal are skipped and the heaviest tiles start
// first: the last q tiles for dQ, the first k tiles for dK/dV. P and dS
// are f32 and enter the second products as one bf16 term each: a hi +
// lo split (16 significant bits) also held the bf16 tolerance at every
// case of chip_smoke.py, and one term uses at most about half of it and
// saves the lo products (dK/dV 37%, dQ 25% of the kernel's time; both
// variants' errors and times: PERF.md).
//
// The bf16 kernels (wgmma + TMA, warp-specialised):
//  * A block of 384 threads: two consumer warpgroups and one producer
//    warpgroup, of which one thread issues every load; setmaxnreg gives
//    the consumers 232 registers and the producer 40.
//  * TMA brings the block's resident tiles in once and streams the others
//    through a ring of stages with full and empty mbarriers; tiles are
//    128-byte swizzled 64-column panels read by stride from [b, t, h, d]
//    (hopper_common.cuh). A consumer skips a tile wholly past its rows.
//  * The first two products (S and dP, or S^T and dP^T) are wgmmas with
//    both operands in shared memory (K-major); the second pair take A
//    from registers (the converted dS, or P^T and dS^T, accumulators) and
//    B from shared memory with the transpose bit: the 128-byte-swizzled
//    tile serves both products, with no gathers.
//  * Keep trap / __trap / assert out of the consumer path (see mbar_wait
//    in hopper_common.cuh): it makes ptxas spill the accumulators and run
//    every wgmma alone.
//  * What they give up: no overlap inside a warpgroup of its elementwise
//    work with its products; outputs written from registers, not through
//    a TMA store.
//
// dQ, bf16: the block owns 128 q rows, 64 a consumer warpgroup. Q and dO
// come in once; K/V tiles of 64 rows (32 at d = 256) stream from key 0
// up to the diagonal through a 3-stage ring. S = Q K^T and dP = dO V^T
// are shared-memory wgmmas, dS = P o (dP - Delta) is computed on their
// accumulators with P = exp2 in the log2 domain (ex2.approx, scale *
// log2(e) folded in, masked p exactly 0 on the diagonal tile), and
// dQ += dS K is a register-A wgmma with K transposed by the descriptor.
// Registers: the dQ accumulator is 64 f32 a consumer thread per 128
// columns; S and dP are BK / 2 each, so at d = 256 (128 for dQ) the K/V
// tile is cut to 32 rows, which also keeps Q, dO and three stages within
// 227 KB of shared memory (160 KB at d = 128, 224 KB at d = 256).
// Delta: each consumer thread reduces its own two rows' dO o O before its
// first dS, O by plain 16-byte loads issued before it waits on the Q/dO
// TMA (so their latency hides behind it) and dO from the staged tile; a
// quad of threads shares a row. This needs no shared memory (there is no
// room for an O tile at d = 256) and no barrier between warpgroups, and
// it keeps the work off the producer warpgroup, whose 40 registers hold
// few loads in flight. The consumers write Delta [b, h, t] f32 for the
// dK/dV kernel, which loads it by TMA.
//
// dK/dV, bf16: at d = 128 the block owns 128 k rows, 64 a consumer
// warpgroup; at d = 256 the two dK + dV accumulators of 64 rows would not
// fit one warpgroup, so the block owns 64 k rows and each consumer
// warpgroup half of d's output columns, both computing the same S^T and
// dP^T. K and V come in once; (Q, dO, lse, Delta) q tiles of 64 rows
// stream through a ring of 3 (d = 128) or 2 (d = 256) stages, starting
// from the tile that holds the diagonal (start_q of the TPU kernel).
// S^T = K Q^T and dP^T = V dO^T put keys on a consumer's rows, so lse and
// Delta are read by column from the staged q tile. dK and dV are 128 f32
// a consumer thread, S^T and dP^T 64 more; their bf16 fragments replace
// them 16 columns at a time before the second pair of products.
//
// Any t, both bf16 kernels: the last q and k tiles may be partial. TMA
// fills the rows of q/k/v/dO past t with zeros and the columns of lse and
// Delta past t too (their rows have a stride ld that is a multiple of 4,
// as TMA needs); keys past t are masked in dQ's P, and queries past t
// get a score of -inf in dK/dV's S^T (both on the partial tile only,
// under a uniform branch: a full tile pays nothing for it); O is read by
// plain loads only for rows below t; rows past t are never stored, nor
// are their Delta entries.
//
// d > 256 (any multiple of 128), and f32 at every d: CUDA-core kernels
// (flash_bwd_dq_simt_kernel, flash_bwd_dkv_simt_kernel) in full f32 (TF32
// would miss the f32 tolerance). A block owns 32 rows (q rows for dQ, k
// rows for dK/dV) and one 128-column panel of its outputs (grid.z walks
// the panels); it sums S and dP over the 128-column chunks of d, so each
// panel's block recomputes them, and keeps only its panel's accumulators.
// The dQ kernel writes Delta too (the block of panel 0). Speed at
// d > 256 is later work.
//
// q/k/v/dO/O are read in their [b, t, h, d] layout by stride; dQ/dK/dV are
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
  const void* out;     // the forward's output (dQ only)
  const float* lse;    // [B, H, T]
  float* delta;        // [B, H, T]: written by dQ, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // dout
  long long out_sb, out_st, out_sh;
  int B, T, H, D;
  int ld;  // row stride of lse and Delta
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
// Both bf16 kernels: 384 threads, warpgroups 0 and 1 consume, warpgroup 2
// produces.
constexpr int kBwdThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

// bf16x8 dot product in f32, added to acc
__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// dQ: a block owns 128 q rows, 64 a consumer warpgroup.
constexpr int kDqRows = 128;

template <int D>
struct DqTile {
  static constexpr int BK = D == 128 ? 64 : 32;  // k rows of a stage
  static constexpr int NS = 3;                   // stages of the ring
  static constexpr int Q_BYTES = kDqRows * D * 2;  // Q or dO
  static constexpr int KV_BYTES = BK * D * 2;      // K or V of one stage
  static constexpr int ST_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = ST_OFF + 2 * NS * KV_BYTES;
  // 1 KB of slack for the 1024-byte alignment, then the barriers
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * NS) * 8;
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const BwdParams p) {
  using Tile = DqTile<D>;
  constexpr int BQ = kDqRows, BK = Tile::BK, NS = Tile::NS, NP = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_align1k(smem_raw);
  unsigned char* dOs = Qs + Tile::Q_BYTES;
  unsigned char* Ks = Qs + Tile::ST_OFF;  // stage s: + s * KV_BYTES
  unsigned char* Vs = Ks + NS * Tile::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Qs + Tile::BAR_OFF);
  uint64_t* full = q_full + 1;  // [NS]: K and V of the stage landed
  uint64_t* empty = full + NS;  // [NS]: both consumers are done with it

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * BQ;
  // k tiles up to the diagonal (causal) or to t, the last one maybe partial
  const int k_end = p.causal ? min(q0 + BQ, p.T) : p.T;
  const int n_kt = (k_end + BK - 1) / BK;
  const int wg = warpgroup_idx();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_arrive_expect_tx(q_full, 2 * Tile::Q_BYTES);
      for (int pn = 0; pn < NP; ++pn) {
        tma_load_4d(Qs + pn * BQ * 128, &tm_q, q_full, 64 * pn, hi, q0, bi);
        tma_load_4d(dOs + pn * BQ * 128, &tm_do, q_full, 64 * pn, hi, q0, bi);
      }
      Ring<NS> ring;
      for (int kt = 0; kt < n_kt; ++kt, ring.advance()) {
        mbar_wait(&empty[ring.stage], ring.parity() ^ 1u);
        uint64_t* bar = &full[ring.stage];
        mbar_arrive_expect_tx(bar, 2 * Tile::KV_BYTES);
        unsigned char* ks = Ks + ring.stage * Tile::KV_BYTES;
        unsigned char* vs = Vs + ring.stage * Tile::KV_BYTES;
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_4d(ks + pn * BK * 128, &tm_k, bar, 64 * pn, hi, kt * BK,
                      bi);
          tma_load_4d(vs + pn * BK * 128, &tm_v, bar, 64 * pn, hi, kt * BK,
                      bi);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const int tr0 = 64 * wg + 16 * warp + g;  // tile rows tr0 and tr0 + 8
    const int row0 = q0 + tr0, row1 = row0 + 8;
    const int first_row = q0 + 64 * wg, last_row = first_row + 63;
    const float scale = 1.0f / sqrtf((float)D);
    const float sl2 = scale * kLog2e;
    const long long rb = (long long)bh * p.ld;
    const bool in0 = row0 < p.T, in1 = row1 < p.T;  // rows past t: not stored
    const float ll[2] = {in0 ? p.lse[rb + row0] * kLog2e : 0.f,
                         in1 ? p.lse[rb + row1] * kLog2e : 0.f};
    // the last key each row sees: its own (causal) and t - 1
    const int lim[2] = {p.causal ? min(row0, p.T - 1) : p.T - 1,
                        p.causal ? min(row1, p.T - 1) : p.T - 1};

    // Delta = rowsum(dO o O) of rows row0 and row1 in f32. A quad shares
    // a row; thread c takes the 16-byte chunks c and c + 4 of every
    // 64-column panel. O comes by plain loads, issued before any wait so
    // they overlap the TMA of Q and dO; dO from its staged tile, where
    // chunk j of tile row tr sits at chunk j ^ (tr % 8) = j ^ g.
    const __nv_bfloat16* og =
        head<__nv_bfloat16>(p.out, p.out_sb, p.out_sh, bi, hi);
    uint4 ov[2][NP][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ov[r][pn][u] = (r ? in1 : in0)
                             ? *reinterpret_cast<const uint4*>(
                                   og + (long long)(r ? row1 : row0) *
                                            p.out_st +
                                   64 * pn + 8 * (c + 4 * u))
                             : make_uint4(0u, 0u, 0u, 0u);
    mbar_wait(q_full, 0);
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned char* row = dOs + (tr0 + 8 * r) * 128;
      float acc = 0.f;
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          acc = dot_bf16x8(*reinterpret_cast<const uint4*>(
                               row + pn * BQ * 128 + ((c + 4 * u) ^ g) * 16),
                           ov[r][pn][u], acc);
      dlt[r] = quad_sum(acc);
    }
    if (c == 0) {
      if (in0) p.delta[rb + row0] = dlt[0];
      if (in1) p.delta[rb + row1] = dlt[1];
    }

    float dq[D / 128][64], s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) dq[h][i] = 0.f;
    const uint32_t da_q = desc_kmajor(Qs + wg * 64 * 128);
    const uint32_t da_do = desc_kmajor(dOs + wg * 64 * 128);

    Ring<NS> ring;
    for (int kt = 0; kt < n_kt; ++kt, ring.advance()) {
      const int k0 = kt * BK;
      mbar_wait(&full[ring.stage], ring.parity());
      if (!p.causal || k0 <= last_row) {
        unsigned char* ks = Ks + ring.stage * Tile::KV_BYTES;
        unsigned char* vs = Vs + ring.stage * Tile::KV_BYTES;
        const uint32_t db_k = desc_kmajor(ks), db_v = desc_kmajor(vs);

        // S = Q K^T, then dP = dO V^T: d / 16 steps of 16 columns, 4 a
        // 64-column panel; each accumulator's products are one commit
        // group
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * BK * 128 + (kk % 4) * 32;
          if (kk == 0)
            wgmma_ss_first<0>(s, desc_add(da_q, a), desc_add(db_k, b));
          else
            wgmma_ss<0>(s, desc_add(da_q, a), desc_add(db_k, b));
        }
        wgmma_commit();
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * BK * 128 + (kk % 4) * 32;
          if (kk == 0)
            wgmma_ss_first<0>(dp, desc_add(da_do, a), desc_add(db_v, b));
          else
            wgmma_ss<0>(dp, desc_add(da_do, a), desc_add(db_v, b));
        }
        wgmma_commit();
        fence_regs(dp);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // dS = P o (dP - Delta) with P = exp2(S scale log2(e) - lse
        // log2(e)), masked p exactly 0 (row0 at i % 4 = 0, 1, row1 at 2, 3)
        // on the diagonal tile and on a partial last tile, then its bf16 A
        // fragments, the keys [16kc, 16kc + 16) at a time
        const bool masking =
            (p.causal && k0 + BK - 1 > first_row) || k0 + BK > p.T;
        uint32_t ad[BK / 16][4];
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
          for (int i = 8 * kc; i < 8 * kc + 8; ++i) {
            const int r = (i >> 1) & 1;
            const bool masked =
                masking && k0 + 8 * (i / 4) + 2 * c + (i & 1) > lim[r];
            const float pv =
                masked ? 0.f : exp2_approx(fmaf(s[i], sl2, -ll[r]));
            s[i] = pv * (dp[i] - dlt[r]);
          }
          acc_to_a(&s[8 * kc], &s[8 * kc + 4], ad[kc]);
        }

        // dQ += dS K: 16 keys a step (+2048 bytes down K's rows), 128
        // output columns a product (two panels, BK * 128 bytes apart),
        // K transposed by the descriptor
        const uint32_t db_kt = desc_mnmajor(ks, BK * 128);
#pragma unroll
        for (int h = 0; h < D / 128; ++h) {
          fence_regs(dq[h]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < BK / 16; ++kc) {
            wgmma_rs<1>(dq[h], ad[kc],
                        desc_add(db_kt, h * 2 * BK * 128 + kc * 2048));
          }
          wgmma_commit();
          fence_regs(dq[h]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < D / 128; ++h) fence_regs(dq[h]);
      }
      mbar_arrive(&empty[ring.stage]);
    }

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq);
    const long long ob0 = out_row(p, bi, hi, row0, D);
    const long long ob1 = out_row(p, bi, hi, row1, D);
#pragma unroll
    for (int h = 0; h < D / 128; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * h + 8 * j + 2 * c;
        if (in0)
          *reinterpret_cast<uint32_t*>(&dqg[ob0 + col]) =
              pack_bf16(__float2bfloat16_rn(dq[h][4 * j] * scale),
                        __float2bfloat16_rn(dq[h][4 * j + 1] * scale));
        if (in1)
          *reinterpret_cast<uint32_t*>(&dqg[ob1 + col]) =
              pack_bf16(__float2bfloat16_rn(dq[h][4 * j + 2] * scale),
                        __float2bfloat16_rn(dq[h][4 * j + 3] * scale));
      }
    }
  }
}

template <int D>
cudaError_t launch_dq_bf16(const BwdParams& p, cudaStream_t stream) {
  using Tile = DqTile<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = map_bthd(&tq, p.q, p.B, p.T, p.H, D, p.q_sb, p.q_st,
                             p.q_sh, kDqRows);
  if (err == cudaSuccess)
    err = map_bthd(&tk, p.k, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                   Tile::BK);
  if (err == cudaSuccess)
    err = map_bthd(&tv, p.v, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                   Tile::BK);
  if (err == cudaSuccess)
    err = map_bthd(&tdo, p.dout, p.B, p.T, p.H, D, p.o_sb, p.o_st, p.o_sh,
                   kDqRows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + kDqRows - 1) / kDqRows, p.B * p.H);
  flash_bwd_dq_bf16_kernel<D><<<grid, kBwdThreads, Tile::SMEM, stream>>>(
      tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// dK/dV: a block owns 128 k rows at d = 128 and 64 at d = 256.
constexpr int kDkvQRows = 64;  // q rows of a stage

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
__global__ void __launch_bounds__(kBwdThreads, 1)
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
  const int n_qt = (p.T + BQ - 1) / BQ - qt0;  // the last one maybe partial
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
        // queries past t on a partial last tile: -inf, so their p is 0
        if (q0 + BQ > p.T) {
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i)
            if (q0 + 8 * (i / 4) + 2 * c + (i & 1) >= p.T) st[i] = -INFINITY;
        }
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
    const bool in0 = krow0 < p.T, in1 = krow1 < p.T;  // rows past t: not stored
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * cw + 8 * j + 2 * c;
      if (in0) {
        *reinterpret_cast<uint32_t*>(&dkg[ob0 + col]) =
            pack_bf16(__float2bfloat16_rn(dk[4 * j] * scale),
                      __float2bfloat16_rn(dk[4 * j + 1] * scale));
        *reinterpret_cast<uint32_t*>(&dvg[ob0 + col]) =
            pack_bf16(__float2bfloat16_rn(dv[4 * j]),
                      __float2bfloat16_rn(dv[4 * j + 1]));
      }
      if (in1) {
        *reinterpret_cast<uint32_t*>(&dkg[ob1 + col]) =
            pack_bf16(__float2bfloat16_rn(dk[4 * j + 2] * scale),
                      __float2bfloat16_rn(dk[4 * j + 3] * scale));
        *reinterpret_cast<uint32_t*>(&dvg[ob1 + col]) =
            pack_bf16(__float2bfloat16_rn(dv[4 * j + 2]),
                      __float2bfloat16_rn(dv[4 * j + 3]));
      }
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
    err = map_rows_f32(&tl, p.lse, p.B * p.H, p.T, p.ld, kDkvQRows);
  if (err == cudaSuccess)
    err = map_rows_f32(&td, p.delta, p.B * p.H, p.T, p.ld, kDkvQRows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + Tile::BK - 1) / Tile::BK, p.B * p.H);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kBwdThreads, Tile::SMEM, stream>>>(
      tq, tk, tv, tdo, tl, td, p);
  return cudaGetLastError();
}

// ----------------------------------------------------------- CUDA cores
// f32 at every d, bf16 at d > 256. grid (ceil(t / 32), b * h, d / 128): a
// block of 128 threads owns 32 rows and the 128-column panel blockIdx.z of
// its outputs; a quad of 4 threads shares a row, thread (r, c) computes
// the row's S and dP at columns c + 4i and its outputs at panel columns
// c + 4j.
constexpr int kDqSimtSmem =
    4 * (4 * kSimtRows * kPanelLd + kSimtRows * (kSimtRows + 1));

template <typename E>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dq_simt_kernel(const BwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = kPanelLd, LP = BK + 1;
  constexpr int NS = BK / 4, NO = kPanel / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // 128-column chunks
  float* dOs = Qs + BQ * LQ;
  float* Ks = dOs + BQ * LQ;  // then the block's panel of K
  float* Vs = Ks + BK * LQ;
  float* dSs = Vs + BK * LQ;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int c0 = blockIdx.z * kPanel, n_ch = p.D / kPanel;
  const int q0 = qt * BQ, row = q0 + r;
  const bool in = row < p.T;
  const int lim = p.causal ? min(row, p.T - 1) : p.T - 1;
  const E* qg = head<E>(p.q, p.q_sb, p.q_sh, bi, hi);
  const E* kg = head<E>(p.k, p.k_sb, p.k_sh, bi, hi);
  const E* vg = head<E>(p.v, p.v_sb, p.v_sh, bi, hi);
  const E* dog = head<E>(p.dout, p.o_sb, p.o_sh, bi, hi);
  const E* outg = head<E>(p.out, p.out_sb, p.out_sh, bi, hi);

  // Delta = rowsum(dO o O) of this row over all of d, a quad sharing it
  float part = 0.f;
  if (in)
    for (int j = c; j < p.D; j += 4)
      part = fmaf(to_f32(dog[(long long)row * p.o_st + j]),
                  to_f32(outg[(long long)row * p.out_st + j]), part);
  const float dlt = quad_sum(part);
  const float scale = 1.0f / sqrtf((float)p.D);
  const long long rb = (long long)bh * p.ld;
  if (blockIdx.z == 0 && c == 0 && in) p.delta[rb + row] = dlt;
  const float lse = in ? p.lse[rb + row] : 0.f;
  float dq[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j] = 0.f;

  const int k_end = p.causal ? min(q0 + BQ, p.T) : p.T;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();  // the previous chunk (or tile) is consumed
      if (n_ch > 1 || kt == 0) {  // one chunk: Q, dO stay from the first tile
        load_panel(Qs, qg, p.q_st, q0, ch * kPanel, p.T, tid);
        load_panel(dOs, dog, p.o_st, q0, ch * kPanel, p.T, tid);
      }
      load_panel(Ks, kg, p.k_st, k0, ch * kPanel, p.T, tid);
      load_panel(Vs, vg, p.v_st, k0, ch * kPanel, p.T, tid);
      __syncthreads();
      for (int dd = 0; dd < kPanel; ++dd) {
        const float qv = Qs[r * LQ + dd], ov = dOs[r * LQ + dd];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = fmaf(qv, Ks[(c + 4 * i) * LQ + dd], s[i]);
          dp[i] = fmaf(ov, Vs[(c + 4 * i) * LQ + dd], dp[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool masked = k0 + c + 4 * i > lim;  // causal, and keys past t
      const float pv = masked ? 0.f : expf(s[i] * scale - lse);
      dSs[r * LP + c + 4 * i] = pv * (dp[i] - dlt);
    }
    if (n_ch > 1) {  // one chunk: K's chunk is the panel
      __syncthreads();
      load_panel(Ks, kg, p.k_st, k0, c0, p.T, tid);
    }
    __syncthreads();  // K's panel, and the row's dS from its quad
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dSs[r * LP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j)
        dq[j] = fmaf(ds, Ks[kk * LQ + c + 4 * j], dq[j]);
    }
  }

  if (!in) return;
  E* dqg = static_cast<E*>(p.dq) + out_row(p, bi, hi, row, p.D) + c0;
#pragma unroll
  for (int j = 0; j < NO; ++j) store_f32(&dqg[c + 4 * j], dq[j] * scale);
}

constexpr int kDkvSimtSmem = 4 * (4 * kSimtRows * kPanelLd + 2 * kSimtRows +
                                  2 * kSimtRows * (kSimtRows + 1));

template <typename E>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dkv_simt_kernel(const BwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = kPanelLd, LP = BQ + 1;
  constexpr int NS = BQ / 4, NO = kPanel / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // 128-column chunks
  float* Vs = Ks + BK * LQ;
  float* Qs = Vs + BK * LQ;  // chunks, then the block's panels of Q, dO
  float* dOs = Qs + BQ * LQ;
  float* lse_s = dOs + BQ * LQ;
  float* dlt_s = lse_s + BQ;
  float* Ps = dlt_s + BQ;
  float* dSs = Ps + BK * LP;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int c0 = blockIdx.z * kPanel, n_ch = p.D / kPanel;
  const int k0 = blockIdx.x * BK, krow = k0 + r;
  const E* qg = head<E>(p.q, p.q_sb, p.q_sh, bi, hi);
  const E* kg = head<E>(p.k, p.k_sb, p.k_sh, bi, hi);
  const E* vg = head<E>(p.v, p.v_sb, p.v_sh, bi, hi);
  const E* dog = head<E>(p.dout, p.o_sb, p.o_sh, bi, hi);

  const float scale = 1.0f / sqrtf((float)p.D);
  const long long rb = (long long)bh * p.ld;
  float dk[NO], dv[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) dk[j] = dv[j] = 0.f;

  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_qt = (p.T + BQ - 1) / BQ;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();  // the previous chunk (or tile) is consumed
      if (n_ch > 1 || qt == qt0) {  // one chunk: K, V stay from the first
        load_panel(Ks, kg, p.k_st, k0, ch * kPanel, p.T, tid);
        load_panel(Vs, vg, p.v_st, k0, ch * kPanel, p.T, tid);
      }
      load_panel(Qs, qg, p.q_st, q0, ch * kPanel, p.T, tid);
      load_panel(dOs, dog, p.o_st, q0, ch * kPanel, p.T, tid);
      if (ch == 0 && tid < 2 * BQ) {
        const int q = q0 + tid % BQ;
        const float* src = tid < BQ ? p.lse : p.delta;
        (tid < BQ ? lse_s : dlt_s)[tid % BQ] = q < p.T ? src[rb + q] : 0.f;
      }
      __syncthreads();
      for (int dd = 0; dd < kPanel; ++dd) {
        const float kv = Ks[r * LQ + dd], vv = Vs[r * LQ + dd];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = fmaf(kv, Qs[(c + 4 * i) * LQ + dd], s[i]);
          dp[i] = fmaf(vv, dOs[(c + 4 * i) * LQ + dd], dp[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qc = c + 4 * i;
      // causal, and queries past t
      const bool masked = (p.causal && q0 + qc < krow) || q0 + qc >= p.T;
      const float pv = masked ? 0.f : expf(s[i] * scale - lse_s[qc]);
      Ps[r * LP + qc] = pv;
      dSs[r * LP + qc] = pv * (dp[i] - dlt_s[qc]);
    }
    if (n_ch > 1) {  // one chunk: Q's and dO's chunks are the panels
      __syncthreads();
      load_panel(Qs, qg, p.q_st, q0, c0, p.T, tid);
      load_panel(dOs, dog, p.o_st, q0, c0, p.T, tid);
    }
    __syncthreads();  // the panels, and the row's P^T and dS^T from its quad
    for (int qq = 0; qq < BQ; ++qq) {
      const float pv = Ps[r * LP + qq], ds = dSs[r * LP + qq];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        dv[j] = fmaf(pv, dOs[qq * LQ + c + 4 * j], dv[j]);
        dk[j] = fmaf(ds, Qs[qq * LQ + c + 4 * j], dk[j]);
      }
    }
  }

  if (krow >= p.T) return;  // rows past t are not stored
  const long long ob = out_row(p, bi, hi, krow, p.D) + c0;
  E* dkg = static_cast<E*>(p.dk) + ob;
  E* dvg = static_cast<E*>(p.dv) + ob;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    store_f32(&dkg[c + 4 * j], dk[j] * scale);
    store_f32(&dvg[c + 4 * j], dv[j]);
  }
}

template <typename Kernel>
cudaError_t launch_simt(Kernel kernel, int smem, const BwdParams& p,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + kSimtRows - 1) / kSimtRows, p.B * p.H, p.D / kPanel);
  kernel<<<grid, kSimtThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, void* delta, int B,
                      int T, int H, int D, int ld, int causal,
                      const long long* st) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.q_sb = st[0], p.q_st = st[1], p.q_sh = st[2];
  p.k_sb = st[3], p.k_st = st[4], p.k_sh = st[5];
  p.v_sb = st[6], p.v_st = st[7], p.v_sh = st[8];
  p.o_sb = st[9], p.o_st = st[10], p.o_sh = st[11];
  p.B = B, p.T = T, p.H = H, p.D = D;
  p.ld = ld;
  p.causal = causal;
  return p;
}

}  // namespace

// q/k/v/dout (and out, for dQ): [B, T, H, D] with the given (batch, seq,
// head) strides in elements (in that order, 3 a tensor) and unit stride
// over D; lse and delta: [B, H, T] f32 with row stride ld; dq/dk/dv:
// [B, T, H, D] contiguous in the input dtype. dtype: 0 = f32, 1 = bf16.
// The caller guarantees T >= 1, D a positive multiple of 128, ld >= T a
// multiple of 4, 16-byte aligned starts and (batch, seq, head) strides
// that are multiples of 16 bytes. Each returns cudaGetLastError() after
// its launch (0 on success).
//
// dQ, and Delta = rowsum(dO o O) into `delta` for the dK/dV kernel.
extern "C" int vtp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* out,
                                const void* lse, void* delta, void* dq,
                                int B, int T, int H, int D, int ld, int dtype,
                                int causal, const long long* strides,
                                void* stream) {
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return err;
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, T, H, D, ld,
                            causal, strides);
  p.out = out;
  p.out_sb = strides[12], p.out_st = strides[13], p.out_sh = strides[14];
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || D < kPanel || D % kPanel) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 128) return launch_dq_bf16<128>(p, s);
  if (dtype == 1 && D == 256) return launch_dq_bf16<256>(p, s);
  if (dtype == 1)
    return launch_simt(flash_bwd_dq_simt_kernel<__nv_bfloat16>, kDqSimtSmem,
                       p, s);
  if (dtype == 0)
    return launch_simt(flash_bwd_dq_simt_kernel<float>, kDqSimtSmem, p, s);
  return cudaErrorInvalidValue;
}

// dK and dV, on the Delta that dQ wrote.
extern "C" int vtp_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, void* delta,
                                 void* dk, void* dv, int B, int T, int H,
                                 int D, int ld, int dtype, int causal,
                                 const long long* strides, void* stream) {
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return err;
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, T, H, D, ld,
                            causal, strides);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || D < kPanel || D % kPanel) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 128) return launch_dkv_bf16<128>(p, s);
  if (dtype == 1 && D == 256) return launch_dkv_bf16<256>(p, s);
  if (dtype == 1)
    return launch_simt(flash_bwd_dkv_simt_kernel<__nv_bfloat16>,
                       kDkvSimtSmem, p, s);
  if (dtype == 0)
    return launch_simt(flash_bwd_dkv_simt_kernel<float>, kDkvSimtSmem, p, s);
  return cudaErrorInvalidValue;
}
