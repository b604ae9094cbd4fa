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
// What bounds it on an H100: at the serving shape (b*h = 128, t = 2048,
// d = 128, bf16, causal) the work is 4*b*h*d*t(t+1)/2 = 1.4e11 FLOP
// against 4 * 67 MB of q/k/v/out, about 510 FLOP per byte, above the
// card's ~295 FLOP/byte ridge: the tensor cores' rate bounds it, 0.139 ms
// at 989 TFLOP/s.
//
// Design of the bf16 path (wgmma + TMA, warp-specialised):
//  * One block of 384 threads owns 128 q rows of one (batch, head): two
//    consumer warpgroups of 64 rows each and one producer warpgroup, of
//    which one thread issues every load. The producer gives its registers
//    to the consumers (setmaxnreg: 40 against 232).
//  * TMA brings Q in once and streams K/V tiles through a ring of
//    stages, each guarded by a full and an empty mbarrier; tiles are
//    128-byte swizzled 64-column panels read by stride from [b, t, h, d]
//    (hopper_common.cuh). K/V tiles are 128 rows at d = 128 and 64 at
//    d = 256, where the O accumulator alone takes 128 registers a thread
//    (shared memory: 160 and 192 KB a block).
//  * S = Q K^T is a wgmma with both operands in shared memory (K-major).
//    The online softmax runs on the accumulator fragments, in the log2
//    domain (ex2.approx with scale * log2(e) folded in), masked by the
//    wgmma accumulator layout.
//  * O += P V is a wgmma with A = P in registers, converted from the S
//    accumulator without a trip through shared memory, and B = V from
//    shared memory with the transpose bit (no gathers of V).
//  * Causal k tiles past the diagonal are neither loaded nor computed (a
//    consumer skips a tile wholly above its own rows), and the heaviest q
//    tiles are launched first.
//  * P enters P V as one bf16 term. Every bf16 case of chip_smoke.py
//    holds the 1e-2 + 1e-2 relative tolerance with it; a second, lo term
//    (P = hi + lo) would cost 1.5x the tensor work (both variants'
//    errors and times: PERF.md).
//  * What it gives up: the two consumer warpgroups are not scheduled in
//    ping-pong, and a warpgroup's softmax does not overlap its own
//    products. out is written from registers, not through shared memory
//    and a TMA store.
//  * Any t: the last q and k tiles may be partial. TMA fills the rows
//    past t with zeros; keys past t are masked: in the causal case by the
//    causal mask (every stored row lies below t), in the full case by a
//    score of -inf on the partial last tile only (a pass under a uniform
//    branch: a full tile pays nothing for it; folding it into the causal
//    mask's test cost 3% at the flagship shape, PERF.md); rows past t are
//    never stored, nor are their lse entries.
//  * d > 256 (any multiple of 128), and f32 at every d: a CUDA-core
//    kernel (flash_fwd_simt_kernel). A block owns 32 q rows and one
//    128-column panel of out (grid.z walks the panels); it sums S over
//    the 128-column chunks of d, so a block of each panel recomputes S,
//    and it keeps only its panel's 32 accumulators a thread. FMAs in full
//    f32 (a tensor-core f32 path would need TF32, whose 10-bit mantissa
//    misses the f32 tolerance). At d > 256 the wgmma design's O
//    accumulator would need 192 or more registers a thread; speed at
//    those shapes is later work.
//  * out is written [b, t, h, d] contiguous and lse [b, h, t] f32 with
//    row stride ld (a multiple of 4, for the backward's TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, T, H, D;
  int ld;  // row stride of lse
  int causal;
};

// ---------------------------------------------------------------- bf16
// 384 threads: warpgroups 0 and 1 consume (q rows [64w, 64w + 64) of the
// block's 128), warpgroup 2 produces.
constexpr int kFwdRows = 128;
constexpr int kFwdThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdTile {
  static constexpr int BK = D == 128 ? 128 : 64;  // k rows of a stage
  static constexpr int NS = 2;                    // stages of the ring
  static constexpr int Q_BYTES = kFwdRows * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // K or V of one stage
  static constexpr int BAR_OFF = Q_BYTES + 2 * NS * KV_BYTES;
  // 1 KB of slack for the 1024-byte alignment, then the barriers
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * NS) * 8;
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const FwdParams p) {
  using Tile = FwdTile<D>;
  constexpr int BK = Tile::BK, NS = Tile::NS, NP = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_align1k(smem_raw);
  unsigned char* Ks = Qs + Tile::Q_BYTES;          // stage s: + s * KV_BYTES
  unsigned char* Vs = Ks + NS * Tile::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Qs + Tile::BAR_OFF);
  uint64_t* full = q_full + 1;     // [NS]: K and V of the stage landed
  uint64_t* empty = full + NS;     // [NS]: both consumers are done with it

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int q0 = qt * kFwdRows;
  // k tiles up to the diagonal (causal) or to t, the last one maybe partial
  const int k_end = p.causal ? min(q0 + kFwdRows, p.T) : p.T;
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
      mbar_arrive_expect_tx(q_full, Tile::Q_BYTES);
      for (int pn = 0; pn < NP; ++pn)
        tma_load_4d(Qs + pn * kFwdRows * 128, &tm_q, q_full, 64 * pn, hi, q0,
                    bi);
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
    const int row0 = q0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
    const int last_row = q0 + 64 * wg + 63;
    const float sl2 = kLog2e / sqrtf((float)D);  // scale in the log2 domain
    float o[D / 128][64];
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
    float s[BK / 2];  // S of one k tile: 64 x BK, BK / 8 blocks of 4
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
    const uint32_t dq = desc_kmajor(Qs + wg * 64 * 128);

    mbar_wait(q_full, 0);
    Ring<NS> ring;
    for (int kt = 0; kt < n_kt; ++kt, ring.advance()) {
      const int k0 = kt * BK;
      mbar_wait(&full[ring.stage], ring.parity());
      if (!p.causal || k0 <= last_row) {
        const uint32_t dk = desc_kmajor(Ks + ring.stage * Tile::KV_BYTES);
        const uint32_t dv =
            desc_mnmajor(Vs + ring.stage * Tile::KV_BYTES, BK * 128);

        // S = Q K^T, d / 16 steps of 16 columns, 4 a 64-column panel
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a =
              desc_add(dq, (kk / 4) * kFwdRows * 128 + (kk % 4) * 32);
          const uint32_t b = desc_add(dk, (kk / 4) * BK * 128 + (kk % 4) * 32);
          if (kk == 0)
            wgmma_ss_first<0>(s, a, b);
          else
            wgmma_ss<0>(s, a, b);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // keys past t on a partial last tile of the full case (causal rows
        // below t never reach them): -inf, which scales to -inf, so their
        // p is 0 as for the masked scores below
        if (!p.causal && k0 + BK > p.T) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (k0 + 8 * (i / 4) + 2 * c + (i & 1) >= p.T) s[i] = -INFINITY;
        }
        // scale, mask, online softmax (rows row0: e = 0, 1; row1: 2, 3)
        float mb[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * sl2;
            if (p.causal &&
                k0 + 8 * j + 2 * c + (e & 1) > (e < 2 ? row0 : row1))
              x = kNegInf;
            s[4 * j + e] = x;
            mb[e >> 1] = fmaxf(mb[e >> 1], x);
          }
        }
        float mn[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mn[r] = fmaxf(m[r], quad_max(mb[r]));
          corr[r] = exp2_approx(m[r] - mn[r]);
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float x = s[i];
          const float pv =
              x <= kNegInf / 2 ? 0.f : exp2_approx(x - mn[(i >> 1) & 1]);
          s[i] = pv;
          ls[(i >> 1) & 1] += pv;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * corr[r] + quad_sum(ls[r]);
          m[r] = mn[r];
        }
#pragma unroll
        for (int h = 0; h < D / 128; ++h)
#pragma unroll
          for (int i = 0; i < 64; ++i) o[h][i] *= corr[(i >> 1) & 1];

        // P as bf16 A fragments: accumulator blocks 2kc, 2kc + 1 are the
        // keys [16kc, 16kc + 16)
        uint32_t ap[BK / 16][4];
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
          acc_to_a(&s[8 * kc], &s[8 * kc + 4], ap[kc]);

        // O += P V: 16 keys a step (+2048 bytes down V's rows), 128
        // output columns a product (two panels, BK * 128 bytes apart);
        // each accumulator's products are one commit group
#pragma unroll
        for (int h = 0; h < D / 128; ++h) {
          fence_regs(o[h]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < BK / 16; ++kc) {
            const uint32_t b = desc_add(dv, h * 2 * BK * 128 + kc * 2048);
            wgmma_rs<1>(o[h], ap[kc], b);
          }
          wgmma_commit();
          fence_regs(o[h]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < D / 128; ++h) fence_regs(o[h]);
      }
      mbar_arrive(&empty[ring.stage]);
    }

    // rows past t are not stored
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
    const float l0 = l[0] == 0.f ? 1.f : l[0];
    const float l1 = l[1] == 0.f ? 1.f : l[1];
    const bool in0 = row0 < p.T, in1 = row1 < p.T;
    const long long ob0 = ((long long)(bi * p.T + row0) * p.H + hi) * D;
    const long long ob1 = ((long long)(bi * p.T + row1) * p.H + hi) * D;
#pragma unroll
    for (int h = 0; h < D / 128; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * h + 8 * j + 2 * c;
        if (in0)
          *reinterpret_cast<uint32_t*>(&og[ob0 + col]) =
              pack_bf16(__float2bfloat16_rn(o[h][4 * j] / l0),
                        __float2bfloat16_rn(o[h][4 * j + 1] / l0));
        if (in1)
          *reinterpret_cast<uint32_t*>(&og[ob1 + col]) =
              pack_bf16(__float2bfloat16_rn(o[h][4 * j + 2] / l1),
                        __float2bfloat16_rn(o[h][4 * j + 3] / l1));
      }
    }
    if (c == 0) {
      if (in0) p.lse[(long long)bh * p.ld + row0] = m[0] * kLn2 + logf(l0);
      if (in1) p.lse[(long long)bh * p.ld + row1] = m[1] * kLn2 + logf(l1);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const FwdParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = map_bthd(&tq, p.q, p.B, p.T, p.H, D, p.q_sb, p.q_st,
                             p.q_sh, kFwdRows);
  if (err == cudaSuccess)
    err = map_bthd(&tk, p.k, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                   FwdTile<D>::BK);
  if (err == cudaSuccess)
    err = map_bthd(&tv, p.v, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                   FwdTile<D>::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FwdTile<D>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + kFwdRows - 1) / kFwdRows, p.B * p.H);
  flash_fwd_bf16_kernel<D>
      <<<grid, kFwdThreads, FwdTile<D>::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ----------------------------------------------------------- CUDA cores
// f32 at every d, bf16 at d > 256. grid (ceil(t / 32), b * h, d / 128): a
// block of 128 threads owns 32 q rows and the 128-column panel
// blockIdx.z of out; a quad of 4 threads shares a row, thread (r, c)
// computes S columns c + 4i and out columns c + 4j of the panel.
constexpr int kSimtSmem =
    4 * (3 * kSimtRows * kPanelLd + kSimtRows * (kSimtRows + 1));

template <typename E>
__global__ void __launch_bounds__(kSimtThreads)
    flash_fwd_simt_kernel(const FwdParams p) {
  constexpr int BQ = kSimtRows, BK = kSimtRows, LQ = kPanelLd, LP = BK + 1;
  constexpr int NS = BK / 4, NO = kPanel / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // a 128-column chunk of Q
  float* Ks = Qs + BQ * LQ;                     // the same chunk of K
  float* Vs = Ks + BK * LQ;                     // the block's panel of V
  float* Ps = Vs + BK * LQ;

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, bi = bh / p.H, hi = bh % p.H;
  const int c0 = blockIdx.z * kPanel, n_ch = p.D / kPanel;
  const int q0 = qt * BQ, row = q0 + r;
  const int lim = p.causal ? min(row, p.T - 1) : p.T - 1;
  const E* qg = static_cast<const E*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const E* kg = static_cast<const E*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const E* vg = static_cast<const E*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  const float scale = 1.0f / sqrtf((float)p.D);
  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m = kNegInf, l = 0.f;

  const int k_end = p.causal ? min(q0 + BQ, p.T) : p.T;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();  // the previous chunk (or tile) is consumed
      if (n_ch > 1 || kt == 0)  // one chunk: Q stays from the first tile
        load_panel(Qs, qg, p.q_st, q0, ch * kPanel, p.T, tid);
      load_panel(Ks, kg, p.k_st, k0, ch * kPanel, p.T, tid);
      __syncthreads();
      for (int dd = 0; dd < kPanel; ++dd) {
        const float qv = Qs[r * LQ + dd];
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[i] = fmaf(qv, Ks[(c + 4 * i) * LQ + dd], s[i]);
      }
    }
    load_panel(Vs, vg, p.v_st, k0, c0, p.T, tid);
    float mb = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = s[i] * scale;
      if (k0 + c + 4 * i > lim) x = kNegInf;  // causal, and keys past t
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
    __syncthreads();  // V's panel, and the row's P from its quad
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float pv = Ps[r * LP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j)
        o[j] = fmaf(pv, Vs[kk * LQ + c + 4 * j], o[j]);
    }
  }

  if (row >= p.T) return;  // rows past t are not stored
  E* og = static_cast<E*>(p.out) +
          ((long long)(bi * p.T + row) * p.H + hi) * p.D + c0;
  const float sl = l == 0.f ? 1.f : l;
#pragma unroll
  for (int j = 0; j < NO; ++j) store_f32(&og[c + 4 * j], o[j] / sl);
  if (blockIdx.z == 0 && c == 0)
    p.lse[(long long)bh * p.ld + row] = m + logf(sl);
}

template <typename E>
cudaError_t launch_simt(const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSimtSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + kSimtRows - 1) / kSimtRows, p.B * p.H, p.D / kPanel);
  flash_fwd_simt_kernel<E><<<grid, kSimtThreads, kSimtSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: [B, T, H, D] with the given (batch, seq, head) strides in
// elements and unit stride over D; out: [B, T, H, D] contiguous in the
// input dtype; lse: [B, H, T] f32 with row stride ld. dtype: 0 = f32,
// 1 = bf16. The caller guarantees T >= 1, D a positive multiple of 128,
// ld >= T a multiple of 4, 16-byte aligned starts and (batch, seq, head)
// strides that are multiples of 16 bytes. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int vtp_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int H,
                             int D, int ld, int dtype, int causal,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             void* stream) {
  FwdParams p{q,    k,    v,    out,  static_cast<float*>(lse),
              q_sb, q_st, q_sh, k_sb, k_st,
              k_sh, v_sb, v_st, v_sh, B,
              T,    H,    D,    ld,   causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || D < kPanel || D % kPanel) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 128) return launch_bf16<128>(p, s);
  if (dtype == 1 && D == 256) return launch_bf16<256>(p, s);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(p, s);
  if (dtype == 0) return launch_simt<float>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* vtp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
