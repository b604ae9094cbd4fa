// AdamW's update of one leaf in one pass, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: no TPU kernel. The reference's optimizer
// (volcano_tpu/workloads/train.py:make_optimizer, optax's
// clip_by_global_norm and adamw) is jnp that XLA fuses into a few loops.
// The port ran it as about 19 eager PyTorch ops a leaf (adamw_plain in
// volcano_tpu_torch/workloads/ops/adamw.py), each reading and writing
// the whole leaf: ~175 bytes a parameter where one pass needs 28.
//
// What it computes, per element, with the clip factor read from a device
// pointer (a 0-dim tensor: the host never waits for the global norm) and
// the step's scalars computed by the host from the count:
//   g  = g * clip
//   m  = (1 - b1) g + b1_mu * mu       (b1_mu * mu rounded to mu's type)
//   nu = (1 - b2) g^2 + b2 nu
//   u  = (m * inv_bc1) / (sqrt(nu * inv_bc2) + eps)
//   mu = m                             (rounded to mu's type)
//   p  = p - lr (u + wd p)
// Each line is the eager op's own rounding, one f32 operation at a time,
// in the same order: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and
// __fsqrt_rn never contract into an FMA. Where PyTorch divides a tensor by
// a host scalar (m / bc1, nu / bc2) it multiplies by the reciprocal taken
// in double and rounded to f32, float(1.0 / bc) (not 1.0f / float(bc),
// which is an ulp away at some counts), which the host computes and
// passes as inv_bc. With
// bf16 mu, b1_mu is bf16(0.9), the product b1_mu * mu is rounded to bf16
// before the f32 add (the eager op's output is bf16), and m-hat uses the
// f32 m before mu is stored as bf16 (round to nearest even). So the
// kernel's p, mu and nu equal the plain loop's bit for bit; no rounding
// is left unmatched.
//
// What bounds it on an H100: it reads p, g, mu and nu and writes p, mu and
// nu once, 28 bytes a parameter with f32 mu and 24 with bf16 mu (mu's 2
// bytes read and 2 written), against ~20 f32 operations (a correctly
// rounded sqrt and divide among them): memory bound. At the training
// cell's 2.458 G parameters that is 68.8 GB, 20.5 ms at 3.35 TB/s (59.0 GB
// and 17.6 ms with bf16 mu).
//
// Design: a streaming pass. Each thread takes one vector of 4 neighbouring
// elements, neighbouring threads neighbouring vectors: 16-byte loads and
// stores of p, g, nu and f32 mu, 8 bytes of bf16 mu (so one thread's four
// lanes line up across all four arrays). Loads and stores are evict-first
// (__ldcs / __stcs): nothing is reused inside the pass. The grid has a
// block for every 256 vectors of the leaf (410,000 for the embedding), so
// every SM is full but for the norms' leaves. On an H100 at the cell's
// leaves this read 23.44 ms, where a grid-stride loop over the blocks that
// fit at once (6 an SM at 40 registers) read 24.94 and two vectors a
// thread in that loop 24.87 (PERF.md). The last n % 4 elements, and every
// element of a leaf whose pointers are not all aligned to their vectors,
// go one a thread with the same arithmetic.
// One launch a leaf, not one multi-tensor launch: the pointers travel as
// kernel arguments, so nothing is allocated or copied to the device per
// step, and the training cell's 75 leaves (the smallest 4096 elements)
// cost ~75 launches a step against the ~1400 eager ops they replace.
// f32 and bf16 mu are one kernel, templated on mu's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One step's scalars, each the f32 value the eager op uses.
struct AdamwScalars {
  float one_minus_b1, b1_mu, one_minus_b2, b2, eps, inv_bc1, inv_bc2, lr,
      wd;
};

// mu's type: how b1_mu * mu is rounded (to the eager op's output type).
template <typename MuT>
struct Moment;

template <>
struct Moment<float> {
  __device__ static float round(float x) { return x; }
};

template <>
struct Moment<__nv_bfloat16> {
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One element: p, mu (as f32) and nu in, updated in place; mu leaves as
// the f32 m, which the caller stores in mu's type.
template <typename MuT>
__device__ __forceinline__ void update(float& p, float g, float& mu,
                                       float& nu, float clip,
                                       const AdamwScalars& s) {
  g = __fmul_rn(g, clip);
  const float m = __fadd_rn(__fmul_rn(s.one_minus_b1, g),
                            Moment<MuT>::round(__fmul_rn(s.b1_mu, mu)));
  const float n = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)),
                            __fmul_rn(s.b2, nu));
  const float u =
      __fdiv_rn(__fmul_rn(m, s.inv_bc1),
                __fadd_rn(__fsqrt_rn(__fmul_rn(n, s.inv_bc2)), s.eps));
  p = __fsub_rn(p, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(s.wd, p))));
  mu = m;
  nu = n;
}

// Four f32 values at a 16-byte aligned address, and back.
__device__ __forceinline__ void load4(const float* x, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(x));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void store4(float* x, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(x), make_float4(v[0], v[1], v[2], v[3]));
}

// Four bf16 values at an 8-byte aligned address, widened to f32 exactly.
__device__ __forceinline__ void load4(const __nv_bfloat16* x, float (&v)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(x));
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store4(__nv_bfloat16* x, const float (&v)[4]) {
  __stcs(reinterpret_cast<uint2*>(x),
         make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                    bf16_bits(v[2]) | (bf16_bits(v[3]) << 16)));
}

__device__ __forceinline__ float load1(const float* x) { return __ldcs(x); }

__device__ __forceinline__ float load1(const __nv_bfloat16* x) {
  return __uint_as_float(
      static_cast<uint32_t>(
          __ldcs(reinterpret_cast<const unsigned short*>(x)))
      << 16);
}

__device__ __forceinline__ void store1(float* x, float v) { __stcs(x, v); }

__device__ __forceinline__ void store1(__nv_bfloat16* x, float v) {
  __stcs(reinterpret_cast<unsigned short*>(x),
         static_cast<unsigned short>(bf16_bits(v)));
}

// n elements; thread i takes vector i of the first n_vec (n_vec = 0 when
// a pointer is not aligned to its vector) and element 4 n_vec + i.
template <typename MuT>
__global__ void __launch_bounds__(kThreads)
    adamw_leaf_kernel(float* __restrict__ p, const float* __restrict__ g,
                      MuT* __restrict__ mu, float* __restrict__ nu,
                      const float* __restrict__ clip_at, long long n,
                      long long n_vec, AdamwScalars s) {
  const float clip = __ldg(clip_at);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < n_vec) {
    const long long e = 4 * i;
    float pv[4], gv[4], mv[4], nv[4];
    load4(p + e, pv);
    load4(g + e, gv);
    load4(mu + e, mv);
    load4(nu + e, nv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      update<MuT>(pv[j], gv[j], mv[j], nv[j], clip, s);
    store4(p + e, pv);
    store4(mu + e, mv);
    store4(nu + e, nv);
  }
  const long long e = 4 * n_vec + i;
  if (e < n) {
    float pe = load1(p + e), me = load1(mu + e), ne = load1(nu + e);
    update<MuT>(pe, load1(g + e), me, ne, clip, s);
    store1(p + e, pe);
    store1(mu + e, me);
    store1(nu + e, ne);
  }
}

bool aligned(const void* x, size_t bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0;
}

template <typename MuT>
cudaError_t launch(float* p, const float* g, MuT* mu, float* nu,
                   const float* clip, long long n, const AdamwScalars& s,
                   cudaStream_t stream) {
  const bool vec = aligned(p, 16) && aligned(g, 16) && aligned(nu, 16) &&
                   aligned(mu, 4 * sizeof(MuT));
  const long long n_vec = vec ? n / 4 : 0;
  const long long rest = n - 4 * n_vec;
  const long long threads = n_vec > rest ? n_vec : rest;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  adamw_leaf_kernel<MuT><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(p, g, mu, nu, clip, n, n_vec, s);
  return cudaGetLastError();
}

}  // namespace

// One AdamW update of one leaf in place. p, g, nu: n f32 values; mu: n
// values of mu_dtype (0 = f32, 1 = bf16); clip: one f32 on the same
// device; all contiguous. The scalars are the f32 values of the eager
// ops' operands: 1 - b1, b1 in mu's type, 1 - b2, b2, eps, the bias
// corrections' reciprocals float(1.0 / (1 - b^count)), lr and the weight
// decay. Launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); n = 0 launches nothing.
extern "C" int vtp_adamw(void* p, const void* g, void* mu, void* nu,
                         const void* clip, long long n, int mu_dtype,
                         float one_minus_b1, float b1_mu, float one_minus_b2,
                         float b2, float eps, float inv_bc1, float inv_bc2,
                         float lr, float wd, void* stream) {
  const AdamwScalars s{one_minus_b1, b1_mu, one_minus_b2, b2, eps,
                       inv_bc1,      inv_bc2, lr,          wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* pf = static_cast<float*>(p);
  auto* gf = static_cast<const float*>(g);
  auto* nf = static_cast<float*>(nu);
  auto* cf = static_cast<const float*>(clip);
  if (mu_dtype == 0)
    return launch(pf, gf, static_cast<float*>(mu), nf, cf, n, s, st);
  if (mu_dtype == 1)
    return launch(pf, gf, static_cast<__nv_bfloat16*>(mu), nf, cf, n, s, st);
  return cudaErrorInvalidValue;
}
