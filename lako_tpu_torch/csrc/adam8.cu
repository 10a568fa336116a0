// One-pass 8-bit Adam update (K5) and its requantization-free fragment (K6).
//
// Replaces the Pallas kernels of the JAX package:
//   K5 lako_tpu/ops/adam8_kernel.py::fused_adam8_update (body _kernel),
//   K6 scripts/bench_adam8_micro.py::k_ema (the floor-proof fragment).
//
// State layout (train/optim8.py Moment8): each moment is (nb, 256) codes,
// int8 linear for m and uint8 log2 for v (code 255 = exactly zero), with one
// f32 scale per 256-element row. One warp owns one row: lane l holds the
// elements l + 32 e (e < 8), so every load and store of a warp is coalesced,
// and the row's absmax of |m| and max of v are warp-shuffle reductions.
// K5 per row: dequantize m and v, the two EMAs, the Adam direction u, then
// requantize both moments with the dithered stochastic rounding of the JAX
// package. K6 stops after u.
//
// Bit parity with the JAX kernel is the bar: the codes must come out equal,
// so every rounding is spelled out with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn / __fmaf_rn, which nvcc never contracts or splits,
// in the Pallas body's order (((1-b2)*g)*g, vs*(base*((f1*f2)*f4)), the
// polynomial p = p*m + c step by step). The JAX package's own CPU run of that
// body (XLA:CPU, the oracle of the parity tests) fuses three products into
// FMAs, the gradient's term of each EMA and each polynomial step, and divides
// by 127 as a product with the reciprocal; the kernel does exactly the same,
// and so does its plain version (ops/adam8_kernel.py). Rounding is rintf
// (half to even, as jnp.round); the dither hash is uint32 arithmetic with
// wraparound.
//
// K5 reads the gradient in its own dtype straight from the parameter's
// tensor, with the row's tail past n read as 0 (JAX pads a float32 copy with
// zeros; bf16 -> f32 is exact), so no blocked copy exists. The blocked layout
// is the JAX package's: a dense weight of the port is (out, in), the
// transpose of JAX's flax kernel (in, out), so for such a leaf ("transposed")
// element idx of the blocked state is weight[idx % out, idx / out]; when out
// is a multiple of 256 the block's 8 warps take 8 neighbouring input columns
// of the same 256 outputs, so that their strided reads share sectors.
//
// What bounds it on the H100: memory traffic. Per element K5 moves the
// gradient and u (4 + 4 bytes in f32) and four one-byte codes, about 40
// simple operations against 12 bytes; the card does ~20 flop per byte, so the
// bound is the bytes: 8.85 GB a t5-large step, ~2.6 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;           // elements per quantization row
constexpr int PER_LANE = BLOCK / 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// float32 values of the JAX package's constants (train/optim8.py)
constexpr float kFrac1 = 0x1.d5818ep-1f;   // 2^-0.125
constexpr float kFrac2 = 0x1.ae89fap-1f;   // 2^-0.25
constexpr float kFrac4 = 0x1.6a09e6p-1f;   // 2^-0.5
constexpr float kLog2P0 = -0x1.47b98p-4f;  // _LOG2_P, highest power first
constexpr float kLog2P1 = 0x1.4561bap-1f;
constexpr float kLog2P2 = -0x1.0cb93ap+1f;
constexpr float kLog2P3 = 0x1.032ceep+2f;
constexpr float kLog2P4 = -0x1.40b7fcp+1f;
constexpr float kLogSteps = 8.0f;          // log-code steps per octave
constexpr float kInv127 = 0x1.020408p-7f;  // 1/127

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps;
};

// 2^(-q/8) for a code q in [0, 254]: 2^-(q>>3) built in the exponent field,
// 2^-((q&7)/8) as a product of three selected constants (_exp2_neg_code)
__device__ __forceinline__ float exp2_neg_code(int q) {
  const float base = __int_as_float((127 - (q >> 3)) << 23);
  const float f1 = (q & 1) ? kFrac1 : 1.f;
  const float f2 = (q & 2) ? kFrac2 : 1.f;
  const float f4 = (q & 4) ? kFrac4 : 1.f;
  return __fmul_rn(base, __fmul_rn(__fmul_rn(f1, f2), f4));
}

// log2 of a positive normal float: exponent plus a degree-4 polynomial of
// the mantissa in [1, 2) (_log2_bits)
__device__ __forceinline__ float log2_bits(float x) {
  const int bits = __float_as_int(x);
  const int e = (bits >> 23) & 0xFF;
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  float p = kLog2P0;
  p = __fmaf_rn(p, m, kLog2P1);
  p = __fmaf_rn(p, m, kLog2P2);
  p = __fmaf_rn(p, m, kLog2P3);
  p = __fmaf_rn(p, m, kLog2P4);
  return __fadd_rn((float)(e - 127), p);
}

// uniform [0, 1) dither of the absolute blocked index (_dither_from_idx);
// salt_hash = (count * 0x9E3779B9) ^ (salt * 0x85EBCA6B), mod 2^32
__device__ __forceinline__ float dither(uint32_t idx, uint32_t salt_hash) {
  uint32_t h = idx ^ salt_hash;
  h *= 0xCC9E2D51u;
  h = (h ^ (h >> 15)) * 0x1B873593u;
  h ^= h >> 13;
  return (float)(int)(h >> 8) * 0x1p-24f;
}

// y rounded down, plus 1 where the dither falls below the fraction
__device__ __forceinline__ float stochastic(float y, uint32_t idx, uint32_t salt_hash) {
  const float lo = floorf(y);
  return __fadd_rn(lo, dither(idx, salt_hash) < __fsub_rn(y, lo) ? 1.f : 0.f);
}

// dequantized moments after one EMA step with gradient g:
// b1*m + (1-b1)*g and b2*v + ((1-b2)*g)*g, the gradient's product fused
__device__ __forceinline__ void ema(int8_t mq, float ms, uint8_t vq, float vs, float g,
                                    const Hyper& hp, float& m, float& v) {
  const float m0 = __fmul_rn((float)mq, ms);
  const float v0 = vq == 255 ? 0.f : __fmul_rn(vs, exp2_neg_code(vq));
  m = __fmaf_rn(hp.one_minus_b1, g, __fmul_rn(hp.b1, m0));
  v = __fmaf_rn(__fmul_rn(hp.one_minus_b2, g), g, __fmul_rn(hp.b2, v0));
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
adam8_update_kernel(const G* __restrict__ g, const int8_t* __restrict__ mq,
                    const float* __restrict__ ms, const uint8_t* __restrict__ vq,
                    const float* __restrict__ vs, G* __restrict__ u,
                    int8_t* __restrict__ out_mq, float* __restrict__ out_ms,
                    uint8_t* __restrict__ out_vq, float* __restrict__ out_vs,
                    long long n, int nb, int rows, int cols, int transposed, int count,
                    int correct_bias, int stochastic_round, uint32_t salt_m,
                    uint32_t salt_v, Hyper hp) {
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= nb) return;
  const int lane = threadIdx.x % 32;
  int row = w;
  if (transposed && rows % BLOCK == 0) {
    const int per_col = rows / BLOCK;   // rows of the state per input column
    row = (w % cols) * per_col + w / cols;
  }
  float corr1 = 1.f, corr2 = 1.f;
  if (correct_bias) {
    const float c = (float)count;
    corr1 = __fsub_rn(1.f, expf(__fmul_rn(c, logf(hp.b1))));
    corr2 = __fsub_rn(1.f, expf(__fmul_rn(c, logf(hp.b2))));
  }
  const size_t base = (size_t)row * BLOCK;
  const float mscale = ms[row], vscale = vs[row];
  float m[PER_LANE], v[PER_LANE];
  float amax = 0.f, vmax = 0.f;
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const long long idx = (long long)base + lane + 32 * e;
    long long off = idx;
    if (transposed) off = (idx % rows) * cols + idx / rows;
    const float gf = idx < n ? lako::to_f32(g[off]) : 0.f;
    ema(mq[idx], mscale, vq[idx], vscale, gf, hp, m[e], v[e]);
    float ue;
    if (correct_bias)
      ue = __fdiv_rn(__fdiv_rn(m[e], corr1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v[e], corr2)), hp.eps));
    else
      ue = __fdiv_rn(m[e], __fadd_rn(__fsqrt_rn(v[e]), hp.eps));
    if (idx < n) u[off] = lako::from_f32<G>(ue);
    amax = fmaxf(amax, fabsf(m[e]));
    vmax = fmaxf(vmax, v[e]);
  }
  amax = lako::warp_max(amax);
  vmax = lako::warp_max(vmax);

  // m: linear signed int8 with the row's absmax / 127 as scale
  const float mscale_new = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  // v: log2 code, (log2(vmax) - log2(v)) * 8 steps, 255 for zero
  const float log_vmax = log2_bits(vmax > 0.f ? vmax : 1.f);
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const size_t idx = base + lane + 32 * e;
    float y = __fdiv_rn(m[e], mscale_new);
    if (stochastic_round) y = stochastic(y, (uint32_t)idx, salt_m);
    out_mq[idx] = (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);

    float yv = __fmul_rn(__fsub_rn(log_vmax, log2_bits(v[e] > 0.f ? v[e] : 1.f)), kLogSteps);
    if (stochastic_round) yv = stochastic(yv, (uint32_t)idx, salt_v);
    float qv = fminf(fmaxf(rintf(yv), 0.f), 254.f);
    if (v[e] <= 0.f || vmax <= 0.f) qv = 255.f;
    out_vq[idx] = (uint8_t)(int)qv;
  }
  if (lane == 0) {
    out_ms[row] = mscale_new;
    out_vs[row] = vmax;
  }
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
adam8_ema_kernel(const G* __restrict__ g, const int8_t* __restrict__ mq,
                 const float* __restrict__ ms, const uint8_t* __restrict__ vq,
                 const float* __restrict__ vs, __nv_bfloat16* __restrict__ u, int nb,
                 Hyper hp) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= nb) return;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)row * BLOCK;
  const float mscale = ms[row], vscale = vs[row];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const size_t idx = base + lane + 32 * e;
    float m, v;
    ema(mq[idx], mscale, vq[idx], vscale, lako::to_f32(g[idx]), hp, m, v);
    u[idx] = __float2bfloat16(__fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), hp.eps)));
  }
}

inline unsigned blocks_for(int nb) { return (unsigned)((nb + WARPS - 1) / WARPS); }

template <typename G>
int launch_update(void* const* p, long long n, int nb, int rows, int cols, int transposed,
                  int count, int correct_bias, int stochastic_round, uint32_t salt_m,
                  uint32_t salt_v, Hyper hp, cudaStream_t stream) {
  adam8_update_kernel<G><<<blocks_for(nb), THREADS, 0, stream>>>(
      static_cast<const G*>(p[0]), static_cast<const int8_t*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const uint8_t*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<G*>(p[5]), static_cast<int8_t*>(p[6]),
      static_cast<float*>(p[7]), static_cast<uint8_t*>(p[8]), static_cast<float*>(p[9]),
      n, nb, rows, cols, transposed, count, correct_bias, stochastic_round, salt_m, salt_v,
      hp);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. g: the parameter's gradient, n elements in dtype (a transposed leaf:
// rows x cols, the port's (out, in)); mq (nb,256) int8, ms (nb,1) f32, vq
// (nb,256) uint8, vs (nb,1) f32; u: like g; out_* like the state.
// salt_m / salt_v: (count * 0x9E3779B9) ^ (salt * 0x85EBCA6B) mod 2^32 for the
// m and v dithers. Returns a cudaError_t code (0 = launched).
extern "C" int lako_adam8_update(const void* g, const void* mq, const void* ms,
                                 const void* vq, const void* vs, void* u, void* out_mq,
                                 void* out_ms, void* out_vq, void* out_vs, int n, int nb,
                                 int rows, int cols, int transposed, int count,
                                 int correct_bias, int stochastic_round, int dtype,
                                 uint32_t salt_m, uint32_t salt_v, float b1,
                                 float b2, float one_minus_b1, float one_minus_b2, float eps,
                                 void* stream) {
  if (nb == 0) return 0;
  void* const p[10] = {const_cast<void*>(g), const_cast<void*>(mq), const_cast<void*>(ms),
                       const_cast<void*>(vq), const_cast<void*>(vs), u, out_mq, out_ms,
                       out_vq, out_vs};
  const Hyper hp{b1, b2, one_minus_b1, one_minus_b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lako::kFloat32)
    return launch_update<float>(p, n, nb, rows, cols, transposed, count, correct_bias,
                                stochastic_round, salt_m, salt_v, hp, s);
  if (dtype == lako::kBFloat16)
    return launch_update<__nv_bfloat16>(p, n, nb, rows, cols, transposed, count, correct_bias,
                                         stochastic_round, salt_m, salt_v, hp, s);
  return (int)cudaErrorInvalidValue;
}

// K6. g: (nb,256) in g_dtype; state as K5's; u: (nb,256) bf16.
extern "C" int lako_adam8_ema_fragment(const void* g, const void* mq, const void* ms,
                                       const void* vq, const void* vs, void* u, int nb,
                                       int g_dtype, float b1, float b2, float one_minus_b1,
                                       float one_minus_b2, float eps, void* stream) {
  if (nb == 0) return 0;
  const Hyper hp{b1, b2, one_minus_b1, one_minus_b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mq8 = static_cast<const int8_t*>(mq);
  const auto* vq8 = static_cast<const uint8_t*>(vq);
  const auto* msf = static_cast<const float*>(ms);
  const auto* vsf = static_cast<const float*>(vs);
  auto* ub = static_cast<__nv_bfloat16*>(u);
  if (g_dtype == lako::kFloat32)
    adam8_ema_kernel<float><<<blocks_for(nb), THREADS, 0, s>>>(
        static_cast<const float*>(g), mq8, msf, vq8, vsf, ub, nb, hp);
  else if (g_dtype == lako::kBFloat16)
    adam8_ema_kernel<__nv_bfloat16><<<blocks_for(nb), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), mq8, msf, vq8, vsf, ub, nb, hp);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
