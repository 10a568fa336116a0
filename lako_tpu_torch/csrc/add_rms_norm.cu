// The decode step's residual add and the RMS norm after it, in one launch
// (K8).
//
// Replaces no pallas_call. The JAX engine's step (lako_tpu/models/t5/
// engine.py) adds each block's output to the residual stream and normalises
// it inside one jitted program, which XLA fuses on the TPU. In eager PyTorch,
// and in a CUDA graph captured from it, the same site is nine launches:
// x + delta, then _rms's float, square, mean, + eps, rsqrt, multiply, cast
// and weight multiply (models/t5/engine.py before this kernel). A decode
// step at t5-large width has 73 such sites, about half of its launches.
//
// What bounds it on the H100: neither bytes nor operations. A site at B=128
// and H=1024 in bf16 reads and writes ~1 MB (0.3 us at 3.35 TB/s); the
// kernel's time is a launch, one round trip to memory and a reduction. So
// one launch covers every row of a site, a block takes a row (one warp for
// H=1024 in bf16, two for H=2048 or f32 at 1024), each lane issues all its
// 16-byte loads of x, delta and the weight before it computes, the sum of
// squares reduces by xor shuffles (and across the block's warps through
// shared memory, in a fixed order), and both outputs are written in the
// same pass.
//
// Rounding is the plain chain's (ops/add_rms_norm.py
// add_rms_norm_reference): x_new = x + delta rounded to the compute type;
// the norm in f32 on that stored value, each square rounded before it is
// added; var = sum x (1/H); x_new x rsqrtf(var + eps) rounded to the
// compute type; the weight rounded to the compute type; their product
// rounded once. Only the order of the sum of squares differs. Every
// rounding is spelled out (__fmul_rn, __fadd_rn) so that nvcc contracts no
// product into an add that the chain rounds apart.

#include "common.cuh"

namespace {

constexpr int PER = 4;            // 16-byte vectors of a row that a lane holds
constexpr int MAX_WARPS = 16;     // a block's warps at most
constexpr int MAX_H = 8192;       // ops/add_rms_norm.py MAX_H
constexpr int MAX_ROWS = 65535;   // ops/add_rms_norm.py MAX_ROWS

// One row per block: blockDim.x = 32 x ceil(H / (N x 32 x PER)) threads, N
// elements of T in 16 bytes; vector i of the row is taken by thread
// i % blockDim.x. delta == nullptr: no add, and x_out is not written (x is
// the residual as it stands).
template <typename T, typename W>
__global__ void __launch_bounds__(32 * MAX_WARPS)
add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                    const W* __restrict__ weight, T* __restrict__ x_out,
                    T* __restrict__ xn, int H, float eps, float inv_h) {
  constexpr int N = 16 / sizeof(T);
  constexpr int W8 = N * sizeof(W) / 8;       // a vector's weights in 8-byte loads
  const int nvec = H / N;
  const size_t base = (size_t)blockIdx.x * H;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* dr = reinterpret_cast<const uint4*>(delta + base);
  const uint2* wr = reinterpret_cast<const uint2*>(weight);

  // every load of the lane first: x, delta and the weight's N values
  uint4 a[PER], b[PER];
  uint2 wv[PER][W8];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      a[k] = xr[i];
      if (delta != nullptr) b[k] = dr[i];
#pragma unroll
      for (int j = 0; j < W8; ++j) wv[k][j] = wr[i * W8 + j];
    }
  }

  float s[PER][N];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      const T* xa = reinterpret_cast<const T*>(&a[k]);
      if (delta != nullptr) {
        const T* db = reinterpret_cast<const T*>(&b[k]);
        uint4 o;
        T* op = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          op[e] = lako::from_f32<T>(__fadd_rn(lako::to_f32<T>(xa[e]), lako::to_f32<T>(db[e])));
          s[k][e] = lako::to_f32<T>(op[e]);
        }
        reinterpret_cast<uint4*>(x_out + base)[i] = o;
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) s[k][e] = lako::to_f32<T>(xa[e]);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) ss = __fadd_rn(ss, __fmul_rn(s[k][e], s[k][e]));
    }
  }

  ss = lako::warp_sum(ss);
  if (blockDim.x > 32) {
    __shared__ float part[MAX_WARPS];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int j = 0; j < (int)blockDim.x / 32; ++j) ss = __fadd_rn(ss, part[j]);
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_h), eps));

#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      const W* wk = reinterpret_cast<const W*>(wv[k]);
      uint4 o;
      T* op = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float y = lako::round_to<T>(__fmul_rn(s[k][e], r));
        op[e] = lako::from_f32<T>(__fmul_rn(y, lako::round_to<T>(lako::to_f32<W>(wk[e]))));
      }
      reinterpret_cast<uint4*>(xn + base)[i] = o;
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* delta, const void* weight, void* x_out, void* xn,
           int B, int H, float eps, cudaStream_t stream) {
  const int nvec = H / (int)(16 / sizeof(T));
  const int warps = (nvec + 32 * PER - 1) / (32 * PER);
  add_rms_norm_kernel<T, W><<<B, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const W*>(weight),
      static_cast<T*>(x_out), static_cast<T*>(xn), H, eps, 1.0f / (float)H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_weight(const void* x, const void* delta, const void* weight, void* x_out, void* xn,
                  int B, int H, int weight_dtype, float eps, cudaStream_t stream) {
  if (weight_dtype == lako::kFloat32)
    return launch<T, float>(x, delta, weight, x_out, xn, B, H, eps, stream);
  if (weight_dtype == lako::kBFloat16)
    return launch<T, __nv_bfloat16>(x, delta, weight, x_out, xn, B, H, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, delta (nullable), x_out, xn: (B, H) of `dtype`, contiguous, 16-byte
// aligned; weight (H,) of `weight_dtype`. Writes x_out = x + delta (unless
// delta is null) and xn = rms_norm(x_out) x weight. Returns a cudaError_t
// code.
extern "C" int lako_add_rms_norm(const void* x, const void* delta, const void* weight,
                                 void* x_out, void* xn, int B, int H, int dtype,
                                 int weight_dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAX_ROWS || H < 8 || H > MAX_H || H % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == lako::kFloat32)
    return launch_weight<float>(x, delta, weight, x_out, xn, B, H, weight_dtype, eps, s);
  if (dtype == lako::kBFloat16)
    return launch_weight<__nv_bfloat16>(x, delta, weight, x_out, xn, B, H, weight_dtype, eps,
                                        s);
  return (int)cudaErrorInvalidValue;
}
