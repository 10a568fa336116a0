// One decode step of cross-attention against int8 K/V.
//
// Replaces the Pallas kernel K3 of the JAX package:
//   lako_tpu/ops/decode_cross_attn.py::fused_decode_cross_attention (body _kernel).
//
// Layout (models/t5/engine.py _quantize_kv): K_i8, V_i8 are (B,h,d,K) int8
// with the key axis minor; k_scale, v_scale are (B,h,d) f32 per-channel
// scales; bias is (B,1,K) f32 (0 or -1e9). Per (b, h):
//   logits[k] = sum_d (q[d] * k_scale[d]) * K_i8[d,k] + bias[k]  (scale folded into q)
//   p = softmax(logits) in f32
//   out[d]    = v_scale[d] * sum_k p[k] * V_i8[d,k]              (scale folded out)
//
// What bounds it on the H100: memory traffic. Each query row is one vector
// (M=1 per head), so the kernel does 4 FLOPs per int8 byte it reads (one
// byte per K and V element) and can never feed the tensor cores. The design
// keeps those bytes int8 all the way into registers (dequantization is one
// multiply on q and one on the output, never a bf16 copy of K/V in device
// memory), and reads them coalesced: neighbouring threads take neighbouring
// keys, the minor axis. One block per (b, h) gives B*h blocks (128 at B=8),
// less than one wave on 132 SMs at small batch; splitting K across blocks
// (flash-decoding) is the next step.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ float block_reduce(float x, float* scratch, bool is_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  x = is_max ? lako::warp_max(x) : lako::warp_sum(x);
  __syncthreads();  // scratch may still be read from a previous reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < WARPS; ++w) r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_cross_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_i8,
                    const float* __restrict__ k_scale, const int8_t* __restrict__ v_i8,
                    const float* __restrict__ v_scale, const float* __restrict__ bias,
                    float* __restrict__ out, int h, int d, int K) {
  extern __shared__ float smem[];
  float* qs = smem;      // [d] q * k_scale
  float* p = smem + d;   // [K] logits, then probabilities
  __shared__ float scratch[WARPS];

  const int b = blockIdx.y;
  const size_t bh = (size_t)b * h + blockIdx.x;
  const int tid = threadIdx.x;
  const int8_t* kb = k_i8 + bh * d * K;
  const int8_t* vb = v_i8 + bh * d * K;
  const float* biasb = bias + (size_t)b * K;

  for (int c = tid; c < d; c += THREADS)
    qs[c] = lako::to_f32(q[bh * d + c]) * k_scale[bh * d + c];
  __syncthreads();

  float local_max = -1e30f;
  for (int key = tid; key < K; key += THREADS) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qs[c], (float)kb[(size_t)c * K + key], acc);
    acc += biasb[key];
    p[key] = acc;
    local_max = fmaxf(local_max, acc);
  }
  const float m = block_reduce(local_max, scratch, true);

  float local_sum = 0.f;
  for (int key = tid; key < K; key += THREADS) {
    const float e = expf(p[key] - m);
    p[key] = e;
    local_sum += e;
  }
  const float sum = block_reduce(local_sum, scratch, false);
  for (int key = tid; key < K; key += THREADS) p[key] = p[key] / sum;
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  for (int c = warp; c < d; c += WARPS) {
    float acc = 0.f;
    for (int key = lane; key < K; key += 32)
      acc = fmaf(p[key], (float)vb[(size_t)c * K + key], acc);
    acc = lako::warp_sum(acc);
    if (lane == 0) out[bh * d + c] = acc * v_scale[bh * d + c];
  }
}

template <typename T>
int launch(const void* q, const void* k_i8, const void* k_scale, const void* v_i8,
           const void* v_scale, const void* bias, void* out, int B, int h, int d,
           int K, cudaStream_t stream) {
  // d + K floats stay within the default 48 KB (checked by the Python wrapper)
  const size_t smem = sizeof(float) * (size_t)(d + K);
  auto kernel = decode_cross_kernel<T>;
  kernel<<<dim3(h, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_i8),
      static_cast<const float*>(k_scale), static_cast<const int8_t*>(v_i8),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<float*>(out), h, d, K);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B,h,d) in `dtype`; k_i8, v_i8: (B,h,d,K) int8; k_scale, v_scale: (B,h,d)
// f32; bias: (B,1,K) f32; out: (B,h,d) f32. All contiguous. Returns a
// cudaError_t code (0 = launched).
extern "C" int lako_decode_cross_attn(const void* q, const void* k_i8,
                                      const void* k_scale, const void* v_i8,
                                      const void* v_scale, const void* bias,
                                      void* out, int B, int h, int d, int K,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lako::kFloat32)
    return launch<float>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
  if (dtype == lako::kBFloat16)
    return launch<__nv_bfloat16>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
  return (int)cudaErrorInvalidValue;
}
