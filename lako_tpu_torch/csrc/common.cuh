// Shared helpers for the port's CUDA kernels (plain C interface, loaded with
// ctypes by lako_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lako {

// Additive "masked" logit of the JAX package (layers.py NEG_INF). Never -inf:
// a row whose keys are all masked still softmaxes to a finite output.
constexpr float kNegInf = -1e9f;

// Dtype codes passed from Python (ops/_build.py DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and back: the value a T operand of a product carries
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Devices a process may use, for the per-device flags of configure_smem.
constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared memory limit to `bytes` on the current
// device, once per device: CUDA keeps function attributes per device context,
// so a flag per process would leave a second card unconfigured. Once set, a
// later launch does no host call, so it can be captured in a CUDA graph.
template <typename Kernel>
cudaError_t configure_smem(Kernel kernel, int bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// d += a (16x16, row-major fragment) * b (16x8, col-major fragment), bf16 in,
// f32 accumulate: mma.sync m16n8k16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x / y from r = __frcp_rn(y): the rounded quotient x r corrected once with
// FMAs (Markstein), which gives the IEEE quotient without div.rn's slow path
// (tests/test_torch_ops.py holds the sequence to x / y in f32)
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// L2 only); zeros instead when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 or 8 bytes from device memory to shared memory, asynchronously
// (cp.async, through L1); zeros instead when !valid (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed copy groups are in flight
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// rows [0, rows) of a (n_rows, D) row-major bf16 matrix into shared memory
// rows `pitch` elements apart, 16 bytes a copy, by all threads of the
// block; rows at or past n_rows are zero. Neighbouring threads copy
// neighbouring 16 bytes of a row.
template <int D>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, int pitch,
                                              const __nv_bfloat16* src, int rows, int n_rows) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * 8;
    const bool valid = r < n_rows;
    cp_async16(dst + r * pitch + c, valid ? src + (size_t)r * D + c : src, valid);
  }
}

// Four 8x8 bf16 matrices from shared memory (ldmatrix.x4): lane i gives the
// address of row i % 8 of matrix i / 8, and r[m] receives matrix m in the
// mma fragment layout (lane holds row lane / 4, columns 2 (lane % 4) + {0,1}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The same, each matrix transposed: lane holds rows 2 (lane % 4) + {0,1} of
// column lane / 4 (row-major V as the col-major B operand of P.V).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The A fragments (16 rows x 32 columns, two m16n8k16 k-steps) of rows
// [0,16) and columns [c0, c0+32) of a row-major bf16 tile in shared memory
__device__ __forceinline__ void load_a_x2(uint32_t (&a0)[4], uint32_t (&a1)[4],
                                          const __nv_bfloat16* tile, int pitch, int c0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p = tile + (lane & 15) * pitch + c0 + (lane >> 4) * 8;
  ldmatrix_x4(a0, p);
  ldmatrix_x4(a1, p + 16);
}

// The B fragments (8 columns of n x 32 of k, two k-steps) of an (n, k)
// row-major bf16 tile in shared memory, i.e. Y of X.Y^T: rows [n0, n0+8),
// columns [c0, c0+32). b[0], b[1] feed the first k-step, b[2], b[3] the second.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int pitch, int n0, int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (n0 + (lane & 7)) * pitch + c0 + (lane >> 3) * 8);
}

// The A fragment (16 x 16) of columns [16 kk, 16 kk + 16) from the C
// fragments x, y of the two 8-column tiles 2 kk and 2 kk + 1, rounded to bf16
// (a product's result as the next product's left operand, e.g. P of P.V)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&x)[4],
                                       const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// acc (16 x D, C fragments of D / 8 column tiles) += a (16 x 16) . Y, where Y
// is 16 rows x D, row-major in shared memory at y: Y's B fragments come
// through ldmatrix.trans (V of P.V, dO of P^T.dO, Q of dS^T.Q)
template <int D>
__device__ __forceinline__ void mma_ay(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* y, int pitch) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int jd = 0; jd < D / 8; jd += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, y + (lane & 15) * pitch + (jd + (lane >> 4)) * 8);
    mma_bf16(acc[jd], a, b[0], b[1]);
    mma_bf16(acc[jd + 1], a, b[2], b[3]);
  }
}

}  // namespace lako
