// K-streamed attention backward for the T5 encoder: three kernels.
//
// Replaces the Pallas kernels of the JAX package's streamed backward
// (lako_tpu/ops/flash_streamed.py, _streamed_bwd_impl):
//   K2a _bwd_dkdv_kernel (:289) -> lako_flash_streamed_bwd_dkdv
//   K2b _bwd_dq_kernel   (:319) -> lako_flash_streamed_bwd_dq
//   K2c _bwd_drel_kernel (:344) -> lako_flash_streamed_bwd_drel
//
// Each kernel recomputes, for one (64-row q tile, 64-key tile) pair,
//   S  = q.k + rel[h]          (a masked key: S = -1e9, as in the forward)
//   P  = exp(S - m) / l        from the forward's row statistics (m, l)
//   dP = dO.v,   dS = P (dP - Dv), and dS = 0 at a masked key
// where Dv = rowsum(dO * O) in f32 comes from the wrapper. Then
//   K2a: dV[k] = sum_q P[q,k] dO[q], dK[k] = sum_q dS[q,k] q[q]
//        one block per (b, h, k tile), walking the q tiles;
//   K2b: dQ[q] = sum_k dS[q,k] k[k]
//        one block per (b, h, q tile), walking the k tiles;
//   K2c: drel[h,q,k] = sum_b dS[b,h,q,k]
//        one block per (h, q tile, k tile), walking the batch. Each element
//        is written once, with no atomics, so drel is the same in every run.
// The (B,H,L,Lk) logits never exist in device memory.
//
// Semantics kept from the JAX package: f32 logits and accumulators; P is
// rounded to the value dtype before dV (p.astype(do.dtype)) and dS to the
// input dtype before dK and dQ; drel sums the f32 dS; outputs in the input
// dtype, drel in f32. Kept from the port's forward instead of the Pallas
// kernel: keys past Lk and rows past L get no weight (no host padding), and
// a fully masked row recomputes P = 1/Lk from (m, l) = (-1e9, Lk) exactly,
// where the Pallas kernel's lse loses log(Lk) to f32 rounding at 1e9. Its dS
// is 0 at every (masked) key, so it adds nothing to dQ, dK or drel; its dV
// share is dO/Lk per key, the gradient of the plain version.
//
// What bounds them on the H100: at the encoder's shape (B*N=16, H=16,
// L=Lk=130, D=64) the three kernels together do ~5 GFLOP of products and
// move a few MB. This first version runs every product on CUDA-core FMAs in
// f32 (67 TFLOP/s on NVIDIA's H100 SXM data sheet), for bf16 and f32 inputs
// alike: simple and right first. Operands are staged in shared memory as f32,
// transposed with a padded row stride so that the tile products read float4s
// and the accumulation loops hit at most two-way bank conflicts. The ragged
// edge at L=130 costs a third, nearly empty tile in each direction. Next:
// mma.sync (or wgmma) for bf16, as the forward has, and smaller edge tiles.

#include "common.cuh"

namespace {

constexpr int TILE = 64;          // q rows and keys per tile
constexpr int SP = TILE + 4;      // shared row stride: float4-aligned, skewed banks
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 tile elements each

using bf16 = __nv_bfloat16;

// dst[c * SP + r] = src[(r0 + r) * D + c] as f32, for the 64 rows of a tile;
// rows at or past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int r0, int n_rows) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, c = i % D;  // neighbouring threads: neighbouring columns
    dst[c * SP + r] = r0 + r < n_rows ? lako::to_f32<T>(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_c aT[c][ty*4 + i] * bT[c][tx*4 + j]
template <int D>
__device__ __forceinline__ void tile_product(const float* aT, const float* bT, int ty, int tx,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[c * SP + ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[c * SP + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The row statistics (m, l) and Dv of a q tile's rows into shared memory;
// rows past L get harmless values and are never used.
__device__ __forceinline__ void load_row_stats(float* m_s, float* l_s, float* dv_s,
                                               const float2* stats, const float* dvec,
                                               size_t bh, int q0, int L) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int row = q0 + r;
    const float2 ml = row < L ? stats[bh * L + row] : make_float2(0.f, 1.f);
    m_s[r] = ml.x;
    l_s[r] = ml.y;
    dv_s[r] = row < L ? dvec[bh * L + row] : 0.f;
  }
}

// P and dS of this thread's 4 x 4 tile elements (rows q0 + ty*4 + i, keys
// k0 + tx*4 + j) from s = q.k and dp = dO.v; both are 0 outside L x Lk, and
// dS is 0 at a masked key. On return s holds P and dp holds dS.
__device__ __forceinline__ void tile_p_ds(float (&s)[4][4], float (&dp)[4][4],
                                          const float* relg, const uint8_t* maskg,
                                          const float* m_s, const float* l_s,
                                          const float* dv_s, int q0, int k0, int ty,
                                          int tx, int L, int Lk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      float p = 0.f, ds = 0.f;
      if (row < L && key < Lk) {
        const bool live = maskg[key] != 0;
        const float sv = live ? s[i][j] + relg[(size_t)row * Lk + key] : lako::kNegInf;
        p = expf(sv - m_s[r]) / l_s[r];
        ds = live ? p * (dp[i][j] - dv_s[r]) : 0.f;
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // qT, doT, kT, vT [D][SP]; pS, dsS [TILE][SP] (row-major: [q row][key]); row stats
  return sizeof(float) * (size_t)(4 * D * SP + 2 * TILE * SP + 3 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ rel, const uint8_t* __restrict__ key_mask,
                const float2* __restrict__ stats, const float* __restrict__ dvec,
                const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                int H, int L, int Lk) {
  constexpr int DC = D / 16;  // output columns per thread: tx + 16 * j
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + D * SP;
  float* kT = doT + D * SP;
  float* vT = kT + D * SP;
  float* pS = vT + D * SP;
  float* dsS = pS + TILE * SP;
  float* m_s = dsS + TILE * SP;
  float* l_s = m_s + TILE;
  float* dv_s = l_s + TILE;

  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * H + h;
  const float* relg = rel + (size_t)h * L * Lk;
  const uint8_t* maskg = key_mask + (size_t)b * Lk;

  load_transposed<T, D>(kT, k + bh * Lk * D, k0, Lk);
  load_transposed<T, D>(vT, v + bh * Lk * D, k0, Lk);

  float dk_acc[4][DC], dv_acc[4][DC];  // keys k0 + ty*4 + i, columns tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < L; q0 += TILE) {
    __syncthreads();  // the previous q tile is no longer read
    load_transposed<T, D>(qT, q + bh * L * D, q0, L);
    load_transposed<T, D>(doT, dout + bh * L * D, q0, L);
    load_row_stats(m_s, l_s, dv_s, stats, dvec, bh, q0, L);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_product<D>(qT, kT, ty, tx, s);
    tile_product<D>(doT, vT, ty, tx, dp);
    tile_p_ds(s, dp, relg, maskg, m_s, l_s, dv_s, q0, k0, ty, tx, L, Lk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      *reinterpret_cast<float4*>(&pS[r * SP + tx * 4]) =
          make_float4(lako::round_to<T>(s[i][0]), lako::round_to<T>(s[i][1]),
                      lako::round_to<T>(s[i][2]), lako::round_to<T>(s[i][3]));
      *reinterpret_cast<float4*>(&dsS[r * SP + tx * 4]) =
          make_float4(lako::round_to<T>(dp[i][0]), lako::round_to<T>(dp[i][1]),
                      lako::round_to<T>(dp[i][2]), lako::round_to<T>(dp[i][3]));
    }
    __syncthreads();  // pS, dsS complete

    const int rmax = min(TILE, L - q0);
    for (int r = 0; r < rmax; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pS[r * SP + ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dsS[r * SP + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int col = tx + 16 * j;
        const float o = doT[col * SP + r], x = qT[col * SP + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pv[i], o, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], x, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Lk) continue;
    const size_t base = (bh * Lk + key) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[base + tx + 16 * j] = lako::from_f32<T>(dk_acc[i][j]);
      dv[base + tx + 16 * j] = lako::from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // qT, doT, kT, vT [D][SP]; dsT [TILE][SP] (transposed: [key][q row]); row stats
  return sizeof(float) * (size_t)(4 * D * SP + TILE * SP + 3 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ rel, const uint8_t* __restrict__ key_mask,
              const float2* __restrict__ stats, const float* __restrict__ dvec,
              const T* __restrict__ dout, T* __restrict__ dq, int H, int L, int Lk) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + D * SP;
  float* kT = doT + D * SP;
  float* vT = kT + D * SP;
  float* dsT = vT + D * SP;
  float* m_s = dsT + TILE * SP;
  float* l_s = m_s + TILE;
  float* dv_s = l_s + TILE;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * H + h;
  const T* kg = k + bh * Lk * D;
  const T* vg = v + bh * Lk * D;
  const float* relg = rel + (size_t)h * L * Lk;
  const uint8_t* maskg = key_mask + (size_t)b * Lk;

  load_transposed<T, D>(qT, q + bh * L * D, q0, L);
  load_transposed<T, D>(doT, dout + bh * L * D, q0, L);
  load_row_stats(m_s, l_s, dv_s, stats, dvec, bh, q0, L);

  float dq_acc[4][DC];  // rows q0 + ty*4 + i, columns tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();  // the previous k tile is no longer read
    load_transposed<T, D>(kT, kg, k0, Lk);
    load_transposed<T, D>(vT, vg, k0, Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_product<D>(qT, kT, ty, tx, s);
    tile_product<D>(doT, vT, ty, tx, dp);
    tile_p_ds(s, dp, relg, maskg, m_s, l_s, dv_s, q0, k0, ty, tx, L, Lk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dsT[(tx * 4 + j) * SP + ty * 4]) =
          make_float4(lako::round_to<T>(dp[0][j]), lako::round_to<T>(dp[1][j]),
                      lako::round_to<T>(dp[2][j]), lako::round_to<T>(dp[3][j]));
    __syncthreads();  // dsT complete

    const int kmax = min(TILE, Lk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dsT[c * SP + ty * 4]);
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float x = kT[(tx + 16 * j) * SP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(dsv[i], x, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[(bh * L + row) * D + tx + 16 * j] = lako::from_f32<T>(dq_acc[i][j]);
  }
}

template <int D>
constexpr size_t drel_smem_bytes() {
  // qT, doT, kT, vT [D][SP]; row stats
  return sizeof(float) * (size_t)(4 * D * SP + 3 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_drel_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ rel, const uint8_t* __restrict__ key_mask,
                const float2* __restrict__ stats, const float* __restrict__ dvec,
                const T* __restrict__ dout, float* __restrict__ drel, int B, int H, int L,
                int Lk) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + D * SP;
  float* kT = doT + D * SP;
  float* vT = kT + D * SP;
  float* m_s = vT + D * SP;
  float* l_s = m_s + TILE;
  float* dv_s = l_s + TILE;

  const int k0 = blockIdx.x * TILE;
  const int q0 = blockIdx.y * TILE;
  const int h = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* relg = rel + (size_t)h * L * Lk;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * H + h;
    __syncthreads();  // the previous batch row's tiles are no longer read
    load_transposed<T, D>(qT, q + bh * L * D, q0, L);
    load_transposed<T, D>(doT, dout + bh * L * D, q0, L);
    load_transposed<T, D>(kT, k + bh * Lk * D, k0, Lk);
    load_transposed<T, D>(vT, v + bh * Lk * D, k0, Lk);
    load_row_stats(m_s, l_s, dv_s, stats, dvec, bh, q0, L);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_product<D>(qT, kT, ty, tx, s);
    tile_product<D>(doT, vT, ty, tx, dp);
    tile_p_ds(s, dp, relg, key_mask + (size_t)b * Lk, m_s, l_s, dv_s, q0, k0, ty, tx, L, Lk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += dp[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      if (key < Lk) drel[((size_t)h * L + row) * Lk + key] = acc[i][j];
    }
  }
}

// Set a kernel's dynamic shared memory once, so that later launches can be
// captured in a CUDA graph.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* rel,
                const void* key_mask, const void* stats, const void* dvec, const void* dout,
                void* dk, void* dv, int B, int H, int L, int Lk, cudaStream_t s) {
  static bool configured = false;
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = configure(bwd_dkdv_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lk + TILE - 1) / TILE, H, B);
  bwd_dkdv_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<const float2*>(stats), static_cast<const float*>(dvec),
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), H, L, Lk);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* rel,
              const void* key_mask, const void* stats, const void* dvec, const void* dout,
              void* dq, int B, int H, int L, int Lk, cudaStream_t s) {
  static bool configured = false;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = configure(bwd_dq_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TILE - 1) / TILE, H, B);
  bwd_dq_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<const float2*>(stats), static_cast<const float*>(dvec),
      static_cast<const T*>(dout), static_cast<T*>(dq), H, L, Lk);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_drel(const void* q, const void* k, const void* v, const void* rel,
                const void* key_mask, const void* stats, const void* dvec, const void* dout,
                void* drel, int B, int H, int L, int Lk, cudaStream_t s) {
  static bool configured = false;
  constexpr size_t smem = drel_smem_bytes<D>();
  cudaError_t err = configure(bwd_drel_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lk + TILE - 1) / TILE, (L + TILE - 1) / TILE, H);
  bwd_drel_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<const float2*>(stats), static_cast<const float*>(dvec),
      static_cast<const T*>(dout), static_cast<float*>(drel), B, H, L, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

// The four (dtype, head dim) instantiations each entry takes.
#define LAKO_BWD_DISPATCH(fn, ...)                                              \
  if (dtype == lako::kFloat32 && D == 64) return fn<float, 64>(__VA_ARGS__);    \
  if (dtype == lako::kFloat32 && D == 128) return fn<float, 128>(__VA_ARGS__);  \
  if (dtype == lako::kBFloat16 && D == 64) return fn<bf16, 64>(__VA_ARGS__);    \
  if (dtype == lako::kBFloat16 && D == 128) return fn<bf16, 128>(__VA_ARGS__);  \
  return (int)cudaErrorInvalidValue

// Common arguments: q, dout: (B,H,L,D) and k, v: (B,H,Lk,D), contiguous in
// `dtype`; rel: (H,L,Lk) f32; key_mask: (B,Lk) bool as bytes; stats:
// (B,H,L,2) f32 (row max, row sum) from lako_flash_streamed_fwd; dvec:
// (B,H,L) f32 rowsum(dout * out). Each returns a cudaError_t code (0 = launched).

// dk, dv: (B,H,Lk,D) in `dtype`.
extern "C" int lako_flash_streamed_bwd_dkdv(const void* q, const void* k, const void* v,
                                            const void* rel, const void* key_mask,
                                            const void* stats, const void* dvec,
                                            const void* dout, void* dk, void* dv, int B,
                                            int H, int L, int Lk, int D, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LAKO_BWD_DISPATCH(launch_dkdv, q, k, v, rel, key_mask, stats, dvec, dout, dk, dv, B, H, L,
                    Lk, s);
}

// dq: (B,H,L,D) in `dtype`.
extern "C" int lako_flash_streamed_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* rel, const void* key_mask,
                                          const void* stats, const void* dvec,
                                          const void* dout, void* dq, int B, int H, int L,
                                          int Lk, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LAKO_BWD_DISPATCH(launch_dq, q, k, v, rel, key_mask, stats, dvec, dout, dq, B, H, L, Lk, s);
}

// drel: (H,L,Lk) f32.
extern "C" int lako_flash_streamed_bwd_drel(const void* q, const void* k, const void* v,
                                            const void* rel, const void* key_mask,
                                            const void* stats, const void* dvec,
                                            const void* dout, void* drel, int B, int H,
                                            int L, int Lk, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LAKO_BWD_DISPATCH(launch_drel, q, k, v, rel, key_mask, stats, dvec, dout, drel, B, H, L,
                    Lk, s);
}
