// K-streamed attention backward for the T5 encoder: three kernels.
//
// Replaces the Pallas kernels of the JAX package's streamed backward
// (lako_tpu/ops/flash_streamed.py, _streamed_bwd_impl):
//   K2a _bwd_dkdv_kernel (:289) -> lako_flash_streamed_bwd_dkdv
//   K2b _bwd_dq_kernel   (:319) -> lako_flash_streamed_bwd_dq
//   K2c _bwd_drel_kernel (:344) -> lako_flash_streamed_bwd_drel
//
// Each kernel recomputes, for its tiles of query rows and keys,
//   S  = q.k + rel[h]          (a masked key: S = -1e9, as in the forward)
//   P  = exp(S - m) / l        from the forward's row statistics (m, l)
//   dP = dO.v,   dS = P (dP - Dv), and dS = 0 at a masked key
// where Dv = rowsum(dO * O) in f32 comes from the wrapper. Then
//   K2a: dV[k] = sum_q P[q,k] dO[q], dK[k] = sum_q dS[q,k] q[q]
//        one block per (b, h, key slab), walking the q rows;
//   K2b: dQ[q] = sum_k dS[q,k] k[k]
//        one block per (b, h, q tile), walking the k tiles;
//   K2c: drel[h,q,k] = sum_b dS[b,h,q,k]
//        walking the batch inside each block (bf16: one block per (24-key
//        slab, 48-row slab, h); f32: per (h, q tile, k tile)). Each element
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
// move ~20 MB each (q, k, v, dO in bf16, the statistics, rel), a few us at
// 3.35 TB/s; so on the CUDA cores (67 TFLOP/s f32 on NVIDIA's H100 SXM data
// sheet) the products bound them, on the tensor cores the bytes and latency.
// - K2b, and every kernel for f32 inputs, run every product on CUDA-core
//   FMAs in f32: operands staged in shared memory as f32, transposed with a
//   padded row stride so that the tile products read float4s, 64 x 64 tiles
//   (the ragged edge at L=130 costs a third, nearly empty tile in each
//   direction).
// - K2a for bf16 runs all four products on the tensor cores with the keys on
//   the mma M axis: each warp owns 16 keys, so S^T = K.Q^T and dP^T = V.dO^T
//   are the same X.Y^T tile step as K2c's (attention_bwd_tile.cuh, K and V
//   as X), P^T and dS^T are formed in the C fragments (warp_p_ds_cols: the
//   row terms vary along the columns there), rounded to bf16 straight into
//   the A operand of dV += P^T.dO and dK += dS^T.q, whose B fragments come
//   through ldmatrix.trans on the row-major q/dO tiles. dK and dV stay in
//   f32 registers for the whole walk and are written once, each element by
//   one warp (no atomics). One block per (b, h, slab of up to 4 warps; at
//   Lk = 130 three blocks of 3), walking the q rows 16 at a time through a
//   3-stage cp.async ring that brings q, dO, their (m, l) and Dv, and the
//   rel tile two steps ahead. The edges cost 16 keys and 8 or 16 rows, not
//   64. K's and V's fragments are loaded from shared memory each step (held
//   in registers at D = 64 they took the kernel to 205 registers and one
//   block an SM; PERF.md); at D = 128, dK and dV alone take 128
//   registers a thread.
// - K2c for bf16 runs both products on the tensor cores (attention_bwd_tile.cuh:
//   S = Q.K^T and dP = dO.V^T as mma.sync m16n8k16 on ldmatrix fragments of
//   the row-major tiles, P and dS formed in the C fragments, P / l by
//   div_rn). What bounds it is the walk's latency, B batch rows one after
//   another in each block, not its bytes: so 240 blocks of 6 warps at L=130
//   (3 x 16 rows by 2 x 16 keys, a warp 16 rows x 16 keys) keep ~11 warps on
//   each of the 132 SMs, and the edges cost 16 rows and 8 keys, not 64. Each
//   warp reads its rel tile into registers once and keeps its drel sum there;
//   cp.async brings q, dO, k and v two batch rows ahead into a 3-stage
//   shared-memory ring, and the next row's (m, l), Dv and key mask are loaded
//   into registers one row ahead, so neither waits on device memory.

#include <type_traits>

#include "attention_bwd_tile.cuh"
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

// ---- K2c for bf16: tensor cores, a pipelined walk over the batch ----------

constexpr int DREL_ROW_WARPS = 3;  // warps along the rows, 16 query rows each
constexpr int DREL_KEY_WARPS = 2;  // warps along the keys
constexpr int DREL_KT = 2;         // 8-key tiles per warp
constexpr int DREL_STAGES = 3;     // batch rows in the shared-memory ring
constexpr int DREL_ROWS = 16 * DREL_ROW_WARPS;               // rows per block
constexpr int DREL_KEYS = 8 * DREL_KT * DREL_KEY_WARPS;      // keys per block
constexpr int DREL_THREADS = 32 * DREL_ROW_WARPS * DREL_KEY_WARPS;

// Instantiations: D = 64 and 128, 116 and 117 registers a thread as ptxas
// reports them for sm_90a (chip_smoke.py prints them), no spills.
template <int D>
constexpr size_t drel_mma_smem_bytes() {
  // per stage: q and dO rows [DREL_ROWS][D+8], k and v rows [DREL_KEYS][D+8]
  return sizeof(bf16) * (size_t)DREL_STAGES * (2 * DREL_ROWS + 2 * DREL_KEYS) * (D + 8);
}

// One block per (key slab, row slab, h); warp (rw, kw) owns 16 rows x 8 KT
// keys of the slab and keeps, in registers, its rel tile (read once) and its
// drel sum, added to in the order b = 0..B-1 and written once. The block walks
// the batch through a DREL_STAGES ring: the copies of rows b + 1 .. b +
// DREL_STAGES - 1 (cp.async), and the loads of row b + 1's statistics and key
// mask (into registers), are in flight while row b computes.
template <int D>
__global__ void __launch_bounds__(DREL_THREADS)
bwd_drel_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ rel,
                    const uint8_t* __restrict__ key_mask, const float2* __restrict__ stats,
                    const float* __restrict__ dvec, const bf16* __restrict__ dout,
                    float* __restrict__ drel, int B, int H, int L, int Lk) {
  constexpr int P = D + 8;  // row pitch: ldmatrix rows hit distinct banks
  constexpr int KT = DREL_KT;
  constexpr int STAGE = (2 * DREL_ROWS + 2 * DREL_KEYS) * P;
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);

  const int k0 = blockIdx.x * DREL_KEYS;
  const int q0 = blockIdx.y * DREL_ROWS;
  const int h = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % DREL_ROW_WARPS, kw = warp / DREL_ROW_WARPS;
  const int t = lane % 4;
  const int row0 = q0 + rw * 16 + lane / 4, row1 = row0 + 8;  // this thread's rows
  const int wk = kw * 8 * KT;                                   // the warp's keys in the slab
  const bool active = q0 + rw * 16 < L && k0 + wk < Lk;  // else the warp only copies
  const int n_tiles = min(KT, (Lk - k0 - wk + 7) / 8);    // tiles that hold a real key

  auto issue = [&](int b) {  // batch row b's operands into its stage
    bf16* st = ring + (b % DREL_STAGES) * STAGE;
    const size_t bh = (size_t)b * H + h;
    lako::cp_async_rows<D>(st, P, q + (bh * L + q0) * D, DREL_ROWS, L - q0);
    lako::cp_async_rows<D>(st + DREL_ROWS * P, P, dout + (bh * L + q0) * D, DREL_ROWS, L - q0);
    lako::cp_async_rows<D>(st + 2 * DREL_ROWS * P, P, k + (bh * Lk + k0) * D, DREL_KEYS, Lk - k0);
    lako::cp_async_rows<D>(st + (2 * DREL_ROWS + DREL_KEYS) * P, P, v + (bh * Lk + k0) * D,
                           DREL_KEYS, Lk - k0);
  };
  // batch row b's statistics, Dv and key-mask bytes for this thread; nothing
  // uses them before the next row's copies have been waited for
  struct RowLoads {
    float2 ml[2];
    float dv[2];
    uint8_t live[KT][2];
  };
  auto load = [&](int b, RowLoads& x) {
    const size_t bh = (size_t)b * H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row0 : row1;
      x.ml[r] = row < L ? stats[bh * L + row] : make_float2(0.f, 1.f);
      x.dv[r] = row < L ? dvec[bh * L + row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + wk + j * 8 + t * 2 + e;
        x.live[j][e] = key < Lk ? key_mask[(size_t)b * Lk + key] : 0;
      }
  };
#pragma unroll
  for (int b = 0; b < DREL_STAGES - 1; ++b) {
    if (b < B) issue(b);
    lako::cp_async_commit();
  }
  RowLoads cur, next;
  if (B > 0) load(0, cur);

  // the rel tile and which keys lie before Lk, read once
  float rl[KT][4], acc[KT][4];
  uint32_t in_keys = 0;
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + wk + j * 8 + t * 2 + (e & 1), row = e < 2 ? row0 : row1;
      rl[j][e] = row < L && key < Lk ? rel[((size_t)h * L + row) * Lk + key] : 0.f;
      acc[j][e] = 0.f;
      if (key < Lk) in_keys |= 1u << (2 * j + (e & 1));
    }

  for (int b = 0; b < B; ++b) {
    if (b + DREL_STAGES - 1 < B) issue(b + DREL_STAGES - 1);
    lako::cp_async_commit();
    if (b + 1 < B) load(b + 1, next);
    lako::cp_async_wait<DREL_STAGES - 1>();
    __syncthreads();
    if (active) {
      lako::RowTerms terms[2];
      uint32_t live_keys = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        terms[r] = {cur.ml[r].x, cur.ml[r].y, __frcp_rn(cur.ml[r].y), cur.dv[r]};
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (cur.live[j][e]) live_keys |= 1u << (2 * j + e);
      const bf16* st = ring + (b % DREL_STAGES) * STAGE;
      float s[KT][4], dp[KT][4];
      lako::warp_s_dp<D, KT>(st + rw * 16 * P, st + (DREL_ROWS + rw * 16) * P,
                             st + (2 * DREL_ROWS + wk) * P,
                             st + (2 * DREL_ROWS + DREL_KEYS + wk) * P, P, n_tiles, s, dp);
      lako::warp_p_ds<KT>(s, dp, rl, in_keys, live_keys, terms, row0 < L, row1 < L);
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += dp[j][e];
    }
    __syncthreads();  // this stage is refilled DREL_STAGES rows later
    cur = next;
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + wk + j * 8 + t * 2 + (e & 1), row = e < 2 ? row0 : row1;
      if (row < L && key < Lk) drel[((size_t)h * L + row) * Lk + key] = acc[j][e];
    }
}

// ---- K2a for bf16: tensor cores, the keys on the M axis --------------------

constexpr int DKDV_MAX_WARPS = 4;  // warps (16 keys each) per block, at most
constexpr int DKDV_ROWS = 16;      // query rows per step of the walk
constexpr int DKDV_STAGES = 3;     // steps in the shared-memory ring
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may use (227 KB)

// the rel tile's row pitch in floats: a warp's reads of it (rows 2 t + c,
// keys g) fall in 32 distinct banks
__host__ __device__ constexpr int dkdv_rel_pitch(int warps) { return warps * 16 + 4; }

// one stage: q and dO rows [DKDV_ROWS][D+8] (bf16), the rel tile
// [DKDV_ROWS][rel pitch] (f32), (m, l) and Dv of the rows
template <int D>
__host__ __device__ constexpr size_t dkdv_stage_bytes(int warps) {
  return sizeof(bf16) * 2 * DKDV_ROWS * (D + 8) +
         sizeof(float) * DKDV_ROWS * dkdv_rel_pitch(warps) +
         (sizeof(float2) + sizeof(float)) * DKDV_ROWS;
}

// a block's K and V rows [warps*16][D+8], then the ring
template <int D>
constexpr size_t dkdv_mma_smem_bytes(int warps) {
  return sizeof(bf16) * 2 * warps * 16 * (D + 8) + DKDV_STAGES * dkdv_stage_bytes<D>(warps);
}

// One block per (b*h, slab of W*16 keys), W warps of 16 keys. Copy group 0
// holds the slab's K and V rows and step 0's tiles, group i step i's (query
// rows [16 i, 16 i + 16)); step i + 2 is issued while step i computes.
// rel_vec: floats per copy of the rel tile (4, 2 or 1, as Lk and rel's
// alignment allow). Warps wholly past Lk only copy.
template <int D>
__global__ void __launch_bounds__(32 * DKDV_MAX_WARPS)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ rel,
                    const uint8_t* __restrict__ key_mask, const float2* __restrict__ stats,
                    const float* __restrict__ dvec, const bf16* __restrict__ dout,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int L, int Lk,
                    int rel_vec) {
  constexpr int P = D + 8;                // row pitch of the bf16 tiles
  constexpr int KT = DKDV_ROWS / 8;       // 8-row column tiles of S^T
  constexpr int NO = D / 8;               // 8-wide column tiles of dK, dV
  const int W = blockDim.x / 32;
  const int KS = W * 16;                  // keys per block
  const int RP = dkdv_rel_pitch(W);
  const size_t stage_bytes = dkdv_stage_bytes<D>(W);
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + KS * P;
  char* ring = reinterpret_cast<char*>(vs + KS * P);
  struct Stage {
    bf16* q;
    bf16* dout;
    float* rel;
    float2* ml;
    float* dv;
  };
  auto stage = [&](int i) {
    Stage st;
    st.q = reinterpret_cast<bf16*>(ring + (i % DKDV_STAGES) * stage_bytes);
    st.dout = st.q + DKDV_ROWS * P;
    st.rel = reinterpret_cast<float*>(st.dout + DKDV_ROWS * P);
    st.ml = reinterpret_cast<float2*>(st.rel + DKDV_ROWS * RP);
    st.dv = reinterpret_cast<float*>(st.ml + DKDV_ROWS);
    return st;
  };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wk = warp * 16;                           // the warp's keys in the slab
  const int key0 = k0 + wk + lane / 4, key1 = key0 + 8;  // this thread's keys
  const bool active = k0 + wk < Lk;
  const int n_steps = (L + DKDV_ROWS - 1) / DKDV_ROWS;

  auto issue = [&](int i) {  // step i's tiles into its stage
    const Stage st = stage(i);
    const int r0 = i * DKDV_ROWS, n = L - r0;
    lako::cp_async_rows<D>(st.q, P, q + ((size_t)bh * L + r0) * D, DKDV_ROWS, n);
    lako::cp_async_rows<D>(st.dout, P, dout + ((size_t)bh * L + r0) * D, DKDV_ROWS, n);
    // the rel tile: warp w copies rows w, w + W, ..., lanes along the keys
    const float* relg = rel + ((size_t)h * L + r0) * Lk + k0;
    for (int r = warp; r < DKDV_ROWS; r += W)
      for (int c = lane * rel_vec; c < KS; c += 32 * rel_vec) {
        const bool valid = r < n && k0 + c < Lk;
        const float* src = valid ? relg + (size_t)r * Lk + c : rel;
        float* dst = st.rel + r * RP + c;
        if (rel_vec == 4) {
          lako::cp_async16(dst, src, valid);
        } else if (rel_vec == 2) {
          lako::cp_async_small<8>(dst, src, valid);
        } else {
          lako::cp_async_small<4>(dst, src, valid);
        }
      }
    for (int r = threadIdx.x; r < DKDV_ROWS; r += blockDim.x) {
      const bool valid = r < n;
      const size_t row = (size_t)bh * L + r0 + r;
      lako::cp_async_small<8>(st.ml + r, valid ? stats + row : stats, valid);
      lako::cp_async_small<4>(st.dv + r, valid ? dvec + row : dvec, valid);
    }
  };
  lako::cp_async_rows<D>(ks, P, k + ((size_t)bh * Lk + k0) * D, KS, Lk - k0);
  lako::cp_async_rows<D>(vs, P, v + ((size_t)bh * Lk + k0) * D, KS, Lk - k0);
#pragma unroll
  for (int i = 0; i < DKDV_STAGES - 1; ++i) {
    if (i < n_steps) issue(i);
    lako::cp_async_commit();
  }

  const bool in0 = key0 < Lk, in1 = key1 < Lk;
  const bool live0 = in0 && key_mask[(size_t)b * Lk + key0] != 0;
  const bool live1 = in1 && key_mask[(size_t)b * Lk + key1] != 0;
  float dka[NO][4], dva[NO][4];  // keys (key0, key1) x columns 8 j + 2 t + {0, 1}
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    lako::cp_async_wait<DKDV_STAGES - 2>();
    __syncthreads();  // step i has landed; step i - 1's stage is no longer read
    if (i + DKDV_STAGES - 1 < n_steps) issue(i + DKDV_STAGES - 1);
    lako::cp_async_commit();
    if (!active) continue;
    const Stage st = stage(i);
    const int n = min(DKDV_ROWS, L - i * DKDV_ROWS);  // real query rows in this step

    // S^T = K.Q^T, dP^T = V.dO^T: keys (key0, key1), rows 8 j + 2 t + {0, 1}
    float s[KT][4], dp[KT][4];
    lako::warp_s_dp<D, KT>(ks + wk * P, vs + wk * P, st.q, st.dout, P, (n + 7) / 8, s, dp);
    float rl[KT][4];
    lako::RowTerms col[KT][2];
    uint32_t in_rows = 0;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = j * 8 + t * 2 + c;
        const float2 ml = st.ml[r];
        col[j][c] = {ml.x, ml.y, __frcp_rn(ml.y), st.dv[r]};
        if (r < n) in_rows |= 1u << (2 * j + c);
        rl[j][c] = st.rel[r * RP + wk + lane / 4];
        rl[j][c + 2] = st.rel[r * RP + wk + lane / 4 + 8];
      }
    lako::warp_p_ds_cols<KT>(s, dp, rl, in_rows, col, in0, in1, live0, live1);

    // dV += P^T.dO, dK += dS^T.q, 16 query rows a k-step
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk)
      if (16 * kk < n) {
        uint32_t a[4];
        lako::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        lako::mma_ay<D>(dva, a, st.dout + kk * 16 * P, P);
        lako::c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        lako::mma_ay<D>(dka, a, st.q + kk * 16 * P, P);
      }
  }
  if (!active) return;

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + t * 2;
    if (in0) {
      const size_t at = ((size_t)bh * Lk + key0) * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) = lako::pack_bf16(dka[j][0], dka[j][1]);
      *reinterpret_cast<uint32_t*>(dv + at) = lako::pack_bf16(dva[j][0], dva[j][1]);
    }
    if (in1) {
      const size_t at = ((size_t)bh * Lk + key1) * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) = lako::pack_bf16(dka[j][2], dka[j][3]);
      *reinterpret_cast<uint32_t*>(dv + at) = lako::pack_bf16(dva[j][2], dva[j][3]);
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

// Picks K2a's bf16 block: up to DKDV_MAX_WARPS warps, spread evenly over the
// fewest blocks that cover Lk's 16-key tiles (three blocks of 3 warps per
// (b, h) at Lk = 130). Registers a thread as ptxas reports them for sm_90a
// (chip_smoke.py prints them): 128 at D = 64, 222 at 128, no spills.
template <int D>
int launch_dkdv_mma(const void* q, const void* k, const void* v, const void* rel,
                    const void* key_mask, const void* stats, const void* dvec,
                    const void* dout, void* dk, void* dv, int B, int H, int L, int Lk,
                    cudaStream_t s) {
  static bool configured = false;
  cudaError_t err = configure(bwd_dkdv_mma_kernel<D>, SMEM_LIMIT, configured);
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (Lk + 15) / 16;
  int warps = key_tiles < DKDV_MAX_WARPS ? key_tiles : DKDV_MAX_WARPS;
  const int blocks = (key_tiles + warps - 1) / warps;
  warps = (key_tiles + blocks - 1) / blocks;
  const size_t smem = dkdv_mma_smem_bytes<D>(warps);
  if (smem > SMEM_LIMIT || blocks > 65535) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(rel);
  const int rel_vec = Lk % 4 == 0 && at % 16 == 0 ? 4 : Lk % 2 == 0 && at % 8 == 0 ? 2 : 1;
  bwd_dkdv_mma_kernel<D><<<dim3(B * H, blocks), 32 * warps, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<const float2*>(stats), static_cast<const float*>(dvec),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, L, Lk,
      rel_vec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* rel,
                const void* key_mask, const void* stats, const void* dvec, const void* dout,
                void* dk, void* dv, int B, int H, int L, int Lk, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_dkdv_mma<D>(q, k, v, rel, key_mask, stats, dvec, dout, dk, dv, B, H, L, Lk, s);
  } else {
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
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr size_t smem = drel_mma_smem_bytes<D>();
    cudaError_t err = configure(bwd_drel_mma_kernel<D>, smem, configured);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Lk + DREL_KEYS - 1) / DREL_KEYS, (L + DREL_ROWS - 1) / DREL_ROWS, H);
    bwd_drel_mma_kernel<D><<<grid, DREL_THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
        static_cast<const float2*>(stats), static_cast<const float*>(dvec),
        static_cast<const bf16*>(dout), static_cast<float*>(drel), B, H, L, Lk);
    return (int)cudaGetLastError();
  } else {
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
