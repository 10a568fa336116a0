// K-streamed attention forward for the T5 encoder (online softmax).
//
// Replaces the Pallas kernel K1 of the JAX package:
//   lako_tpu/ops/flash_streamed.py::streamed_attention -> _streamed_fwd_impl
//   (body _make_streamed_kernel), with its optional training statistics.
//
// out[b,h,q,:] = softmax_k(S[b,h,q,k]) . v[b,h,k,:], where
//   S = q.k (unscaled, as T5 folds 1/sqrt(d) into its init) + rel[h,q,k],
//   and S = -1e9 where key_mask[b,k] is False.
// The (B,H,L,Lk) bias and logits never exist in device memory: each block
// streams the k tiles of one (b, h) for its query rows, reading its rows of
// the batch-free relative-position bias and the key-mask row.
//
// What bounds it on the H100: at the encoder's shape (B*N=16 rows, H=16,
// L=130, D=64) a call moves ~18 MB (q, k, v and out in bf16, 4.3 MB each,
// and the 1.1 MB f32 bias, which each of the B rows re-reads from L2) and
// does ~1.1 GFLOP: 5.4 us at 3.35 TB/s, ~1 us on the tensor cores (989
// TFLOP/s bf16 on NVIDIA's H100 SXM data sheet), ~16 us on the CUDA cores
// (67 TFLOP/s f32, same sheet). So bf16 inputs take a tensor-core kernel
// whose blocks each stream their K/V once:
// - One block per (b, h, slab of up to 6 warps x 16 query rows at D = 64, 4
//   at 128), two blocks an SM: at L = 130 two blocks of 5 warps per (b, h),
//   so K and V are read twice per (b, h), not once per 64-row q tile. One
//   block of 9 warps per (b, h), which reads them once, fits one block an SM
//   and measured slower (0.0283 against 0.0268 ms; PERF.md). The edges
//   cost 16 rows and 8 or 16 keys (the ragged last tile is computed only to
//   its 8-key edge in Q.K^T and its 16-key edge in P.V), not 64.
// - Q's rows, then K/V in 64-key tiles, come through cp.async into padded
//   shared memory: a 3-stage ring, so any Lk streams and the next tiles'
//   copies overlap this tile's math. Q's fragments are loaded once by
//   ldmatrix and stay in registers for the whole walk; K's B fragments come
//   through ldmatrix, V's through ldmatrix.trans on the row-major tile.
// - Q.K^T and P.V are mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//   logits stay in registers and become the A operand of P.V.
// - The key mask is turned into bits in shared memory once per block; each
//   thread loads the next tile's bias pairs (8 bytes a pair when Lk is even)
//   into registers once this tile's logits are formed, so they arrive during
//   this tile's softmax and P.V, not on the critical path.
// - o / l is div_rn's quotient: IEEE division's slow-path check dominated K4
//   before it (PERF.md).
// The order of the sums is the two-pass kernel's, which the K1 route's
// greedy tokens depend on (one f32 ulp of l flips near-ties): S summed over d
// in 16-deep steps from d = 0, the bias added after; the running max and
// the rescale at the same 64-key tile boundaries, each P rounded to bf16
// against the running max of its tile; l summed per thread in the same order
// and reduced over the row's 4 threads at the end.
// float32 inputs take a CUDA-core FMA kernel with f32 products, kept for
// exact checks against the plain version.
//
// Semantics kept from the JAX package:
// - f32 logits, f32 running max/sum; P is rounded to the value dtype before
//   P.V (the Pallas kernel's p.astype(v.dtype)); output in the input dtype.
// - A masked key gets logit -1e9, never -inf. A row whose keys are all masked
//   (the padding rows collate(pad_to=B) makes) softmaxes to the mean of V over
//   the real keys, as the plain version does.
// - Keys past Lk (the ragged last tile) get no weight at all; rows past L are
//   computed on zeros and never stored. Nothing is padded on the host.
//
// Statistics for the backward (csrc/flash_streamed_bwd.cu): with a non-null
// `stats` each row also writes (m, l), its f32 row max and row sum of
// exp(S - m), where the JAX kernel writes lse = m + log(l). The pair is exact
// on a fully masked row: there every S is -1e9, so m = -1e9 and l = Lk, and
// the backward's exp(S - m) / l gives 1/Lk per key. lse would not: at 1e9 an
// f32 ulp is 64, so log(Lk) is lost and exp(S - lse) is 1 per key. Serving
// passes null and pays nothing.

#include "common.cuh"

namespace {

constexpr int TQ = 64;  // query rows per block (f32)
constexpr int TK = 64;  // keys per streamed tile

// ---- float32: CUDA-core FMAs ------------------------------------------------

constexpr int FMA_THREADS = 256;  // 16 x 16 threads

template <int D>
constexpr size_t fma_smem_bytes() {
  // qT [D][TQ], kT [D][TK], vS [TK][D], pT [TK][TQ]
  return sizeof(float) * (size_t)(D * TQ + D * TK + TK * D + TK * TQ);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
streamed_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ rel,
                        const uint8_t* __restrict__ key_mask, float* __restrict__ out,
                        float2* __restrict__ stats, int H, int L, int Lk) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + D * TQ;
  float* vS = kT + D * TK;
  float* pT = vS + TK * D;

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key / output-column group
  const int ty = tid / 16;  // query-row group
  const size_t bh = (size_t)b * H + h;
  const float* qg = q + bh * L * D;
  const float* kg = k + bh * Lk * D;
  const float* vg = v + bh * Lk * D;
  const float* relg = rel + (size_t)h * L * Lk;
  const uint8_t* maskg = key_mask + (size_t)b * Lk;

  for (int i = tid; i < TQ * D; i += FMA_THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    qT[c * TQ + r] = row < L ? qg[(size_t)row * D + c] : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;  // below any real logit (>= -1e9), so the first alpha is 0
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();  // the previous tile's kT/vS/pT are no longer read
    for (int i = tid; i < TK * D; i += FMA_THREADS) {
      const int r = i / D, c = i % D, key = k0 + r;
      const bool in = key < Lk;
      kT[c * TK + r] = in ? kg[(size_t)key * D + c] : 0.f;
      vS[r * D + c] = in ? vg[(size_t)key * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[c * TQ + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&kT[c * TK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float row_max[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      row_max[i] = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        if (key < Lk) {
          const float r = row < L ? relg[(size_t)row * Lk + key] : 0.f;
          s[i][j] = maskg[key] ? s[i][j] + r : lako::kNegInf;
          row_max[i] = fmaxf(row_max[i], s[i][j]);
        }
      }
      // the 16 threads of a row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max[i] = fmaxf(row_max[i], __shfl_xor_sync(0xffffffffu, row_max[i], off));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], row_max[i]);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const float p = key < Lk ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        pT[(tx * 4 + j) * TQ + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // pT complete

    const int kmax = min(TK, Lk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pT[c * TQ + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&vS[c * D + tx * DC + j]);
        vv[j] = t.x; vv[j + 1] = t.y; vv[j + 2] = t.z; vv[j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    float* og = out + (bh * L + row) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) og[j] = acc[i][j] / l[i];
    // m and l are whole-row values in every thread of the row group
    if (stats != nullptr && tx == 0) stats[bh * L + row] = make_float2(m[i], l[i]);
  }
}

// ---- bfloat16: tensor cores (mma.sync m16n8k16, f32 accumulate) -------------

constexpr int STAGES = 3;           // K/V tiles in the shared-memory ring
constexpr int PAD = 8;              // bf16 row padding: ldmatrix rows hit distinct banks
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may use (227 KB)

using bf16 = __nv_bfloat16;
using lako::mma_bf16;
using lako::pack_bf16;

// warps (16 query rows each) per block, at most: two blocks an SM, within
// the registers (167 a thread at D = 64, 247 at 128, as ptxas reports them
// for sm_90a; chip_smoke.py prints them)
template <int D>
constexpr int mma_max_warps() { return D == 64 ? 6 : 4; }

// A block's shared memory: Q's rows [warps*16][D+PAD], the ring of STAGES
// (K, V) tile pairs [TK][D+PAD] each, and the key mask as bits, two words a
// tile.
template <int D>
size_t mma_smem_bytes(int warps, int Lk) {
  return sizeof(bf16) * (size_t)(warps * 16 + STAGES * 2 * TK) * (D + PAD) +
         sizeof(uint32_t) * 2 * (size_t)((Lk + TK - 1) / TK);
}

// One block per (b*h, slab of W*16 query rows), W warps of 16 rows. Copy
// group 0 holds Q's rows and K/V tile 0, group i tile i; tile i + 2 is
// issued while tile i computes. Warps wholly past L only copy.
template <int D>
__global__ void __launch_bounds__(32 * mma_max_warps<D>(), 2)
streamed_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ rel,
                        const uint8_t* __restrict__ key_mask, bf16* __restrict__ out,
                        float2* __restrict__ stats, int H, int L, int Lk) {
  constexpr int P = D + PAD;        // row pitch of Q and the K/V tiles
  constexpr int NT = TK / 8;        // 8-key column tiles of S
  constexpr int NO = D / 8;         // 8-wide column tiles of O
  constexpr int STAGE = 2 * TK * P;  // one (K, V) tile pair
  const int W = blockDim.x / 32;
  const int nk = (Lk + TK - 1) / TK;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ring = qs + W * 16 * P;
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(ring + STAGES * STAGE);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * W * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;  // mma fragment column pair
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;

  // K/V tile i (keys [64 i, 64 i + 64)) into its stage, up to its 16-key edge
  auto issue = [&](int i) {
    bf16* st = ring + (i % STAGES) * STAGE;
    const int k0 = i * TK, rows = min(TK, (Lk - k0 + 15) & ~15);
    lako::cp_async_rows<D>(st, P, kg + (size_t)k0 * D, rows, Lk - k0);
    lako::cp_async_rows<D>(st + TK * P, P, vg + (size_t)k0 * D, rows, Lk - k0);
  };
  lako::cp_async_rows<D>(qs, P, q + ((size_t)bh * L + q0) * D, W * 16, L - q0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) issue(i);
    lako::cp_async_commit();
  }
  // the key mask as bits: word w holds keys [32 w, 32 w + 32), 0 past Lk
  for (int w = warp; w < 2 * nk; w += W) {
    const int key = 32 * w + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, key < Lk && key_mask[(size_t)b * Lk + key]);
    if (lane == 0) live_bits[w] = bits;
  }

  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;  // this thread's rows
  const bool active = q0 + warp * 16 < L;
  const bool vec = (Lk & 1) == 0 && reinterpret_cast<uintptr_t>(rel) % 8 == 0;
  // bias at (row, key) and (row, key + 1); 0 past L or Lk
  auto rel_pair = [&](int row, int key) {
    if (row >= L || key >= Lk) return make_float2(0.f, 0.f);
    const float* r = rel + ((size_t)h * L + row) * Lk + key;
    if (vec) return *reinterpret_cast<const float2*>(r);
    return make_float2(r[0], key + 1 < Lk ? r[1] : 0.f);
  };
  // tile i's bias at this thread's rows and keys 64 i + 8 j + 2 t + {0, 1}
  float rl[NT][4];
  auto load_rel = [&](int i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = i * TK + j * 8 + t * 2;
      const float2 a = rel_pair(row0, key), c = rel_pair(row1, key);
      rl[j][0] = a.x; rl[j][1] = a.y; rl[j][2] = c.x; rl[j][3] = c.y;
    }
  };
  if (active) load_rel(0);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // below any real logit, so the first alpha is 0
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums
  uint32_t qf[D / 16][4];         // this warp's q fragments, loaded once

  for (int i = 0; i < nk; ++i) {
    lako::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; tile i - 1's stage is no longer read
    if (i + STAGES - 1 < nk) issue(i + STAGES - 1);
    lako::cp_async_commit();
    if (!active) continue;
    if (i == 0) {
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32)
        lako::load_a_x2(qf[c0 / 16], qf[c0 / 16 + 1], qs + warp * 16 * P, P, c0);
    }
    const bf16* ks = ring + (i % STAGES) * STAGE;
    const int n = min(TK, Lk - i * TK);  // real keys in this tile
    const int n_tiles = (n + 7) / 8;     // 8-key tiles that hold one

    // S = q k^T: rows (row0, row1), keys 64 i + 8 j + 2 t + {0,1}
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 32)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < n_tiles) {
          uint32_t bk[4];
          lako::load_b_rows(bk, ks, P, j * 8, c0);
          mma_bf16(s[j], qf[c0 / 16], bk[0], bk[1]);
          mma_bf16(s[j], qf[c0 / 16 + 1], bk[2], bk[3]);
        }

    // + bias; a masked key -1e9; past Lk no weight
    const uint32_t w0 = live_bits[2 * i], w1 = live_bits[2 * i + 1];
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t * 2 + (e & 1);  // in the tile
        const bool live = ((j < NT / 2 ? w0 >> key : w1 >> (key - 32)) & 1u) != 0;
        float val;
        if (key >= n) {
          val = -INFINITY;
        } else if (!live) {
          val = lako::kNegInf;
        } else {
          val = s[j][e] + rl[j][e];
        }
        s[j][e] = val;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], val);
      }
    if (i + 1 < nk) load_rel(i + 1);  // in flight during this tile's softmax and P.V

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 64 keys are spread over the 4 threads of its group
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m[r], row_max[r]);  // finite: key 64 i is real
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // P = exp(S - m): summed in f32, rounded to bf16 as the A operand of P.V
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n_tiles) {
        const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
        const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        s[j][0] = p0; s[j][1] = p1; s[j][2] = p2; s[j][3] = p3;
      } else {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      if (16 * kk < n) {
        uint32_t a[4];
        lako::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        lako::mma_ay<D>(o, a, ks + TK * P + kk * 16 * P, P);
      }
  }
  if (!active) return;

  float rcp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    rcp[r] = __frcp_rn(l[r]);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + t * 2;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + row0) * D + col) =
          pack_bf16(lako::div_rn(o[j][0], l[0], rcp[0]), lako::div_rn(o[j][1], l[0], rcp[0]));
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + row1) * D + col) =
          pack_bf16(lako::div_rn(o[j][2], l[1], rcp[1]), lako::div_rn(o[j][3], l[1], rcp[1]));
  }
  if (stats != nullptr && t == 0) {
    if (row0 < L) stats[(size_t)bh * L + row0] = make_float2(m[0], l[0]);
    if (row1 < L) stats[(size_t)bh * L + row1] = make_float2(m[1], l[1]);
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* rel,
               const void* key_mask, void* out, void* stats, int B, int H, int L,
               int Lk, cudaStream_t s) {
  auto kernel = streamed_fwd_fma_kernel<D>;
  constexpr size_t smem = fma_smem_bytes<D>();
  static bool configured[lako::kMaxDevices] = {};
  const cudaError_t err = lako::configure_smem(kernel, (int)smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  kernel<<<grid, FMA_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), static_cast<float2*>(stats), H, L, Lk);
  return (int)cudaGetLastError();
}

// Picks the block: up to mma_max_warps warps, spread evenly over the fewest
// blocks that cover L's 16-row tiles (two blocks of 5 warps per (b, h) at
// L = 130).
template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* rel,
               const void* key_mask, void* out, void* stats, int B, int H, int L,
               int Lk, cudaStream_t s) {
  auto kernel = streamed_fwd_mma_kernel<D>;
  static bool configured[lako::kMaxDevices] = {};
  const cudaError_t err = lako::configure_smem(kernel, SMEM_LIMIT, configured);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (L + 15) / 16;
  int warps = min(row_tiles, mma_max_warps<D>());
  const int blocks = (row_tiles + warps - 1) / warps;
  warps = (row_tiles + blocks - 1) / blocks;
  const size_t smem = mma_smem_bytes<D>(warps, Lk);
  if (smem > SMEM_LIMIT || blocks > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(B * H, blocks), 32 * warps, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<bf16*>(out), static_cast<float2*>(stats), H, L, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B,H,L|Lk,D) contiguous in `dtype` (bf16 pointers 16-byte
// aligned); rel: (H,L,Lk) f32; key_mask: (B,Lk) bool as bytes; stats: null,
// or (B,H,L,2) f32 for (row max, row sum). Returns a cudaError_t code
// (0 = launched).
extern "C" int lako_flash_streamed_fwd(const void* q, const void* k, const void* v,
                                       const void* rel, const void* key_mask,
                                       void* out, void* stats, int B, int H, int L,
                                       int Lk, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lako::kFloat32 && D == 64)
    return launch_fma<64>(q, k, v, rel, key_mask, out, stats, B, H, L, Lk, s);
  if (dtype == lako::kFloat32 && D == 128)
    return launch_fma<128>(q, k, v, rel, key_mask, out, stats, B, H, L, Lk, s);
  if (dtype == lako::kBFloat16 && D == 64)
    return launch_mma<64>(q, k, v, rel, key_mask, out, stats, B, H, L, Lk, s);
  if (dtype == lako::kBFloat16 && D == 128)
    return launch_mma<128>(q, k, v, rel, key_mask, out, stats, B, H, L, Lk, s);
  return (int)cudaErrorInvalidValue;
}
