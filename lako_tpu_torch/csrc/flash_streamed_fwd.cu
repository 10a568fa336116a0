// K-streamed attention forward for the T5 encoder (online softmax).
//
// Replaces the Pallas kernel K1 of the JAX package:
//   lako_tpu/ops/flash_streamed.py::streamed_attention -> _streamed_fwd_impl
//   (body _make_streamed_kernel), forward without the logsumexp output.
//
// out[b,h,q,:] = softmax_k(S[b,h,q,k]) . v[b,h,k,:], where
//   S = q.k (unscaled, as T5 folds 1/sqrt(d) into its init) + rel[h,q,k],
//   and S = -1e9 where key_mask[b,k] is False.
// The (B,H,L,Lk) bias and logits never exist in device memory: each block
// streams the k tiles of one (b, h, 64-row q tile), reading its tile of the
// batch-free relative-position bias and the key-mask row.
//
// What bounds it on the H100: at the encoder's shape (B*N=16 rows, H=16,
// L=130, D=64) a call moves ~6 MB (q, k, v in bf16 and the f32 bias, which
// each of the B rows re-reads from L2) and does ~1.1 GFLOP. On the tensor
// cores (989 TFLOP/s bf16 on NVIDIA's H100 SXM data sheet) that arithmetic is
// small next to the loads; on the CUDA cores (67 TFLOP/s f32, same sheet) it
// bounds the kernel. So bf16 inputs take a tensor-core kernel: each of 4 warps owns 16
// query rows, keeps its q fragments in registers, and runs QK^T and PV as
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the logits stay in registers
// and become the A operand of PV without a trip through shared memory. What
// is left is latency: loads of the k/v tiles and the bias, not overlapped
// with the math (cp.async/TMA double buffering is the next step).
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

#include "common.cuh"

namespace {

constexpr int TQ = 64;  // query rows per block
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
                        int H, int L, int Lk) {
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
  }
}

// ---- bfloat16: tensor cores (mma.sync m16n8k16, f32 accumulate) -------------

constexpr int MMA_WARPS = 4;  // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int PAD = 8;  // bf16 row padding: fragment reads hit 32 distinct banks

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t mma_smem_bytes() {
  // qs [TQ][D+PAD], ks [TK][D+PAD], vt [D][TK+PAD] (V transposed)
  return sizeof(bf16) * (size_t)(TQ * (D + PAD) + TK * (D + PAD) + D * (TK + PAD));
}

// d += a (16x16, row-major fragment) * b (16x8, col-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 in shared memory as one register (lower index low)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0+64) x D of a (rows, D) bf16 matrix into smem [64][D+PAD],
// 16 bytes a load; rows at or past n_rows are zero
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int n_rows) {
  for (int i = threadIdx.x; i < 64 * D / 8; i += MMA_THREADS) {
    const int r = i % 64, c = (i / 64) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
streamed_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ rel,
                        const uint8_t* __restrict__ key_mask, bf16* __restrict__ out,
                        int H, int L, int Lk) {
  constexpr int QS = D + PAD;  // row stride of qs and ks
  constexpr int VS = TK + PAD;  // row stride of vt
  constexpr int NT = TK / 8;    // 8-key column tiles of S
  constexpr int KD = D / 16;    // 16-deep steps over d
  constexpr int NO = D / 8;     // 8-wide column tiles of O
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + TQ * QS;
  bf16* vt = ks + TK * QS;

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair
  const size_t bh = (size_t)b * H + h;
  const bf16* kg = k + bh * Lk * D;
  const bf16* vg = v + bh * Lk * D;
  const float* relg = rel + (size_t)h * L * Lk;
  const uint8_t* maskg = key_mask + (size_t)b * Lk;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows

  load_rows<D>(qs, q + bh * L * D, q0, L);
  __syncthreads();
  uint32_t qf[KD][4];  // this warp's q fragments, reused for every k tile
  const bf16* qw = qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qf[kk][0] = ld_pair(qw + g * QS + kk * 16 + t * 2);
    qf[kk][1] = ld_pair(qw + (g + 8) * QS + kk * 16 + t * 2);
    qf[kk][2] = ld_pair(qw + g * QS + kk * 16 + 8 + t * 2);
    qf[kk][3] = ld_pair(qw + (g + 8) * QS + kk * 16 + 8 + t * 2);
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // below any real logit, so the first alpha is 0
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();  // the previous tile's ks/vt are no longer read
    load_rows<D>(ks, kg, k0, Lk);
    for (int i = threadIdx.x; i < TK * D / 8; i += MMA_THREADS) {
      const int r = i % TK, c = (i / TK) * 8;  // neighbouring threads: neighbouring keys
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) val = *reinterpret_cast<const uint4*>(vg + (size_t)(k0 + r) * D + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VS + r] = e[j];
    }
    __syncthreads();

    // S = q k^T: rows (row0, row1), keys k0 + j*8 + t*2 + {0,1}
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kp = ks + (j * 8 + g) * QS + kk * 16 + t * 2;
        mma_bf16(s[j], qf[kk], ld_pair(kp), ld_pair(kp + 8));
      }
    }

    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float val;
        if (key >= Lk) {
          val = -INFINITY;  // past the ragged edge: no weight
        } else if (!maskg[key]) {
          val = lako::kNegInf;
        } else {
          val = s[j][e] + (row < L ? relg[(size_t)row * Lk + key] : 0.f);
        }
        s[j][e] = val;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 64 keys are spread over the 4 threads of its group
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m[r], row_max[r]);  // finite: key k0 is real
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // P = exp(S - m): summed in f32, rounded to bf16 as the A operand of P.V
    uint32_t pf[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
      const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j][0] = pack_bf16(p0, p1);
      pf[j][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const bf16* vp = vt + (j * 8 + g) * VS + kk * 16 + t * 2;
        mma_bf16(o[j], a, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + t * 2;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(out + (bh * L + row0) * D + col) =
          pack_bf16(o[j][0] / l[0], o[j][1] / l[0]);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(out + (bh * L + row1) * D + col) =
          pack_bf16(o[j][2] / l[1], o[j][3] / l[1]);
  }
}

template <typename T, int D, int THREADS, size_t SMEM>
int launch(void (*kernel)(const T*, const T*, const T*, const float*, const uint8_t*,
                          T*, int, int, int),
           const void* q, const void* k, const void* v, const void* rel,
           const void* key_mask, void* out, int B, int H, int L, int Lk,
           cudaStream_t stream) {
  static bool configured = false;  // once, so later launches can be graph-captured
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(rel), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), H, L, Lk);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* rel,
               const void* key_mask, void* out, int B, int H, int L, int Lk,
               cudaStream_t s) {
  return launch<float, D, FMA_THREADS, fma_smem_bytes<D>()>(
      streamed_fwd_fma_kernel<D>, q, k, v, rel, key_mask, out, B, H, L, Lk, s);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* rel,
               const void* key_mask, void* out, int B, int H, int L, int Lk,
               cudaStream_t s) {
  return launch<bf16, D, MMA_THREADS, mma_smem_bytes<D>()>(
      streamed_fwd_mma_kernel<D>, q, k, v, rel, key_mask, out, B, H, L, Lk, s);
}

}  // namespace

// q, k, v, out: (B,H,L|Lk,D) contiguous in `dtype` (bf16 pointers 16-byte
// aligned); rel: (H,L,Lk) f32; key_mask: (B,Lk) bool as bytes. Returns a
// cudaError_t code (0 = launched).
extern "C" int lako_flash_streamed_fwd(const void* q, const void* k, const void* v,
                                       const void* rel, const void* key_mask,
                                       void* out, int B, int H, int L, int Lk,
                                       int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lako::kFloat32 && D == 64)
    return launch_fma<64>(q, k, v, rel, key_mask, out, B, H, L, Lk, s);
  if (dtype == lako::kFloat32 && D == 128)
    return launch_fma<128>(q, k, v, rel, key_mask, out, B, H, L, Lk, s);
  if (dtype == lako::kBFloat16 && D == 64)
    return launch_mma<64>(q, k, v, rel, key_mask, out, B, H, L, Lk, s);
  if (dtype == lako::kBFloat16 && D == 128)
    return launch_mma<128>(q, k, v, rel, key_mask, out, B, H, L, Lk, s);
  return (int)cudaErrorInvalidValue;
}
