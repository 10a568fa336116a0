// Whole-block attention with a dense additive bias: the forward of K4.
//
// Replaces the Pallas kernel K4 of the JAX package:
//   lako_tpu/ops/flash_attention.py::fused_attention (body _attention_kernel).
//
// Per (b, h) and query row i, with q, k, v in T (float or bf16):
//   S[j]   = sum_d q[i,d] * k[j,d]  (f32)  + bias[b,h,i,j]  (f32 or bf16, read as f32)
//   P[j]   = exp(S[j] - max S) / sum_j exp(S[j] - max S), rounded to T
//   out[d] = sum_j P[j] * v[j,d]    (f32), stored as T
// The bias is read through its strides, so a broadcast batch or head axis
// (stride 0) costs no copy; a null bias adds nothing. Every row sees all Lk
// keys at once, Lk <= 512 (the wrapper refuses more).
//
// What bounds it on the H100: at the encoder's shape (16,16,130,64) it reads
// 17 MB of q/k/v/out and 17 MB of f32 bias for 1.1 GFLOP, so memory traffic
// bounds it (about 10 us at 3.35 TB/s); S and P never reach device memory.
// - bf16 with D = 64 or 128 runs on the tensor cores, in K1's tiling
//   (csrc/flash_streamed_fwd.cu): one block per (b*h, 64 query rows), each of
//   4 warps owns 16 rows with its q fragments in registers, and Q.K^T and P.V
//   are mma.sync m16n8k16 over 64-key tiles. The exact softmax takes two
//   passes over the keys: the first keeps each row's running max and sum,
//   the second recomputes the logits (the bias's second read mostly hits L2)
//   and feeds P = exp(S - m) / sum, rounded to bf16, to P.V as the A operand.
// - float32, and bf16 at other head dims, run on CUDA-core FMAs: one block
//   per (b*h, 32 query rows) holds its rows' logits in shared memory,
//   streams K and then V through shared memory in chunks of 128 keys
//   (converted to f32 once), and each of its 8 warps owns 4 query rows, so
//   that a K or V element read from shared memory feeds 4 rows.

#include <type_traits>

#include "common.cuh"

namespace {

// ---- float32, and bf16 at other head dims: CUDA-core FMAs ------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int CHUNK = 128;                   // keys per shared-memory chunk
constexpr int KEYS_PER_LANE = CHUNK / 32;
constexpr int MAX_D = 128;
constexpr int D_PER_LANE = MAX_D / 32;

// shared memory: q rows [ROWS][D], a K or V chunk [CHUNK][D + 4] (the pad
// keeps the lanes' float4 reads of neighbouring keys in distinct banks), and
// the rows' logits, then probabilities, [ROWS][round_up(Lk, 4)]
__host__ __device__ inline int kv_pitch(int D) { return D + 4; }
__host__ __device__ inline int s_pitch(int Lk) { return (Lk + 3) & ~3; }
inline size_t smem_bytes(int D, int Lk) {
  return sizeof(float) * ((size_t)ROWS * D + (size_t)CHUNK * kv_pitch(D) + (size_t)ROWS * s_pitch(Lk));
}

// n rows of D values from device memory to shared memory as f32, rows
// `pitch` floats apart, in 16-byte loads (D is a multiple of 8), a few in
// flight per thread. Rows past n are left as they are: lanes that own them
// compute on them, but nothing they give is kept.
template <typename T>
__device__ void load_rows(float* __restrict__ dst, int pitch, const T* __restrict__ src,
                          int n, int D) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = D / V;
#pragma unroll 4
  for (int x = threadIdx.x; x < n * per_row; x += THREADS) {
    const int row = x / per_row, seg = x - row * per_row;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * D + seg * V);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* out = dst + row * pitch + seg * V;
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = lako::to_f32(vals[e]);
  }
}

template <typename T, typename BT>
__global__ void __launch_bounds__(THREADS)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const BT* __restrict__ bias,
                       T* __restrict__ out, int H, int L, int Lk, int D,
                       int sb, int sh, int si, int sj) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + ROWS * D;
  float* s = kv + CHUNK * kv_pitch(D);
  const int sp = s_pitch(Lk), kp = kv_pitch(D);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int row0 = blockIdx.y * ROWS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  load_rows(qs, D, q + ((size_t)bh * L + row0) * D, min(ROWS, L - row0), D);

  const float* qw = qs + warp * ROWS_PER_WARP * D;
  float* sw = s + warp * ROWS_PER_WARP * sp;
  const int wrow0 = row0 + warp * ROWS_PER_WARP;

  // S = q k^T + bias, one chunk of keys at a time; lane owns keys lane + 32 t
  for (int c0 = 0; c0 < Lk; c0 += CHUNK) {
    const int n = min(CHUNK, Lk - c0);
    __syncthreads();  // the previous chunk has been read
    load_rows(kv, kp, kb + (size_t)c0 * D, n, D);
    __syncthreads();
    float acc[ROWS_PER_WARP][KEYS_PER_LANE] = {};
    for (int d = 0; d < D; d += 4) {
      float4 kf[KEYS_PER_LANE];
#pragma unroll
      for (int t = 0; t < KEYS_PER_LANE; ++t)
        if (32 * t < n) kf[t] = *reinterpret_cast<const float4*>(kv + (lane + 32 * t) * kp + d);
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float4 qf = *reinterpret_cast<const float4*>(qw + r * D + d);
#pragma unroll
        for (int t = 0; t < KEYS_PER_LANE; ++t) {
          if (32 * t >= n) continue;  // a group of 32 keys wholly past the chunk's end
          float a = acc[r][t];
          a = fmaf(qf.x, kf[t].x, a);
          a = fmaf(qf.y, kf[t].y, a);
          a = fmaf(qf.z, kf[t].z, a);
          acc[r][t] = fmaf(qf.w, kf[t].w, a);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = wrow0 + r;
#pragma unroll
      for (int t = 0; t < KEYS_PER_LANE; ++t) {
        const int j = c0 + lane + 32 * t;
        if (row < L && j < Lk) {
          const float add = bias == nullptr ? 0.f
              : lako::to_f32(bias[(long long)b * sb + (long long)h * sh +
                                  (long long)row * si + (long long)j * sj]);
          sw[r * sp + j] = acc[r][t] + add;
        }
      }
    }
  }
  __syncwarp();  // the warp's rows of S were written by all its lanes

  // exact softmax per row; P = e / sum, rounded to v's type
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    if (wrow0 + r >= L) break;
    float* sr = sw + r * sp;
    float m = -1e30f;  // every logit is >= about -1e9
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, sr[j]);
    m = lako::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = lako::warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) sr[j] = lako::round_to<T>(sr[j] / sum);
  }
  __syncwarp();

  // out = P V, one chunk of V at a time; lane owns columns lane + 32 i
  float o[ROWS_PER_WARP][D_PER_LANE] = {};
  for (int c0 = 0; c0 < Lk; c0 += CHUNK) {
    const int n = min(CHUNK, Lk - c0);
    __syncthreads();
    load_rows(kv, kp, vb + (size_t)c0 * D, n, D);
    __syncthreads();
    // four keys at a time: one float4 of each row's P (sp and c0 are
    // multiples of 4), the last keys of the chunk one by one
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float4 p4[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        p4[r] = *reinterpret_cast<const float4*>(sw + r * sp + c0 + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[D_PER_LANE];
#pragma unroll
        for (int i = 0; i < D_PER_LANE; ++i)
          vv[i] = lane + 32 * i < D ? kv[(j + jj) * kp + lane + 32 * i] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
#pragma unroll
          for (int i = 0; i < D_PER_LANE; ++i) o[r][i] = fmaf(p, vv[i], o[r][i]);
        }
      }
    }
    for (; j < n; ++j) {
      float vv[D_PER_LANE];
#pragma unroll
      for (int i = 0; i < D_PER_LANE; ++i)
        vv[i] = lane + 32 * i < D ? kv[j * kp + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float p = sw[r * sp + c0 + j];
#pragma unroll
        for (int i = 0; i < D_PER_LANE; ++i) o[r][i] = fmaf(p, vv[i], o[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = wrow0 + r;
    if (row >= L) break;
    T* orow = out + ((size_t)bh * L + row) * D;
#pragma unroll
    for (int i = 0; i < D_PER_LANE; ++i)
      if (lane + 32 * i < D) orow[lane + 32 * i] = lako::from_f32<T>(o[r][i]);
  }
}

// ---- bfloat16 at D = 64 or 128: tensor cores (mma.sync m16n8k16) ---------

constexpr int TQ = 64;  // query rows per block
constexpr int TK = 64;  // keys per tile
constexpr int MMA_WARPS = 4;  // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int PAD = 8;  // bf16 row padding: fragment reads hit 32 distinct banks

using bf16 = __nv_bfloat16;
using lako::ld_pair;
using lako::mma_bf16;
using lako::pack_bf16;

template <int D>
constexpr size_t mma_smem_bytes() {
  // qs [TQ][D+PAD], ks [TK][D+PAD], vt [D][TK+PAD] (V transposed)
  return sizeof(bf16) * (size_t)(TQ * (D + PAD) + TK * (D + PAD) + D * (TK + PAD));
}

// rows [r0, r0+64) of a (rows, D) bf16 matrix, zero at or past n_rows, into
// dst [64][D+PAD]; transposed into dst [D][TK+PAD] (V as the B operand)
template <int D, bool kTransposed>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n_rows) {
  for (int i = threadIdx.x; i < 64 * D / 8; i += MMA_THREADS) {
    const int r = i % 64, c = (i / 64) * 8;  // neighbouring threads: neighbouring rows
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    if constexpr (kTransposed) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(c + j) * (TK + PAD) + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
    }
  }
}

template <int D, typename BT>
__global__ void __launch_bounds__(MMA_THREADS)
fused_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const BT* __restrict__ bias,
                           bf16* __restrict__ out, int H, int L, int Lk,
                           int sb, int sh, int si, int sj) {
  constexpr int QS = D + PAD;  // row stride of qs and ks
  constexpr int VS = TK + PAD;  // row stride of vt
  constexpr int NT = TK / 8;    // 8-key column tiles of S
  constexpr int KD = D / 16;    // 16-deep steps over d
  constexpr int NO = D / 8;     // 8-wide column tiles of O
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + TQ * QS;
  bf16* vt = ks + TK * QS;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows
  // their bias rows; null without a bias or past L (those rows are not stored)
  const long long base = (long long)b * sb + (long long)h * sh;
  const BT* bias0 = bias != nullptr && row0 < L ? bias + base + (long long)row0 * si : nullptr;
  const BT* bias1 = bias != nullptr && row1 < L ? bias + base + (long long)row1 * si : nullptr;

  load_tile<D, false>(qs, q + (size_t)bh * L * D, q0, L);
  __syncthreads();
  uint32_t qf[KD][4];  // this warp's q fragments, reused for every key tile
  const bf16* qw = qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qf[kk][0] = ld_pair(qw + g * QS + kk * 16 + t * 2);
    qf[kk][1] = ld_pair(qw + (g + 8) * QS + kk * 16 + t * 2);
    qf[kk][2] = ld_pair(qw + g * QS + kk * 16 + 8 + t * 2);
    qf[kk][3] = ld_pair(qw + (g + 8) * QS + kk * 16 + 8 + t * 2);
  }

  // S = q k^T + bias for the key tile at k0 in ks: rows (row0, row1), keys
  // k0 + j*8 + t*2 + {0,1}; -inf past Lk (no weight). The tile's bias is
  // loaded first, so that its latency hides behind the products.
  auto logits = [&](int k0, float (&s)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const BT* br = e < 2 ? bias0 : bias1;
        s[j][e] = key >= Lk ? -INFINITY
                  : br != nullptr ? lako::to_f32(br[(long long)key * sj]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kp = ks + (j * 8 + g) * QS + kk * 16 + t * 2;
        mma_bf16(s[j], qf[kk], ld_pair(kp), ld_pair(kp + 8));
      }
  };

  // pass 1: each row's max m and sum of exp(S - m), rescaled as m grows
  float m[2] = {-1e30f, -1e30f};  // below any real logit (>= about -1e9)
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums
  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();  // the previous tile's ks is no longer read
    load_tile<D, false>(ks, kg, k0, Lk);
    __syncthreads();
    float s[NT][4];
    logits(k0, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's keys are spread over the 4 threads of its group
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l[r] *= expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l[0] += expf(s[j][0] - m[0]) + expf(s[j][1] - m[0]);
      l[1] += expf(s[j][2] - m[1]) + expf(s[j][3] - m[1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // pass 2: P = exp(S - m) / sum, rounded to bf16, times V
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();  // the previous tile's ks and vt are no longer read
    load_tile<D, false>(ks, kg, k0, Lk);
    load_tile<D, true>(vt, vg, k0, Lk);
    __syncthreads();
    float s[NT][4];
    logits(k0, s);
    uint32_t pf[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pf[j][0] = pack_bf16(expf(s[j][0] - m[0]) / l[0], expf(s[j][1] - m[0]) / l[0]);
      pf[j][1] = pack_bf16(expf(s[j][2] - m[1]) / l[1], expf(s[j][3] - m[1]) / l[1]);
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
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + t * 2;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + row0) * D + col) =
          pack_bf16(o[j][0], o[j][1]);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + row1) * D + col) =
          pack_bf16(o[j][2], o[j][3]);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int D, typename BT>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, void* out,
               int B, int H, int L, int Lk, int sb, int sh, int si, int sj,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = fused_attention_mma_kernel<D, BT>;
  if (const int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (L + TQ - 1) / TQ);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const BT*>(bias), static_cast<bf16*>(out), H, L, Lk, sb, sh, si, sj);
  return (int)cudaGetLastError();
}

template <typename T, typename BT>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int B, int H, int L, int Lk, int D, int sb, int sh, int si, int sj,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (D == 64)
      return launch_mma<64, BT>(q, k, v, bias, out, B, H, L, Lk, sb, sh, si, sj, stream);
    if (D == 128)
      return launch_mma<128, BT>(q, k, v, bias, out, B, H, L, Lk, sb, sh, si, sj, stream);
  }
  const size_t smem = smem_bytes(D, Lk);
  auto kernel = fused_attention_kernel<T, BT>;
  if (const int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (L + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const BT*>(bias), static_cast<T*>(out), H, L, Lk, D, sb, sh, si, sj);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bias(const void* q, const void* k, const void* v, const void* bias, void* out,
                int B, int H, int L, int Lk, int D, int sb, int sh, int si, int sj,
                int bias_dtype, cudaStream_t s) {
  if (bias_dtype == lako::kFloat32)
    return launch<T, float>(q, k, v, bias, out, B, H, L, Lk, D, sb, sh, si, sj, s);
  if (bias_dtype == lako::kBFloat16)
    return launch<T, __nv_bfloat16>(q, k, v, bias, out, B, H, L, Lk, D, sb, sh, si, sj, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B,H,L,D), k, v: (B,H,Lk,D), out: (B,H,L,D), all contiguous in `dtype`;
// bias: null, or element (b,h,i,j) at b*sb + h*sh + i*si + j*sj in
// `bias_dtype`. D <= 128 and a multiple of 8, q/k/v 16-byte aligned, Lk <= 512
// (checked by the Python wrapper). Returns a cudaError_t code (0 = launched).
extern "C" int lako_fused_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int B, int H, int L,
                                    int Lk, int D, int sb, int sh, int si, int sj,
                                    int dtype, int bias_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > MAX_D || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == lako::kFloat32)
    return launch_bias<float>(q, k, v, bias, out, B, H, L, Lk, D, sb, sh, si, sj, bias_dtype, s);
  if (dtype == lako::kBFloat16)
    return launch_bias<__nv_bfloat16>(q, k, v, bias, out, B, H, L, Lk, D, sb, sh, si, sj,
                                      bias_dtype, s);
  return (int)cudaErrorInvalidValue;
}
