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
// What bounds it on the H100: at the encoder's shape (16,16,130,64) it moves
// 17 MB of q/k/v/out and 17 MB of f32 bias for 1.1 GFLOP, so memory traffic
// bounds it (about 10 us at 3.35 TB/s); S and P never reach device memory.
// - bf16 with D = 64 or 128 runs on the tensor cores in one pass over the
//   keys, so that every byte is read once: one block per (b*h, slab of up to
//   12 warps x 16 query rows; at L = 130 one block of 9 warps per (b, h)).
//   Q's rows and K (one cp.async group), then V (the next), are copied once
//   into padded shared memory, V's copy overlapping Q.K^T. Each thread first
//   issues all its bias loads (8 bytes a pair of keys when the key stride is
//   1, else through the strides), which seed S; Q.K^T is mma.sync m16n8k16 on
//   ldmatrix fragments, keys padded to 16 (144 x 144 at L = Lk = 130, where
//   64-wide tiles would pad to 192). The exact row max m, the row sum l of
//   exp(S - m) and P = exp(S - m) / l, rounded to bf16, are formed in the C
//   fragments, which become P.V's A operand; V's B fragments come through
//   ldmatrix.trans. l is summed per 64 keys and rescaled as the max grows,
//   the order of the two-pass version this one replaced, so that P rounds
//   as it did and the encoder route's greedy tokens stay as they were
//   (summed after the exact max, as the JAX body sums it, l moved by f32
//   ulps, P's bf16 rounding with it, and the tokens at near-ties). The
//   division is div_rn's: div.rn's slow-path check dominated the kernel's
//   time. Up to 160 keys S stays in
//   registers (launch_mma_tier<., ., true>); above, each thread keeps its
//   fragments of S in shared memory (16 rows x Lk x 4 bytes a warp), with up
//   to 4 warps a block and V over K's buffer where both do not fit.
//   mma.sync rather than wgmma: a 64-row wgmma tile pads L = 130 to 192 rows,
//   16-row warps to 144, and the products are not what bounds the kernel.
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

// ---- bfloat16 at D = 64 or 128: tensor cores (mma.sync m16n8k16), one pass -

constexpr int PAD = 8;             // bf16 row padding: ldmatrix rows hit distinct banks
constexpr int REG_KEYS = 160;      // up to this many keys a warp's logits stay in registers
constexpr int REG_TILES = REG_KEYS / 8;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may use (227 KB)

using bf16 = __nv_bfloat16;
using lako::mma_bf16;
using lako::pack_bf16;

// warps (16 query rows each) per block, at most: the register tier's logits
// and output fragments take 130 registers a thread at D = 64, 166 at 128
template <int D, bool kRegLogits>
constexpr int max_warps() { return kRegLogits ? (D == 64 ? 12 : 8) : 4; }

template <typename BT> __device__ __forceinline__ float2 load_pair(const BT* p);
template <> __device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load_pair<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// c[0], c[1] = the bias at keys (key, key+1) of the row at br (null: no bias,
// or a row past L), as the logits' starting value; -inf past Lk. `vec`: the
// pair is contiguous and aligned, one 8-byte (f32) or 4-byte (bf16) load.
template <typename BT>
__device__ __forceinline__ void bias_pair(float* c, const BT* br, int key, int Lk, int sj,
                                          bool vec) {
  if (key + 1 < Lk) {
    if (br == nullptr) {
      c[0] = c[1] = 0.f;
    } else if (vec) {
      const float2 x = load_pair(br + key);
      c[0] = x.x;
      c[1] = x.y;
    } else {
      c[0] = lako::to_f32(br[(long long)key * sj]);
      c[1] = lako::to_f32(br[(long long)(key + 1) * sj]);
    }
  } else {
    c[0] = key >= Lk ? -INFINITY : br == nullptr ? 0.f : lako::to_f32(br[(long long)key * sj]);
    c[1] = -INFINITY;
  }
}

// One block per (b*h, slab of W*16 query rows), W warps of 16 rows. Q's rows
// and K, then V, are copied once into shared memory with cp.async; each warp
// forms S = bias + Q.K^T for all its keys (bias first, then the products in
// d order, as the two-pass version did), takes the exact row max and the sum
// of e = exp(S - max), and feeds P = e / sum, rounded to bf16, to P.V. With
// kRegLogits (Lk <= REG_KEYS) S stays in registers; else each thread keeps
// its fragments of S in shared memory (es, fragment-major, private to it).
// v_apart: V has its own region and its copy overlaps Q.K^T; otherwise it
// reuses K's once every warp is done with K.
template <int D, typename BT, bool kRegLogits>
__global__ void __launch_bounds__(32 * max_warps<D, kRegLogits>())
fused_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const BT* __restrict__ bias,
                           bf16* __restrict__ out, int H, int L, int Lk,
                           int sb, int sh, int si, int sj, int v_apart) {
  constexpr int P = D + PAD;  // row pitch of qs, ks, vs
  constexpr int NO = D / 8;   // 8-wide column tiles of O
  const int W = blockDim.x / 32;
  const int lkp = (Lk + 15) & ~15;  // keys padded to P.V's k-depth
  const int nt = lkp / 8;           // 8-key column tiles of S
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [W*16][P]
  bf16* ks = qs + W * 16 * P;                 // [lkp][P]
  bf16* vs = v_apart ? ks + lkp * P : ks;     // [lkp][P]
  float4* es = reinterpret_cast<float4*>(vs + lkp * P);  // [W][nt][32] (shared-memory tier)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * W * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;  // mma fragment column pair
  const bf16* vg = v + (size_t)bh * Lk * D;

  // copy group 0: Q's rows and K; group 1: V
  lako::cp_async_rows<D>(qs, P, q + ((size_t)bh * L + q0) * D, W * 16, L - q0);
  lako::cp_async_rows<D>(ks, P, k + (size_t)bh * Lk * D, lkp, Lk);
  lako::cp_async_commit();
  if (v_apart) lako::cp_async_rows<D>(vs, P, vg, lkp, Lk);
  lako::cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;  // this thread's rows
  const bool active = q0 + warp * 16 < L;  // a warp wholly past L only copies
  const long long base = (long long)b * sb + (long long)h * sh;
  const BT* bias0 = bias != nullptr && row0 < L ? bias + base + (long long)row0 * si : nullptr;
  const BT* bias1 = bias != nullptr && row1 < L ? bias + base + (long long)row1 * si : nullptr;
  const bool vec = sj == 1 && ((si | sb | sh) & 1) == 0 &&
                   reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(BT)) == 0;
  // key tile j's logits start as the bias: rows (row0, row1), keys j*8 + t*2 + {0,1}
  auto bias_tile = [&](int j, float* c) {
    bias_pair(c, bias0, j * 8 + t * 2, Lk, sj, vec);
    bias_pair(c + 2, bias1, j * 8 + t * 2, Lk, sj, vec);
  };
  const bf16* qw = qs + warp * 16 * P;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // O += P.V over keys [16 kk, 16 kk + 16), a: P's A fragment
  auto pv = [&](int kk, const uint32_t (&a)[4]) {
#pragma unroll
    for (int jd = 0; jd < NO; jd += 2) {
      uint32_t bv[4];
      lako::ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 15)) * P + (jd + (lane >> 4)) * 8);
      mma_bf16(o[jd], a, bv[0], bv[1]);
      mma_bf16(o[jd + 1], a, bv[2], bv[3]);
    }
  };
  // The exact row max m and the row sum l of exp(S - m), taken as the
  // two-pass kernel took them, so that P rounds as it did: per 64 keys, the
  // max grown over the keys so far and l rescaled by exp(m_old - m_new).
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, rcp[2];
  // a row's keys are spread over the 4 threads of its group
  auto row_reduce = [](float (&x)[2], bool is_max) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x[r], off);
        x[r] = is_max ? fmaxf(x[r], y) : x[r] + y;
      }
  };
  auto grow = [&](float (&mt)[2]) {  // the max after another 64 keys
    row_reduce(mt, true);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] *= expf(m[r] - mt[r]);
      m[r] = mt[r];
    }
  };
  auto add = [&](float a, float b, int r) { l[r] += expf(a - m[r]) + expf(b - m[r]); };
  auto finish = [&] {
    row_reduce(l, false);
    rcp[0] = __frcp_rn(l[0]);
    rcp[1] = __frcp_rn(l[1]);
  };
  // P = exp(S - m) / l
  auto prob = [&](float x, int r) { return lako::div_rn(expf(x - m[r]), l[r], rcp[r]); };

  if constexpr (kRegLogits) {
    float s[REG_TILES][4];
#pragma unroll
    for (int j = 0; j < REG_TILES; ++j)
      if (j < nt) bias_tile(j, s[j]);  // every bias load in flight before the products
    lako::cp_async_wait<1>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32) {
        uint32_t a0[4], a1[4];
        lako::load_a_x2(a0, a1, qw, P, c0);
#pragma unroll
        for (int j = 0; j < REG_TILES; ++j) {
          if (j < nt) {
            uint32_t bk[4];
            lako::load_b_rows(bk, ks, P, j * 8, c0);
            mma_bf16(s[j], a0, bk[0], bk[1]);
            mma_bf16(s[j], a1, bk[2], bk[3]);
          }
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < REG_TILES; j0 += 8) {
        if (j0 < nt) {
          float mt[2] = {m[0], m[1]};
#pragma unroll
          for (int j = j0; j < j0 + 8 && j < REG_TILES; ++j)
            if (j < nt) {
              mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
              mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
            }
          grow(mt);
#pragma unroll
          for (int j = j0; j < j0 + 8 && j < REG_TILES; ++j)
            if (j < nt) {
              add(s[j][0], s[j][1], 0);
              add(s[j][2], s[j][3], 1);
            }
        }
      }
      finish();
    }
    lako::cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < REG_TILES / 2; ++kk)
        if (kk < nt / 2) {
          const float(&x)[4] = s[2 * kk];
          const float(&y)[4] = s[2 * kk + 1];
          const uint32_t a[4] = {pack_bf16(prob(x[0], 0), prob(x[1], 0)),
                                 pack_bf16(prob(x[2], 1), prob(x[3], 1)),
                                 pack_bf16(prob(y[0], 0), prob(y[1], 0)),
                                 pack_bf16(prob(y[2], 1), prob(y[3], 1))};
          pv(kk, a);
        }
    }
  } else {
    float4* ew = es + warp * nt * 32 + lane;  // this thread's tile j at ew[32 j]
    float c[4];
    bias_tile(0, c);
    lako::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      uint32_t qf[D / 16][4];
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32) lako::load_a_x2(qf[c0 / 16], qf[c0 / 16 + 1], qw, P, c0);
      for (int j = 0; j < nt; ++j) {
        float next[4];
        if (j + 1 < nt) bias_tile(j + 1, next);  // the next tile's bias in flight
#pragma unroll
        for (int c0 = 0; c0 < D; c0 += 32) {
          uint32_t bk[4];
          lako::load_b_rows(bk, ks, P, j * 8, c0);
          mma_bf16(c, qf[c0 / 16], bk[0], bk[1]);
          mma_bf16(c, qf[c0 / 16 + 1], bk[2], bk[3]);
        }
        ew[32 * j] = make_float4(c[0], c[1], c[2], c[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = next[e];
      }
      for (int j0 = 0; j0 < nt; j0 += 8) {  // unrolled as the register tier's loops
        float mt[2] = {m[0], m[1]};
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j)
          if (j < nt) {
            const float4 x = ew[32 * j];
            mt[0] = fmaxf(mt[0], fmaxf(x.x, x.y));
            mt[1] = fmaxf(mt[1], fmaxf(x.z, x.w));
          }
        grow(mt);
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j)
          if (j < nt) {
            const float4 x = ew[32 * j];
            add(x.x, x.y, 0);
            add(x.z, x.w, 1);
          }
      }
      finish();
    }
    if (!v_apart) {
      __syncthreads();  // every warp is done with K
      lako::cp_async_rows<D>(vs, P, vg, lkp, Lk);
      lako::cp_async_commit();
    }
    lako::cp_async_wait<0>();
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < nt / 2; ++kk) {
        const float4 x = ew[32 * (2 * kk)], y = ew[32 * (2 * kk + 1)];
        const uint32_t a[4] = {pack_bf16(prob(x.x, 0), prob(x.y, 0)),
                               pack_bf16(prob(x.z, 1), prob(x.w, 1)),
                               pack_bf16(prob(y.x, 0), prob(y.y, 0)),
                               pack_bf16(prob(y.z, 1), prob(y.w, 1))};
        pv(kk, a);
      }
    }
  }

  if (active) {
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
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// Picks the block: as many warps as the tier allows and shared memory holds,
// then spread evenly over the fewest blocks that cover L's 16-row tiles (one
// block per (b, h) at the encoder's L = 130: 9 warps).
template <int D, typename BT, bool kRegLogits>
int launch_mma_tier(const void* q, const void* k, const void* v, const void* bias, void* out,
                    int B, int H, int L, int Lk, int sb, int sh, int si, int sj,
                    cudaStream_t stream) {
  auto kernel = fused_attention_mma_kernel<D, BT, kRegLogits>;
  static bool configured = false;  // once, so later launches can be graph-captured
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int lkp = (Lk + 15) & ~15;
  const int row_tiles = (L + 15) / 16;
  const size_t kv = (size_t)lkp * (D + PAD) * sizeof(bf16);
  const size_t per_warp = 16 * (D + PAD) * sizeof(bf16) +
                          (kRegLogits ? 0 : (size_t)lkp * 16 * sizeof(float));
  int warps = row_tiles < max_warps<D, kRegLogits>() ? row_tiles : max_warps<D, kRegLogits>();
  int v_apart = 1;
  auto smem = [&] { return (v_apart ? 2 : 1) * kv + warps * per_warp; };
  if (smem() > SMEM_LIMIT) v_apart = 0;
  while (warps > 1 && smem() > SMEM_LIMIT) --warps;
  const int blocks = (row_tiles + warps - 1) / warps;
  warps = (row_tiles + blocks - 1) / blocks;
  if (smem() > SMEM_LIMIT || (kRegLogits && !v_apart) || blocks > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(B * H, blocks), 32 * warps, smem(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const BT*>(bias), static_cast<bf16*>(out), H, L, Lk, sb, sh, si, sj,
      v_apart);
  return (int)cudaGetLastError();
}

// Instantiations (D x bias type float|bf16 x tier), registers a thread as
// ptxas reports them for sm_90a (chip_smoke.py prints them), no spills in any:
//   <64, *, true> 130   <128, *, true> 166   <64, *, false> 64   <128, *, false> 96
template <int D, typename BT>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, void* out,
               int B, int H, int L, int Lk, int sb, int sh, int si, int sj,
               cudaStream_t stream) {
  if (Lk <= REG_KEYS)
    return launch_mma_tier<D, BT, true>(q, k, v, bias, out, B, H, L, Lk, sb, sh, si, sj, stream);
  return launch_mma_tier<D, BT, false>(q, k, v, bias, out, B, H, L, Lk, sb, sh, si, sj, stream);
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
