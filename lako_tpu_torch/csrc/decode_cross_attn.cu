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
// (M=1 per head), so the kernel does 4 operations per int8 byte it reads and
// can never feed the tensor cores; at (8,16,64,260) it moves 4.3 MB, 1.3 us
// at 3.35 TB/s. So the design is about bytes in flight and warps to hide
// their latency:
// - K/V stay int8 until they are in registers (dequantization is one
//   multiply on q and one on the output, never a bf16 copy of K/V in device
//   memory), and nothing is padded or re-laid in device memory.
// - Each block walks its keys in tiles of 128: the (d x 128) int8 tiles of K
//   and V come into shared memory through a 2-stage cp.async ring, 4 bytes a
//   copy (a row of K = 260 keys is 4-byte aligned, not 16; byte loads where
//   K % 4 != 0), the next tile's copies in flight while this one computes.
// - Thread t sums the logit of key t over d in order with FMAs,
//   (q[d] k_scale[d]) K_i8[d,k], the scale folded into q as the JAX kernel
//   folds it: at large logits an f32 ulp of a logit moves the output by
//   ~1e-5, and this order keeps it within 1e-5 of the plain version. Its
//   bytes are read 16 rows ahead of the FMAs, and its bias a tile ahead.
// - Lane l owns keys 4 l .. 4 l + 3 of every tile and keeps an online
//   softmax over them (its max and sum, rescaled as the max grows); warp w
//   owns d rows [16 w, 16 w + 16) of the output, a per-key FMA over the V
//   words, 16 partials a thread; above 16 warps (d > 256) each warp loops
//   over the groups of 16 rows w, w + W, ... No row of K logits stays on
//   chip, so K is unbounded; the lanes' partials are summed in
//   lako::warp_sum's butterfly order once at the end.
// - Above d = 256 the logits sum each 16 rows apart and add those sums in
//   order: one long FMA chain over d rounds ~3x further from the exact sum
//   than the plain version's blocked product at d = 512.
// - The ring's shared memory follows d (512 d bytes for two stages); where
//   two stages do not fit (d > ~400), one stage, its next tile copied after
//   the current one is consumed. d <= 768.
// - Enough blocks at serving batch sizes: the keys of each (b, h) are split
//   over up to 8 blocks (flash-decoding), chosen from B*h against the SMs (no
//   split at B=128, 2048 (b, h) pairs; 3 at B=8, 128 pairs). The blocks of a
//   (b, h) form one thread-block cluster; each writes its (m, l, o[d]) into
//   block 0's shared memory (distributed shared memory, one cluster barrier
//   after the writes, the first phase arrived at while the copies fly), and
//   block 0 merges them in a fixed order, in the same launch, so the result
//   is the same in every run.

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KEYS = 4;              // consecutive keys per lane
constexpr int TILE = 32 * KEYS;      // keys per tile
constexpr int ROWS = 16;             // output rows per warp
constexpr int MIN_WARPS = TILE / 32;  // the logits take one thread per key of a tile
constexpr int MAX_WARPS = 16;
constexpr int MAX_GROUPS = 3;        // groups of 16 output rows a warp
constexpr int MAX_HEAD_DIM = MAX_GROUPS * MAX_WARPS * ROWS;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory one block may use (227 KB)
constexpr int MAX_SPLITS = 8;        // blocks per (b, h): a portable cluster size
constexpr int MIN_SPLIT_KEYS = 64;
constexpr int STAGES = 2;            // at most; one where two do not fit

// Signed byte e of w as a float, exactly, without the quarter-rate integer
// conversion: wx = w ^ 0x80808080 holds each byte + 128, and the float whose
// bits are 0x4B0000xx is 2^23 + xx.
__device__ __forceinline__ float byte_at(uint32_t wx, int e) {
  return __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + e)) - 8388736.f;
}

// v[c] summed over the warp's lanes, in the butterfly order of
// lako::warp_sum (so bitwise its sums): each step keeps half of the channels
// and takes the partner's share of them, until one is left; on return lane
// t holds the sum of channel t / (32 / N) in v[0].
template <int N>
__device__ __forceinline__ void warp_sum_transposed(float (&v)[N]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16, n = N; off >= 1; off >>= 1) {
    if (n > 1) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float keep = upper ? v[i + n / 2] : v[i];
        const float give = upper ? v[i] : v[i + n / 2];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, off);
      }
      n >>= 1;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

// A block's shared memory: the ring of `stages` (K, V) int8 tile pairs
// [d][TILE], the tile's logits [TILE], q * k_scale [d] and, in block 0,
// every block's partial (m, l, o[d]) [splits][d + 2].
inline size_t smem_bytes(int d, int splits, int stages) {
  return (size_t)stages * 2 * d * TILE +
         sizeof(float) * ((size_t)TILE + d + (size_t)splits * (d + 2));
}

// Grid (splits, h, B), one cluster of `splits` blocks per (b, h); block s
// takes keys [s * per_split, min(K, (s + 1) * per_split)), never empty. Warp
// w owns the output rows of groups w + W g, g < kGroups (W warps); the ring
// has kStages stages.
template <typename T, bool kWord, int kGroups, int kStages>
__global__ void __launch_bounds__(32 * MAX_WARPS)
decode_cross_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_i8,
                    const float* __restrict__ k_scale, const int8_t* __restrict__ v_i8,
                    const float* __restrict__ v_scale, const float* __restrict__ bias,
                    float* __restrict__ out, int h, int d, int K, int per_split) {
  extern __shared__ float4 smem4[];
  const int S = gridDim.x, R = d + 2;
  int8_t* ring = reinterpret_cast<int8_t*>(smem4);  // stage i: K then V, [d][TILE] each
  float* ls = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * d * TILE);
  float* qs = ls + TILE;
  float* all = qs + d;       // [S][R]: block j's m, l, o[d] (block 0)

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, b = blockIdx.z;
  const size_t bh = (size_t)b * h + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int k_begin = split * per_split, k_end = min(K, k_begin + per_split);
  const int n_tiles = (k_end - k_begin + TILE - 1) / TILE;
  const int8_t* kb = k_i8 + bh * d * K;
  const int8_t* vb = v_i8 + bh * d * K;
  const float* biasb = bias + (size_t)b * K;

  // tile i's K and V rows into its stage; bytes at or past k_end are 0
  auto issue = [&](int i) {
    int8_t* st = ring + (size_t)(i % kStages) * 2 * d * TILE;
    const int k0 = k_begin + i * TILE;
    if constexpr (kWord) {
      for (int x = threadIdx.x; x < 2 * d * (TILE / 4); x += blockDim.x) {
        const int row = x / (TILE / 4), wd = x - row * (TILE / 4);  // row: K's then V's
        const int key = k0 + 4 * wd;
        const int8_t* src = (row < d ? kb : vb) + (size_t)(row < d ? row : row - d) * K + key;
        lako::cp_async_small<4>(st + row * TILE + 4 * wd, key < k_end ? src : kb, key < k_end);
      }
    } else {
      for (int x = threadIdx.x; x < 2 * d * TILE; x += blockDim.x) {
        const int row = x / TILE, j = x - row * TILE, key = k0 + j;
        const int8_t* src = (row < d ? kb : vb) + (size_t)(row < d ? row : row - d) * K + key;
        st[row * TILE + j] = key < k_end ? *src : 0;
      }
    }
  };
  issue(0);
  lako::cp_async_commit();
  // the cluster's first barrier phase: every block has started by the time
  // this block writes into block 0's shared memory, at the end
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    qs[c] = lako::to_f32(q[bh * d + c]) * k_scale[bh * d + c];
  // loaded ahead of use, off the critical path: the bias of thread t's key a
  // tile ahead, and (block 0, thread c < d <= blockDim) v_scale[c]
  auto load_bias = [&](int i) {
    const int key = k_begin + i * TILE + threadIdx.x;
    return threadIdx.x < TILE && key < k_end ? biasb[key] : 0.f;
  };
  float bias_cur = load_bias(0);
  const float vsc = split == 0 && (int)threadIdx.x < d ? v_scale[bh * d + threadIdx.x] : 0.f;

  float m = -INFINITY, l = 0.f, o[kGroups][ROWS];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) o[g][r] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const float bias_next = i + 1 < n_tiles ? load_bias(i + 1) : 0.f;
    if (kStages > 1 && i + 1 < n_tiles) issue(i + 1);
    lako::cp_async_commit();
    lako::cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i (and q * k_scale) has landed
    const int8_t* ks = ring + (size_t)(i % kStages) * 2 * d * TILE;
    const int8_t* vs = ks + d * TILE;
    const int k0 = k_begin + i * TILE;

    // thread t: the logit of key k0 + t, summed over d in order (its bytes
    // read 16 rows at a time, ahead of the FMAs); -inf past the split. Above
    // d = 256 each 16 rows are summed apart and their sums added in order,
    // which keeps the rounding of a long sum near a blocked product's.
    if (threadIdx.x < TILE) {
      float acc = -INFINITY;
      if (k0 + (int)threadIdx.x < k_end) {
        const int8_t* col = ks + threadIdx.x;
        acc = 0.f;
        int c0 = 0;
        for (; c0 + 16 <= d; c0 += 16) {
          float kv[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) kv[j] = (float)col[(c0 + j) * TILE];
          if constexpr (kGroups == 1) {
#pragma unroll
            for (int j = 0; j < 16; ++j) acc = fmaf(qs[c0 + j], kv[j], acc);
          } else {
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) part = fmaf(qs[c0 + j], kv[j], part);
            acc += part;
          }
        }
        if constexpr (kGroups == 1) {
          for (; c0 < d; ++c0) acc = fmaf(qs[c0], (float)col[c0 * TILE], acc);
        } else {
          float part = 0.f;
          for (; c0 < d; ++c0) part = fmaf(qs[c0], (float)col[c0 * TILE], part);
          acc += part;
        }
        acc += bias_cur;
      }
      ls[threadIdx.x] = acc;
    }
    __syncthreads();

    // the lane's keys 4 l .. 4 l + 3: its online softmax, the same in every warp
    if (k0 + KEYS * lane < k_end) {
      const float4 s4 = *reinterpret_cast<const float4*>(ls + KEYS * lane);
      const float s[KEYS] = {s4.x, s4.y, s4.z, s4.w};
      float m_new = m;
#pragma unroll
      for (int e = 0; e < KEYS; ++e) m_new = fmaxf(m_new, s[e]);  // finite: key 4 l is real
      const float alpha = expf(m - m_new);  // 0 on the lane's first tile
      float p[KEYS];
#pragma unroll
      for (int e = 0; e < KEYS; ++e) p[e] = expf(s[e] - m_new);
      l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
      m = m_new;
      // this warp's rows of the output
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int c = (warp + warps * g) * ROWS + r;
          if (c < d) {
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(vs + c * TILE + KEYS * lane) ^ 0x80808080u;
            float acc = o[g][r] * alpha;
#pragma unroll
            for (int e = 0; e < KEYS; ++e) acc = fmaf(p[e], byte_at(w, e), acc);
            o[g][r] = acc;
          }
        }
    }
    __syncthreads();  // this stage and the logits are rewritten
    if (kStages == 1 && i + 1 < n_tiles) issue(i + 1);
    bias_cur = bias_next;
  }

  // this block's partial: the lanes' (m, l, o) merged against the block's max
  // (every warp holds the same lanes' m and l)
  const float mw = lako::warp_max(m);
  const float f = mw == -INFINITY ? 0.f : expf(m - mw);  // a lane without keys: 0
  const float lw = lako::warp_sum(l * f);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) o[g][r] *= f;
    warp_sum_transposed<ROWS>(o[g]);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* part = cluster.map_shared_rank(all, 0) + split * R;  // in block 0
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int c = (warp + warps * g) * ROWS + lane / (32 / ROWS);
    if (lane % (32 / ROWS) == 0 && c < d) part[2 + c] = o[g][0];
  }
  if (threadIdx.x == 0) {
    part[0] = mw;
    part[1] = lw;
  }
  cluster.sync();  // every block's partial has landed in block 0

  // thread t: channels t, t + blockDim.x, ... (one channel up to d = 256)
  for (int c = threadIdx.x; split == 0 && c < d; c += kGroups > 1 ? blockDim.x : d) {
    float mx = -INFINITY;
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, all[j * R]);
    float num = 0.f, den = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* pj = all + j * R;
      const float wgt = pj[0] == -INFINITY ? 0.f : expf(pj[0] - mx);
      num += wgt * pj[2 + c];
      den += wgt * pj[1];
    }
    out[bh * d + c] = num / den * (c == (int)threadIdx.x ? vsc : v_scale[bh * d + c]);
  }
}

template <typename T, bool kWord, int kGroups, int kStages>
int launch_split(const void* q, const void* k_i8, const void* k_scale, const void* v_i8,
                 const void* v_scale, const void* bias, void* out, int B, int h, int d, int K,
                 int splits, int per_split, cudaStream_t stream) {
  static bool configured[lako::kMaxDevices] = {};
  auto kernel = decode_cross_kernel<T, kWord, kGroups, kStages>;
  const size_t most = smem_bytes(kGroups * MAX_WARPS * ROWS, MAX_SPLITS, kStages);
  cudaError_t err = lako::configure_smem(
      kernel, (int)(most < SMEM_LIMIT ? most : SMEM_LIMIT), configured);
  if (err != cudaSuccess) return (int)err;
  const int warps = std::max(MIN_WARPS, ((d + ROWS - 1) / ROWS + kGroups - 1) / kGroups);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, h, B);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem_bytes(d, splits, kStages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const int8_t*>(k_i8), static_cast<const float*>(k_scale),
                           static_cast<const int8_t*>(v_i8), static_cast<const float*>(v_scale),
                           static_cast<const float*>(bias), static_cast<float*>(out), h, d, K,
                           per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The keys' splits, the groups of 16 output rows a warp takes (one up to
// d = 256, 16 warps) and the ring's stages (two where they fit).
template <typename T, bool kWord>
int launch_groups(const void* q, const void* k_i8, const void* k_scale, const void* v_i8,
                  const void* v_scale, const void* bias, void* out, int B, int h, int d, int K,
                  cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // about 2 blocks an SM, at least MIN_SPLIT_KEYS keys a block
  const long long pairs = (long long)B * h;
  int splits = (int)std::min<long long>(MAX_SPLITS, (2LL * sms + pairs - 1) / pairs);
  splits = std::max(1, std::min(splits, (K + MIN_SPLIT_KEYS - 1) / MIN_SPLIT_KEYS));
  const int per_split = ((K + splits - 1) / splits + KEYS - 1) / KEYS * KEYS;
  splits = (K + per_split - 1) / per_split;  // every split holds a key
  const int groups = ((d + ROWS - 1) / ROWS + MAX_WARPS - 1) / MAX_WARPS;
  const bool two = smem_bytes(d, splits, STAGES) <= SMEM_LIMIT;
  if (smem_bytes(d, splits, 1) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static_assert(MAX_GROUPS == 3 && STAGES == 2, "one instance per group and stage count");
  if (groups == 1)   // two stages fit up to d = 256
    return launch_split<T, kWord, 1, 2>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K,
                                        splits, per_split, s);
  if (groups == 2 && two)
    return launch_split<T, kWord, 2, 2>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K,
                                        splits, per_split, s);
  if (groups == 2)
    return launch_split<T, kWord, 2, 1>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K,
                                        splits, per_split, s);
  return launch_split<T, kWord, 3, 1>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K,
                                      splits, per_split, s);   // d > 512: one stage only
}

// Word copies where every row start is 4-byte aligned.
template <typename T>
int launch(const void* q, const void* k_i8, const void* k_scale, const void* v_i8,
           const void* v_scale, const void* bias, void* out, int B, int h, int d, int K,
           cudaStream_t s) {
  const bool word = K % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(k_i8) | reinterpret_cast<uintptr_t>(v_i8)) % 4 == 0;
  if (word) return launch_groups<T, true>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
  return launch_groups<T, false>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
}

}  // namespace

// q: (B,h,d) in `dtype`; k_i8, v_i8: (B,h,d,K) int8; k_scale, v_scale: (B,h,d)
// f32; bias: (B,1,K) f32; out: (B,h,d) f32. All contiguous; d <= 768, B and h
// <= 65535 (checked by the Python wrapper). Returns a cudaError_t code (0 =
// launched).
extern "C" int lako_decode_cross_attn(const void* q, const void* k_i8,
                                      const void* k_scale, const void* v_i8,
                                      const void* v_scale, const void* bias,
                                      void* out, int B, int h, int d, int K,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > MAX_HEAD_DIM || K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == lako::kFloat32)
    return launch<float>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
  if (dtype == lako::kBFloat16)
    return launch<__nv_bfloat16>(q, k_i8, k_scale, v_i8, v_scale, bias, out, B, h, d, K, s);
  return (int)cudaErrorInvalidValue;
}
