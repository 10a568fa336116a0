// One-pass 8-bit Adam update (K5) and its requantization-free fragment (K6).
//
// Replaces the Pallas kernels of the JAX package:
//   K5 lako_tpu/ops/adam8_kernel.py::fused_adam8_update (body _kernel),
//   K6 scripts/bench_adam8_micro.py::k_ema (the floor-proof fragment).
//
// State layout (train/optim8.py Moment8): each moment is (nb, 256) codes,
// int8 linear for m and uint8 log2 for v (code 255 = exactly zero), with one
// f32 scale per 256-element row. One warp owns one row, and the row's absmax
// of |m| and max of v are warp-shuffle reductions. K5 per row: dequantize m
// and v, the two EMAs, the Adam direction u, then requantize both moments
// with the dithered stochastic rounding of the JAX package. K6 stops after u.
//
// Bit parity with the JAX package is the bar: the codes must come out equal,
// so every rounding is spelled out with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn / __fmaf_rn, which nvcc never contracts or splits,
// in the JAX package's order. The JAX package's own CPU run (XLA:CPU, the
// oracle of the parity tests) fuses the gradient's term of each EMA and each
// polynomial step into FMAs and divides by 127 as a product with the
// reciprocal; the kernel does exactly the same, and so do its plain versions
// (ops/adam8_kernel.py, train/optim8.py). The dither hash is uint32
// arithmetic with wraparound.
//
// K5 takes every leaf of a parameter tree in one launch. A descriptor table
// in device memory (ops/adam8_kernel.py builds it, LEAF_FIELDS) gives each
// leaf its gradient and u pointers, its old state, its shape, its first row
// in the new flat state, its first block, its two salt hashes and its
// rounding order: the Pallas body's ("kernel": ((1-b2)*g)*g and the bias
// correction 1 - exp(c*log b)) or the jnp path's ("jnp": (1-b2)*square(g) and
// 1 - b**c), as the JAX package routes a leaf; the bias corrections of both
// orders come from the host. A block finds its leaf by binary search over
// the leaves' first blocks. A one-leaf call takes its descriptor as a kernel
// argument instead, so it needs no copy and can be captured in a CUDA graph.
//
// The gradient is read in its own dtype straight from the parameter's
// tensor, with the row's tail past n read as 0 (JAX pads a float32 copy with
// zeros; bf16 -> f32 is exact). The blocked layout is the JAX package's: a
// dense weight of the port is (out, in), the transpose of JAX's flax kernel
// (in, out), so for such a leaf ("transposed") element idx of the blocked
// state is weight[idx % out, idx / out]. Three tiers read g and write u:
// - contiguous (a leaf that is not transposed): lane l owns elements
//   8 l .. 8 l + 7 of its row, read and written 16 bytes at a time;
// - tile (transposed, out % 256 == 0, in % 8 == 0, g 16-byte aligned): the
//   block stages 256 outputs x 16 neighbouring input columns of g through
//   shared memory, read along `in` in 16-byte loads, transposed there, and
//   each warp takes the state rows of two columns; u goes back the same way;
// - strided (any other transposed leaf): element by element.
// The dither index is the element's blocked index within its leaf in every
// tier, and the row reductions are maxima, so the tiers agree bitwise.
//
// What bounds it on the H100: bytes for float32 gradients (12 bytes an
// element: 0.94 SM clocks at 3.35 TB/s) and the ALU pipe for bfloat16 ones
// (8 bytes, 0.63 clocks, against ~0.67 clocks of integer, compare and
// select operations in chip_smoke.py's K5_OPS): the two are close, so the
// design cuts both. The codes move 8 bytes a lane and g and u 16, and a
// warp loads both its rows before either row's arithmetic; a code byte
// becomes a float without the quarter-rate I2F (signed_byte); 2^(-q/8)
// comes from an 8-entry table and the exponent field; the division by the
// row's new m scale takes the reciprocal once a row and one FMA correction
// an element (lako::div_rn); floor and round to nearest even are additions
// of 1.5 * 2^23 (floor rounding down) over their bounded ranges, whose bits
// also give the code bytes without F2I, packed by byte permutes. Each cut
// is exact: the card tests hold every code bitwise. K6 keeps the first
// design.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;           // elements per quantization row
constexpr int PER_LANE = BLOCK / 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 2;     // K5: state rows a warp takes in a block
constexpr int TILE_COLS = WARPS * ROWS_PER_WARP;  // input columns of a tile
constexpr int SEG = 33;              // a tile column's 8 slices of 32 outputs, padded
constexpr int TILE_PITCH = 290;      // floats a tile column: >= 8 * SEG, 2 mod 32 banks

// float32 values of the JAX package's constants (train/optim8.py)
constexpr float kFrac1 = 0x1.d5818ep-1f;   // 2^-0.125
constexpr float kFrac2 = 0x1.ae89fap-1f;   // 2^-0.25
constexpr float kFrac4 = 0x1.6a09e6p-1f;   // 2^-0.5
constexpr float kLog2P0 = -0x1.47b98p-4f;  // _LOG2_P, highest power first
constexpr float kLog2P1 = 0x1.4561bap-1f;
constexpr float kLog2P2 = -0x1.0cb93ap+1f;
constexpr float kLog2P3 = 0x1.032ceep+2f;
constexpr float kLog2P4 = -0x1.40b7fcp+1f;
constexpr float kLogSteps = 8.0f;          // log-code steps per octave
constexpr float kInv127 = 0x1.020408p-7f;  // 1/127
// 1.5 * 2^23: x + kRound is x rounded to an integer (half to even) for
// |x| < 2^22, held in the low mantissa bits
constexpr float kRound = 12582912.f;

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps;
};

// K5's step constants: the bias corrections 1 - b1^c and 1 - b2^c of each
// rounding order, computed on the host (ops/adam8_kernel.py)
struct Step {
  Hyper hp;
  float corr1[2], corr2[2];  // [kernel order, jnp order]
  int correct_bias, stochastic_round;
};

// A leaf of K5's launch: the layout of ops/adam8_kernel.py LEAF_FIELDS,
// sixteen 64-bit words
struct Leaf {
  const void* g;
  void* u;
  const int8_t* mq;
  const float* ms;
  const uint8_t* vq;
  const float* vs;
  long long n;           // elements
  long long rows, cols;  // a transposed leaf's (out, in), else 0
  long long row0;        // first row of the leaf's state in the flat output
  long long block0;      // first block of the launch
  long long nb;          // state rows
  long long salt_m, salt_v;  // (count * 0x9E3779B9) ^ (salt * 0x85EBCA6B) mod 2^32
  long long flags;
  long long col_tiles;   // tile tier: column groups of TILE_COLS
};

enum LeafFlags : long long {
  kBF16 = 1,        // g and u in bfloat16, else float32
  kTile = 2,        // the tile tier
  kStrided = 4,     // the strided tier
  kJnpOrder = 8,    // the jnp path's rounding order
  kVector = 16,     // contiguous tier: g 16-byte aligned
};

// 2^(-q/8) for a code q in [0, 254]: 2^-(q>>3) built in the exponent field,
// 2^-((q&7)/8) as a product of three selected constants (_exp2_neg_code)
__device__ __forceinline__ float exp2_neg_code(int q) {
  const float base = __int_as_float((127 - (q >> 3)) << 23);
  const float f1 = (q & 1) ? kFrac1 : 1.f;
  const float f2 = (q & 2) ? kFrac2 : 1.f;
  const float f4 = (q & 4) ? kFrac4 : 1.f;
  return __fmul_rn(base, __fmul_rn(__fmul_rn(f1, f2), f4));
}

// log2 of a positive normal float: exponent plus a degree-4 polynomial of
// the mantissa in [1, 2) (_log2_bits)
__device__ __forceinline__ float log2_bits(float x) {
  const int bits = __float_as_int(x);
  const int e = (bits >> 23) & 0xFF;
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  float p = kLog2P0;
  p = __fmaf_rn(p, m, kLog2P1);
  p = __fmaf_rn(p, m, kLog2P2);
  p = __fmaf_rn(p, m, kLog2P3);
  p = __fmaf_rn(p, m, kLog2P4);
  // e - 127 as a float without I2F: 2^23 + e, less 2^23 + 127, both exact
  const float ef = __fsub_rn(__int_as_float(0x4B000000 | e), 8388735.f);
  return __fadd_rn(ef, p);
}

// uniform [0, 1) dither of the absolute blocked index (_dither_from_idx);
// salt_hash = (count * 0x9E3779B9) ^ (salt * 0x85EBCA6B), mod 2^32
__device__ __forceinline__ float dither(uint32_t idx, uint32_t salt_hash) {
  uint32_t h = idx ^ salt_hash;
  h *= 0xCC9E2D51u;
  h = (h ^ (h >> 15)) * 0x1B873593u;
  h ^= h >> 13;
  return (float)(int)(h >> 8) * 0x1p-24f;
}

// floor(y) for |y| < 2^22: y + 1.5 * 2^23 rounded down, less 1.5 * 2^23,
// both exact (floorf is a quarter-rate instruction)
__device__ __forceinline__ float floor_small(float y) {
  return __fsub_rn(__fadd_rd(y, kRound), kRound);
}

// y rounded down, plus 1 where the dither falls below the fraction
__device__ __forceinline__ float stochastic_small(float y, uint32_t idx, uint32_t salt_hash) {
  const float lo = floor_small(y);
  return __fadd_rn(lo, dither(idx, salt_hash) < __fsub_rn(y, lo) ? 1.f : 0.f);
}

// the low bytes of four integer-valued floats q, |q| < 2^22, as two's
// complement codes in one word: the bits of q + 1.5 * 2^23 are
// 0x4B400000 + q, and two byte permutes gather the low bytes
__device__ __forceinline__ uint32_t code_bytes(const float* q) {
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = (uint32_t)__float_as_int(__fadd_rn(q[i], kRound));
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// dequantized moments after one EMA step with gradient g:
// b1*m + (1-b1)*g and b2*v + ((1-b2)*g)*g, the gradient's product fused (K6)
__device__ __forceinline__ void ema(int8_t mq, float ms, uint8_t vq, float vs, float g,
                                    const Hyper& hp, float& m, float& v) {
  const float m0 = __fmul_rn((float)mq, ms);
  const float v0 = vq == 255 ? 0.f : __fmul_rn(vs, exp2_neg_code(vq));
  m = __fmaf_rn(hp.one_minus_b1, g, __fmul_rn(hp.b1, m0));
  v = __fmaf_rn(__fmul_rn(hp.one_minus_b2, g), g, __fmul_rn(hp.b2, v0));
}

// Signed byte e of w as a float, exactly, without the quarter-rate integer
// conversion: wx = w ^ 0x80808080 holds each byte + 128, and the float whose
// bits are 0x4B0000xx is 2^23 + xx (as K3's byte_at).
__device__ __forceinline__ float signed_byte(uint32_t wx, int e) {
  return __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + e)) - 8388736.f;
}

// A lane's old state of one row: its 8 codes of each moment and the row's
// scales, loaded ahead of the row's arithmetic
struct RowState {
  uint2 mw, vw;
  float mscale, vscale;
};

__device__ __forceinline__ RowState load_row(const Leaf& L, long long row) {
  const size_t base = (size_t)row * BLOCK + PER_LANE * (threadIdx.x % 32);
  return {__ldg(reinterpret_cast<const uint2*>(L.mq + base)),
          __ldg(reinterpret_cast<const uint2*>(L.vq + base)), __ldg(L.ms + row),
          __ldg(L.vs + row)};
}

// One state row of K5 in a warp: lane l holds g[e] and returns u[e] for the
// row's elements 8 l + e (blocked index row * 256 + 8 l + e within the leaf),
// and writes the row's new codes and scales at row0 + row of the flat output.
template <bool kJnp>
__device__ __forceinline__ void adam8_row(const float (&g)[PER_LANE], float (&u)[PER_LANE],
                                          const Leaf& L, long long row, const RowState& in,
                                          const Step& st, const float* frac8,
                                          int8_t* __restrict__ out_mq,
                                          float* __restrict__ out_ms,
                                          uint8_t* __restrict__ out_vq,
                                          float* __restrict__ out_vs) {
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)row * BLOCK + PER_LANE * lane;
  const float mscale = in.mscale, vscale = in.vscale;
  const Hyper& hp = st.hp;
  const uint32_t mx[2] = {in.mw.x ^ 0x80808080u, in.mw.y ^ 0x80808080u};
  const uint32_t vx[2] = {in.vw.x, in.vw.y};
  const float c1 = st.corr1[kJnp], c2 = st.corr2[kJnp];
  float m[PER_LANE], v[PER_LANE];
  float amax = 0.f, vmax = 0.f;
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const float m0 = __fmul_rn(signed_byte(mx[e / 4], e % 4), mscale);
    const int q = (vx[e / 4] >> (8 * (e % 4))) & 0xFF;
    // 2^(-q/8) = frac8[q & 7] * 2^-(q >> 3), the power of two in the exponent
    // field: exact, as exp2_neg_code's product is (its result >= 2^-32)
    const float code = __int_as_float(__float_as_int(frac8[q & 7]) - ((q >> 3) << 23));
    const float v0 = q == 255 ? 0.f : __fmul_rn(vscale, code);
    m[e] = __fmaf_rn(hp.one_minus_b1, g[e], __fmul_rn(hp.b1, m0));
    if (kJnp)  // (1-b2) * square(g)
      v[e] = __fmaf_rn(hp.one_minus_b2, __fmul_rn(g[e], g[e]), __fmul_rn(hp.b2, v0));
    else       // ((1-b2) * g) * g
      v[e] = __fmaf_rn(__fmul_rn(hp.one_minus_b2, g[e]), g[e], __fmul_rn(hp.b2, v0));
    if (st.correct_bias)
      u[e] = __fdiv_rn(__fdiv_rn(m[e], c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v[e], c2)), hp.eps));
    else
      u[e] = __fdiv_rn(m[e], __fadd_rn(__fsqrt_rn(v[e]), hp.eps));
    amax = fmaxf(amax, fabsf(m[e]));
    vmax = fmaxf(vmax, v[e]);
  }
  amax = lako::warp_max(amax);
  vmax = lako::warp_max(vmax);

  // m: linear signed int8 with the row's absmax / 127 as scale
  const float mscale_new = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  // the division as a product with the reciprocal, corrected once; a
  // subnormal (or underflowed) scale takes div.rn
  const bool normal_scale = mscale_new >= 0x1p-126f;
  const float rcp = __frcp_rn(mscale_new);
  // v: log2 code, (log2(vmax) - log2(v)) * 8 steps, 255 for zero
  const float log_vmax = log2_bits(vmax > 0.f ? vmax : 1.f);
  const uint32_t salt_m = (uint32_t)L.salt_m, salt_v = (uint32_t)L.salt_v;
  float qm[PER_LANE], qv[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const uint32_t idx = (uint32_t)(base + e);
    float y = normal_scale ? lako::div_rn(m[e], mscale_new, rcp) : __fdiv_rn(m[e], mscale_new);
    y = st.stochastic_round ? stochastic_small(y, idx, salt_m)
                            : __fsub_rn(__fadd_rn(y, kRound), kRound);
    qm[e] = fminf(fmaxf(y, -127.f), 127.f);

    // log2 of v <= 0 is never used: such a v takes code 255 (v <= vmax)
    float yv = __fmul_rn(__fsub_rn(log_vmax, log2_bits(v[e])), kLogSteps);
    yv = st.stochastic_round ? stochastic_small(yv, idx, salt_v)
                             : __fsub_rn(__fadd_rn(yv, kRound), kRound);
    qv[e] = v[e] <= 0.f || vmax <= 0.f ? 255.f : fminf(fmaxf(yv, 0.f), 254.f);
  }
  const size_t out_row = (size_t)(L.row0 + row);
  *reinterpret_cast<uint2*>(out_mq + out_row * BLOCK + PER_LANE * lane) =
      make_uint2(code_bytes(qm), code_bytes(qm + 4));
  *reinterpret_cast<uint2*>(out_vq + out_row * BLOCK + PER_LANE * lane) =
      make_uint2(code_bytes(qv), code_bytes(qv + 4));
  if (lane == 0) {
    out_ms[out_row] = mscale_new;
    out_vs[out_row] = vmax;
  }
}

// 8 elements of G from 16-byte-aligned memory, as floats
template <typename G> __device__ __forceinline__ void load8(const G* p, float (&x)[8]);
template <> __device__ __forceinline__ void load8<float>(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is the high half of the word
    x[2 * i] = __int_as_float(ws[i] << 16);
    x[2 * i + 1] = __int_as_float(ws[i] & 0xFFFF0000u);
  }
}

template <typename G> __device__ __forceinline__ void store8(G* p, const float (&x)[8]);
template <> __device__ __forceinline__ void store8<float>(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(lako::pack_bf16(x[0], x[1]), lako::pack_bf16(x[2], x[3]),
                                            lako::pack_bf16(x[4], x[5]),
                                            lako::pack_bf16(x[6], x[7]));
}

// the tile tier's block: 256 outputs [256 j, 256 j + 256) of the input
// columns [c0, c0 + TILE_COLS); output r of column k sits at
// tile[k * TILE_PITCH + (r % 8) * SEG + r / 8], so that lane l reading its
// elements 8 l + e, and a thread writing 16 bytes of an output row, hit
// distinct banks
template <typename G, bool kJnp>
__device__ void tile_block(const Leaf& L, long long tile, const Step& st, float* sm,
                           int8_t* out_mq, float* out_ms, uint8_t* out_vq, float* out_vs) {
  constexpr int EPC = 16 / sizeof(G);           // elements of a 16-byte copy
  constexpr int CH = TILE_COLS / EPC;           // copies per output row
  const long long per_col = L.rows / BLOCK;
  const long long j = tile / L.col_tiles;
  const long long c0 = (tile - j * L.col_tiles) * TILE_COLS;
  const G* g = static_cast<const G*>(L.g);
  G* u = static_cast<G*>(L.u);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  RowState in[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
    if (c0 + warp + WARPS * i < L.cols) in[i] = load_row(L, (c0 + warp + WARPS * i) * per_col + j);
#pragma unroll
  for (int i = 0; i < BLOCK * CH / THREADS; ++i) {
    const int x = threadIdx.x + THREADS * i, r = x / CH, part = x % CH;
    const long long c = c0 + part * EPC;
    if (c < L.cols) {
      const G* src = g + (size_t)(BLOCK * j + r) * L.cols + c;
      float f[EPC];
      if constexpr (EPC == 8) {
        load8<G>(src, f);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(src);
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) sm[(part * EPC + e) * TILE_PITCH + (r % 8) * SEG + r / 8] = f[e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int k = warp + WARPS * i;
    if (c0 + k < L.cols) {
      float gr[PER_LANE], ur[PER_LANE];
      float* col = sm + k * TILE_PITCH + lane;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) gr[e] = col[e * SEG];
      adam8_row<kJnp>(gr, ur, L, (c0 + k) * per_col + j, in[i], st, sm + TILE_COLS * TILE_PITCH,
                      out_mq, out_ms, out_vq, out_vs);
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) col[e * SEG] = ur[e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BLOCK * CH / THREADS; ++i) {
    const int x = threadIdx.x + THREADS * i, r = x / CH, part = x % CH;
    const long long c = c0 + part * EPC;
    if (c < L.cols) {
      G* dst = u + (size_t)(BLOCK * j + r) * L.cols + c;
      float f[8];
#pragma unroll
      for (int e = 0; e < EPC; ++e) f[e] = sm[(part * EPC + e) * TILE_PITCH + (r % 8) * SEG + r / 8];
      if constexpr (EPC == 8) {
        store8<G>(dst, f);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  }
}

// the contiguous and strided tiers' block: state rows 16 t + w + 8 i of the
// leaf (t the block's tile, w the warp), both rows' inputs loaded before
// either row's arithmetic
template <typename G, bool kJnp>
__device__ void row_block(const Leaf& L, long long tile, const Step& st, const float* frac8,
                          int8_t* out_mq, float* out_ms, uint8_t* out_vq, float* out_vs) {
  const G* g = static_cast<const G*>(L.g);
  G* u = static_cast<G*>(L.u);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool strided = (L.flags & kStrided) != 0;
  float gr[ROWS_PER_WARP][PER_LANE];
  RowState in[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const long long row = tile * TILE_COLS + warp + WARPS * i;
    if (row >= L.nb) continue;
    in[i] = load_row(L, row);
    const long long idx0 = row * BLOCK + PER_LANE * lane;
    if (strided) {
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const long long idx = idx0 + e;
        gr[i][e] = idx < L.n ? lako::to_f32(g[(idx % L.rows) * L.cols + idx / L.rows]) : 0.f;
      }
    } else if ((L.flags & kVector) && idx0 + PER_LANE <= L.n) {
      load8<G>(g + idx0, gr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e)
        gr[i][e] = idx0 + e < L.n ? lako::to_f32(g[idx0 + e]) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const long long row = tile * TILE_COLS + warp + WARPS * i;
    if (row >= L.nb) continue;
    float ur[PER_LANE];
    adam8_row<kJnp>(gr[i], ur, L, row, in[i], st, frac8, out_mq, out_ms, out_vq, out_vs);
    const long long idx0 = row * BLOCK + PER_LANE * lane;
    if (strided) {
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const long long idx = idx0 + e;
        if (idx < L.n) u[(idx % L.rows) * L.cols + idx / L.rows] = lako::from_f32<G>(ur[e]);
      }
    } else if ((L.flags & kVector) && idx0 + PER_LANE <= L.n) {
      store8<G>(u + idx0, ur);
    } else {
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e)
        if (idx0 + e < L.n) u[idx0 + e] = lako::from_f32<G>(ur[e]);
    }
  }
}

template <typename G, bool kJnp>
__device__ __forceinline__ void leaf_block(const Leaf& L, long long tile, const Step& st,
                                           float* sm, int8_t* out_mq, float* out_ms,
                                           uint8_t* out_vq, float* out_vs) {
  if (L.flags & kTile)
    tile_block<G, kJnp>(L, tile, st, sm, out_mq, out_ms, out_vq, out_vs);
  else
    row_block<G, kJnp>(L, tile, st, sm + TILE_COLS * TILE_PITCH, out_mq, out_ms, out_vq,
                       out_vs);
}

// the last leaf whose first block is at or before block b (n_leaves > 1)
__device__ __forceinline__ int find_leaf(const Leaf* table, int n_leaves, long long b) {
  const int* block0 = reinterpret_cast<const int*>(table + n_leaves);
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (__ldg(block0 + mid) <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// K5 over n_leaves leaves: `table` (device) holds their descriptors,
// followed by their first blocks as int32; a one-leaf launch passes its
// descriptor in `single` and no table.
__global__ void __launch_bounds__(THREADS)
adam8_update_leaves_kernel(const Leaf* __restrict__ table, Leaf single, int n_leaves,
                           int8_t* __restrict__ out_mq, float* __restrict__ out_ms,
                           uint8_t* __restrict__ out_vq, float* __restrict__ out_vs, Step st) {
  // the tile, then the 8 values of 2^-(q&7)/8 as exp2_neg_code rounds them
  __shared__ float sm[TILE_COLS * TILE_PITCH + 8];
  if (threadIdx.x < 8) sm[TILE_COLS * TILE_PITCH + threadIdx.x] = exp2_neg_code(threadIdx.x);
  __syncthreads();
  const long long b = blockIdx.x;
  const Leaf L = n_leaves > 1 ? table[find_leaf(table, n_leaves, b)] : single;
  const long long tile = b - L.block0;
  const bool bf16 = (L.flags & kBF16) != 0, jnp = (L.flags & kJnpOrder) != 0;
  if (bf16 && jnp)
    leaf_block<__nv_bfloat16, true>(L, tile, st, sm, out_mq, out_ms, out_vq, out_vs);
  else if (bf16)
    leaf_block<__nv_bfloat16, false>(L, tile, st, sm, out_mq, out_ms, out_vq, out_vs);
  else if (jnp)
    leaf_block<float, true>(L, tile, st, sm, out_mq, out_ms, out_vq, out_vs);
  else
    leaf_block<float, false>(L, tile, st, sm, out_mq, out_ms, out_vq, out_vs);
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
adam8_ema_kernel(const G* __restrict__ g, const int8_t* __restrict__ mq,
                 const float* __restrict__ ms, const uint8_t* __restrict__ vq,
                 const float* __restrict__ vs, __nv_bfloat16* __restrict__ u, int nb,
                 Hyper hp) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= nb) return;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)row * BLOCK;
  const float mscale = ms[row], vscale = vs[row];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const size_t idx = base + lane + 32 * e;
    float m, v;
    ema(mq[idx], mscale, vq[idx], vscale, lako::to_f32(g[idx]), hp, m, v);
    u[idx] = __float2bfloat16(__fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), hp.eps)));
  }
}

inline unsigned blocks_for(int nb) { return (unsigned)((nb + WARPS - 1) / WARPS); }

}  // namespace

// K5 over n_leaves >= 1 leaves in one launch of n_blocks blocks. leaves: the
// host's descriptors (n_leaves x 16 int64, ops/adam8_kernel.py LEAF_FIELDS;
// read here only for a one-leaf launch); table: the same descriptors followed
// by their first blocks as int32, in device memory (unused for one leaf).
// The host chose each leaf's tier and blocks for rows_per_block state rows
// (or tile columns) a block; a launch is refused unless that is TILE_COLS.
// out_mq (NB,256) int8, out_ms (NB,1) f32, out_vq (NB,256) uint8, out_vs
// (NB,1) f32: the flat new state. corr*: the bias corrections of the kernel
// and the jnp order. Returns a cudaError_t code (0 = launched).
extern "C" int lako_adam8_update_leaves(const void* leaves, const void* table, void* out_mq,
                                        void* out_ms, void* out_vq, void* out_vs,
                                        int n_leaves, int n_blocks, int rows_per_block,
                                        int correct_bias, int stochastic_round, float b1,
                                        float b2, float one_minus_b1, float one_minus_b2,
                                        float eps, float corr1_kernel, float corr2_kernel,
                                        float corr1_jnp, float corr2_jnp, void* stream) {
  static_assert(sizeof(Leaf) == 16 * 8, "Leaf is sixteen 64-bit words");
  if (n_leaves < 1 || rows_per_block != TILE_COLS) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const Step st{{b1, b2, one_minus_b1, one_minus_b2, eps},
                {corr1_kernel, corr1_jnp}, {corr2_kernel, corr2_jnp},
                correct_bias, stochastic_round};
  const Leaf single = *static_cast<const Leaf*>(leaves);
  adam8_update_leaves_kernel<<<(unsigned)n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), single, n_leaves, static_cast<int8_t*>(out_mq),
      static_cast<float*>(out_ms), static_cast<uint8_t*>(out_vq), static_cast<float*>(out_vs),
      st);
  return (int)cudaGetLastError();
}

// K6. g: (nb,256) in g_dtype; state as K5's; u: (nb,256) bf16.
extern "C" int lako_adam8_ema_fragment(const void* g, const void* mq, const void* ms,
                                       const void* vq, const void* vs, void* u, int nb,
                                       int g_dtype, float b1, float b2, float one_minus_b1,
                                       float one_minus_b2, float eps, void* stream) {
  if (nb == 0) return 0;
  const Hyper hp{b1, b2, one_minus_b1, one_minus_b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mq8 = static_cast<const int8_t*>(mq);
  const auto* vq8 = static_cast<const uint8_t*>(vq);
  const auto* msf = static_cast<const float*>(ms);
  const auto* vsf = static_cast<const float*>(vs);
  auto* ub = static_cast<__nv_bfloat16*>(u);
  if (g_dtype == lako::kFloat32)
    adam8_ema_kernel<float><<<blocks_for(nb), THREADS, 0, s>>>(
        static_cast<const float*>(g), mq8, msf, vq8, vsf, ub, nb, hp);
  else if (g_dtype == lako::kBFloat16)
    adam8_ema_kernel<__nv_bfloat16><<<blocks_for(nb), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), mq8, msf, vq8, vsf, ub, nb, hp);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
