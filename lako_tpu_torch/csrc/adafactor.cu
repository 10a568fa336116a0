// Adafactor over every leaf of a parameter tree in four launches (K7).
//
// Replaces no pallas_call. The JAX package's Adafactor is optax's chain
// (lako_tpu/train/optim.py: clip by global norm -> factored RMS -> clip by
// block RMS -> lr -> x parameter RMS -> -1), which XLA fuses on the TPU.
// In eager PyTorch the same chain (train/optim.py) issues ~38 launches a
// leaf, ~19,000 a t5-3b step, and keeps several full-size copies of the
// tree alive. This is that chain for a tree of float32 leaves on the card,
// in the chain's arithmetic, with sums taken in another (fixed) order and
// one product rounded elsewhere: the factored statistics are the clip's
// scale squared times the row and column sums of g^2, which pass 1 takes
// beside the norms, where the chain sums the squares of the clipped g.
// (Where the global norm overflows float32, a row or column whose own sum
// overflows then reads NaN; the chain's reads eps unless it holds an inf.)
//
// What bounds it on the H100: bytes. Every pass walks the tree in tiles of
// 256 x 256 elements of the port's (rows, cols) layout (a leaf that is not
// factored is read flat, as rows of 256), one block a tile, 8 warps of 32
// rows, a lane 8 columns in two 16-byte loads. Per float32 element:
//   1. norms:   reads g and p (8 bytes); per-tile sums of g^2 and p^2, and a
//               factored leaf's per-tile row and column sums of g^2 (2/256
//               of a float an element). The last block to finish reduces
//               the tiles per leaf and over the tree: the global norm, each
//               leaf's max(rms(p), 1e-3).
//   2. factors: reads those sums; with s = clip / norm where the norm
//               reaches clip (else 1), a mean of g'^2 + eps is s^2 x mean
//               of g^2 + eps: the new v_row and v_col in place, the row
//               factor (v_row / mean(v_row))^-1/2 and the column factor
//               v_col^-1/2 into scratch (one block for v_row, one for each
//               1,024 entries of v_col).
//   3. block rms: reads g (4 bytes); g' = g, or g / norm * clip where the
//               norm reaches clip; a leaf not factored updates its v in
//               place (decay v + keep (g'^2 + eps)); per-tile sums of u^2,
//               u = g' x row factor x column factor (or g' v^-1/2). The
//               last block: each leaf's max(1, rms(u)).
//   4. update:  reads g, writes g (8 bytes): -((u / max(1, rms(u))) x lr) x
//               max(rms(p), 1e-3), in the gradient's buffer.
// 20 bytes an element, 57.0 GB at t5-3b's 2.852e9 elements, 17.0 ms at 3.35
// TB/s: the least this arithmetic reads, since the norm, the statistics and
// the block RMS each wait on a sum over the whole of a leaf or the tree.
// apply_updates' p += u reads and writes 12 bytes more: 32, 91.3 GB, 27.2
// ms (24 with p += u folded into pass 4).
//
// Reductions are deterministic and close to pairwise: a lane loads four
// rows at once and keeps a sum for each, a row's 8 values and the four
// sums add as trees, warps reduce by xor shuffles and a block's warps as a
// tree, and the last block (found with an integer counter in scratch, set
// to 0 before the launches) adds a leaf's tiles in a fixed order, so two
// runs are bitwise equal. No float atomics. Every rounding is spelled out (__fmul_rn, __fadd_rn, ...) so
// nvcc contracts no product into an add the chain rounds apart. The leaves
// come from one descriptor table in device memory (ops/adafactor_kernel.py
// LEAF_FIELDS), followed by each leaf's first tile and its first block of
// pass 2 as int32; a block finds its leaf by binary search.

#include "common.cuh"

namespace {

constexpr int TILE = 256;                  // a tile's rows and columns
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;        // one thread a tile column in pass 1
constexpr int ROWS_PER_WARP = TILE / WARPS;
constexpr int PER_LANE = TILE / 32;        // columns 4 lane + e and 128 + 4 lane + e
constexpr int SLOTS = 4;                   // rows a warp loads at once
constexpr int FIN_CHUNK = 1024;            // v_col entries a block of pass 2 takes

enum LeafFlags : long long {
  kFactored = 1,     // v_row and v_col, else v whole
  kRowStat = 2,      // v_row runs along the port's rows (its mean is over the columns)
  kVector = 4,       // g and p 16-byte aligned, cols a multiple of 4
  kVTransposed = 8,  // v whole in the JAX orientation of an (out, in) leaf
};

// A leaf: the layout of ops/adafactor_kernel.py LEAF_FIELDS, sixteen 64-bit
// words. Scratch offsets count floats from the scratch buffer's start.
struct Leaf {
  float* g;                  // the gradient in, the update out
  const float* p;            // the parameter
  float* va;                 // factored: v_row; else v
  float* vb;                 // factored: v_col
  long long n, rows, cols;   // a leaf not factored: (ceil(n / 256), 256)
  long long tile0, tiles_c;  // its first tile; tiles along a row
  long long rpart, cpart;    // row sums (tiles_c x rows), column sums (tiles_r x cols)
  long long frow, fcol;      // the factor of each row, of each column
  long long fin0;            // its first block of pass 2
  long long flags;
  long long vt_cols;         // kVTransposed: the port's columns
};

// the update's scalars: the constant ones from the host in float32, the
// step's own (decay, keep, lr) read from the card when a pass runs, so a
// CUDA graph that captured the launch takes each step's values
struct Step {
  float clip, eps, min_scale;
  const float* values;  // decay, keep, lr
};

// the fixed head of the scratch buffer
struct Scratch {
  float* base;
  float* part_a;   // [tiles] a tile's sum of g^2, then of u^2
  float* part_b;   // [tiles] a tile's sum of p^2
  float* leaf_sq;  // [leaves] a leaf's sum of g^2
  float* pscale;   // [leaves] max(rms(p), min_scale)
  float* uscale;   // [leaves] max(1, rms(u))
  float* norm;     // [1] the global norm
  unsigned* counters;  // [2] blocks finished in passes 1 and 3
};

__host__ __device__ __forceinline__ Scratch scratch_of(float* s, int tiles, int leaves) {
  float* leaf = s + 2 * (long long)tiles;
  return {s, s, s + tiles, leaf, leaf + leaves, leaf + 2 * leaves, leaf + 3 * leaves,
          reinterpret_cast<unsigned*>(leaf + 3 * leaves + 1)};
}

// the last leaf whose first block (first[]) is at or before block b
__device__ __forceinline__ int find_leaf(const int* first, int n_leaves, int b) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (__ldg(first + mid) <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ long long tiles_r_of(const Leaf& L) {
  return (L.rows + TILE - 1) / TILE;
}

// column of the lane's element j in a tile starting at column c0
__device__ __forceinline__ long long col_of(long long c0, int lane, int j) {
  return c0 + (j >> 2) * 128 + 4 * lane + (j & 3);
}

// The lane's 8 elements of row r of a tile starting at column c0 (0 outside
// the leaf); bit j of the result marks element j as inside.
__device__ __forceinline__ unsigned load8(const float* base, const Leaf& L, long long r,
                                          long long c0, int lane, float (&x)[PER_LANE]) {
  unsigned mask = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long c = c0 + h * 128 + 4 * lane;
    const long long idx = r * L.cols + c;
    if ((L.flags & kVector) && c + 4 <= L.cols && idx + 4 <= L.n) {
      const float4 v = *reinterpret_cast<const float4*>(base + idx);
      x[4 * h] = v.x;
      x[4 * h + 1] = v.y;
      x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
      mask |= 0xFu << (4 * h);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = c + e < L.cols && idx + e < L.n;
        x[4 * h + e] = in ? base[idx + e] : 0.f;
        mask |= (unsigned)in << (4 * h + e);
      }
    }
  }
  return mask;
}

__device__ __forceinline__ void store8(float* base, const Leaf& L, long long r, long long c0,
                                       int lane, const float (&x)[PER_LANE], unsigned mask) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long c = c0 + h * 128 + 4 * lane;
    const long long idx = r * L.cols + c;
    if (((mask >> (4 * h)) & 0xFu) == 0xFu && (L.flags & kVector)) {
      *reinterpret_cast<float4*>(base + idx) =
          make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((mask >> (4 * h + e)) & 1u) base[idx + e] = x[4 * h + e];
    }
  }
}

// x / y: lako::div_rn with y's reciprocal r where y is finite and not 0,
// else the IEEE division
__device__ __forceinline__ float div_by(float x, float y, float r, bool fast) {
  return fast ? lako::div_rn(x, y, r) : __fdiv_rn(x, y);
}

// clip_by_global_norm: g where norm < clip, else g / norm * clip
struct Clip {
  float norm, rnorm, clip;
  bool keep, fast;
  __device__ __forceinline__ float operator()(float g) const {
    return keep ? g : __fmul_rn(div_by(g, norm, rnorm, fast), clip);
  }
};

__device__ __forceinline__ Clip clip_of(const Scratch& S, const Step& st) {
  const float norm = *S.norm;
  return {norm, __frcp_rn(norm), st.clip, norm < st.clip, isfinite(norm) && norm != 0.f};
}

// index into a whole v of element idx of the leaf (the JAX orientation of a
// transposed leaf: port (i, j) is JAX (j, i))
__device__ __forceinline__ long long v_index(const Leaf& L, long long idx) {
  if (!(L.flags & kVTransposed)) return idx;
  const long long i = idx / L.vt_cols, j = idx - i * L.vt_cols;
  return j * (L.n / L.vt_cols) + i;
}

// x[0] + ... + x[N-1] as a balanced tree (N a power of 2), x[i] at stride
template <int N>
__device__ __forceinline__ float tree_sum(const float* x, int stride = 1) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return __fadd_rn(tree_sum<N / 2>(x, stride), tree_sum<N / 2>(x + N / 2 * stride, stride));
  }
}

// the sum of x over the block, in a fixed order; every thread gets it
__device__ __forceinline__ float block_sum(float x, float* sm) {
  x = lako::warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // sm may still be read from an earlier call
  if (lane == 0) sm[warp] = x;
  __syncthreads();
  return tree_sum<WARPS>(sm);
}

// the sum over a leaf's tiles of part[], in tile order (by one warp)
__device__ __forceinline__ float leaf_tiles_sum(const Leaf& L, const float* part, int lane) {
  const long long nt = tiles_r_of(L) * L.tiles_c;
  float s = 0.f;
  for (long long k = lane; k < nt; k += 32) s = __fadd_rn(s, __ldcg(part + L.tile0 + k));
  return lako::warp_sum(s);
}

// True in every thread of the block that finished last. Thread 0 wrote the
// block's partial sums before.
__device__ __forceinline__ bool last_block(unsigned* counter, bool* flag) {
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// u of factored element (r, c): (g' x row factor) x column factor, the row
// factor belonging to v_row's axis
__device__ __forceinline__ float u_factored(float gc, float f_row, float f_col, bool row_stat) {
  return row_stat ? __fmul_rn(__fmul_rn(gc, f_row), f_col) : __fmul_rn(__fmul_rn(gc, f_col), f_row);
}

// Calls f(a, r, g', mask, fcol) for each row r of tile `tile` that the
// warp takes, loading SLOTS rows at once (a: the row's slot among them):
// g' the lane's 8 clipped gradients; fcol the factors of its 8 columns
// (factored leaves).
template <typename F>
__device__ __forceinline__ void walk_tile(const Leaf& L, long long tile, const Scratch& S,
                                          const Clip& clip, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tr = tile / L.tiles_c, tc = tile - tr * L.tiles_c;
  const long long r0 = tr * TILE, c0 = tc * TILE;
  float fcol[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const long long c = col_of(c0, lane, j);
    fcol[j] = (L.flags & kFactored) && c < L.cols ? S.base[L.fcol + c] : 0.f;
  }
  for (int i = 0; i < ROWS_PER_WARP && r0 + warp + WARPS * i < L.rows; i += SLOTS) {
    float g[SLOTS][PER_LANE];
    unsigned mask[SLOTS];
#pragma unroll
    for (int a = 0; a < SLOTS; ++a) {
      const long long r = r0 + warp + WARPS * (i + a);
      mask[a] = r < L.rows ? load8(L.g, L, r, c0, lane, g[a]) : 0u;
    }
#pragma unroll
    for (int a = 0; a < SLOTS; ++a) {
      const long long r = r0 + warp + WARPS * (i + a);
      if (r < L.rows) {  // warp-uniform
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) g[a][j] = clip(g[a][j]);
        f(a, r, g[a], mask[a], fcol);
      }
    }
  }
}

// u of the lane's 8 elements of row r (passes 3 and 4), in place of g'
__device__ __forceinline__ void u_row(const Leaf& L, const Scratch& S, long long r, long long c0,
                                      int lane, float (&g)[PER_LANE], unsigned mask,
                                      const float (&fcol)[PER_LANE]) {
  if (L.flags & kFactored) {
    const float f_row = S.base[L.frow + r];
    const bool row_stat = (L.flags & kRowStat) != 0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) g[j] = u_factored(g[j], f_row, fcol[j], row_stat);
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if ((mask >> j) & 1u)
        g[j] = __fmul_rn(g[j], __frsqrt_rn(L.va[v_index(L, r * L.cols + col_of(c0, lane, j))]));
  }
}

// Pass 1: per-tile sums of g^2 and p^2, and a factored leaf's per-tile row
// and column sums of g^2; the last block: each leaf's sum of g^2 and
// max(rms(p), min_scale), and the global norm.
__global__ void __launch_bounds__(THREADS)
norms_kernel(const Leaf* __restrict__ table, int n_leaves, int n_tiles, float* scratch, Step st) {
  __shared__ float sm[WARPS];
  __shared__ float cols[WARPS][TILE];
  __shared__ bool last;
  const Scratch S = scratch_of(scratch, n_tiles, n_leaves);
  const int b = blockIdx.x;
  const Leaf L = table[find_leaf(reinterpret_cast<const int*>(table + n_leaves), n_leaves, b)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tile = b - L.tile0;
  const long long tr = tile / L.tiles_c, tc = tile - tr * L.tiles_c;
  const long long r0 = tr * TILE, c0 = tc * TILE;
  const bool factored = (L.flags & kFactored) != 0;
  float sg[SLOTS] = {}, sp[SLOTS] = {};
  float cacc[SLOTS][PER_LANE] = {};   // a column's sum of g^2 over the rows of each slot
  for (int i = 0; i < ROWS_PER_WARP && r0 + warp + WARPS * i < L.rows; i += SLOTS) {
    float g[SLOTS][PER_LANE], p[SLOTS][PER_LANE];
#pragma unroll
    for (int a = 0; a < SLOTS; ++a) {
      const long long r = r0 + warp + WARPS * (i + a);
      if (r < L.rows) {
        load8(L.g, L, r, c0, lane, g[a]);
        load8(L.p, L, r, c0, lane, p[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < SLOTS; ++a) {
      const long long r = r0 + warp + WARPS * (i + a);
      if (r < L.rows) {  // warp-uniform
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          g[a][j] = __fmul_rn(g[a][j], g[a][j]);
          p[a][j] = __fmul_rn(p[a][j], p[a][j]);
        }
        const float row = tree_sum<PER_LANE>(g[a]);
        sg[a] = __fadd_rn(sg[a], row);
        sp[a] = __fadd_rn(sp[a], tree_sum<PER_LANE>(p[a]));
        if (factored) {  // block-uniform
#pragma unroll
          for (int j = 0; j < PER_LANE; ++j) cacc[a][j] = __fadd_rn(cacc[a][j], g[a][j]);
          const float rs = lako::warp_sum(row);
          if (lane == 0) S.base[L.rpart + tc * L.rows + r] = rs;
        }
      }
    }
  }
  if (factored) {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      cols[warp][col_of(0, lane, j)] = tree_sum<SLOTS>(&cacc[0][j], PER_LANE);
    __syncthreads();
    const long long c = c0 + threadIdx.x;
    if (c < L.cols) S.base[L.cpart + tr * L.cols + c] = tree_sum<WARPS>(&cols[0][threadIdx.x], TILE);
  }
  const float tg = block_sum(tree_sum<SLOTS>(sg), sm);
  const float tp = block_sum(tree_sum<SLOTS>(sp), sm);
  if (threadIdx.x == 0) {
    S.part_a[b] = tg;
    S.part_b[b] = tp;
  }
  if (!last_block(S.counters, &last)) return;
  for (int i = warp; i < n_leaves; i += WARPS) {
    const Leaf Li = table[i];
    const float g2 = leaf_tiles_sum(Li, S.part_a, lane);
    const float p2 = leaf_tiles_sum(Li, S.part_b, lane);
    if (lane == 0) {
      S.leaf_sq[i] = g2;
      const float rms = __fsqrt_rn(__fdiv_rn(p2, (float)Li.n));
      S.pscale[i] = rms <= st.min_scale ? st.min_scale : rms;
    }
  }
  __syncthreads();
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_leaves; i += THREADS) acc = __fadd_rn(acc, S.leaf_sq[i]);
  acc = block_sum(acc, sm);
  if (threadIdx.x == 0) *S.norm = __fsqrt_rn(acc);
}

// sum over q < count of part[q * stride + k], in a fixed order: eight
// interleaved sums (loads in flight), added as a tree
__device__ __forceinline__ float sum_parts(const float* part, long long stride, long long count,
                                           long long k) {
  constexpr int WAYS = 8;
  float s[WAYS] = {};
  for (long long q = 0; q < count; q += WAYS) {
#pragma unroll
    for (int u = 0; u < WAYS; ++u)
      if (q + u < count) s[u] = __fadd_rn(s[u], part[(q + u) * stride + k]);
  }
  return tree_sum<WAYS>(s);
}

// Pass 2, per factored leaf: block 0 the new v_row (decay v_row + keep
// mean) in place and the row factor (v_row / mean(v_row))^-1/2; the others
// FIN_CHUNK entries each of the new v_col and the column factor v_col^-1/2.
// A mean of g'^2 + eps is s^2 x (the sum of g^2 / its count) + eps.
__global__ void __launch_bounds__(THREADS)
factors_kernel(const Leaf* __restrict__ table, int n_leaves, int n_tiles, float* scratch,
               Step st) {
  __shared__ float sm[WARPS];
  const Scratch S = scratch_of(scratch, n_tiles, n_leaves);
  const int b = blockIdx.x;
  const Leaf L =
      table[find_leaf(reinterpret_cast<const int*>(table + n_leaves) + n_leaves, n_leaves, b)];
  if (!(L.flags & kFactored)) return;
  const bool row_stat = (L.flags & kRowStat) != 0;
  // v_row's entries run along the port's rows (its mean over the columns,
  // from the row sums) or along the columns (from the column sums)
  const long long n_vrow = row_stat ? L.rows : L.cols, n_vcol = row_stat ? L.cols : L.rows;
  const float* vrow_part = S.base + (row_stat ? L.rpart : L.cpart);
  const float* vcol_part = S.base + (row_stat ? L.cpart : L.rpart);
  const long long vrow_parts = row_stat ? L.tiles_c : tiles_r_of(L);
  const long long vcol_parts = row_stat ? tiles_r_of(L) : L.tiles_c;
  const float vrow_over = (float)n_vcol, vcol_over = (float)n_vrow;  // elements a mean takes
  float* vrow_factor = S.base + (row_stat ? L.frow : L.fcol);
  float* vcol_factor = S.base + (row_stat ? L.fcol : L.frow);
  const Clip clip = clip_of(S, st);
  const float decay = st.values[0], keep = st.values[1];
  const float s = clip.keep ? 1.f : __fdiv_rn(clip.clip, clip.norm);
  const float s2 = __fmul_rn(s, s);
  // s^2 x (sum / count) + eps
  auto mean_of = [&](float sum, float count) {
    return __fadd_rn(__fmul_rn(s2, __fdiv_rn(sum, count)), st.eps);
  };
  const long long k_block = b - L.fin0;
  if (k_block == 0) {
    float acc = 0.f;
    for (long long k = threadIdx.x; k < n_vrow; k += THREADS) {
      const float mean = mean_of(sum_parts(vrow_part, n_vrow, vrow_parts, k), vrow_over);
      const float v = __fadd_rn(__fmul_rn(decay, L.va[k]), __fmul_rn(keep, mean));
      L.va[k] = v;
      acc = __fadd_rn(acc, v);
    }
    const float mean = __fdiv_rn(block_sum(acc, sm), (float)n_vrow);
    for (long long k = threadIdx.x; k < n_vrow; k += THREADS)
      vrow_factor[k] = __frsqrt_rn(__fdiv_rn(L.va[k], mean));
  } else {
    const long long end = min(n_vcol, k_block * FIN_CHUNK);
    for (long long k = (k_block - 1) * FIN_CHUNK + threadIdx.x; k < end; k += THREADS) {
      const float mean = mean_of(sum_parts(vcol_part, n_vcol, vcol_parts, k), vcol_over);
      const float v = __fadd_rn(__fmul_rn(decay, L.vb[k]), __fmul_rn(keep, mean));
      L.vb[k] = v;
      vcol_factor[k] = __frsqrt_rn(v);
    }
  }
}

// Pass 3: a leaf not factored updates its v, decay v + keep (g'^2 + eps),
// in place; per-tile sums of u^2; the last block: each leaf's max(1, rms(u)).
__global__ void __launch_bounds__(THREADS)
block_rms_kernel(const Leaf* __restrict__ table, int n_leaves, int n_tiles, float* scratch,
                 Step st) {
  __shared__ float sm[WARPS];
  __shared__ bool last;
  const Scratch S = scratch_of(scratch, n_tiles, n_leaves);
  const int b = blockIdx.x;
  const Leaf L = table[find_leaf(reinterpret_cast<const int*>(table + n_leaves), n_leaves, b)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tile = b - L.tile0;
  const long long c0 = (tile - tile / L.tiles_c * L.tiles_c) * TILE;
  const Clip clip = clip_of(S, st);
  const float decay = st.values[0], keep = st.values[1];
  float su[SLOTS] = {};
  walk_tile(L, tile, S, clip, [&](int a, long long r, float (&g)[PER_LANE], unsigned mask,
                                       const float (&fcol)[PER_LANE]) {
    if (!(L.flags & kFactored)) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if ((mask >> j) & 1u) {
          const float sq = __fadd_rn(__fmul_rn(g[j], g[j]), st.eps);
          float* v = L.va + v_index(L, r * L.cols + col_of(c0, lane, j));
          *v = __fadd_rn(__fmul_rn(decay, *v), __fmul_rn(keep, sq));
        }
      }
    }
    u_row(L, S, r, c0, lane, g, mask, fcol);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) g[j] = (mask >> j) & 1u ? __fmul_rn(g[j], g[j]) : 0.f;
    su[a] = __fadd_rn(su[a], tree_sum<PER_LANE>(g));
  });
  const float tu = block_sum(tree_sum<SLOTS>(su), sm);
  if (threadIdx.x == 0) S.part_a[b] = tu;
  if (!last_block(S.counters + 1, &last)) return;
  for (int i = warp; i < n_leaves; i += WARPS) {
    const Leaf Li = table[i];
    const float u2 = leaf_tiles_sum(Li, S.part_a, lane);
    if (lane == 0) {
      const float rms = __fsqrt_rn(__fdiv_rn(u2, (float)Li.n));
      S.uscale[i] = rms < 1.f ? 1.f : rms;  // clamp(rms, min=1), NaN kept
    }
  }
}

// Pass 4: g = -((u / max(1, rms(u))) x lr) x max(rms(p), min_scale).
__global__ void __launch_bounds__(THREADS)
update_kernel(const Leaf* __restrict__ table, int n_leaves, int n_tiles, float* scratch, Step st) {
  const Scratch S = scratch_of(scratch, n_tiles, n_leaves);
  const int b = blockIdx.x;
  const int leaf = find_leaf(reinterpret_cast<const int*>(table + n_leaves), n_leaves, b);
  const Leaf L = table[leaf];
  const int lane = threadIdx.x % 32;
  const long long tile = b - L.tile0;
  const long long c0 = (tile - tile / L.tiles_c * L.tiles_c) * TILE;
  const Clip clip = clip_of(S, st);
  const float us = S.uscale[leaf], ps = S.pscale[leaf], lr = st.values[2];
  const float rus = __frcp_rn(us);
  const bool fast = isfinite(us);
  walk_tile(L, tile, S, clip, [&](int, long long r, float (&g)[PER_LANE], unsigned mask,
                                       const float (&fcol)[PER_LANE]) {
    u_row(L, S, r, c0, lane, g, mask, fcol);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      g[j] = -__fmul_rn(__fmul_rn(div_by(g[j], us, rus, fast), lr), ps);
    store8(L.g, L, r, c0, lane, g, mask);
  });
}

}  // namespace

// K7 over n_leaves >= 1 leaves: table (device) holds their descriptors
// (n_leaves x 16 int64, ops/adafactor_kernel.py LEAF_FIELDS), then each
// leaf's first tile and its first block of pass 2 as int32. n_tiles: the
// tiles of passes 1, 3 and 4; n_fin: the blocks of pass 2. scratch: the
// float32 buffer the table's offsets point into, its head (2 n_tiles + 3
// n_leaves + 3 floats, the last two the uint32 counters) first. values
// (device): the step's decay, keep and lr as float32, read when the passes
// run. Sets the
// counters to 0 and launches the four passes (three with no factored leaf)
// on `stream`; returns a cudaError_t code (0 = launched).
extern "C" int lako_adafactor_update(const void* table, void* scratch, const void* values,
                                     int n_leaves, int n_tiles, int n_fin, float clip, float eps,
                                     float min_scale, void* stream) {
  static_assert(sizeof(Leaf) == 16 * 8, "Leaf is sixteen 64-bit words");
  static_assert(THREADS == TILE, "pass 1 takes a tile column a thread");
  if (n_leaves < 1 || n_tiles < 0 || n_fin < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const Step st{clip, eps, min_scale, static_cast<const float*>(values)};
  const auto* t = static_cast<const Leaf*>(table);
  auto* s = static_cast<float*>(scratch);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)n_tiles;
  cudaError_t err = cudaMemsetAsync(scratch_of(s, n_tiles, n_leaves).counters, 0,
                                    2 * sizeof(unsigned), cs);
  if (err != cudaSuccess) return (int)err;
  norms_kernel<<<grid, THREADS, 0, cs>>>(t, n_leaves, n_tiles, s, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_fin > 0) {
    factors_kernel<<<(unsigned)n_fin, THREADS, 0, cs>>>(t, n_leaves, n_tiles, s, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  block_rms_kernel<<<grid, THREADS, 0, cs>>>(t, n_leaves, n_tiles, s, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_kernel<<<grid, THREADS, 0, cs>>>(t, n_leaves, n_tiles, s, st);
  return (int)cudaGetLastError();
}
