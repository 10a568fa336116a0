// The attention backward's tile step on the tensor cores, for one warp: 16
// rows of X against 8*KT rows of Y of one (b, h), operands row-major bf16
// in shared memory with one row pitch. S = Q.K^T and dP = dO.V^T are both
// X.Y^T, so both take X's rows as the A operand and Y's rows as the col-major
// B operand of mma.sync m16n8k16 (ldmatrix, no transposes), f32
// accumulators. Either side may be the queries: K2c puts 16 query rows on X
// (S, dP), K2a 16 keys (S^T = K.Q^T, dP^T = V.dO^T). P and dS are then
// formed in the C fragments: thread (g = lane / 4, t = lane % 4) holds X rows
// g (e = 0, 1) and g + 8 (e = 2, 3) of each Y tile j at Y rows
// 8 j + 2 t + (e & 1).
#pragma once

#include "common.cuh"

namespace lako {

// s = X1.Y1^T, dp = X2.Y2^T over D for X's 16 rows (x1, x2: their first
// row) and Y tiles [0, n_tiles) at y1, y2 (their first row); tiles at or past
// n_tiles are left at 0. Sums over d run in 16-deep steps from d = 0, as K1's
// forward sums S.
template <int D, int KT>
__device__ __forceinline__ void warp_s_dp(const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                          const __nv_bfloat16* y1, const __nv_bfloat16* y2,
                                          int pitch, int n_tiles, float (&s)[KT][4],
                                          float (&dp)[KT][4]) {
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 32) {
    uint32_t x1a[4], x1b[4], x2a[4], x2b[4];
    load_a_x2(x1a, x1b, x1, pitch, c0);
    load_a_x2(x2a, x2b, x2, pitch, c0);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < n_tiles) {
        uint32_t b1[4], b2[4];
        load_b_rows(b1, y1, pitch, j * 8, c0);
        load_b_rows(b2, y2, pitch, j * 8, c0);
        mma_bf16(s[j], x1a, b1[0], b1[1]);
        mma_bf16(s[j], x1b, b1[2], b1[3]);
        mma_bf16(dp[j], x2a, b2[0], b2[1]);
        mma_bf16(dp[j], x2b, b2[2], b2[3]);
      }
    }
  }
}

// One query row's values from the forward and the wrapper: the row max m and
// row sum l of exp(S - m), and Dv = rowsum(dO * O); inv_l = __frcp_rn(l).
struct RowTerms {
  float m, l, inv_l, dv;
};

// P = exp(S - m) / l and dS = P (dP - Dv) of one element from s = q.k, dp =
// dO.v and its bias; a masked key (!live) has S = -1e9 (its P is 1/Lk on a
// fully masked row, where (m, l) = (-1e9, Lk)) and dS = 0.
__device__ __forceinline__ void p_ds(float& s, float& dp, float rel, bool live,
                                     const RowTerms& r) {
  const float p = div_rn(expf((live ? s + rel : kNegInf) - r.m), r.l, r.inv_l);
  dp = live ? p * (dp - r.dv) : 0.f;
  s = p;
}

// P and dS in place of s and dp with the query rows on X (K2c): the row
// terms vary along the C rows, the key mask along the columns. Bit
// 2 j + (e & 1) of `in_keys` says the key lies before Lk, of `live_keys` that
// it is also unmasked; in0/in1: the rows lie before L. P and dS are 0 outside
// L x Lk.
template <int KT>
__device__ __forceinline__ void warp_p_ds(float (&s)[KT][4], float (&dp)[KT][4],
                                          const float (&rel)[KT][4], uint32_t in_keys,
                                          uint32_t live_keys, const RowTerms (&row)[2],
                                          bool in0, bool in1) {
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 2 * j + (e & 1);
      if (((in_keys >> bit) & 1u) && (e < 2 ? in0 : in1)) {
        p_ds(s[j][e], dp[j][e], rel[j][e], (live_keys >> bit) & 1u, row[e >> 1]);
      } else {
        s[j][e] = dp[j][e] = 0.f;
      }
    }
}

// The column-terms twin, with the keys on X (K2a): P^T and dS^T in place of
// s = k.q and dp = v.dO. col[j][c] holds the terms of query row (column)
// 8 j + 2 t + c, and bit 2 j + c of `in_rows` says it lies before L; the key
// mask varies along the C rows: in0/in1 say keys g and g + 8 lie before Lk,
// live0/live1 that they are also unmasked.
template <int KT>
__device__ __forceinline__ void warp_p_ds_cols(float (&s)[KT][4], float (&dp)[KT][4],
                                               const float (&rel)[KT][4], uint32_t in_rows,
                                               const RowTerms (&col)[KT][2], bool in0,
                                               bool in1, bool live0, bool live1) {
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (((in_rows >> (2 * j + (e & 1))) & 1u) && (e < 2 ? in0 : in1)) {
        p_ds(s[j][e], dp[j][e], rel[j][e], e < 2 ? live0 : live1, col[j][e & 1]);
      } else {
        s[j][e] = dp[j][e] = 0.f;
      }
    }
}

}  // namespace lako
