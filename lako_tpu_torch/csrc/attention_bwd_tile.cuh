// The attention backward's tile step on the tensor cores, for one warp: 16
// query rows of one (b, h) against 8*KT keys, all operands row-major bf16 in
// shared memory with one row pitch. S = Q.K^T and dP = dO.V^T are both X.Y^T,
// so both take X's rows as the A operand and Y's rows as the col-major B
// operand of mma.sync m16n8k16 (ldmatrix, no transposes), f32 accumulators.
// P and dS are then formed in the C fragments: thread (g = lane / 4,
// t = lane % 4) holds rows g (e = 0, 1) and g + 8 (e = 2, 3) of each key
// tile j at keys 8 j + 2 t + (e & 1).
#pragma once

#include "common.cuh"

namespace lako {

// s = Q.K^T, dp = dO.V^T over D for the warp's 16 rows (qw, dow: their first
// row) and key tiles [0, n_tiles) at kw, vw (their first key row); tiles at
// or past n_tiles are left at 0. Sums over d run in 16-deep steps from d = 0,
// as K1's forward sums S.
template <int D, int KT>
__device__ __forceinline__ void warp_s_dp(const __nv_bfloat16* qw, const __nv_bfloat16* dow,
                                          const __nv_bfloat16* kw, const __nv_bfloat16* vw,
                                          int pitch, int n_tiles, float (&s)[KT][4],
                                          float (&dp)[KT][4]) {
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 32) {
    uint32_t qa[4], qb[4], oa[4], ob[4];
    load_a_x2(qa, qb, qw, pitch, c0);
    load_a_x2(oa, ob, dow, pitch, c0);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < n_tiles) {
        uint32_t bk[4], bv[4];
        load_b_rows(bk, kw, pitch, j * 8, c0);
        load_b_rows(bv, vw, pitch, j * 8, c0);
        mma_bf16(s[j], qa, bk[0], bk[1]);
        mma_bf16(s[j], qb, bk[2], bk[3]);
        mma_bf16(dp[j], oa, bv[0], bv[1]);
        mma_bf16(dp[j], ob, bv[2], bv[3]);
      }
    }
  }
}

// One row's values from the forward and the wrapper: the row max m and row
// sum l of exp(S - m), and Dv = rowsum(dO * O); inv_l = __frcp_rn(l).
struct RowTerms {
  float m, l, inv_l, dv;
};

// P = exp(S - m) / l and dS = P (dP - Dv) in place of s and dp, from
// s = q.k and dp = dO.v. Bit 2 j + (e & 1) of `in_keys` says the key lies
// before Lk, of `live_keys` that it is also unmasked; in0/in1: the rows lie
// before L. A masked key has S = -1e9 (its P is 1/Lk on a fully masked row,
// where (m, l) = (-1e9, Lk)) and dS = 0; P and dS are 0 outside L x Lk.
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
      const RowTerms& r = row[e >> 1];
      const bool live = (live_keys >> bit) & 1u;
      float p = 0.f, ds = 0.f;
      if (((in_keys >> bit) & 1u) && (e < 2 ? in0 : in1)) {
        p = div_rn(expf((live ? s[j][e] + rel[j][e] : kNegInf) - r.m), r.l, r.inv_l);
        ds = live ? p * (dp[j][e] - r.dv) : 0.f;
      }
      s[j][e] = p;
      dp[j][e] = ds;
    }
}

}  // namespace lako
