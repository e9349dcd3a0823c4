// The primal effective gradient and capacity test of one allocation, shared
// by K1 (pg_round.cu) and K2's admission round (masked_argmax.cu), so the two
// kernels evaluate one formula and cannot drift apart.
//
// The formula is repro_torch/core/greedy.py::_batch_pg, operation for
// operation, in float32:
//   value    = sum_k p_k (c_k - g_k)
//   uniform  = value * sqrt(m)    / max(sum_k g_k / c_k, 1e-9)
//   occupied = value * ||o||_2    / max(sum_k g_k (o_k / c_k), 1e-9)
//   PG       = any(o > 0) ? occupied : uniform
//   cap_ok   = all_k g_k <= (c_k - o_k) + 1e-9
// Every operation is the correctly rounded intrinsic; each m-term sum folds
// left to right from +0 (as the reference's eager reduce does) and square
// roots round correctly. The libraries are built with --fmad=false and the
// formula has no FMA, so PG is bit-identical to the plain PyTorch version.
#pragma once

#include <math.h>

constexpr int kPgMaxM = 8;

// The per-pool terms of the formula: computed once per (thread, round) from
// the pool's price, capacity and occupancy, then reused for every lane.
struct PgPool {
  float p[kPgMaxM], c[kPgMaxM], lim[kPgMaxM], ratio[kPgMaxM];
  float o_norm, sqrt_m;
  bool any_occ;
  int m;
};

__device__ __forceinline__ PgPool pg_pool(const float* __restrict__ price,
                                          const float* __restrict__ cap,
                                          const float* occ, int m) {
  PgPool s;
  s.m = m;
  s.any_occ = false;
  float osum = 0.0f;
#pragma unroll
  for (int k = 0; k < kPgMaxM; ++k) {
    if (k < m) {
      s.p[k] = price[k];
      s.c[k] = cap[k];
      const float o = occ[k];
      s.lim[k] = __fadd_rn(__fsub_rn(s.c[k], o), 1e-9f);
      s.ratio[k] = __fdiv_rn(o, s.c[k]);
      s.any_occ = s.any_occ || (o > 0.0f);
      osum = __fadd_rn(osum, __fmul_rn(o, o));
    }
  }
  s.o_norm = __fsqrt_rn(osum);
  s.sqrt_m = __fsqrt_rn(static_cast<float>(m));
  return s;
}

// PG of the allocation whose m amounts start at g; *ok is its capacity test.
__device__ __forceinline__ float pg_lane(const PgPool& s,
                                         const float* __restrict__ g,
                                         bool* ok) {
  bool fits = true;
  float value = 0.0f, norm_use = 0.0f, weighted = 0.0f;
#pragma unroll
  for (int k = 0; k < kPgMaxM; ++k) {
    if (k < s.m) {
      const float gk = g[k];
      fits = fits && (gk <= s.lim[k]);
      value = __fadd_rn(value, __fmul_rn(s.p[k], __fsub_rn(s.c[k], gk)));
      norm_use = __fadd_rn(norm_use, __fdiv_rn(gk, s.c[k]));
      weighted = __fadd_rn(weighted, __fmul_rn(gk, s.ratio[k]));
    }
  }
  *ok = fits;
  return s.any_occ
      ? __fdiv_rn(__fmul_rn(value, s.o_norm), fmaxf(weighted, 1e-9f))
      : __fdiv_rn(__fmul_rn(value, s.sqrt_m), fmaxf(norm_use, 1e-9f));
}
