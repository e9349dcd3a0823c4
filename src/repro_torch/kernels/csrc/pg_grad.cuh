// The primal effective gradient and capacity test of one allocation, shared
// by K1 (pg_round.cu: the one-round entry and the whole batched solve) and
// K2's admission round (masked_argmax.cu), so the kernels evaluate one
// formula and cannot drift apart.
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
//
// Any m. The per-pool terms (p, c, lim = (c - o) + 1e-9, ratio = o / c) live
// in shared memory, pg_terms_floats(m) floats a pool, filled once per pool
// and state by pg_pool_fill and read by every lane; the sums loop over k in
// order, so m has no bound and the fold order is the plain formula's.

#pragma once

#include <math.h>

// The terms of one pool, in shared memory, and the pool-wide scalars.
struct PgPool {
  const float* p;
  const float* c;
  const float* lim;
  const float* ratio;
  float o_norm, sqrt_m;
  bool any_occ;
  int m;
};

// floats of shared memory one pool's terms take
__host__ __device__ __forceinline__ int pg_terms_floats(int m) {
  return 4 * m;
}

// The terms of term k: the capacity limit and the occupancy ratio are the
// only ones that move with the occupancy, so an admission rewrites just
// these two per resource (pg_term_update).
__device__ __forceinline__ void pg_term_update(float* s, int m, int k,
                                               float c, float o) {
  s[2 * m + k] = __fadd_rn(__fsub_rn(c, o), 1e-9f);
  s[3 * m + k] = __fdiv_rn(o, c);
}

// Fill the terms of the pool (price, cap, occ) into s (pg_terms_floats(m)
// floats), k strided by the threads [tid, ...) of stride nthr; the caller
// synchronizes before any thread reads them (pg_pool_view, pg_lane).
__device__ __forceinline__ void pg_pool_fill(float* s, const float* price,
                                             const float* cap,
                                             const float* occ, int m,
                                             int tid, int nthr) {
  for (int k = tid; k < m; k += nthr) {
    const float c = cap[k];
    s[k] = price[k];
    s[m + k] = c;
    pg_term_update(s, m, k, c, occ[k]);
  }
}

// The pool over filled terms s; occ (global or shared) gives ||o||_2 and
// any(o > 0), each thread folding the m terms itself in order.
__device__ __forceinline__ PgPool pg_pool_view(const float* s,
                                               const float* occ, int m) {
  PgPool P;
  P.p = s;
  P.c = s + m;
  P.lim = s + 2 * m;
  P.ratio = s + 3 * m;
  P.m = m;
  bool any = false;
  float osum = 0.0f;
  for (int k = 0; k < m; ++k) {
    const float o = occ[k];
    any = any || (o > 0.0f);
    osum = __fadd_rn(osum, __fmul_rn(o, o));
  }
  P.o_norm = __fsqrt_rn(osum);
  P.sqrt_m = __fsqrt_rn(static_cast<float>(m));
  P.any_occ = any;
  return P;
}

// The occupancy-free half of a lane's PG: value = sum_k p_k (c_k - g_k) and
// norm_use = sum_k g_k / c_k, fixed for a pool's whole solve (a solve that
// rescores a lane after every admission keeps them).
__device__ __forceinline__ void pg_lane_fixed(const PgPool& s,
                                              const float* __restrict__ g,
                                              float* value, float* norm_use) {
  float v = 0.0f, n = 0.0f;
#pragma unroll 4
  for (int k = 0; k < s.m; ++k) {
    const float gk = g[k];
    v = __fadd_rn(v, __fmul_rn(s.p[k], __fsub_rn(s.c[k], gk)));
    n = __fadd_rn(n, __fdiv_rn(gk, s.c[k]));
  }
  *value = v;
  *norm_use = n;
}

// The occupancy half: the capacity test (*ok), weighted = sum_k g_k
// (o_k / c_k), and PG from the fixed half. Each sum folds in the same
// order as in one pass, so the split changes no bit.
__device__ __forceinline__ float pg_lane_occ(const PgPool& s,
                                             const float* __restrict__ g,
                                             float value, float norm_use,
                                             bool* ok) {
  bool fits = true;
  float weighted = 0.0f;
#pragma unroll 4
  for (int k = 0; k < s.m; ++k) {
    const float gk = g[k];
    fits = fits && (gk <= s.lim[k]);
    weighted = __fadd_rn(weighted, __fmul_rn(gk, s.ratio[k]));
  }
  *ok = fits;
  return s.any_occ
      ? __fdiv_rn(__fmul_rn(value, s.o_norm), fmaxf(weighted, 1e-9f))
      : __fdiv_rn(__fmul_rn(value, s.sqrt_m), fmaxf(norm_use, 1e-9f));
}

// PG of the allocation whose m amounts start at g; *ok is its capacity test.
__device__ __forceinline__ float pg_lane(const PgPool& s,
                                         const float* __restrict__ g,
                                         bool* ok) {
  float value, norm_use;
  pg_lane_fixed(s, g, &value, &norm_use);
  return pg_lane_occ(s, g, value, norm_use, ok);
}
