// K1: one fused flexible admission round of the batched SF-ESP greedy.
//
// Replaces src/repro/kernels/pg/pg.py::batch_round (Pallas body
// _round_kernel). Per instance b it computes, over the bit-packed (T, W)
// latency-feasibility words and the per-round alive mask:
//   cap_ok[a] = all_k grid[a,k] <= (cap_k - occ_k) + 1e-9
//   PG[a]     = primal gradient (greedy.primal_gradient, uniform branch when
//               nothing is occupied, occupancy branch otherwise, eps 1e-9)
//   V         = max PG[a] over cap_ok lanes lat-feasible for an alive task
//   tau       = first alive task whose row attains V
//   best_a    = tau's first lane attaining V
// and V = -inf, tau = 0, best_a = 0 when nothing is feasible.
//
// Design. The Pallas kernel carries (V, tau, a) across T-blocks in its output
// block and relies on the TPU running the grid in order. Hopper runs blocks in
// parallel, so here ONE block owns one instance and loops over all of its
// (task, word) pairs: PG and cap_ok are computed once per lane into shared
// memory (A floats, 1.2 KB at A = 300), each thread scans its words' set bits
// in (task, lane) order, and the block reduces the candidates with the
// lexicographic order (max V, then min tau, then min lane) — the sequential
// first-max tie-break, made explicit. Lanes >= A are never read, so a padded
// lane can never be selected whatever its bits say.
//
// Arithmetic. The library is built with --fmad=false and every operation is
// the correctly rounded intrinsic, in the plain formula's order: each m-term
// sum folds left to right from +0 (as the reference's eager reduce does) and
// square roots round correctly, so PG is bit-identical to the plain PyTorch
// version (repro_torch/core/greedy.py::_batch_pg). There is no FMA in that
// formula.
//
// Bound. One round moves the packed words, B*T*W*4 bytes (0.33 MB at
// B = 256, T = 32, W = 10), plus O(B*m) pool state: 0.1 us of HBM time on an
// H100, far below one launch. The kernel is bound by launch latency; the
// solve's cost is rounds x launches, which a persistent loop or CUDA graphs
// attack, not this kernel.

#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;

__device__ __forceinline__ bool better(float v1, int t1, int a1, float v2,
                                       int t2, int a2) {
  return v1 > v2 || (v1 == v2 && (t1 < t2 || (t1 == t2 && a1 < a2)));
}

__global__ void __launch_bounds__(kThreads)
pg_round_kernel(const uint32_t* __restrict__ bits,
                const uint8_t* __restrict__ alive,
                const float* __restrict__ grid,   // (A, m)
                const float* __restrict__ price,  // (B, m)
                const float* __restrict__ cap,    // (B, m)
                const float* __restrict__ occ,    // (B, m)
                int T, int W, int A, int m,
                float* __restrict__ v_out, int* __restrict__ tau_out,
                int* __restrict__ a_out) {
  extern __shared__ float s_score[];  // (A,) PG where cap_ok, else -inf
  __shared__ float s_v[kThreads / 32];
  __shared__ int s_t[kThreads / 32];
  __shared__ int s_a[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  float p[kMaxM], c[kMaxM], lim[kMaxM], ratio[kMaxM];
  bool any_occ = false;
  float osum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxM; ++k) {
    if (k < m) {
      p[k] = price[b * m + k];
      c[k] = cap[b * m + k];
      const float o = occ[b * m + k];
      lim[k] = __fadd_rn(__fsub_rn(c[k], o), 1e-9f);
      ratio[k] = __fdiv_rn(o, c[k]);
      any_occ = any_occ || (o > 0.0f);
      const float sq = __fmul_rn(o, o);
      osum = __fadd_rn(osum, sq);
    }
  }
  const float o_norm = __fsqrt_rn(osum);
  const float sqrt_m = __fsqrt_rn(static_cast<float>(m));

  for (int a = tid; a < A; a += kThreads) {
    const float* g = grid + static_cast<int64_t>(a) * m;
    bool ok = true;
    float value = 0.0f, norm_use = 0.0f, weighted = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxM; ++k) {
      if (k < m) {
        const float gk = g[k];
        ok = ok && (gk <= lim[k]);
        const float d = __fmul_rn(p[k], __fsub_rn(c[k], gk));
        const float u = __fdiv_rn(gk, c[k]);
        const float wv = __fmul_rn(gk, ratio[k]);
        value = __fadd_rn(value, d);
        norm_use = __fadd_rn(norm_use, u);
        weighted = __fadd_rn(weighted, wv);
      }
    }
    const float pg = any_occ
        ? __fdiv_rn(__fmul_rn(value, o_norm), fmaxf(weighted, 1e-9f))
        : __fdiv_rn(__fmul_rn(value, sqrt_m), fmaxf(norm_use, 1e-9f));
    s_score[a] = ok ? pg : -INFINITY;
  }
  __syncthreads();

  float bv = -INFINITY;
  int bt = INT_MAX, ba = INT_MAX;
  const int pairs = T * W;
  const uint32_t* row_bits = bits + static_cast<int64_t>(b) * pairs;
  const uint8_t* row_alive = alive + static_cast<int64_t>(b) * T;
  for (int q = tid; q < pairs; q += kThreads) {
    const int t = q / W;
    if (!row_alive[t]) continue;
    const int w = q - t * W;
    uint32_t word = row_bits[q];
    while (word) {
      const int k = __ffs(word) - 1;
      word &= word - 1;
      const int a = w * 32 + k;
      if (a >= A) break;
      const float s = s_score[a];
      if (s > -INFINITY && better(s, t, a, bv, bt, ba)) {
        bv = s; bt = t; ba = a;
      }
    }
  }

  // block reduction under the same lexicographic order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int ot = __shfl_down_sync(0xffffffffu, bt, off);
    const int oa = __shfl_down_sync(0xffffffffu, ba, off);
    if (better(ov, ot, oa, bv, bt, ba)) { bv = ov; bt = ot; ba = oa; }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) { s_v[warp] = bv; s_t[warp] = bt; s_a[warp] = ba; }
  __syncthreads();
  if (warp == 0) {
    constexpr int nw = kThreads / 32;
    bv = lane < nw ? s_v[lane] : -INFINITY;
    bt = lane < nw ? s_t[lane] : INT_MAX;
    ba = lane < nw ? s_a[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int ot = __shfl_down_sync(0xffffffffu, bt, off);
      const int oa = __shfl_down_sync(0xffffffffu, ba, off);
      if (better(ov, ot, oa, bv, bt, ba)) { bv = ov; bt = ot; ba = oa; }
    }
    if (lane == 0) {
      const bool found = bv > -INFINITY;
      v_out[b] = found ? bv : -INFINITY;
      tau_out[b] = found ? bt : 0;
      a_out[b] = found ? ba : 0;
    }
  }
}

}  // namespace

extern "C" int pg_round_launch(const void* bits, const void* alive,
                               const void* grid, const void* price,
                               const void* cap, const void* occ, int B,
                               int T, int W, int A, int m, void* v_out,
                               void* tau_out, void* a_out, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(A) * sizeof(float);
  pg_round_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(grid), static_cast<const float*>(price),
      static_cast<const float*>(cap), static_cast<const float*>(occ), T, W, A,
      m, static_cast<float*>(v_out), static_cast<int*>(tau_out),
      static_cast<int*>(a_out));
  return repro_last_error();
}
