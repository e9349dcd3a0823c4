// K4', CUDA-core route: the gradient of K4 (causal or non-causal GQA flash
// attention) for the training backward: dQ, dK and dV from q, k, v, the
// forward's output o, its log-sum-exp and the incoming gradient dO. It
// takes float32, bf16 with Dh % 8 != 0, and bf16 at Dh 257-512: what the
// tensor-core route (flash_attn_bwd_tc.cu: bf16, Dh % 8 == 0, Dh <= 256)
// does not, up to Dh 512.
//
// Replaces the reference's gradient of its training attention, which is the
// recompute VJP of the jnp chunked flash attention
// (src/repro/models/attention.py:79-174: jax.checkpoint on kv_step and
// q_block, so P is recomputed from q and k in the backward). The Pallas K4
// (src/repro/kernels/attn/attn.py::flash_attention_fwd) has no VJP; this is
// the gradient of K4's own function: q scaled by Dh^-0.5 in f32, masked
// scores NEG = -1e30 (kpos <= qpos when causal, no offset), query head h on
// KV head h / G. With P = exp(S - lse), lse the forward's log-sum-exp (the
// CUDA-core K4 in flash_attn.cu writes it, as the tensor-core K4 does),
//
//   D = rowsum(dO o o),  dV = P^T dO,  dS = P o (dO V^T - D),
//   dQ = scale dS K,     dK = scale dS^T Q,
//
// dK and dV summed over the G query heads of each KV head. All arithmetic
// is f32 on the CUDA cores (inputs f32 or bf16, widened when staged;
// outputs in the inputs' type), every multiply-add an explicit __fmaf_rn
// (the library is built with --fmad=false).
//
// Passes, each a launch, no atomics (a repeat is bit for bit), as the
// tensor-core route's:
//   0 dQ with D: one block per (b, KV head, query tile), the tile's rows the
//     KV head's G query heads flattened head-major (R = g Tq + t), as K4's.
//     D = rowsum(dO o o) of its rows first, from o staged beside Q and dO
//     (written for pass 1), then over
//     the key tiles it can see (causal: to the diagonal): S and dP = dO V^T
//     in registers, P = exp(S - lse), dS into shared memory over the tile's
//     V (read by then), dQ += dS K.
//   1 dK/dV: one block per (b, KV head, key tile, group of G / groups query
//     heads), groups = bwd_groups(G) <= 4: over the group's heads and the
//     query tiles that see the key tile (causal: from the diagonal down),
//     S^T and dP^T in registers, P^T then dS^T through one shared tile,
//     dV += P^T dO, dK += dS^T Q; the group's sums into f32 partials
//     (groups, B, Tk, Hkv, Dh).
//   2 reduce: dK, dV = the sum of the groups' partials in order, cast to the
//     inputs' type.
//
// Bound. At chatglm3-6b's training shape (B = 2, T = 2048, 32 query heads
// over 2 KV heads, Dh = 128, causal) the function is 2.5x the forward's
// operations (two products of the forward, five of the gradient): 172 GFLOP,
// 2.57 ms at the 67 TFLOP/s of f32 FMAs; the bytes (q, k, v, o, dO read,
// dq, dk, dv written, bf16) are 88 MB, 26 us. Operations bound it; this
// design recomputes S and dP in both product passes (14 Dh flops a visible
// (query, key) pair against the function's 10 Dh: a 3.59 ms floor). Its
// means against that bound are K4's (flash_attn.cu): a cp.async ring of
// K/V tiles (dQ) or Q/dO tiles (dK/dV) under the products, register
// micro-tiles of 4 x 4 scores and dP, 4 x 8 outputs at Dh 128, and no S
// or dP round trip through shared memory: only dS (dQ pass) and P^T, dS^T
// (dK/dV pass), which the products read across threads.
//
// Tiles (BQ query rows x BK keys, 256 threads) and dynamic shared memory
// (dQ pass, dK/dV pass):
//   Dh <=  64: 64 x 64, 2 and 3 stages, 102 and 152 KB;
//   Dh <= 128: 64 x 64, 2 stages, 198 and 214 KB;
//   Dh <= 256: 32 x 32, 2 stages, 195 and 199 KB;
//   Dh <= 512: 16 x 16, 2 stages, 193.5 and 194.5 KB.

#include "common.cuh"
#include "flash_core.cuh"

namespace {

using namespace fcore;

template <int DH>
struct Cfg;
// (rows a thread, keys a thread, K/V stages of the dQ pass, Q/dO stages of
// the dK/dV pass, dQ blocks an SM): at Dh <= 64 the dQ pass fits two
// blocks an SM (102 KB, 128 registers), whose prologues and barriers
// then overlap each other's products
#define REPRO_CFG(DH, TR_, TK_, SQ_, SK_, MB_)                              \
  template <>                                                             \
  struct Cfg<DH> {                                                        \
    static constexpr int TR = TR_, TK = TK_, SQ = SQ_, SK = SK_, MB = MB_; \
  };
REPRO_CFG(64, 4, 4, 2, 3, 2)
REPRO_CFG(128, 4, 4, 2, 2, 1)
REPRO_CFG(256, 2, 2, 2, 2, 1)
REPRO_CFG(512, 1, 1, 2, 2, 1)
#undef REPRO_CFG

template <int DH>
struct Tile {
  static constexpr int TR = Cfg<DH>::TR;   // query rows a thread
  static constexpr int TK = Cfg<DH>::TK;   // keys a thread
  static constexpr int SQ = Cfg<DH>::SQ;   // stages of the dQ pass's ring
  static constexpr int SK = Cfg<DH>::SK;   // stages of the dK/dV pass's
  static constexpr int MB = Cfg<DH>::MB;   // dQ blocks an SM
  static constexpr int BQ = 16 * TR, BK = 16 * TK;
  static constexpr int LD = DH + 4;        // Q, dO, K, V rows (floats)
  static constexpr int CV = DH / 64;       // float4 output columns a thread
  static constexpr int kQ = BQ * LD;       // one Q or dO tile
  static constexpr int kK = BK * LD;       // one K or V tile
  static_assert(BQ <= LD, "dS (BQ x BK) fits a V tile");
  static_assert(BQ <= BK && TR <= 16, "O (BQ x Dh) fits a K tile");
  static constexpr int kDqBytes = (2 * kQ + SQ * 2 * kK) * 4;
  static constexpr int kDkdvBytes = (2 * kK + SK * 2 * kQ + BK * BQ) * 4;
};

struct Geometry {
  int B, Tq, Tk, Hq, Hkv, dh, groups;
  float scale;
  int causal, vec;
};

// x += A B^T over the head, A's rows rg + 16 i and B's rows cg + 16 c, a
// float4 of columns at a time in order
template <int TR, int TK, int LD>
__device__ __forceinline__ void product(const float* A, const float* B,
                                        float (&x)[TR][TK], int rg, int cg,
                                        int dpad) {
#pragma unroll 1
  for (int d = 0; d < dpad; d += 4) {
    float4 av[TR], bv[TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(rg + 16 * i) * LD + d]);
#pragma unroll
    for (int c = 0; c < TK; ++c)
      bv[c] = *reinterpret_cast<const float4*>(&B[(cg + 16 * c) * LD + d]);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c) x[i][c] = dot4(av[i], bv[c], x[i][c]);
  }
}

// ---------------------------------------------------------------- pass 0
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, Tile<DH>::MB)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, Geometry g) {
  using L = Tile<DH>;
  constexpr int TR = L::TR, TK = L::TK, ST = L::SQ, BQ = L::BQ, BK = L::BK;
  constexpr int LD = L::LD, CV = L::CV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + L::kQ;                   // dO
  float* KV = Os + L::kQ;                   // stage s: K, then V

  const int G = g.Hq / g.Hkv;
  const int total = G * g.Tq;
  const int n_tiles = (total + BQ - 1) / BQ;
  const int x = blockIdx.x / (g.Hkv * g.B);
  const int rest = blockIdx.x % (g.Hkv * g.B);
  const int hk = rest % g.Hkv, b = rest / g.Hkv;
  const int r0 = packed_tile(x, n_tiles, BQ, g.Tq, G, g.causal) * BQ;
  const int r_last = min(r0 + BQ, total) - 1;
  const int t_hi = r0 / g.Tq == r_last / g.Tq ? r_last % g.Tq : g.Tq - 1;
  const int k_end = g.causal ? min(g.Tk, t_hi + 1) : g.Tk;
  const int n_kv = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;

  const int64_t q_row = static_cast<int64_t>(g.Hq) * g.dh;
  const int64_t kv_row = static_cast<int64_t>(g.Hkv) * g.dh;
  const int64_t q_b = static_cast<int64_t>(b) * g.Tq * q_row;
  const int64_t kv_base = static_cast<int64_t>(b) * g.Tk * kv_row
                          + static_cast<int64_t>(hk) * g.dh;

  auto issue = [&](int j) {
    if (j < n_kv) {
      float* Ks = KV + (j % ST) * 2 * L::kK;
      const SeqRows rows{kv_base, kv_row, j * BK, g.Tk};
      stage<DH>(Ks, LD, BK, k, rows, g.dh, g.vec);
      stage<DH>(Ks + L::kK, LD, BK, v, rows, g.dh, g.vec);
    }
    cp_async_commit();
  };

  // Q, dO and, for D, o (in the K tile of the ring's last stage, which
  // the prologue leaves free until the first tile's top barrier)
  float* Ob = KV + (ST - 1) * 2 * L::kK;
  const PackedRows rows{q_b, q_row, r0, total, g.Tq, hk * G, g.dh};
  stage<DH>(Qs, LD, BQ, q, rows, g.dh, g.vec);
  stage<DH>(Os, LD, BQ, dout, rows, g.dh, g.vec);
  stage<DH>(Ob, LD, BQ, o, rows, g.dh, g.vec);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) issue(j);

  // this thread's rows: position, LSE and D = rowsum(dO o o), summed as
  // the products below sum dP = dO V^T, a float4 of columns at a time in
  // order (so a row whose P is one-hot, o then a row of V, gets dP - D = 0
  // exactly, as the plain version does): the thread of column group i
  // sums row rg + 16 i, and the row group's 16 threads share it
  int t_of[TR];
  bool live[TR];
  float lse_of[TR], d_of[TR];
  float acc[TR][CV][4];
  const int dpad = (g.dh + 3) & ~3;
  cp_async_wait<ST - 1>();   // Q, dO and o have landed
  __syncthreads();
  float dd = 0.f;
  if (cg < TR && r0 + rg + 16 * cg < total) {
    const float* a = Os + (rg + 16 * cg) * LD;
    const float* c = Ob + (rg + 16 * cg) * LD;
    for (int d = 0; d < dpad; d += 4)
      dd = dot4(*reinterpret_cast<const float4*>(a + d),
                *reinterpret_cast<const float4*>(c + d), dd);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int R = r0 + rg + 16 * i;
    live[i] = R < total;
    const int gq = live[i] ? R / g.Tq : 0;
    t_of[i] = live[i] ? R - gq * g.Tq : g.Tq - 1;
    const int64_t r_at = (static_cast<int64_t>(b) * g.Hq + hk * G + gq)
                         * g.Tq + t_of[i];
    d_of[i] = __shfl_sync(0xffffffffu, dd, (tid & 16) | i);
    lse_of[i] = live[i] ? lse[r_at] : 0.f;
    if (live[i] && cg == i) delta[r_at] = dd;
#pragma unroll
    for (int c = 0; c < CV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  scale_tile<DH>(Qs, LD, BQ, g.scale);

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    issue(j + ST - 1);
    const float* Ks = KV + (j % ST) * 2 * L::kK;
    float* Vs = KV + (j % ST) * 2 * L::kK + L::kK;
    const int k0 = j * BK;

    // S = (q scale) K^T and dP = dO V^T
    float s[TR][TK], dp[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c) s[i][c] = dp[i][c] = 0.f;
    // one loop over the head for both products; with two blocks an SM
    // (128 registers) one loop each, half the operands live
    if constexpr (L::MB > 1) {
      product<TR, TK, LD>(Qs, Ks, s, rg, cg, dpad);
      product<TR, TK, LD>(Os, Vs, dp, rg, cg, dpad);
    } else {
#pragma unroll 1
      for (int d = 0; d < dpad; d += 4) {
        float4 qv[TR], ov[TR], kv[TK], vv[TK];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg + 16 * i) * LD + d]);
          ov[i] = *reinterpret_cast<const float4*>(&Os[(rg + 16 * i) * LD + d]);
        }
#pragma unroll
        for (int c = 0; c < TK; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(&Ks[(cg + 16 * c) * LD + d]);
          vv[c] = *reinterpret_cast<const float4*>(&Vs[(cg + 16 * c) * LD + d]);
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int c = 0; c < TK; ++c) {
            s[i][c] = dot4(qv[i], kv[c], s[i][c]);
            dp[i][c] = dot4(ov[i], vv[c], dp[i][c]);
          }
      }
    }
    // dS = P o (dP - D), over this tile's V once its readers are done
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        const int kpos = k0 + cg + 16 * c;
        const bool ok = live[i] && kpos < g.Tk
                        && (!g.causal || kpos <= t_of[i]);
        const float p = ok ? expf(s[i][c] - lse_of[i]) : 0.f;
        s[i][c] = p * (dp[i][c] - d_of[i]);
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c)
        Vs[swz<BK>(rg + 16 * i, cg + 16 * c)] = s[i][c];
    __syncthreads();
    // dQ += dS K
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 sv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&Vs[swz<BK>(rg + 16 * i, c)]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int n = 0; n < CV; ++n) {
          if (CV > 2 && 64 * n >= g.dh) continue;   // columns past the head
          const float4 kk = *reinterpret_cast<const float4*>(
              &Ks[(c + cc) * LD + 4 * cg + 64 * n]);
#pragma unroll
          for (int i = 0; i < TR; ++i) axpy4(comp(sv[i], cc), kk, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (!live[i]) continue;
    const int64_t at = rows(rg + 16 * i);
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      float x4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x4[e] = acc[i][n][e] * g.scale;
      store4(dq, at, 4 * cg + 64 * n, g.dh, x4, g.vec);
    }
  }
}

// ---------------------------------------------------------------- pass 1
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk_part,
                float* __restrict__ dv_part, Geometry g) {
  using L = Tile<DH>;
  constexpr int TR = L::TR, TK = L::TK, ST = L::SK, BQ = L::BQ, BK = L::BK;
  constexpr int LD = L::LD, CV = L::CV;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kK;
  float* QO = Vs + L::kK;                   // stage s: Q, then dO
  float* X = QO + ST * 2 * L::kQ;           // P^T, then dS^T (BK x BQ)

  // block -> (b, KV head, group, key tile), key tile 0 (the most query
  // tiles when causal) first
  int x = blockIdx.x;
  const int b = x % g.B;
  x /= g.B;
  const int hk = x % g.Hkv;
  x /= g.Hkv;
  const int gr = x % g.groups, kt = x / g.groups;
  const int G = g.Hq / g.Hkv, per_group = G / g.groups;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;

  const int64_t q_row = static_cast<int64_t>(g.Hq) * g.dh;
  const int64_t kv_row = static_cast<int64_t>(g.Hkv) * g.dh;
  const int64_t q_b = static_cast<int64_t>(b) * g.Tq * q_row;
  const int64_t kv_base = static_cast<int64_t>(b) * g.Tk * kv_row
                          + static_cast<int64_t>(hk) * g.dh;
  const int h0 = hk * G + gr * per_group;   // the group's first query head

  // items: (head of the group, query tile from the diagonal down)
  const int n_qt = (g.Tq + BQ - 1) / BQ;
  const int qt0 = g.causal ? min(k0 / BQ, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_items = per_group * per_head;

  auto issue = [&](int it) {
    if (it < n_items) {
      float* Qi = QO + (it % ST) * 2 * L::kQ;
      const int hq = h0 + it / per_head;
      const int t0 = (qt0 + it % per_head) * BQ;
      const SeqRows rows{q_b + static_cast<int64_t>(hq) * g.dh, q_row, t0,
                         g.Tq};
      stage<DH>(Qi, LD, BQ, q, rows, g.dh, g.vec);
      stage<DH>(Qi + L::kQ, LD, BQ, dout, rows, g.dh, g.vec);
    }
    cp_async_commit();
  };

  const SeqRows krows{kv_base, kv_row, k0, g.Tk};
  stage<DH>(Ks, LD, BK, k, krows, g.dh, g.vec);
  stage<DH>(Vs, LD, BK, v, krows, g.dh, g.vec);
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) issue(it);

  float dk[TK][CV][4], dv[TK][CV][4];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;
  const int dpad = (g.dh + 3) & ~3;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    issue(it + ST - 1);
    const float* Qs = QO + (it % ST) * 2 * L::kQ;
    const float* Os = Qs + L::kQ;
    const int hq = h0 + it / per_head;
    const int t0 = (qt0 + it % per_head) * BQ;

    // this thread's query columns: LSE and D (pass 0's)
    float lse_of[TR], d_of[TR];
#pragma unroll
    for (int c = 0; c < TR; ++c) {
      const int t = t0 + cg + 16 * c;
      const int64_t r_at = (static_cast<int64_t>(b) * g.Hq + hq) * g.Tq + t;
      lse_of[c] = t < g.Tq ? lse[r_at] : 0.f;
      d_of[c] = t < g.Tq ? delta[r_at] : 0.f;
    }

    // S^T = K (q scale)^T and dP^T = V dO^T, (BK x BQ)
    float s[TK][TR], dp[TK][TR];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int c = 0; c < TR; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 1
    for (int d = 0; d < dpad; d += 4) {
      float4 kv[TK], vv[TK], qv[TR], ov[TR];
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(&Ks[(rg + 16 * i) * LD + d]);
        vv[i] = *reinterpret_cast<const float4*>(&Vs[(rg + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        qv[c] = *reinterpret_cast<const float4*>(&Qs[(cg + 16 * c) * LD + d]);
        ov[c] = *reinterpret_cast<const float4*>(&Os[(cg + 16 * c) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int c = 0; c < TR; ++c) {
          s[i][c] = dot4(kv[i], qv[c], s[i][c]);
          dp[i][c] = dot4(vv[i], ov[c], dp[i][c]);
        }
    }
    // P^T (into s) and dS^T (into dp)
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        const int kpos = k0 + rg + 16 * i, qpos = t0 + cg + 16 * c;
        const bool ok = qpos < g.Tq && kpos < g.Tk
                        && (!g.causal || kpos <= qpos);
        const float p = ok ? expf(s[i][c] * g.scale - lse_of[c]) : 0.f;
        s[i][c] = p;
        dp[i][c] = p * (dp[i][c] - d_of[c]);
      }

    // dV += P^T dO, then dK += dS^T Q (q unscaled: dK takes the scale
    // last), each through X
    auto product = [&](const float (&t)[TK][TR], const float* Y,
                       float (&out)[TK][CV][4]) {
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int c = 0; c < TR; ++c)
          X[swz<BQ>(rg + 16 * i, cg + 16 * c)] = t[i][c];
      __syncthreads();
#pragma unroll 1
      for (int c = 0; c < BQ; c += 4) {
        float4 xv[TK];
#pragma unroll
        for (int i = 0; i < TK; ++i)
          xv[i] = *reinterpret_cast<const float4*>(
              &X[swz<BQ>(rg + 16 * i, c)]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int n = 0; n < CV; ++n) {
            if (CV > 2 && 64 * n >= g.dh) continue;   // columns past the head
            const float4 yy = *reinterpret_cast<const float4*>(
                &Y[(c + cc) * LD + 4 * cg + 64 * n]);
#pragma unroll
            for (int i = 0; i < TK; ++i) axpy4(comp(xv[i], cc), yy, out[i][n]);
          }
        }
      }
    };
    product(s, Os, dv);
    __syncthreads();   // the dV product's reads of X are done
    product(dp, Qs, dk);
  }

  // the group's sums, f32 (groups, B, Tk, Hkv, Dh)
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kpos = k0 + rg + 16 * i;
    if (kpos >= g.Tk) continue;
    const int64_t at = (((static_cast<int64_t>(gr) * g.B + b) * g.Tk + kpos)
                        * g.Hkv + hk) * g.dh;
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      float x4[4], y4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x4[e] = dk[i][n][e] * g.scale;
        y4[e] = dv[i][n][e];
      }
      store4(dk_part, at, 4 * cg + 64 * n, g.dh, x4, g.vec);
      store4(dv_part, at, 4 * cg + 64 * n, g.dh, y4, g.vec);
    }
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part, T* __restrict__ dk,
                  T* __restrict__ dv, int64_t n, int groups) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    float a = dk_part[i], c = dv_part[i];
    for (int j = 1; j < groups; ++j) {
      a += dk_part[j * n + i];
      c += dv_part[j * n + i];
    }
    store(dk, i, a);
    store(dv, i, c);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float *delta, *dk_part, *dv_part;
};

template <typename T, int DH>
int launch(int pass, const Args& a, const Geometry& g, cudaStream_t stream) {
  using L = Tile<DH>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err = cudaSuccess;
  if (pass == 0) {
    auto kern = bwd_dq_kernel<T, DH>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t tiles = (static_cast<int64_t>(g.Hq / g.Hkv) * g.Tq
                           + L::BQ - 1) / L::BQ;
    const int64_t grid = tiles * g.Hkv * g.B;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    kern<<<static_cast<unsigned>(grid), kThreads, L::kDqBytes, stream>>>(
        q, k, v, o, dout, a.lse, a.delta, static_cast<T*>(a.dq), g);
  } else if (pass == 1) {
    auto kern = bwd_dkdv_kernel<T, DH>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkdvBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t grid = static_cast<int64_t>((g.Tk + L::BK - 1) / L::BK)
                         * g.groups * g.Hkv * g.B;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    kern<<<static_cast<unsigned>(grid), kThreads, L::kDkdvBytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.dk_part, a.dv_part, g);
  } else {
    const int64_t n = static_cast<int64_t>(g.B) * g.Tk * g.Hkv * g.dh;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    bwd_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
        a.dk_part, a.dv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n,
        g.groups);
  }
  return repro_last_error();
}

template <typename T>
int dispatch(int pass, const Args& a, const Geometry& g, cudaStream_t s) {
  switch (dh_tile(g.dh)) {
    case 64: return launch<T, 64>(pass, a, g, s);
    case 128: return launch<T, 128>(pass, a, g, s);
    case 256: return launch<T, 256>(pass, a, g, s);
    default: return launch<T, 512>(pass, a, g, s);
  }
}

template <typename T, int DH>
int info(int pass, int* out) {
  using L = Tile<DH>;
  cudaFuncAttributes attr;
  const cudaError_t err = pass == 0
      ? cudaFuncGetAttributes(&attr, bwd_dq_kernel<T, DH>)
      : cudaFuncGetAttributes(&attr, bwd_dkdv_kernel<T, DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = pass == 0 ? L::kDqBytes : L::kDkdvBytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = pass == 0 ? L::SQ : L::SK;
  out[5] = L::BQ;
  out[6] = L::BK;
  return 0;
}

template <typename T>
int info_of(int pass, int dh, int* out) {
  switch (dh_tile(dh)) {
    case 64: return info<T, 64>(pass, out);
    case 128: return info<T, 128>(pass, out);
    case 256: return info<T, 256>(pass, out);
    default: return info<T, 512>(pass, out);
  }
}

}  // namespace

// What pass (0 dQ, 1 dK/dV) of dtype (0 f32, 1 bf16) at head width dh
// launches with: out[0] threads, out[1] dynamic shared bytes, out[2]
// registers a thread, out[3] local (spill) bytes a thread, out[4] stages
// of its ring, out[5] query rows and out[6] keys a tile.
extern "C" int flash_attn_bwd_info(int pass, int dtype, int dh, int* out) {
  if (pass < 0 || pass > 1 || dh < 1 || dh > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return info_of<float>(pass, dh, out);
  if (dtype == 1) return info_of<__nv_bfloat16>(pass, dh, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One pass of K4's gradient (0 dQ with D, 1 dK/dV, 2 reduce; run in that
// order on one stream). q, o, dout, dq (B, Tq, Hq, dh); k, v, dk, dv
// (B, Tk, Hkv, dh), all contiguous, of one type (0 = float32,
// 1 = bfloat16); lse (the forward's) and delta f32 (B, Hq, Tq); dk_part
// and dv_part f32 (groups, B, Tk, Hkv, dh), groups dividing Hq / Hkv.
// 1 <= dh <= 512, every dimension >= 1. vec: q, k, v, o and dout 16-byte
// aligned and dh a multiple of 8 (bf16) or 4 (f32), so tiles are staged 16
// bytes a copy.
extern "C" int flash_attn_bwd_launch(
    int pass, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, float* dk_part, float* dv_part, int dtype, int B, int Tq,
    int Tk, int Hq, int Hkv, int dh, int groups, float scale, int causal,
    int vec, void* stream) {
  if (pass < 0 || pass > 2 || dh < 1 || dh > 512 || Hkv < 1 || Hq % Hkv != 0
      || groups < 1 || (Hq / Hkv) % groups != 0 || B < 1 || Tq < 1 || Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, dk_part, dv_part};
  const Geometry g{B, Tq, Tk, Hq, Hkv, dh, groups, scale, causal, vec};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(pass, a, g, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(pass, a, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
