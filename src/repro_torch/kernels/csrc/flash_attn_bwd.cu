// K4', CUDA-core route: the gradient of K4 (causal or non-causal GQA flash
// attention) for the training backward: dQ, dK and dV from q, k, v, the
// forward's output o and its incoming gradient dO. It takes float32, bf16
// of widths the tensor-core route (flash_attn_bwd_tc.cu: bf16, Dh % 8 == 0,
// Dh <= 128) does not, and every Dh up to 512.
//
// Replaces the reference's gradient of its training attention, which is the
// recompute VJP of the jnp chunked flash attention
// (src/repro/models/attention.py:79-174: jax.checkpoint on kv_step and
// q_block, so P is recomputed from q and k in the backward). The Pallas K4
// (src/repro/kernels/attn/attn.py::flash_attention_fwd) has no VJP; this is
// the gradient of K4's own function: q scaled by Dh^-0.5 in f32, masked
// scores NEG = -1e30 (kpos <= qpos when causal, no offset), query head h on
// KV head h / G. With P the row softmax,
//
//   D = rowsum(dO o o),  dV = P^T dO,  dS = P o (dO V^T - D),
//   dQ = scale dS K,     dK = scale dS^T Q,
//
// dK and dV summed over the G query heads of each KV head. All arithmetic
// is f32 on the CUDA cores (inputs f32 or bf16, outputs in the inputs'
// type), every multiply-add an explicit __fmaf_rn (the library is built
// with --fmad=false).
//
// Passes, each a launch, no atomics (a repeat is bit for bit):
//   0 rows: one block per (b, query head, query tile): D = rowsum(dO o o)
//     into f32 (B, Hq, Tq) and, unless the caller gives the forward's
//     (lse_in), each row's log-sum-exp lse = m + log(max(l, 1e-30)) from Q
//     and K, as the forward computes m and l. The tensor-core K4 writes the
//     LSE (flash_attn_tc.cu); the CUDA-core K4 (flash_attn.cu) does not, so
//     a float32 backward recomputes it here.
//   1 dQ: one block per (b, query head, query tile), looping over the key
//     tiles it can see (causal: up to the diagonal): recompute S and
//     dP = dO V^T, P = exp(S - lse), dS in shared memory, dQ += dS K.
//   2 dK/dV: one block per (b, query head, key tile), looping over the
//     query tiles that can see the key tile (causal: from the diagonal
//     down): recompute S^T and dP^T, dV += P^T dO, dK += dS^T (scale Q);
//     the query head's share goes to f32 scratch (B, Tk, Hq, Dh). Splitting
//     the G heads of a KV head over blocks keeps a causal launch balanced:
//     with one block per KV head, the first key tile's block would do all G
//     heads of every query tile, twice the mean.
//   3 reduce: dK, dV = the sum over g = 0..G-1 of the scratch, in order, cast
//     to the inputs' type.
//
// Bound. At chatglm3-6b's training shape (B = 2, T = 2048, 32 query heads
// over 2 KV heads, Dh = 128, causal) the function is 2.5x the forward's
// operations (two products of the forward, five of the gradient): 172 GFLOP,
// 0.174 ms at the bf16 tensor-core peak, 2.6 ms at the 67 TFLOP/s of f32
// outside the tensor cores; the bytes (q, k, v, o, dO read, dq, dk, dv
// written, bf16) are 88 MB, 26 us. This design recomputes S in every pass
// and dP in two (16 Dh flops a visible (query, key) pair against the
// function's 10 Dh), so its own f32 floor is ~4.1 ms. Operations bound it:
// bf16 at Dh <= 128 takes the wgmma design of flash_attn_bwd_tc.cu.
//
// Tiles (BQ query rows x BK keys, 256 threads as a 16 x 16 grid, every
// operand in shared memory as f32 at a pitch of Dh + 4 floats, so the
// float4 reads along a row are conflict-free; staged 16 bytes a load where
// every row is 16-byte aligned, and the products' loops unrolled by four)
// by head width, dynamic shared memory of the dK/dV pass (the largest):
//   Dh <=  64: 64 x 64, 105 KB;  Dh <= 128: 64 x 64, 170 KB;
//   Dh <= 256: 32 x 32, 143 KB;  Dh <= 512: 16 x 16, 135 KB.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* acc) {
  acc[0] = __fmaf_rn(a, x.x, acc[0]);
  acc[1] = __fmaf_rn(a, x.y, acc[1]);
  acc[2] = __fmaf_rn(a, x.z, acc[2]);
  acc[3] = __fmaf_rn(a, x.w, acc[3]);
}

__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int DHMAX, int BQ, int BK>
struct Tile {
  static constexpr int LD = DHMAX + 4;   // Q, dO, K and V rows (floats)
  static constexpr int LDP = BQ + 4;     // P, dS of the dK/dV pass (BK x BQ)
  static constexpr int LDS = BK + 4;     // S or dS of the row and dQ passes
  static constexpr int RQ = BQ / 16;     // query rows (or columns) a thread
  static constexpr int RK = BK / 16;     // key rows (or columns) a thread
  static constexpr int CV = DHMAX / 64;  // float4 head columns a thread
  static constexpr int kRowsBytes = (BQ * LD + BK * LD + BQ * LDS + 3 * BQ)
                                    * 4;
  static constexpr int kDqBytes = (2 * BQ * LD + 2 * BK * LD + BQ * LDS
                                   + 2 * BQ) * 4;
  static constexpr int kDkdvBytes = (2 * BK * LD + 2 * BQ * LD + 2 * BK * LDP
                                     + 2 * BQ) * 4;
};

// Eight bf16 or four f32 values from 16 bytes of global memory.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Rows [r0, r0 + n) of one head of a (B, T, H, Dh) tensor into a shared
// tile of pitch ld, times scale; rows past t_len and columns in [dh, DHMAX)
// are zero (the column-group products read them). With ``vec`` (dh a
// multiple of a 16-byte load's elements, every base 16-byte aligned) each
// thread moves 16 bytes a load, else one element; the values are the same.
template <int DHMAX, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int n,
                                      const T* __restrict__ src, int64_t base,
                                      int64_t row_stride, int r0, int t_len,
                                      int dh, float scale, int vec) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);     // elements a load
    constexpr int CH = DHMAX / W;         // loads a row
    for (int i = threadIdx.x; i < n * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * W;
      float v[W];
      if (r0 + r < t_len && c < dh) {
        load16(src + base + static_cast<int64_t>(r0 + r) * row_stride + c,
               v);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < W; e += 4)
        *reinterpret_cast<float4*>(&dst[r * ld + c + e]) = make_float4(
            v[e] * scale, v[e + 1] * scale, v[e + 2] * scale,
            v[e + 3] * scale);
    }
    return;
  }
  for (int i = threadIdx.x; i < n * DHMAX; i += kThreads) {
    const int r = i / DHMAX, d = i - r * DHMAX;
    float v = 0.f;
    if (r0 + r < t_len && d < dh)
      v = load(src, base + static_cast<int64_t>(r0 + r) * row_stride + d) *
          scale;
    dst[r * ld + d] = v;
  }
}

struct Geometry {
  int Tq, Tk, Hq, Hkv, dh;
  float scale;
  int causal, vec, lse_in;
};

// ---------------------------------------------------------------- pass 0
template <typename T, int DHMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ lse, float* __restrict__ delta,
                Geometry g) {
  using L = Tile<DHMAX, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::LD;
  float* Ss = Ks + BK * L::LD;
  float* m_s = Ss + BQ * L::LDS;
  float* l_s = m_s + BQ;

  const int n_q = (g.Tq + BQ - 1) / BQ;
  const int qt = g.causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (g.Hq / g.Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int dpad = (g.dh + 3) & ~3;

  const int64_t q_row = static_cast<int64_t>(g.Hq) * g.dh;
  const int64_t kv_row = static_cast<int64_t>(g.Hkv) * g.dh;
  const int64_t q_base = static_cast<int64_t>(b) * g.Tq * q_row
                         + static_cast<int64_t>(hq) * g.dh;
  const int64_t kv_base = static_cast<int64_t>(b) * g.Tk * kv_row
                          + static_cast<int64_t>(hk) * g.dh;

  stage<DHMAX>(Qs, L::LD, BQ, q, q_base, q_row, q0,
               g.Tq, g.dh, g.scale, g.vec);
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  // with the caller's LSE only D is computed
  const int k_end = g.lse_in ? 0
                    : g.causal ? min(g.Tk, min(g.Tq, q0 + BQ)) : g.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<DHMAX>(Ks, L::LD, BK, k, kv_base, kv_row, k0,
                 g.Tk, g.dh, 1.f, g.vec);
    __syncthreads();
    float s[L::RQ][L::RK];
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[L::RQ], kv[L::RK];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * L::LD
                                                     + d]);
#pragma unroll
      for (int j = 0; j < L::RK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * L::LD
                                                     + d]);
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
#pragma unroll
        for (int j = 0; j < L::RK; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < g.Tk && (!g.causal || kpos <= q0 + r);
        Ss[r * L::LDS + c] = ok ? s[i][j] : kNeg;
      }
    __syncthreads();
    // the forward's running max and sum: one warp per row
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = kNeg;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ss[r * L::LDS + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32)
        sum += expf(Ss[r * L::LDS + c] - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        l_s[r] = __fmaf_rn(l_s[r], expf(m_prev - m_new), sum);
        m_s[r] = m_new;
      }
    }
  }
  __syncthreads();

  // lse and D = rowsum(dO o o): one warp per row
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    if (row >= g.Tq) continue;
    const int64_t at = q_base + static_cast<int64_t>(row) * q_row;
    float acc = 0.f;
    for (int d = lane; d < g.dh; d += 32)
      acc = __fmaf_rn(load(dout, at + d), load(o, at + d), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int64_t i = (static_cast<int64_t>(b) * g.Hq + hq) * g.Tq + row;
      if (!g.lse_in) lse[i] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
      delta[i] = acc;
    }
  }
}

// ---------------------------------------------------------------- pass 1
template <typename T, int DHMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Geometry g) {
  using L = Tile<DHMAX, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + BQ * L::LD;     // dO
  float* Ks = Os + BQ * L::LD;
  float* Vs = Ks + BK * L::LD;
  float* Ds = Vs + BK * L::LD;     // dS (BQ x BK)
  float* lse_s = Ds + BQ * L::LDS;
  float* d_s = lse_s + BQ;

  const int n_q = (g.Tq + BQ - 1) / BQ;
  const int qt = g.causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (g.Hq / g.Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int dpad = (g.dh + 3) & ~3;

  const int64_t q_row = static_cast<int64_t>(g.Hq) * g.dh;
  const int64_t kv_row = static_cast<int64_t>(g.Hkv) * g.dh;
  const int64_t q_base = static_cast<int64_t>(b) * g.Tq * q_row
                         + static_cast<int64_t>(hq) * g.dh;
  const int64_t kv_base = static_cast<int64_t>(b) * g.Tk * kv_row
                          + static_cast<int64_t>(hk) * g.dh;
  const int64_t r_base = (static_cast<int64_t>(b) * g.Hq + hq) * g.Tq;

  stage<DHMAX>(Qs, L::LD, BQ, q, q_base, q_row, q0,
               g.Tq, g.dh, g.scale, g.vec);
  stage<DHMAX>(Os, L::LD, BQ, dout, q_base, q_row, q0, g.Tq, g.dh, 1.f, g.vec);
  if (tid < BQ) {
    const bool in = q0 + tid < g.Tq;
    lse_s[tid] = in ? lse[r_base + q0 + tid] : 0.f;
    d_s[tid] = in ? delta[r_base + q0 + tid] : 0.f;
  }

  float acc[L::RQ][L::CV][4];
#pragma unroll
  for (int i = 0; i < L::RQ; ++i)
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_end = g.causal ? min(g.Tk, min(g.Tq, q0 + BQ)) : g.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<DHMAX>(Ks, L::LD, BK, k, kv_base, kv_row, k0,
                 g.Tk, g.dh, 1.f, g.vec);
    stage<DHMAX>(Vs, L::LD, BK, v, kv_base, kv_row, k0,
                 g.Tk, g.dh, 1.f, g.vec);
    __syncthreads();
    // S = (q scale) K^T and dP = dO V^T
    float s[L::RQ][L::RK], dp[L::RQ][L::RK];
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[L::RQ], ov[L::RQ], kv[L::RK], vv[L::RK];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * L::LD
                                                     + d]);
        ov[i] = *reinterpret_cast<const float4*>(&Os[(ty + 16 * i) * L::LD
                                                     + d]);
      }
#pragma unroll
      for (int j = 0; j < L::RK; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * L::LD
                                                     + d]);
        vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * L::LD
                                                     + d]);
      }
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
#pragma unroll
        for (int j = 0; j < L::RK; ++j) {
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
          dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const bool ok = qpos < g.Tq && kpos < g.Tk
                        && (!g.causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
        Ds[r * L::LDS + c] = p * (dp[i][j] - d_s[r]);
      }
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 sv[L::RQ];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&Ds[(ty + 16 * i) * L::LDS
                                                     + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 kv[L::CV];
#pragma unroll
        for (int j = 0; j < L::CV; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              &Ks[(c + cc) * L::LD + 4 * tx + 64 * j]);
#pragma unroll
        for (int i = 0; i < L::RQ; ++i) {
          const float ds = comp(sv[i], cc);
#pragma unroll
          for (int j = 0; j < L::CV; ++j) axpy4(ds, kv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.Tq) continue;
    const int64_t at = q_base + static_cast<int64_t>(row) * q_row;
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * j + e;
        if (d < g.dh) store(dq, at + d, acc[i][j][e] * g.scale);
      }
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T, int DHMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk_part,
                float* __restrict__ dv_part, Geometry g) {
  using L = Tile<DHMAX, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * L::LD;
  float* Qs = Vs + BK * L::LD;     // q scale
  float* Os = Qs + BQ * L::LD;     // dO
  float* Ps = Os + BQ * L::LD;     // P^T (BK x BQ)
  float* Ds = Ps + BK * L::LDP;    // dS^T (BK x BQ)
  float* lse_s = Ds + BK * L::LDP;
  float* d_s = lse_s + BQ;

  const int kt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (g.Hq / g.Hkv);
  const int k0 = kt * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int dpad = (g.dh + 3) & ~3;

  const int64_t q_row = static_cast<int64_t>(g.Hq) * g.dh;
  const int64_t kv_row = static_cast<int64_t>(g.Hkv) * g.dh;
  const int64_t q_base = static_cast<int64_t>(b) * g.Tq * q_row
                         + static_cast<int64_t>(hq) * g.dh;
  const int64_t kv_base = static_cast<int64_t>(b) * g.Tk * kv_row
                          + static_cast<int64_t>(hk) * g.dh;
  const int64_t r_base = (static_cast<int64_t>(b) * g.Hq + hq) * g.Tq;

  stage<DHMAX>(Ks, L::LD, BK, k, kv_base, kv_row, k0, g.Tk, g.dh, 1.f, g.vec);
  stage<DHMAX>(Vs, L::LD, BK, v, kv_base, kv_row, k0, g.Tk, g.dh, 1.f, g.vec);

  float dk[L::RK][L::CV][4], dv[L::RK][L::CV][4];
#pragma unroll
  for (int i = 0; i < L::RK; ++i)
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][j][e] = dv[i][j][e] = 0.f;

  // causal: the query tiles holding a row at or below key k0
  const int q_begin = g.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < g.Tq; q0 += BQ) {
    __syncthreads();
    stage<DHMAX>(Qs, L::LD, BQ, q, q_base, q_row, q0,
                 g.Tq, g.dh, g.scale, g.vec);
    stage<DHMAX>(Os, L::LD, BQ, dout, q_base, q_row, q0,
                 g.Tq, g.dh, 1.f, g.vec);
    if (tid < BQ) {
      const bool in = q0 + tid < g.Tq;
      lse_s[tid] = in ? lse[r_base + q0 + tid] : 0.f;
      d_s[tid] = in ? delta[r_base + q0 + tid] : 0.f;
    }
    __syncthreads();
    // S^T = K (q scale)^T and dP^T = V dO^T, (BK x BQ)
    float s[L::RK][L::RQ], dp[L::RK][L::RQ];
#pragma unroll
    for (int i = 0; i < L::RK; ++i)
#pragma unroll
      for (int j = 0; j < L::RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dpad; d += 4) {
      float4 kv[L::RK], vv[L::RK], qv[L::RQ], ov[L::RQ];
#pragma unroll
      for (int i = 0; i < L::RK; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(&Ks[(ty + 16 * i) * L::LD
                                                     + d]);
        vv[i] = *reinterpret_cast<const float4*>(&Vs[(ty + 16 * i) * L::LD
                                                     + d]);
      }
#pragma unroll
      for (int j = 0; j < L::RQ; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(&Qs[(tx + 16 * j) * L::LD
                                                     + d]);
        ov[j] = *reinterpret_cast<const float4*>(&Os[(tx + 16 * j) * L::LD
                                                     + d]);
      }
#pragma unroll
      for (int i = 0; i < L::RK; ++i)
#pragma unroll
        for (int j = 0; j < L::RQ; ++j) {
          s[i][j] = dot4(kv[i], qv[j], s[i][j]);
          dp[i][j] = dot4(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < L::RK; ++i)
#pragma unroll
      for (int j = 0; j < L::RQ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + r, qpos = q0 + c;
        const bool ok = qpos < g.Tq && kpos < g.Tk
                        && (!g.causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] - lse_s[c]) : 0.f;
        Ps[r * L::LDP + c] = p;
        Ds[r * L::LDP + c] = p * (dp[i][j] - d_s[c]);
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T (q scale)
#pragma unroll 4
    for (int c = 0; c < BQ; c += 4) {
      float4 pv[L::RK], sv[L::RK];
#pragma unroll
      for (int i = 0; i < L::RK; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * L::LDP
                                                     + c]);
        sv[i] = *reinterpret_cast<const float4*>(&Ds[(ty + 16 * i) * L::LDP
                                                     + c]);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 ov[L::CV], qv[L::CV];
#pragma unroll
        for (int j = 0; j < L::CV; ++j) {
          ov[j] = *reinterpret_cast<const float4*>(
              &Os[(c + cc) * L::LD + 4 * tx + 64 * j]);
          qv[j] = *reinterpret_cast<const float4*>(
              &Qs[(c + cc) * L::LD + 4 * tx + 64 * j]);
        }
#pragma unroll
        for (int i = 0; i < L::RK; ++i) {
          const float p = comp(pv[i], cc), ds = comp(sv[i], cc);
#pragma unroll
          for (int j = 0; j < L::CV; ++j) {
            axpy4(p, ov[j], dv[i][j]);
            axpy4(ds, qv[j], dk[i][j]);
          }
        }
      }
    }
  }

  // this query head's share, f32 (B, Tk, Hq, Dh)
#pragma unroll
  for (int i = 0; i < L::RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= g.Tk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * g.Tk + kpos) * g.Hq + hq)
                       * g.dh;
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * j + e;
        if (d < g.dh) {
          dk_part[at + d] = dk[i][j][e];
          dv_part[at + d] = dv[i][j][e];
        }
      }
  }
}

// ---------------------------------------------------------------- pass 3
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part, T* __restrict__ dk,
                  T* __restrict__ dv, int64_t n, int Hkv, int G, int dh) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    // i indexes (b, t, hk, d) of the (B, Tk, Hkv, Dh) output
    const int d = static_cast<int>(i % dh);
    const int64_t bth = i / dh;                    // (b, t) * Hkv + hk
    const int hk = static_cast<int>(bth % Hkv);
    const int64_t bt = bth / Hkv;
    const int64_t src = (bt * Hkv * G + static_cast<int64_t>(hk) * G) * dh
                        + d;
    float a = 0.f, c = 0.f;
    for (int j = 0; j < G; ++j) {
      a += dk_part[src + static_cast<int64_t>(j) * dh];
      c += dv_part[src + static_cast<int64_t>(j) * dh];
    }
    store(dk, i, a);
    store(dv, i, c);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *dk_part, *dv_part;
  int B;
};

template <typename T, int DHMAX, int BQ, int BK>
int launch(int pass, const Args& a, const Geometry& g, cudaStream_t stream) {
  using L = Tile<DHMAX, BQ, BK>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err = cudaSuccess;
  if (pass == 0) {
    auto kern = bwd_rows_kernel<T, DHMAX, BQ, BK>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kRowsBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((g.Tq + BQ - 1) / BQ, g.Hq, a.B);
    kern<<<grid, kThreads, L::kRowsBytes, stream>>>(q, k, o, dout, a.lse,
                                                    a.delta, g);
  } else if (pass == 1) {
    auto kern = bwd_dq_kernel<T, DHMAX, BQ, BK>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((g.Tq + BQ - 1) / BQ, g.Hq, a.B);
    kern<<<grid, kThreads, L::kDqBytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), g);
  } else if (pass == 2) {
    auto kern = bwd_dkdv_kernel<T, DHMAX, BQ, BK>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkdvBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((g.Tk + BK - 1) / BK, g.Hq, a.B);
    kern<<<grid, kThreads, L::kDkdvBytes, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.dk_part, a.dv_part, g);
  } else {
    const int64_t n = static_cast<int64_t>(a.B) * g.Tk * g.Hkv * g.dh;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    bwd_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
        a.dk_part, a.dv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n,
        g.Hkv, g.Hq / g.Hkv, g.dh);
  }
  return repro_last_error();
}

template <typename T>
int dispatch(int pass, const Args& a, const Geometry& g, cudaStream_t s) {
  if (g.dh <= 64) return launch<T, 64, 64, 64>(pass, a, g, s);
  if (g.dh <= 128) return launch<T, 128, 64, 64>(pass, a, g, s);
  if (g.dh <= 256) return launch<T, 256, 32, 32>(pass, a, g, s);
  return launch<T, 512, 16, 16>(pass, a, g, s);
}

}  // namespace

// One pass of K4's gradient (0 rows, 1 dQ, 2 dK/dV, 3 reduce; run in that
// order on one stream). q, o, dout, dq (B, Tq, Hq, dh); k, v, dk, dv
// (B, Tk, Hkv, dh), all contiguous, of one type (0 = float32,
// 1 = bfloat16); lse and delta f32 (B, Hq, Tq); dk_part and dv_part f32
// (B, Tk, Hq, dh). 1 <= dh <= 512, Hq % Hkv == 0, every dimension >= 1.
// vec: q, k, v, o and dout 16-byte aligned and dh a multiple of 8 (bf16)
// or 4 (f32), so tiles are staged 16 bytes a load. lse_in: lse holds the
// forward's log-sum-exp, which pass 0 then leaves as it is.
extern "C" int flash_attn_bwd_launch(
    int pass, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* dk_part, float* dv_part, int dtype, int B, int Tq, int Tk, int Hq,
    int Hkv, int dh, float scale, int causal, int vec, int lse_in,
    void* stream) {
  if (pass < 0 || pass > 3 || dh < 1 || dh > 512 || Hkv < 1 || Hq % Hkv != 0
      || B < 1 || Tq < 1 || Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, dk_part, dv_part, B};
  const Geometry g{Tq, Tk, Hq, Hkv, dh, scale, causal, vec, lse_in};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(pass, a, g, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(pass, a, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
