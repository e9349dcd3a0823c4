// K4: causal or non-causal GQA flash attention, forward, for the LM prefill.
//
// Replaces src/repro/kernels/attn/attn.py::flash_attention_fwd (Pallas body
// _kernel plus the epilogue in the same function). For q (B, Tq, Hq, Dh) and
// k, v (B, Tk, Hkv, Dh), each query row attends to the keys of KV head
// h / G (G = Hq / Hkv) with a streaming softmax: q is scaled by Dh^-0.5 in
// f32, masked scores are NEG = -1e30 (the padding mask kpos < Tk, and
// kpos <= qpos when causal), and the output is acc / max(l, 1e-30) in q's
// type. Inputs are f32 or bf16; all arithmetic is f32.
//
// Grid. The Pallas kernel carries (acc, m, l) across its innermost n_k grid
// axis in revisited output blocks, which relies on the TPU running the grid
// in order. Here one block owns one (b, hq, q-tile): it loops over the KV
// tiles itself and keeps m and l in shared memory and acc in registers, so
// nothing is carried between blocks. With causal masking a KV tile wholly
// above the diagonal adds exactly nothing (key 0 is valid for every row, so
// m is finite after the first tile and exp(-1e30 - m) is 0 in f32, alpha 1),
// and the loop stops before it. The heaviest q-tiles of a causal launch are
// scheduled first. The public (B, T, H, Dh) layout is read directly: no
// head-major copy, the KV head is hq / G.
//
// Per KV tile: stage K and V (rows beyond Tk as zeros), S = Q K^T into
// shared memory with each thread a (BQ/16 x BK/16) micro-tile over float4
// reads, mask, one warp per row for the running max, p = expf(s - m) and
// the row sum, then acc = acc * alpha + P V with each thread a
// (BQ/16 x 4·DHMAX/64) micro-tile. Every multiply-add is an explicit
// __fmaf_rn: the library is built with --fmad=false, and expf (not __expf)
// keeps the exponent accurate.
//
// Bound. At the path's largest shape (B = 2, T = 2048, chatglm3's 32 query
// heads over 2 KV heads, Dh = 128) the causal work is 68.7 GFLOP (two
// products of 2·Dh flops per valid (q, k) pair), 1.03 ms at the H100's
// 67 TFLOP/s of f32 outside the tensor cores; q, k, v and o are 71.3 MB in
// bf16 (the model's type; 142.6 MB in f32), 21 us at 3.35 TB/s. So the
// kernel is bound by operations, and this first design is CUDA-core f32
// with Q, K and V tiles in shared memory. The bf16 tensor-core roof
// (989 TFLOP/s) is about 69 us; reaching for it with wgmma, TMA and a
// producer warp is a later redesign.
//
// Shared memory by head width (tiles BQ x BK, dynamic, above the 48 KB
// default, so the launcher raises the limit first):
//   Dh <=  64: 64 x 64, 69 KB;  Dh <= 128: 64 x 32, 77 KB;
//   Dh <= 256: 32 x 32, 104 KB; Dh <= 512: 32 x 16, 135 KB.
// Dh > 512 has no instantiation, and no model of the repository comes near
// it (the 32 x 16 tile would fit the 227 KB a block may use up to Dh 893).

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

template <int DHMAX, int BQ, int BK>
struct Tile {
  static constexpr int LDQ = DHMAX + 4;   // row pitch of Q and K (floats):
  static constexpr int LDK = DHMAX + 4;   // 16-byte rows, conflict-free
  static constexpr int LDV = DHMAX;       // float4 reads along a row
  static constexpr int LDS = BK + 4;
  static constexpr int RQ = BQ / 16;      // rows per thread
  static constexpr int CK = BK / 16;      // score columns per thread
  static constexpr int CV = DHMAX / 64;   // float4 output columns per thread
  static constexpr int kFloats = BQ * LDQ + BK * LDK + BK * LDV + BQ * LDS
                                 + 3 * BQ;
  static constexpr int kBytes = kFloats * 4;
};

// Copy rows [r0, r0 + n) of one head of a (B, T, H, Dh) tensor into a
// shared tile of pitch ld, times scale; rows past t_len and columns in
// [dh, dpad) are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int n,
                                      const T* __restrict__ src, int64_t base,
                                      int64_t row_stride, int r0, int t_len,
                                      int dh, int dpad, float scale) {
  for (int i = threadIdx.x; i < n * dpad; i += kThreads) {
    const int r = i / dpad, d = i - r * dpad;
    float v = 0.f;
    if (r0 + r < t_len && d < dh)
      v = load(src, base + static_cast<int64_t>(r0 + r) * row_stride + d);
    dst[r * ld + d] = v * scale;
  }
}

template <typename T, int DHMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
                 int Hq, int Hkv, int dh, float scale, int causal) {
  using L = Tile<DHMAX, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::LDQ;
  float* Vs = Ks + BK * L::LDK;
  float* Ss = Vs + BK * L::LDV;
  float* m_s = Ss + BQ * L::LDS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int n_q = (Tq + BQ - 1) / BQ;
  // causal: the last q-tiles see the most keys; start them first
  const int qt = causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int dpad = (dh + 3) & ~3;

  const int64_t q_row = static_cast<int64_t>(Hq) * dh;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * dh;
  const int64_t q_base = static_cast<int64_t>(b) * Tq * q_row
                         + static_cast<int64_t>(hq) * dh;
  const int64_t kv_base = static_cast<int64_t>(b) * Tk * kv_row
                          + static_cast<int64_t>(hk) * dh;

  stage(Qs, L::LDQ, BQ, q, q_base, q_row, q0, Tq, dh, dpad, scale);
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[L::RQ][L::CV][4];
#pragma unroll
  for (int i = 0; i < L::RQ; ++i)
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // keys any stored row can see: all Tk, or up to the tile's last row
  const int k_end = causal ? min(Tk, min(Tq, q0 + BQ)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    stage(Ks, L::LDK, BK, k, kv_base, kv_row, k0, Tk, dh, dpad, 1.f);
    stage(Vs, L::LDV, BK, v, kv_base, kv_row, k0, Tk, dh, DHMAX, 1.f);
    __syncthreads();

    // S = (q·scale) K^T, masked
    float s[L::RQ][L::CK];
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::CK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[L::RQ], kv[L::CK];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &Qs[(ty + 16 * i) * L::LDQ + d]);
#pragma unroll
      for (int j = 0; j < L::CK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &Ks[(tx + 16 * j) * L::LDK + d]);
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
#pragma unroll
        for (int j = 0; j < L::CK; ++j) {
          float a = s[i][j];
          a = __fmaf_rn(qv[i].x, kv[j].x, a);
          a = __fmaf_rn(qv[i].y, kv[j].y, a);
          a = __fmaf_rn(qv[i].z, kv[j].z, a);
          a = __fmaf_rn(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::CK; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < Tk && (!causal || kpos <= q0 + r);
        Ss[r * L::LDS + c] = ok ? s[i][j] : kNeg;
      }
    __syncthreads();

    // streaming softmax: one warp per row
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = kNeg;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ss[r * L::LDS + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(Ss[r * L::LDS + c] - m_new);
        Ss[r * L::LDS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = __fmaf_rn(l_s[r], alpha, sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < L::RQ; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < L::CV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
    for (int c = 0; c < BK; c += 4) {
      float4 pv[L::RQ];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &Ss[(ty + 16 * i) * L::LDS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[L::CV];
#pragma unroll
        for (int j = 0; j < L::CV; ++j)
          vv[j] = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * L::LDV + 4 * tx + 64 * j]);
#pragma unroll
        for (int i = 0; i < L::RQ; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < L::CV; ++j) {
            acc[i][j][0] = __fmaf_rn(p, vv[j].x, acc[i][j][0]);
            acc[i][j][1] = __fmaf_rn(p, vv[j].y, acc[i][j][1]);
            acc[i][j][2] = __fmaf_rn(p, vv[j].z, acc[i][j][2]);
            acc[i][j][3] = __fmaf_rn(p, vv[j].w, acc[i][j][3]);
          }
        }
      }
    }
  }
  __syncthreads();

  // epilogue: acc / max(l, 1e-30), in q's type
#pragma unroll
  for (int i = 0; i < L::RQ; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const int64_t row = q_base + static_cast<int64_t>(q0 + r) * q_row;
#pragma unroll
    for (int j = 0; j < L::CV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * j + e;
        if (d < dh) store(o, row + d, acc[i][j][e] / l);
      }
  }
}

template <typename T, int DHMAX, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int Hq, int Hkv, int dh, float scale, int causal,
           cudaStream_t stream) {
  using L = Tile<DHMAX, BQ, BK>;
  auto kern = flash_fwd_kernel<T, DHMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, Hq, Hkv, dh,
      scale, causal);
  return repro_last_error();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int Tk, int Hq, int Hkv, int dh, float scale, int causal,
             cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale,
                                 causal, stream);
  if (dh <= 128)
    return launch<T, 128, 64, 32>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale,
                                  causal, stream);
  if (dh <= 256)
    return launch<T, 256, 32, 32>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale,
                                  causal, stream);
  return launch<T, 512, 32, 16>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale,
                                causal, stream);
}

}  // namespace

// q (B, Tq, Hq, dh), k and v (B, Tk, Hkv, dh), o like q, all contiguous.
// dtype: 0 = float32, 1 = bfloat16. 1 <= dh <= 512, Hq % Hkv == 0.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int B, int Tq, int Tk,
                                 int Hq, int Hkv, int dh, float scale,
                                 int causal, void* stream) {
  if (dh < 1 || dh > 512 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale, causal,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
