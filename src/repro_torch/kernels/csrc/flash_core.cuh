// What the CUDA-core K4 (flash_attn.cu) and K4' (flash_attn_bwd.cu) share:
// the loads and stores by type, the f32 micro-products, the asynchronous
// staging of tiles into shared memory, the swizzle of the score tiles that
// go through shared memory, and the row maps of a block.
//
// Both kernels run 256 threads a block as 16 row groups x 16 column groups
// (rg = tid / 16, cg = tid % 16): a row group is a half-warp, so a row's
// reductions are shuffles within it, and a float4 read along a tile's rows
// at a pitch of Dh + 4 floats touches 2 rows (broadcast over a half-warp)
// or 16 (a column group's), on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fcore {

constexpr int kThreads = 256;
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

// Four values at columns d0..d0+3 of a row starting at element ``at``,
// those below dh: one 16-byte store for f32 when ``vec`` (every row
// 16-byte aligned) and all four are in the row.
template <typename T>
__device__ __forceinline__ void store4(T* p, int64_t at, int d0, int dh,
                                       const float* x, int vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec && d0 + 4 <= dh) {
      *reinterpret_cast<float4*>(p + at + d0) =
          make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < dh) store(p, at + d0 + e, x[e]);
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

// Element (r, c) of a [rows][W] score tile in shared memory, its float4
// chunks XOR-swizzled by r % 4: the consecutive rows a warp reads at one
// chunk fall on distinct banks with no padding (W >= 16). A float4 at
// c % 4 == 0 stays contiguous.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(W >= 16 && W % 16 == 0, "a row holds >= 4 chunks");
  return r * W + ((((c >> 2) ^ (r & 3)) << 2) | (c & 3));
}

// ------------------------------------------------------------ cp.async
// 16 bytes global -> shared, asynchronously; zero-filled, reading
// nothing, when !valid (src must still be a global address).
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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

// Rows [t0, t0 + n) of one head of a (B, T, H, Dh) tensor: the element
// offset of row r's first element, or -1 past t_len.
struct SeqRows {
  int64_t base, stride;
  int t0, t_len;
  __device__ __forceinline__ int64_t operator()(int r) const {
    return t0 + r < t_len ? base + static_cast<int64_t>(t0 + r) * stride
                          : -1;
  }
};

// Rows [r0, r0 + n) of a KV head's G query heads flattened head-major,
// R = g * Tq + t (head h0 + g): with long sequences a tile lies within a
// head, with short ones it packs several.
struct PackedRows {
  int64_t base, stride;   // base: batch row b's first element
  int r0, total, Tq, h0, dh;
  __device__ __forceinline__ int64_t operator()(int r) const {
    const int R = r0 + r;
    if (R >= total) return -1;
    const int g = R / Tq;
    return base + static_cast<int64_t>(R - g * Tq) * stride
           + static_cast<int64_t>(h0 + g) * dh;
  }
};

// Stage n rows of DH columns into a shared tile of pitch ld (floats):
// row(r) is the row's first element, -1 for a row of zeros; columns in
// [dh, DH) are zeros. With ``vec`` (dh a multiple of a 16-byte load's
// elements, every row 16-byte aligned) f32 goes by 16-byte cp.async (the
// caller commits and waits) and bf16 by 16-byte loads widened to f32;
// otherwise element by element. The values are the same either way.
template <int DH, typename T, typename RowFn>
__device__ __forceinline__ void stage(float* dst, int ld, int n,
                                      const T* __restrict__ src, RowFn row,
                                      int dh, int vec) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);     // elements a load
    constexpr int CH = DH / W;            // loads a row
    for (int i = threadIdx.x; i < n * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * W;
      const int64_t at = row(r);
      const bool ok = at >= 0 && c < dh;
      if constexpr (sizeof(T) == 4) {
        cp_async16(dst + r * ld + c, ok ? src + at + c : src, ok);
      } else {
        float v[W];
        if (ok) {
          load16(src + at + c, v);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < W; e += 4)
          *reinterpret_cast<float4*>(&dst[r * ld + c + e]) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    const int64_t at = row(r);
    dst[r * ld + d] = at >= 0 && d < dh ? load(src, at + d) : 0.f;
  }
}

// Multiplies rows [0, n) x columns [0, DH) of a shared tile by s.
template <int DH>
__device__ __forceinline__ void scale_tile(float* t, int ld, int n, float s) {
  for (int i = threadIdx.x; i < n * (DH / 4); i += kThreads) {
    const int r = i / (DH / 4), c = (i - r * (DH / 4)) * 4;
    float4* p = reinterpret_cast<float4*>(t + r * ld + c);
    const float4 x = *p;
    *p = make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
  }
}

// The flattened query tile ``tile`` of n_tiles: with causal masking the
// heaviest tiles first (the last tile of each head, then the one before).
__device__ __forceinline__ int packed_tile(int x, int n_tiles, int BQ,
                                           int Tq, int G, int causal) {
  if (!causal) return x;
  if (Tq % BQ == 0) {
    const int per_head = Tq / BQ;
    return (x % G) * per_head + per_head - 1 - x / G;
  }
  return n_tiles - 1 - x;
}

// Head width -> the instantiation's width: 64, 128, 256 or 512.
inline int dh_tile(int dh) {
  return dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 512;
}

}  // namespace fcore
