// K3: the semantic-compression bilinear resize of the serving data plane.
//
// Replaces src/repro/kernels/resize/resize.py::resize_bilinear (Pallas body
// _kernel), which evaluates out = R_h @ img @ R_w^T per (batch, channel) slab
// on the MXU with the 2-banded interpolation matrices of resize/ref.py
// (half-pixel centres, clamped). Each matrix row holds at most two nonzero
// weights, at columns lo and lo + 1, so the product is a 4-tap gather,
// computed in the reference's (B, h, w, C) layout, rows first as the matrix
// product does:
//   out = w_lo^w * (w_lo^h x[r0,c0] + w_hi^h x[r1,c0])
//       + w_hi^w * (w_lo^h x[r0,c1] + w_hi^h x[r1,c1])
// f32 or bf16 in, f32 arithmetic, output in the input's type.
//
// Taps in the kernel. The kernel takes only the sizes: each output row's and
// column's two taps are derived from (n_in, n_out) with the float64
// expressions of repro_torch/kernels/resize/resize.py (_lo_index,
// resize_matrix, resize_taps):
//   scale = n_in / n_out;  src = clamp((i + 0.5) * scale - 0.5, 0, n_in - 1)
//   lo = floor(src);  frac = src - lo
//   w_lo = float(1 - frac);  w_hi = float(frac)
// and at the clamped edge (lo + 1 == n_in) the high weight folds into the low
// one (float32 add) with hi = lo, as resize_taps reads it off the matrix.
// The library is built with --fmad=false and each operation is the correctly
// rounded intrinsic, so this is numpy's arithmetic and the taps are
// bit-equal to resize_taps: no tap table is built, uploaded or checked.
//
// Layout. A block owns one output row of one image and kTileW consecutive
// output columns: thread 0 derives the row's taps, the first threads the
// tile's column taps, into shared memory, once per block. One thread per
// (pixel, channel) output, consecutive threads on consecutive outputs
// (coalesced stores; a warp's reads span a few 128-byte lines). On the H100
// this beat one thread per pixel covering all C channels at both smoke
// shapes (5x128x128x3 -> 27x27 and 8x1024x2048x3 at z = 0.25), once the
// thread stepped its (column, channel) index without a division per
// output.
//
// Bound. Bytes: every input pixel the taps touch is read once and every
// output written once; 4 multiply-adds per output and one tap derivation
// per column keep it far below the H100's compute roof, so the bound is HBM
// bandwidth (0.075 ms for 8x1024x2048x3 f32 at z = 0.25). At the serving
// shape (5x128x128x3 -> 27x27) it is launch latency.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTileW = 128;
constexpr int kThreads = 128;

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
  p[i] = __float2bfloat16_rn(v);
}

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

// Output sample i of n_out over n_in input samples (resize_taps' arithmetic).
__device__ __forceinline__ Tap tap(int i, int n_out, int n_in) {
  const double scale = __ddiv_rn(static_cast<double>(n_in),
                                 static_cast<double>(n_out));
  double src = __dadd_rn(__dmul_rn(__dadd_rn(static_cast<double>(i), 0.5),
                                   scale), -0.5);
  src = fmin(fmax(src, 0.0), static_cast<double>(n_in - 1));
  const double lo = floor(src);
  const double frac = __dadd_rn(src, -lo);
  Tap t;
  t.lo = static_cast<int>(lo);
  t.w_lo = __double2float_rn(__dadd_rn(1.0, -frac));
  t.w_hi = __double2float_rn(frac);
  if (t.lo + 1 < n_in) {
    t.hi = t.lo + 1;
  } else {  // clamped: R[lo] += w_hi in float32, hi = lo with weight 0
    t.hi = t.lo;
    t.w_lo = __fadd_rn(t.w_lo, t.w_hi);
    t.w_hi = 0.0f;
  }
  return t;
}

template <typename T>
__device__ __forceinline__ float gather(const T* __restrict__ img,
                                        int64_t r0, int64_t r1, const Tap& rt,
                                        int64_t c0, int64_t c1, float b0,
                                        float b1) {
  // r0/r1: row offsets (elements), c0/c1: column-and-channel offsets
  const float t0 = __fadd_rn(__fmul_rn(rt.w_lo, load(img, r0 + c0)),
                             __fmul_rn(rt.w_hi, load(img, r1 + c0)));
  const float t1 = __fadd_rn(__fmul_rn(rt.w_lo, load(img, r0 + c1)),
                             __fmul_rn(rt.w_hi, load(img, r1 + c1)));
  return __fadd_rn(__fmul_rn(b0, t0), __fmul_rn(b1, t1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const T* __restrict__ img, int H, int W, int C, int h, int w,
              T* __restrict__ out) {
  __shared__ int s_c0[kTileW], s_c1[kTileW];
  __shared__ float s_b0[kTileW], s_b1[kTileW];
  __shared__ Tap s_row;
  const int j0 = blockIdx.x * kTileW;
  const int r = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int nj = min(kTileW, w - j0);
  if (threadIdx.x < nj) {
    const Tap ct = tap(j0 + threadIdx.x, w, W);
    s_c0[threadIdx.x] = ct.lo;
    s_c1[threadIdx.x] = ct.hi;
    s_b0[threadIdx.x] = ct.w_lo;
    s_b1[threadIdx.x] = ct.w_hi;
  }
  if (threadIdx.x == 0) s_row = tap(r, h, H);
  __syncthreads();
  const Tap rt = s_row;
  const int64_t r0 = ((bb * H) + rt.lo) * W * C;
  const int64_t r1 = ((bb * H) + rt.hi) * W * C;
  const int64_t o = (((bb * h) + r) * w + j0) * C;
  // output q of the tile is (column q / C, channel q % C); the thread steps
  // both by kThreads without dividing again
  const int n = nj * C;
  const int dj = kThreads / C, dc = kThreads - dj * C;
  int j = threadIdx.x / C, c = threadIdx.x - j * C;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    store(out, o + q,
          gather(img, r0, r1, rt, static_cast<int64_t>(s_c0[j]) * C + c,
                 static_cast<int64_t>(s_c1[j]) * C + c, s_b0[j], s_b1[j]));
    j += dj;
    c += dc;
    if (c >= C) {
      c -= C;
      ++j;
    }
  }
}

template <typename T>
int launch(const void* img, int B, int H, int W, int C, int h, int w,
           void* out, void* stream) {
  if (static_cast<int64_t>(B) * h * w * C == 0) return 0;
  if (h > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileW - 1) / kTileW, h, B);
  resize_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), H, W, C, h, w, static_cast<T*>(out));
  return repro_last_error();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int resize_launch(const void* img, int dtype, int B, int H, int W,
                             int C, int h, int w, void* out, void* stream) {
  if (dtype == 0) return launch<float>(img, B, H, W, C, h, w, out, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(img, B, H, W, C, h, w, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
