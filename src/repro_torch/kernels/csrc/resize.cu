// K3: the semantic-compression bilinear resize of the serving data plane.
//
// Replaces src/repro/kernels/resize/resize.py::resize_bilinear (Pallas body
// _kernel), which evaluates out = R_h @ img @ R_w^T per (batch, channel) slab
// on the MXU with the 2-banded interpolation matrices of resize/ref.py
// (half-pixel centres, clamped). Each matrix row holds at most two nonzero
// weights, at columns lo and lo + 1, so the product is a 4-tap gather: this
// kernel reads the taps (lo, hi, w_lo, w_hi per output row and column, taken
// from the same matrices) and computes one output element per thread in the
// reference's (B, h, w, C) layout, rows first as the matrix product does:
//   out = w_lo^w * (w_lo^h x[r0,c0] + w_hi^h x[r1,c0])
//       + w_hi^w * (w_lo^h x[r0,c1] + w_hi^h x[r1,c1])
// f32 or bf16 in, f32 arithmetic, output in the input's type.
//
// Bound. Bytes: every input pixel the taps touch is read once and every
// output written once; there is no reuse to exploit beyond the 2x2
// neighbourhood, and 4 multiply-adds per output keep it far below the
// H100's compute roof, so the bound is HBM bandwidth. Consecutive threads
// take consecutive (column, channel) outputs, so a warp's reads fall on a
// few neighbouring rows and coalesce into few sectors.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const T* __restrict__ img, int64_t total, int H, int W, int C,
              int h, int w, const int* __restrict__ idx_h,
              const float* __restrict__ wt_h, const int* __restrict__ idx_w,
              const float* __restrict__ wt_w, T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  const int64_t q = i / C;
  const int j = static_cast<int>(q % w);
  const int64_t q2 = q / w;
  const int r = static_cast<int>(q2 % h);
  const int64_t bb = q2 / h;
  // taps: idx/wt are (2, n) row-major — [0] the low tap, [1] the high tap
  const int r0 = idx_h[r], r1 = idx_h[h + r];
  const float a0 = wt_h[r], a1 = wt_h[h + r];
  const int c0 = idx_w[j], c1 = idx_w[w + j];
  const float b0 = wt_w[j], b1 = wt_w[w + j];
  const int64_t base = bb * H;
  const int64_t p00 = ((base + r0) * W + c0) * C + c;
  const int64_t p01 = ((base + r0) * W + c1) * C + c;
  const int64_t p10 = ((base + r1) * W + c0) * C + c;
  const int64_t p11 = ((base + r1) * W + c1) * C + c;
  const float t0 = __fadd_rn(__fmul_rn(a0, load(img, p00)),
                             __fmul_rn(a1, load(img, p10)));
  const float t1 = __fadd_rn(__fmul_rn(a0, load(img, p01)),
                             __fmul_rn(a1, load(img, p11)));
  store(out, i, __fadd_rn(__fmul_rn(b0, t0), __fmul_rn(b1, t1)));
}

template <typename T>
int launch(const void* img, int B, int H, int W, int C, int h, int w,
           const void* idx_h, const void* wt_h, const void* idx_w,
           const void* wt_w, void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * h * w * C;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  resize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), total, H, W, C, h, w,
      static_cast<const int*>(idx_h), static_cast<const float*>(wt_h),
      static_cast<const int*>(idx_w), static_cast<const float*>(wt_w),
      static_cast<T*>(out));
  return repro_last_error();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int resize_launch(const void* img, int dtype, int B, int H, int W,
                             int C, int h, int w, const void* idx_h,
                             const void* wt_h, const void* idx_w,
                             const void* wt_w, void* out, void* stream) {
  if (dtype == 0)
    return launch<float>(img, B, H, W, C, h, w, idx_h, wt_h, idx_w, wt_w,
                         out, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(img, B, H, W, C, h, w, idx_h, wt_h, idx_w,
                                 wt_w, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
