// K4, CUDA-core route: causal or non-causal GQA flash attention, forward,
// in f32 on the CUDA cores — for float32 inputs, bf16 heads the
// tensor-core kernel (flash_attn_tc.cu) does not take (Dh % 8 != 0), and
// every head of width 257-512.
//
// Replaces src/repro/kernels/attn/attn.py::flash_attention_fwd (Pallas body
// _kernel plus the epilogue in the same function). For q (B, Tq, Hq, Dh) and
// k, v (B, Tk, Hkv, Dh), each query row attends to the keys of KV head
// h / G (G = Hq / Hkv) with a streaming softmax: q is scaled by Dh^-0.5 in
// f32, masked scores are NEG = -1e30 (the padding mask kpos < Tk, and
// kpos <= t when causal), and the output is acc / max(l, 1e-30) in q's
// type. On request (a non-null lse, f32 (B, Hq, Tq)) each row's
// log-sum-exp m + log(max(l, 1e-30)) as well, the m and l the reference's
// Pallas kernel returns beside acc, which K4' takes to recompute P
// (flash_attn_bwd.cu); writing it changes no output bit. Inputs f32 or
// bf16 (widened to f32 when staged); every multiply-add an explicit
// __fmaf_rn (the library is built with --fmad=false), and expf, not
// __expf.
//
// Bound. At chatglm3-6b's prefill (B = 2, T = 2048, 32 query over 2 KV
// heads, Dh = 128, causal) the work is 68.7 GFLOP, 1.026 ms at the H100's
// 67 TFLOP/s of f32 FMAs; the bytes (q, k, v, o in f32: 142.6 MB) take 43
// us at 3.35 TB/s. So it is bound by operations, and the design keeps the
// FMA pipes fed:
// - Grid: one block per (batch, KV head, query tile) whose rows are the KV
//   head's G query heads flattened head-major (R = g Tq + t), as in
//   flash_attn_tc.cu, so one staged K/V tile serves all G heads; the
//   heaviest tiles first. The block loops over the KV tiles itself (to the
//   diagonal when causal): the Pallas kernel's sequential n_k grid axis.
// - A ring of K/V stages in shared memory, filled by 16-byte cp.async
//   copies (f32 rows 16-byte aligned; other rows are staged through
//   registers), tile j + STAGES - 1 in flight while tile j is computed.
// - Register micro-tiles: 256 threads as 16 row groups x 16 column groups
//   (rg = tid / 16, cg = tid % 16, a half-warp a row group); a thread
//   holds rows rg + 16 i, keys cg + 16 j of S (8 x 4 at Dh 128) and output
//   columns 4 cg + 64 n (8 x 8), so a float4 read from shared memory feeds
//   10.7 FMAs in S and 16 in P V. Shared memory delivers 32 floats a cycle
//   to an SM's 128 FMA lanes, so S runs at most at 2/3 of the FMA peak.
// - The softmax stays in registers: the row's max and sum are shuffles over
//   its 16 threads; P goes to shared memory once, for P V (in the K slot of
//   the tile, whose readers are done, where it fits).
// - A grid of 128-row tiles short of two waves of the card (the whisper
//   encoder, train_lm's 256 tokens) takes 64-row tiles instead, at Dh <= 64
//   two blocks an SM: the last wave's idle SMs cost less.
//
// Tiles (BQ rows x BK keys, 256 threads) and dynamic shared memory:
//   Dh <=  64: 128 x 64, 3 stages, P apart, 168 KB (short grids: 64 x 64,
//              2 stages, 85 KB, two blocks an SM);
//   Dh <= 128: 128 x 64, 2 stages, 198 KB (short grids: 64 x 64, 165 KB);
//   Dh <= 256: 64 x 32, 2, 195 KB;  Dh <= 512: 32 x 16, 2 stages, 193.5 KB.

#include "common.cuh"
#include "flash_core.cuh"

namespace {

using namespace fcore;

// The sum (or max) over the 16 threads of a row group, a half-warp, the
// same value on each (the butterfly's additions commute).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// (rows a thread, keys a thread, K/V stages, blocks an SM) by head-width
// tile; SMALL: the 64-row tiles of a short grid
template <int DH, bool SMALL>
struct Cfg;
#define REPRO_CFG(DH, SMALL, TR_, TK_, ST_, MB_)                         \
  template <>                                                            \
  struct Cfg<DH, SMALL> {                                                \
    static constexpr int TR = TR_, TK = TK_, ST = ST_, MB = MB_;         \
  };
REPRO_CFG(64, false, 8, 4, 3, 1)
REPRO_CFG(64, true, 4, 4, 2, 2)
REPRO_CFG(128, false, 8, 4, 2, 1)
REPRO_CFG(128, true, 4, 4, 2, 1)
REPRO_CFG(256, false, 4, 2, 2, 1)
REPRO_CFG(512, false, 2, 1, 2, 1)
#undef REPRO_CFG

constexpr int kRG = 16, kCG = 16;   // row groups x column groups
static_assert(kRG * kCG == kThreads, "the thread grid covers the block");

template <int DH, bool SMALL>
struct Tile {
  using C = Cfg<DH, SMALL>;
  static constexpr int TR = C::TR, TK = C::TK, ST = C::ST, MB = C::MB;
  static constexpr int BQ = kRG * TR, BK = kCG * TK;
  static constexpr int LD = DH + 4;        // Q, K, V rows (floats)
  static constexpr int CV = DH / 64;       // float4 output columns a thread
  static constexpr bool kPInK = BQ <= LD;  // P (BQ x BK) fits a K tile
  static constexpr int kQ = BQ * LD;
  static constexpr int kKV = BK * LD;      // one K or one V tile
  static constexpr int kFloats = kQ + ST * 2 * kKV + (kPInK ? 0 : BQ * BK);
  static constexpr int kBytes = kFloats * 4;
};

template <typename T, int DH, bool SMALL>
__global__ void __launch_bounds__(kThreads, Tile<DH, SMALL>::MB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int B, int Tq, int Tk, int Hq,
                 int Hkv, int dh, float scale, int causal, int vec) {
  using L = Tile<DH, SMALL>;
  constexpr int TR = L::TR, TK = L::TK, ST = L::ST, BQ = L::BQ, BK = L::BK;
  constexpr int LD = L::LD, CV = L::CV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KV = Qs + L::kQ;                   // stage s: K, then V
  float* Pa = KV + ST * 2 * L::kKV;         // P when it does not fit a K tile

  const int G = Hq / Hkv;
  const int total = G * Tq;
  const int n_tiles = (total + BQ - 1) / BQ;
  const int x = blockIdx.x / (Hkv * B);
  const int rest = blockIdx.x % (Hkv * B);
  const int hk = rest % Hkv, b = rest / Hkv;
  const int r0 = packed_tile(x, n_tiles, BQ, Tq, G, causal) * BQ;
  const int r_last = min(r0 + BQ, total) - 1;
  const int t_hi = r0 / Tq == r_last / Tq ? r_last % Tq : Tq - 1;
  const int k_end = causal ? min(Tk, t_hi + 1) : Tk;
  const int n_kv = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;

  const int64_t q_row = static_cast<int64_t>(Hq) * dh;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * dh;
  const int64_t q_b = static_cast<int64_t>(b) * Tq * q_row;
  const int64_t kv_base = static_cast<int64_t>(b) * Tk * kv_row
                          + static_cast<int64_t>(hk) * dh;

  auto issue = [&](int j) {
    if (j < n_kv) {
      float* Ks = KV + (j % ST) * 2 * L::kKV;
      const SeqRows rows{kv_base, kv_row, j * BK, Tk};
      stage<DH>(Ks, LD, BK, k, rows, dh, vec);
      stage<DH>(Ks + L::kKV, LD, BK, v, rows, dh, vec);
    }
    cp_async_commit();
  };

  stage<DH>(Qs, LD, BQ, q, PackedRows{q_b, q_row, r0, total, Tq, hk * G, dh},
            dh, vec);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) issue(j);

  // this thread's rows: their position (a row past the heads reads as the
  // last position: finite, never stored) and running max and sum
  int t_of[TR];
  float m[TR], l[TR];
  float acc[TR][CV][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int R = r0 + rg + kRG * i;
    t_of[i] = R < total ? R % Tq : Tq - 1;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  cp_async_wait<ST - 1>();   // Q has landed
  __syncthreads();
  scale_tile<DH>(Qs, LD, BQ, scale);
  const int dpad = (dh + 3) & ~3;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<ST - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();           // ... everyone's; tile j - 1's readers done
    issue(j + ST - 1);
    float* Ks = KV + (j % ST) * 2 * L::kKV;
    const float* Vs = Ks + L::kKV;
    const int k0 = j * BK;

    // S = (q scale) K^T
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c) s[i][c] = 0.f;
#pragma unroll 1
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[TR], kv[TK];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &Qs[(rg + kRG * i) * LD + d]);
#pragma unroll
      for (int c = 0; c < TK; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            &Ks[(cg + kCG * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TK; ++c) s[i][c] = dot4(qv[i], kv[c], s[i][c]);
    }

    // mask; the streaming softmax in registers
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        const int kpos = k0 + cg + kCG * c;
        const bool ok = kpos < Tk && (!causal || kpos <= t_of[i]);
        s[i][c] = ok ? s[i][c] : kNeg;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = __fmaf_rn(l[i], alpha, row_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CV; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }

    // P into shared memory (over this tile's K once its readers are done)
    float* Ps = L::kPInK ? Ks : Pa;
    if (L::kPInK) __syncthreads();
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c)
        Ps[swz<BK>(rg + kRG * i, cg + kCG * c)] = s[i][c];
    __syncthreads();

    // acc += P V
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &Ps[swz<BK>(rg + kRG * i, c)]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int n = 0; n < CV; ++n) {
          if (CV > 2 && 64 * n >= dh) continue;   // columns past the head
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * LD + 4 * cg + 64 * n]);
#pragma unroll
          for (int i = 0; i < TR; ++i) axpy4(comp(pv[i], cc), vv, acc[i][n]);
        }
      }
    }
  }

  // epilogue: acc / max(l, 1e-30), in q's type; the LSE on request
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int R = r0 + rg + kRG * i;
    if (R >= total) continue;
    const int g = R / Tq, t = R - g * Tq, hq = hk * G + g;
    const float lv = fmaxf(l[i], 1e-30f);
    const int64_t at = q_b + static_cast<int64_t>(t) * q_row
                       + static_cast<int64_t>(hq) * dh;
#pragma unroll
    for (int n = 0; n < CV; ++n) {
      float x4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x4[e] = acc[i][n][e] / lv;
      store4(o, at, 4 * cg + 64 * n, dh, x4, vec);
    }
    if (lse != nullptr && cg == 0)
      lse[(static_cast<int64_t>(b) * Hq + hq) * Tq + t] = m[i] + logf(lv);
  }
}

template <int DH, bool SMALL>
int64_t grid_of(int B, int Tq, int Hq, int Hkv) {
  return (static_cast<int64_t>(Hq / Hkv) * Tq + Tile<DH, SMALL>::BQ - 1)
         / Tile<DH, SMALL>::BQ * Hkv * B;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int DH, bool SMALL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int Tk, int Hq, int Hkv, int dh, float scale,
           int causal, int vec, cudaStream_t stream) {
  using L = Tile<DH, SMALL>;
  auto kern = flash_fwd_kernel<T, DH, SMALL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = grid_of<DH, SMALL>(B, Tq, Hq, Hkv);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(grid), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, B, Tq, Tk, Hq, Hkv,
      dh, scale, causal, vec);
  return repro_last_error();
}

// Dh <= 128 with a grid of 128-row tiles short of two waves: 64-row tiles
template <int DH>
bool small(int B, int Tq, int Hq, int Hkv) {
  return DH <= 128 && grid_of<DH, false>(B, Tq, Hq, Hkv) < 2 * sm_count();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Tq, int Tk, int Hq, int Hkv, int dh,
             float scale, int causal, int vec, cudaStream_t s) {
#define REPRO_FWD(DH, SMALL)                                               \
  launch<T, DH, SMALL>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh, scale,     \
                       causal, vec, s)
  switch (dh_tile(dh)) {
    case 64:
      return small<64>(B, Tq, Hq, Hkv) ? REPRO_FWD(64, true)
                                       : REPRO_FWD(64, false);
    case 128:
      return small<128>(B, Tq, Hq, Hkv) ? REPRO_FWD(128, true)
                                        : REPRO_FWD(128, false);
    case 256: return REPRO_FWD(256, false);
    default: return REPRO_FWD(512, false);
  }
#undef REPRO_FWD
}

template <typename T, int DH, bool SMALL>
int info(int* out) {
  using L = Tile<DH, SMALL>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, flash_fwd_kernel<T, DH, SMALL>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = L::kBytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = L::ST;
  out[5] = L::BQ;
  out[6] = L::BK;
  return 0;
}

template <typename T>
int info_of(int dh, int short_grid, int* out) {
  switch (dh_tile(dh)) {
    case 64: return short_grid ? info<T, 64, true>(out)
                               : info<T, 64, false>(out);
    case 128: return short_grid ? info<T, 128, true>(out)
                                : info<T, 128, false>(out);
    case 256: return info<T, 256, false>(out);
    default: return info<T, 512, false>(out);
  }
}

}  // namespace

// What the instantiation for dtype (0 f32, 1 bf16) at head width dh
// launches with (short_grid: the 64-row tiles of a short grid, Dh <= 128):
// out[0] threads, out[1] dynamic shared bytes, out[2] registers a thread,
// out[3] local (spill) bytes a thread, out[4] K/V stages, out[5] query
// rows and out[6] keys a tile.
extern "C" int flash_attn_info(int dtype, int dh, int short_grid, int* out) {
  if (dh < 1 || dh > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return info_of<float>(dh, short_grid, out);
  if (dtype == 1) return info_of<__nv_bfloat16>(dh, short_grid, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (B, Tq, Hq, dh), k and v (B, Tk, Hkv, dh), o like q, all contiguous.
// dtype: 0 = float32, 1 = bfloat16. 1 <= dh <= 512, Hq % Hkv == 0. lse:
// null, or f32 (B, Hq, Tq) for each row's log-sum-exp. vec: q, k, v and o
// 16-byte aligned and dh a multiple of 4 (f32) or 8 (bf16).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int dtype, int B,
                                 int Tq, int Tk, int Hq, int Hkv, int dh,
                                 float scale, int causal, int vec,
                                 void* stream) {
  if (dh < 1 || dh > 512 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh, scale,
                           causal, vec, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh,
                                   scale, causal, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
