// K4, bf16 route: causal or non-causal GQA flash attention, forward, on
// Hopper's tensor cores.
//
// Replaces src/repro/kernels/attn/attn.py::flash_attention_fwd (Pallas body
// _kernel plus its epilogue) for bf16 q, k, v with Dh % 8 == 0; f32 inputs
// and other bf16 head widths keep the CUDA-core kernel in flash_attn.cu. For
// q (B, Tq, Hq, Dh) and k, v (B, Tk, Hkv, Dh), each query row attends to the
// keys of KV head h / G (G = Hq / Hkv): masked scores are NEG = -1e30 (the
// padding mask kpos < Tk, and kpos <= t when causal), and the output is
// acc / max(l, 1e-30) rounded to bf16.
//
// Bound. At the LM prefill's largest shape (B = 2, T = 2048, chatglm3-6b's
// 32 query over 2 KV heads, Dh = 128) the causal work is 68.75 GFLOP, 69.5 us
// at the H100's 989 TFLOP/s of dense bf16; q, k, v and o are 71.3 MB, 21 us
// at 3.35 TB/s. So the kernel is bound by operations, and only the tensor
// cores reach that roof: both products are wgmma.mma_async with f32
// accumulators, and the loads are kept off the threads that issue them.
//
// Design.
// - Grid: one block owns one (b, KV head, query tile) and loops over the KV
//   tiles itself, stopping at the diagonal when causal. The tile's rows are
//   the KV head's G query heads flattened head-major, row r = g * Tq + t:
//   with long prompts a tile lies within one head, and with short ones
//   (the engine's LM jobs, Tq = 16) one tile packs 4 to 8 heads, so one
//   K/V tile feeds them all. The heaviest tiles are launched first.
// - Warp roles: warpgroup 0 is the producer (setmaxnreg down to 24); one
//   thread of it keeps a ring of K/V stages in flight with TMA
//   (cp.async.bulk.tensor, 4-D maps over the public (B, T, H, Dh) layout,
//   64-element boxes under the 128-byte swizzle), under a full and an empty
//   mbarrier per stage. Rows past Tk and columns past Dh arrive as zeros,
//   filled by the hardware. Warpgroups 1..NWG (setmaxnreg up to 240) each
//   own 64 query rows: Q is loaded once with 16-byte loads into the same
//   swizzled layout.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory, on
//   the raw bf16 values (every product exact in f32). The online softmax
//   runs on the accumulator fragments: the mask, the row max on the raw S
//   (a quad shuffle), then p = 2^(S c - m c) with c = Dh^-0.5 log2(e) in
//   f32 (one __fmaf_rn, then the MUFU's ex2); m and l stay in registers.
// - O += P V: P is rounded to bf16 and fed from registers as the A operand
//   (the accumulator layout of S is the A-fragment layout, no shuffle); V is
//   an MN-major B operand read through the instruction's transpose bit. l
//   sums the same bf16-rounded P that was multiplied.
// - Overlap: a consumer issues S of tile j and then P V of tile j-1, waits
//   for S alone and runs tile j's softmax while the tensor cores finish
//   P V; the two consumer warpgroups interleave on their own. Once a row's
//   max settles the O rescale is skipped (alpha = 1 for the whole warp).
// - Epilogue: acc / max(l, 1e-30), rounded to bf16, stored into (B, Tq, Hq,
//   Dh). On request (a non-null lse, f32 (B, Hq, Tq)) each row's
//   log-sum-exp m c' + log(max(l, 1e-30)) as well, c' = Dh^-0.5, in natural
//   log units of the scaled scores: what the reference's Pallas kernel
//   returns beside acc as m and l (attn.py:88-115), and what K4' takes to
//   recompute P (flash_attn_bwd_tc.cu). m is the max of the raw S, and l is
//   the kernel's own sum of the bf16-rounded P it multiplied, the l that
//   acc was divided by: exp(S c' - lse) then gives each key the weight the
//   output was normalised with (up to P's own bf16 rounding), so the rows
//   of the backward's P sum to 1 as the forward's did. The exact sum differs from it
//   by at most 2^-9 relative (one bf16 rounding a term), 2^-9 in the LSE.
//   The write is after the output's and changes no value of it.
//
// Shared memory (dynamic, above the 48 KB default; the launcher raises the
// limit): Dh <= 64: Q 16 KB + 4 stages of K+V 64 KB; Dh <= 128: 32 KB +
// 128 KB; Dh <= 256 (one consumer warpgroup): 32 KB + 2 stages 128 KB.
// Head widths are padded to 64, 128 or 256 by the TMA's zero fill.
//
// The library is built with --fmad=false; the one FMA of the softmax is
// written as __fmaf_rn (the products are on the tensor cores).

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "tc_ptx.cuh"

namespace {

constexpr float kNeg = -1e30f;

template <int DP, int NWG>
struct Cfg {
  static constexpr int kBK = 64;                  // keys per KV tile
  static constexpr int kChunks = DP / 64;         // 64-column chunks
  static constexpr int kBQ = 64 * NWG;            // query rows per block
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTile = kBK * DP * 2;      // one K or one V tile
  static constexpr int kStages = DP <= 128 ? 4 : 2;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kBarOff = kVOff + kStages * kTile;
  // + 1024 bytes of slack to align the base for the 128-byte swizzle
  static constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;
};


template <int DP, int NWG>
__global__ void __launch_bounds__(384, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int B, int Tq, int Tk, int Hq, int Hkv, int dh,
                float scale_log2, float scale, int causal) {
  using C = Cfg<DP, NWG>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t full = base + C::kBarOff;
  const uint32_t empty = full + 8 * C::kStages;

  // block -> (tile, KV head, batch), the heaviest tiles first
  const int G = Hq / Hkv;
  const Rows rows{G * Tq, Tq};
  const int n_tiles = (rows.total + C::kBQ - 1) / C::kBQ;
  const int x = blockIdx.x / (Hkv * B);
  const int rest = blockIdx.x % (Hkv * B);
  const int hk = rest % Hkv, b = rest / Hkv;
  int tile = x;
  if (causal) {
    if (Tq % C::kBQ == 0) {
      const int per_head = Tq / C::kBQ;
      tile = (x % G) * per_head + per_head - 1 - x / G;
    } else {
      tile = n_tiles - 1 - x;
    }
  }
  const int r_first = tile * C::kBQ;
  const int r_last = min(r_first + C::kBQ, rows.total) - 1;
  const int k_end = causal ? min(Tk, rows.t_max(r_first, r_last) + 1) : Tk;
  constexpr int kBK = C::kBK;           // keys per KV tile
  const int n_kv = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty + 8 * s, ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kTile);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t off = s * C::kTile + c * kBK * kRow;
          tma_load_4d(k_s + off, &k_map, 64 * c, hk, it * kBK, b, full + 8 * s);
          tma_load_4d(v_s + off, &v_map, 64 * c, hk, it * kBK, b, full + 8 * s);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;                  // this warpgroup's 64 rows
  const int lt = threadIdx.x % 128;
  const int warp = lt / 32, lane = lt % 32, grp = lane / 4, tq = lane % 4;
  const int64_t q_row = static_cast<int64_t>(Hq) * dh;

  // Q: 64 rows x DP columns, 16-byte units, zeros past the rows and Dh
  constexpr int kUnits = DP / 8;
  const int wr0 = r_first + 64 * cw;      // first row of this warpgroup
  for (int i = lt; i < 64 * kUnits; i += 128) {
    const int r = i / kUnits, u = i % kUnits;
    const int row = wr0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < rows.total && 8 * u < dh) {
      const int g = row / Tq, t = row % Tq;
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<int64_t>(b) * Tq + t) * q_row
          + static_cast<int64_t>(hk * G + g) * dh + 8 * u);
    }
    *reinterpret_cast<uint4*>(
        smem + (q_s - base) + swz(64 * cw + r, u, C::kBQ * kRow)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + cw, 128);

  // the two rows of this thread's fragments, and the warpgroup's extent
  const int my_row[2] = {wr0 + 16 * warp + grp, wr0 + 16 * warp + grp + 8};
  int t_of[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) t_of[h] = my_row[h] % Tq;
  const bool live = wr0 < rows.total;
  const int wr1 = min(wr0 + 63, rows.total - 1);
  const int wt_max = live ? rows.t_max(wr0, wr1) : -1;
  const int wt_min = live ? rows.t_min(wr0, wr1) : 0;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const uint32_t q_wg = q_s + 64 * cw * kRow;

  auto wait_full = [&](int it) {
    mbar_wait(full + 8 * (it % C::kStages), (it / C::kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % C::kStages));
  };
  // S = Q K^T of KV tile `it`, issued and committed as one group
  constexpr int kS = kBK / 2;            // S fragment registers
  constexpr int kP = kBK / 16;           // 16-key slices of P
  auto issue_qk = [&](int it, float (&sc)[kS]) {
    const uint32_t ks = k_s + (it % C::kStages) * C::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(sc, desc_k_major(q_wg, C::kBQ * kRow, kk),
               desc_k_major(ks, kBK * kRow, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of KV tile `it`, issued and committed as one group
  auto issue_pv = [&](int it, const uint32_t (&pa)[kP][4]) {
    const uint32_t vs = v_s + (it % C::kStages) * C::kTile;
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
      wgmma_rs(acc, pa[kk], desc_mn_major(vs, kBK * kRow, kk));
    wgmma_commit();
  };
  // mask S of tile `it` in place, update the running max m (in S's raw
  // units) and take S to p = 2^(S c - m c) in f32, c = Dh^-0.5 log2(e), one
  // rounding by __fmaf_rn; alpha rescales what was accumulated before this
  // tile. Element i of the fragment is row my_row[(i >> 1) & 1], key
  // k0 + 8 (i / 4) + 2 tq + (i & 1)
  auto softmax = [&](int it, float (&sc)[kS], float (&alpha)[2]) {
    const int k0 = it * kBK;
    const bool mask = k0 + kBK > Tk || (causal && k0 + kBK - 1 > wt_min);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int h = (i >> 1) & 1;
      if (mask) {
        const int kpos = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        if (kpos >= Tk || (causal && kpos > t_of[h])) sc[i] = kNeg;
      }
      mx[h] = fmaxf(mx[h], sc[i]);
    }
    float mc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2((m[h] - m_new) * scale_log2);
      m[h] = m_new;
      mc[h] = m_new * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < kS; ++i)
      sc[i] = ex2(__fmaf_rn(sc[i], scale_log2, -mc[(i >> 1) & 1]));
  };
  // P in bf16 as the A fragments of the tile's four 16-key slices; l sums
  // the rounded values, acc and l are rescaled by alpha
  auto to_p = [&](const float (&sc)[kS], const float (&alpha)[2],
                  uint32_t (&pa)[kP][4]) {
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        pa[kk][e] = pack_bf16(sc[i], sc[i + 1], ps[e & 1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
    // once the running max settles, alpha is 1 for whole warps
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  };

  // The KV tiles this warpgroup computes: a prefix of the block's (causal
  // tiles wholly above its rows add nothing). Tile it's softmax runs while
  // the tensor cores do tile it-1's P V: S of tile it is issued first,
  // then P V of tile it-1, and the wait for the older group returns S.
  // P and the rescale of acc wait for P V to finish.
  const int n_act = !live ? 0
                    : causal ? min(n_kv, wt_max / kBK + 1) : n_kv;
  float sc[kS] = {};
  uint32_t pa[kP][4];
  float alpha[2];
  if (n_act > 0) {
    wait_full(0);
    issue_qk(0, sc);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, sc, alpha);
    to_p(sc, alpha, pa);
    for (int it = 1; it < n_act; ++it) {
      wait_full(it);
      issue_qk(it, sc);
      issue_pv(it - 1, pa);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(it, sc, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(it - 1);
      to_p(sc, alpha, pa);
    }
    wgmma_fence();
    issue_pv(n_act - 1, pa);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release(n_act - 1);
  }
  for (int it = n_act; it < n_kv; ++it) {   // tiles this warpgroup skips
    wait_full(it);
    release(it);
  }

  // epilogue: acc / max(l, 1e-30) in bf16; element i is row
  // my_row[(i >> 1) & 1], column 8 (i / 4) + 2 tq + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = my_row[h];
    if (row >= rows.total) continue;
    __nv_bfloat16* dst = o + (static_cast<int64_t>(b) * Tq + t_of[h]) * q_row
                         + static_cast<int64_t>(hk * G + row / Tq) * dh
                         + 2 * tq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= dh) break;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
    }
    // the row's log-sum-exp, once a quad (its four threads share m and l)
    if (lse != nullptr && tq == 0)
      lse[(static_cast<int64_t>(b) * Hq + hk * G + row / Tq) * Tq + t_of[h]] =
          m[h] * scale + logf(l[h]);
  }
}

// ----------------------------------------------------------------- host


template <int DP, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int Tk, int Hq, int Hkv, int dh, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<DP, NWG>;
  CUtensorMap km, vm;
  int code = encode_map(&km, k, B, Tk, Hkv, dh, C::kBK);
  if (code == 0) code = encode_map(&vm, v, B, Tk, Hkv, dh, C::kBK);
  if (code != 0) return code;
  auto kern = flash_tc_kernel<DP, NWG>;
  static bool ready = false;            // the shared-memory limit, once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int n_tiles = ((Hq / Hkv) * Tq + C::kBQ - 1) / C::kBQ;
  kern<<<n_tiles * Hkv * B, C::kThreads, C::kSmem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, B, Tq, Tk, Hq, Hkv, dh,
      scale * kLog2e, scale, causal);
  return repro_last_error();
}

template <int DP, int NWG>
int info(int* out) {
  using C = Cfg<DP, NWG>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr,
                                                flash_tc_kernel<DP, NWG>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = C::kThreads;
  out[1] = C::kSmem;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = C::kStages;
  out[5] = C::kBK;
  return 0;
}

}  // namespace

// What the instantiation for head width dh launches with: out[0] threads,
// out[1] dynamic shared bytes, out[2] registers a thread at launch (before
// setmaxnreg), out[3] local (spill) bytes a thread, out[4] K/V stages,
// out[5] keys per KV tile.
extern "C" int flash_attn_tc_info(int dh, int* out) {
  if (dh <= 64) return info<64, 2>(out);
  if (dh <= 128) return info<128, 2>(out);
  return info<256, 1>(out);
}

// q (B, Tq, Hq, dh), k and v (B, Tk, Hkv, dh), o like q: contiguous bf16,
// 16-byte aligned. dh % 8 == 0, 8 <= dh <= 256, Hq % Hkv == 0. lse: null,
// or f32 (B, Hq, Tq) for each row's log-sum-exp.
extern "C" int flash_attn_tc_launch(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int B, int Tq, int Tk, int Hq, int Hkv,
                                    int dh, float scale, int causal,
                                    void* stream) {
  if (dh < 8 || dh > 256 || dh % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch<64, 2>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh, scale,
                         causal, s);
  if (dh <= 128)
    return launch<128, 2>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh, scale,
                          causal, s);
  return launch<256, 1>(q, k, v, o, lse, B, Tq, Tk, Hq, Hkv, dh, scale,
                        causal, s);
}
