// K4', bf16 route: the gradient of K4 (causal or non-causal GQA flash
// attention) on Hopper's tensor cores, for bf16 q, k, v with Dh % 8 == 0 and
// Dh <= 256 (padded to DP = 64, 128 or 256). float32, other bf16 widths and
// Dh 257-512 keep the CUDA-core kernel in flash_attn_bwd.cu (see
// kernels/attn/attn.py::bwd_route).
//
// Replaces the reference's gradient of its training attention, the
// recompute VJP of the jnp chunked flash attention
// (src/repro/models/attention.py:79-174); the Pallas K4
// (src/repro/kernels/attn/attn.py::flash_attention_fwd) has no VJP. It
// computes K4's gradient as kernels/attn/attn.py::flash_attention_bwd_ref
// defines it: with c = Dh^-0.5, masked scores NEG (kpos <= t when causal, no
// offset), query head h on KV head h / G, and the forward's per-row
// log-sum-exp (K4 writes it, flash_attn_tc.cu),
//
//   P = exp(S c - lse),  D = rowsum(dO o O)  (O the bf16 output),
//   dV = P^T dO,  dS = P o (dO V^T - D),  dQ = c dS K,  dK = c dS^T Q,
//
// dK and dV summed over the G query heads of each KV head.
//
// Bound. At chatglm3-6b's training shape (B = 2, T = 2048, 32 query over 2
// KV heads, Dh = 128, causal) the function is five products of 2 Dh flops a
// visible (query, key) pair: 172 GFLOP, 0.174 ms at the H100's 989 TFLOP/s
// of dense bf16; this design does seven (S and dP in both passes below):
// 241 GFLOP, 0.244 ms. q, k, v, O, dO read and dq, dk, dv written once are
// 88 MB, 26 us at 3.35 TB/s. gemma3-12b's global layers (2, 2048, 16 over 8
// heads, Dh = 256) are the same 172 GFLOP (241 in this design) and 201 MB,
// 60 us. Operations bound both, and only wgmma reaches that roof: every
// product is wgmma.mma_async with f32 accumulators on tiles loaded by TMA.
//
// Passes, each a launch, run in this order on one stream, no atomics (a
// repeat is bit for bit):
//   0 dQ: the forward's structure. A block owns one (b, KV head, row tile)
//     of the KV head's G query heads flattened head-major (row
//     r = g Tq + t; consumer warpgroups of 64 rows: three at DP <= 128, two
//     at DP 256) and loops over the key tiles it can see (causal: to the
//     diagonal; heaviest tiles first). Its consumers load Q and dO once
//     into the 128-byte swizzle and, from the same dO units and O's, each
//     row's D = rowsum(dO o O) (f32, written to (B, Hq, Tq) for pass 1); a
//     producer warpgroup keeps a ring of K and V tiles in flight by TMA. Per
//     tile: S = Q K^T and dP = dO V^T (wgmma_ss, both K-major), then
//     P = 2^(S c log2e - lse log2e) and dS = P o (dP - D) on the fragments,
//     dS rounded to bf16 and fed from registers to dQ += dS K (wgmma_rs, K
//     an MN-major B operand through the transpose bit, as V is in the
//     forward). The consumers share each K/V tile that is loaded.
//   1 dK/dV: a block owns keys of one (b, KV head) and one group of the KV
//     head's query heads, K and V loaded once by TMA, and loops over the
//     (query head, 64-row query tile) items that can see its keys; the
//     producer streams Q and dO by TMA and each tile's lse and D into
//     shared memory. Per item, S^T = K Q^T and dP^T = V dO^T (wgmma_ss),
//     P^T and dS^T on the fragments, then dV += P^T dO and dK += dS^T Q (dO
//     and Q MN-major). At DP <= 128 the block owns 128 keys, 64 a consumer
//     warpgroup, and each consumer feeds its P^T and dS^T from registers
//     (wgmma_rs), 4 stages. At DP 256 a consumer's dK and dV of 64 keys
//     would be 256 accumulator registers, over the 255 a thread may hold,
//     so the head is split: the block owns 64 keys and two consumers share
//     them. Each computes S^T and dP^T for 32 of the item's 64 query
//     columns (16 + 16 registers), writes its P^T and dS^T in bf16 to
//     shared memory (8 KiB each, the 128-byte swizzle), and after a named
//     barrier computes dV and dK for its 128 of the head's 256 columns from
//     the whole P^T and dS^T (wgmma_ss_mn; 64 + 64 registers), 2 stages. The
//     group's share goes to f32 scratch (groups, B, Tk, Hkv, Dh).
//   2 reduce: dK = c sum, dV = sum over the groups of the scratch, in
//     order, rounded to bf16.
//
// Grid of the dK/dV pass. One block per (b, KV head, key tile) would give
// chatglm3's shape 2 x 2 x 16 = 64 blocks for 132 SMs, and the causal first
// key tile twice the mean work. So the G query heads of a KV head are split
// into groups: the largest divisor of G that is at most 4 (chatglm3 and
// qwen3-moe: 4 groups of 4 heads, 256 blocks; gemma3: 2 groups of 1 head,
// 32 key tiles of 64, 1024 blocks). Each group's f32 partials cost
// 2 x 4 x (B Tk Hkv Dh) bytes written and read once: 34 MB, ~20 us at 4
// groups, against 268 MB (~80 us, half the bound) at a group per query
// head. The heaviest key tiles (causal: the first) are launched first.
//
// Rounding. P^T and dS^T (dK/dV pass) and dS (dQ pass) are rounded to bf16
// before their products, as the forward rounds P: about 2^-9.8 of a row's
// rms per output element, which chip_smoke.py's K4B_TC_TOL covers.
//
// Tiles, shared memory (dynamic; the launcher raises the limit) and
// registers, for Dh padded to DP = 64, 128 or 256 by the TMA's zero fill
// (setmaxnreg moves registers from the producer warpgroup to the consumers;
// the launch gives each thread 65536 / threads, rounded down to 8):
//   dQ:    Q and dO 2 x BQ x DP x 2 B + a ring of K and V tiles BK x DP x 2
//          B each + D (BQ x 4 B). DP <= 128: BQ = 192 (three consumers),
//          BK = 64, 3 stages: 96 + 96 KB at DP 128 (48 + 48 KB at DP 64); a
//          consumer holds dQ (DP / 2 f32), S and dP (32 + 32 f32) and the
//          bf16 dS fragments (16): under the 160 registers a consumer gets
//          beside two others (the producer keeps 24). DP 256: BQ = 128 (two
//          consumers), BK = 64 in 1 stage: 128 + 64 KB; a consumer holds
//          dQ (128 f32), S and dP (32 + 32) and dS (16) of its 240
//          registers (the producer keeps 24: 2 x 128 x 240 + 128 x 24 =
//          128 x 3 x 168).
//   dK/dV: DP <= 128: K and V of 128 keys 4 x 64 x DP x 2 B + 4 stages of Q
//          and dO (64 x DP x 2 B each) and of the tile's lse and D (512 B):
//          64 KB + 130 KB at DP 128 (32 + 66 KB at DP 64); a consumer holds
//          dK and dV (2 x DP / 2 f32), S^T and dP^T (64) and the bf16 P^T
//          and dS^T fragments (32): ~220 of its 232 registers at DP 128 (the
//          producer keeps 40: 64 of its threads stage lse and D). DP 256: K
//          and V of 64 keys (64 KB) + 2 stages of Q and dO (128 KB) and of
//          lse and D (1 KB) + P^T and dS^T (16 KB): 209 KB of the 227 KB a
//          block may use; a consumer holds dK and dV for its 128 columns
//          (128 f32) and S^T and dP^T (32) of its 232 registers.
//
// The library is built with --fmad=false; the FMAs it wants are written as
// __fmaf_rn (the products are on the tensor cores).

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "tc_ptx.cuh"

namespace {

// ----------------------------------------------------------------- pass 0

template <int DP>
struct QCfg {
  static constexpr bool kWide = DP == 256;
  static constexpr int kNWG = kWide ? 2 : 3;
  static constexpr int kBK = 64;                  // keys a tile
  static constexpr int kChunks = DP / 64;
  static constexpr int kBQ = 64 * kNWG;           // rows per block
  static constexpr int kThreads = 128 * (kNWG + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kWide ? 240 : 160;
  static constexpr int kQBytes = kBQ * DP * 2;    // Q, and dO after it
  static constexpr int kTile = kBK * DP * 2;      // one K or one V tile
  // the K/V ring; at DP 256 one stage fits beside Q and dO (32-key tiles
  // would fit 2 or 3, and on an H100 at gemma3-12b's shape were no faster:
  // the two consumers' products overlap each other's exponentials)
  static constexpr int kStages = kWide ? 1 : 3;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kDOff = kVOff + kStages * kTile;   // D of the rows
  static constexpr int kBarOff = kDOff + kBQ * 4;
  static constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;
};

template <int DP>
__global__ void __launch_bounds__(QCfg<DP>::kThreads, 1)
bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int B, int Tq, int Tk,
                 int Hq, int Hkv, int dh, float scale_log2, float scale,
                 int causal) {
  using C = QCfg<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + C::kQBytes;
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff;
  float* d_s = reinterpret_cast<float*>(smem + C::kDOff);
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
  constexpr int kBK = C::kBK;
  const int n_kv = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::kNWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(C::kProducerRegs));
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(C::kConsumerRegs));
  const int cw = wg - 1;
  const int lt = threadIdx.x % 128;
  const int warp = lt / 32, lane = lt % 32, grp = lane / 4, tq = lane % 4;
  const int64_t q_row = static_cast<int64_t>(Hq) * dh;

  // Q and dO: 64 rows x DP columns each, 16-byte units, zeros past the
  // rows and Dh; and each row's D = rowsum(dO o O) from the same dO units
  // and O's: an 8-term __fmaf_rn chain a unit, then a shuffle tree over
  // the row's kUnits units (neighbouring lanes), written to shared memory
  // for this pass and to `delta` for the dK/dV pass
  constexpr int kUnits = DP / 8;
  const int wr0 = r_first + 64 * cw;
  for (int i = lt; i < 64 * kUnits; i += 128) {
    const int r = i / kUnits, u = i % kUnits;
    const int row = wr0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), dv = qv, ov = qv;
    int64_t d_at = -1;
    if (row < rows.total) {
      const int g = row / Tq, t = row % Tq;
      d_at = (static_cast<int64_t>(b) * Hq + hk * G + g) * Tq + t;
      if (8 * u < dh) {
        const int64_t at = (static_cast<int64_t>(b) * Tq + t) * q_row
                           + static_cast<int64_t>(hk * G + g) * dh + 8 * u;
        qv = *reinterpret_cast<const uint4*>(q + at);
        dv = *reinterpret_cast<const uint4*>(dout + at);
        ov = *reinterpret_cast<const uint4*>(o + at);
      }
    }
    const uint32_t off = swz(64 * cw + r, u, C::kBQ * kRow);
    *reinterpret_cast<uint4*>(smem + (q_s - base) + off) = qv;
    *reinterpret_cast<uint4*>(smem + (do_s - base) + off) = dv;
    const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&ov);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(hd[e]);
      const float2 y = __bfloat1622float2(ho[e]);
      part = __fmaf_rn(x.x, y.x, part);
      part = __fmaf_rn(x.y, y.y, part);
    }
#pragma unroll
    for (int m = kUnits / 2; m > 0; m /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (u == 0) {
      d_s[64 * cw + r] = part;
      if (d_at >= 0) delta[d_at] = part;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + cw, 128);

  // the two rows of this thread's fragments, their lse (log2 units) and D
  const int my_row[2] = {wr0 + 16 * warp + grp, wr0 + 16 * warp + grp + 8};
  int t_of[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t_of[h] = my_row[h] % Tq;
    lse2[h] = 0.f;
    dd[h] = 0.f;
    if (my_row[h] < rows.total) {
      const int64_t i = (static_cast<int64_t>(b) * Hq + hk * G
                         + my_row[h] / Tq) * Tq + t_of[h];
      lse2[h] = lse[i] * kLog2e;
      dd[h] = d_s[my_row[h] - r_first];
    }
  }
  const bool live = wr0 < rows.total;
  const int wr1 = min(wr0 + 63, rows.total - 1);
  const int wt_max = live ? rows.t_max(wr0, wr1) : -1;
  const int wt_min = live ? rows.t_min(wr0, wr1) : 0;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint32_t q_wg = q_s + 64 * cw * kRow;
  const uint32_t do_wg = do_s + 64 * cw * kRow;

  auto wait_full = [&](int it) {
    mbar_wait(full + 8 * (it % C::kStages), (it / C::kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % C::kStages));
  };
  constexpr int kS = kBK / 2;            // S fragment registers
  constexpr int kP = kBK / 16;           // 16-key slices of dS
  // S = Q K^T and dP = dO V^T of KV tile `it`, committed as one group
  auto issue_sdp = [&](int it, float (&sc)[kS], float (&dp)[kS]) {
    const uint32_t ks = k_s + (it % C::kStages) * C::kTile;
    const uint32_t vs = v_s + (it % C::kStages) * C::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(sc, desc_k_major(q_wg, C::kBQ * kRow, kk),
               desc_k_major(ks, kBK * kRow, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(dp, desc_k_major(do_wg, C::kBQ * kRow, kk),
               desc_k_major(vs, kBK * kRow, kk), kk > 0);
    wgmma_commit();
  };
  // dQ += dS K of KV tile `it` (K MN-major), committed as one group
  auto issue_dq = [&](int it, const uint32_t (&da)[kP][4]) {
    const uint32_t ks = k_s + (it % C::kStages) * C::kTile;
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
      wgmma_rs(acc, da[kk], desc_mn_major(ks, kBK * kRow, kk));
    wgmma_commit();
  };
  // dS = P o (dP - D) of tile `it` into sc, P = 2^(S c log2e - lse log2e),
  // 0 where masked. Element i of a fragment is row my_row[(i >> 1) & 1],
  // key k0 + 8 (i / 4) + 2 tq + (i & 1)
  auto grad = [&](int it, float (&sc)[kS], const float (&dp)[kS]) {
    const int k0 = it * kBK;
    const bool mask = k0 + kBK > Tk || (causal && k0 + kBK - 1 > wt_min);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(__fmaf_rn(sc[i], scale_log2, -lse2[h]));
      float ds = p * (dp[i] - dd[h]);
      if (mask) {
        const int kpos = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        if (kpos >= Tk || (causal && kpos > t_of[h])) ds = 0.f;
      }
      sc[i] = ds;
    }
  };
  auto to_frag = [&](const float (&sc)[kS], uint32_t (&da)[kP][4]) {
#pragma unroll
    for (int kk = 0; kk < kP; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        da[kk][e] = pack2_bf16(sc[i], sc[i + 1]);
      }
  };

  // the key tiles this warpgroup sees: a prefix of the block's
  const int n_act = !live ? 0
                    : causal ? min(n_kv, wt_max / kBK + 1) : n_kv;
  float sc[kS] = {}, dp[kS] = {};
  uint32_t da[kP][4];
  for (int it = 0; it < n_act; ++it) {
    wait_full(it);
    issue_sdp(it, sc, dp);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grad(it, sc, dp);
    to_frag(sc, da);
    wgmma_fence();
    issue_dq(it, da);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    release(it);
  }
  for (int it = n_act; it < n_kv; ++it) {   // tiles this warpgroup skips
    wait_full(it);
    release(it);
  }

  // epilogue: c dQ in bf16; element i is row my_row[(i >> 1) & 1], column
  // 8 (i / 4) + 2 tq + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = my_row[h];
    if (row >= rows.total) continue;
    __nv_bfloat16* dst = dq + (static_cast<int64_t>(b) * Tq + t_of[h]) * q_row
                         + static_cast<int64_t>(hk * G + row / Tq) * dh
                         + 2 * tq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= dh) break;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------- pass 1

// DP <= 128: 128 keys a block, 64 a consumer, each consumer computing S^T
// and dP^T for the whole of an item and feeding P^T and dS^T from its
// registers. DP 256 (kSplit): 64 keys a block, shared by both consumers,
// each computing S^T and dP^T for half of an item's query columns and dK
// and dV for half of the head's columns; P^T and dS^T exchanged through
// shared memory
template <int DP>
struct KvCfg {
  static constexpr bool kSplit = DP == 256;
  static constexpr int kNWG = 2;
  static constexpr int kKeys = kSplit ? 64 : 128;  // keys a block
  static constexpr int kKeyTiles = kKeys / 64;     // 64-key K and V tiles
  static constexpr int kBQ = 64;                   // query rows an item
  static constexpr int kQCols = kSplit ? kBQ / kNWG : kBQ;   // S^T columns
  static constexpr int kCols = kSplit ? DP / kNWG : DP;      // dK/dV columns
  static constexpr int kChunks = DP / 64;
  static constexpr int kThreads = 128 * (kNWG + 1);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kRing = kSplit ? 2 : 4;     // stages of Q and dO
  static constexpr int kTile = 64 * DP * 2;        // one 64-row bf16 tile
  static constexpr int kKOff = 0;                  // K, a tile a 64 keys
  static constexpr int kVOff = kKeyTiles * kTile;  // V
  static constexpr int kQOff = 2 * kKeyTiles * kTile;   // stage s: Q, dO
  static constexpr int kPOff = kQOff + kRing * 2 * kTile;   // P^T, dS^T
  static constexpr int kPTile = 64 * kRow;         // 64 keys x 64 queries
  static constexpr int kRowOff = kPOff + (kSplit ? 2 * kPTile : 0);
  static constexpr int kRowBytes = 2 * kBQ * 4;    // lse (log2 units), D
  static constexpr int kBarOff = kRowOff + kRing * kRowBytes;
  static constexpr int kSmem = 1024 + kBarOff + (2 * kRing + 1) * 8;
};

template <int DP>
__global__ void __launch_bounds__(384, 1)
bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   float* __restrict__ dk_part, float* __restrict__ dv_part,
                   int B, int Tq, int Tk, int Hq, int Hkv, int dh, int groups,
                   float scale_log2, int causal) {
  using C = KvCfg<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* row_s = reinterpret_cast<float*>(smem + C::kRowOff);
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t q_s = base + C::kQOff;
  const uint32_t full = base + C::kBarOff;
  const uint32_t empty = full + 8 * C::kRing;
  const uint32_t kv_bar = empty + 8 * C::kRing;

  // block -> (key tile, group, KV head, batch), key tiles outermost: causal,
  // the first key tile sees the most query tiles, so the heaviest go first
  const int G = Hq / Hkv;
  const int hpg = G / groups;                     // query heads a group
  const int per = groups * Hkv * B;
  const int kt = blockIdx.x / per;
  int rest = blockIdx.x % per;
  const int gi = rest % groups;
  rest /= groups;
  const int hk = rest % Hkv, b = rest / Hkv;
  const int k0 = kt * C::kKeys;
  const int n_qt = (Tq + C::kBQ - 1) / C::kBQ;
  // causal: the query tiles holding a row t >= k0
  const int qt0 = causal ? min(k0 / C::kBQ, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_items = hpg * per_head;
  const int h_first = hk * G + gi * hpg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kRing; ++s) {
      mbar_init(full + 8 * s, 1 + 64);     // the TMA's and 64 row stagers'
      mbar_init(empty + 8 * s, 4 * C::kNWG);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(C::kProducerRegs));
    const int pt = threadIdx.x;
    if (pt == 0) {
      mbar_expect_tx(kv_bar, 2 * C::kKeyTiles * C::kTile);
      for (int w = 0; w < C::kKeyTiles; ++w)
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t off = w * C::kTile + c * 64 * kRow;
          tma_load_4d(k_s + off, &k_map, 64 * c, hk, k0 + 64 * w, b, kv_bar);
          tma_load_4d(v_s + off, &v_map, 64 * c, hk, k0 + 64 * w, b, kv_bar);
        }
    }
    if (pt < 64) {
      for (int it = 0; it < n_items; ++it) {
        const int s = it % C::kRing;
        const int hq = h_first + it / per_head;
        const int t0 = (qt0 + it % per_head) * C::kBQ;
        mbar_wait(empty + 8 * s, ((it / C::kRing) & 1) ^ 1);
        if (pt == 0) {
          const uint32_t qs = q_s + s * 2 * C::kTile;
          mbar_expect_tx(full + 8 * s, 2 * C::kTile);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(qs + c * 64 * kRow, &q_map, 64 * c, hq, t0, b,
                        full + 8 * s);
            tma_load_4d(qs + C::kTile + c * 64 * kRow, &do_map, 64 * c, hq,
                        t0, b, full + 8 * s);
          }
        }
        const int t = t0 + pt;
        float l2 = 0.f, d = 0.f;
        if (t < Tq) {
          const int64_t i = (static_cast<int64_t>(b) * Hq + hq) * Tq + t;
          l2 = lse[i] * kLog2e;
          d = delta[i];
        }
        row_s[s * 2 * C::kBQ + pt] = l2;
        row_s[s * 2 * C::kBQ + C::kBQ + pt] = d;
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(C::kConsumerRegs));
  const int cw = wg - 1;
  const int lt = threadIdx.x % 128;
  const int warp = lt / 32, lane = lt % 32, grp = lane / 4, tq = lane % 4;
  // this consumer's keys (kw0..kw0 + 63), S^T columns (qc0..) and dK/dV
  // columns (dc0..): split, the block's keys, half the item, half the head
  const int kw0 = k0 + (C::kSplit ? 0 : 64 * cw);
  const int qc0 = C::kSplit ? C::kQCols * cw : 0;
  const int dc0 = C::kSplit ? C::kCols * cw : 0;
  const int row[2] = {16 * warp + grp, 16 * warp + grp + 8};
  const int my_key[2] = {kw0 + row[0], kw0 + row[1]};
  const bool live = kw0 < Tk;
  const uint32_t k_wg = k_s + (C::kSplit ? 0 : cw * C::kTile);
  const uint32_t v_wg = v_s + (C::kSplit ? 0 : cw * C::kTile);

  float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[C::kQCols / 2] = {}, dpt[C::kQCols / 2] = {};
  uint32_t pa[C::kQCols / 16][4], da[C::kQCols / 16][4];
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_items; ++it) {
    const int s = it % C::kRing;
    const int t0 = (qt0 + it % per_head) * C::kBQ;
    mbar_wait(full + 8 * s, (it / C::kRing) & 1);
    // causal items wholly above this consumer's keys add nothing (split,
    // none is: 64-key blocks on 64-row tiles, so both consumers reach the
    // named barriers below)
    if (!live || (causal && t0 + C::kBQ - 1 < kw0)) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      continue;
    }
    const uint32_t qs = q_s + s * 2 * C::kTile;
    const uint32_t dos = qs + C::kTile;
    // S^T = K Q^T and dP^T = V dO^T for this consumer's query columns, both
    // operands K-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(st, desc_k_major(k_wg, 64 * kRow, kk),
               desc_k_major(qs + qc0 * kRow, 64 * kRow, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(dpt, desc_k_major(v_wg, 64 * kRow, kk),
               desc_k_major(dos + qc0 * kRow, 64 * kRow, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // P^T = 2^(S^T c log2e - lse log2e) and dS^T = P^T o (dP^T - D), 0
    // where masked, as bf16 pairs; element i is key my_key[(i >> 1) & 1],
    // query t0 + qc0 + 8 (i / 4) + 2 tq + (i & 1)
    const float* rs = row_s + s * 2 * C::kBQ;
    const bool mask = t0 + C::kBQ > Tq || (causal && kw0 + 63 > t0 + qc0);
#pragma unroll
    for (int kk = 0; kk < C::kQCols / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int col = qc0 + 8 * (i / 4) + 2 * tq;
        const int key = my_key[(i >> 1) & 1];
        const float2 l2 = *reinterpret_cast<const float2*>(rs + col);
        const float2 d2 = *reinterpret_cast<const float2*>(rs + C::kBQ + col);
        float p[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          p[x] = ex2(__fmaf_rn(st[i + x], scale_log2, x ? -l2.y : -l2.x));
          if (mask) {
            const int t = t0 + col + x;
            if (t >= Tq || (causal && key > t)) p[x] = 0.f;
          }
          ds[x] = p[x] * (dpt[i + x] - (x ? d2.y : d2.x));
        }
        pa[kk][e] = pack2_bf16(p[0], p[1]);
        da[kk][e] = pack2_bf16(ds[0], ds[1]);
      }
    if constexpr (C::kSplit) {
      // both consumers are past the previous item's dV/dK products (each
      // waited on its own before this barrier): P^T and dS^T may be replaced
      named_sync(1, 256);
#pragma unroll
      for (int kk = 0; kk < C::kQCols / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const int r = row[(i >> 1) & 1];
          const int col = qc0 + 8 * (i / 4) + 2 * tq;
          const uint32_t off = r * kRow + ((((col >> 3) ^ (r & 7))) << 4)
                               + (col & 7) * 2;
          *reinterpret_cast<uint32_t*>(smem + C::kPOff + off) = pa[kk][e];
          *reinterpret_cast<uint32_t*>(smem + C::kPOff + C::kPTile + off) =
              da[kk][e];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(2, 256);
      // dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]:
      // P^T and dS^T K-major, dO and Q MN-major, from this consumer's two
      // 64-column chunks
      const uint32_t half = dc0 * kRow;
      const uint32_t pt_s = base + C::kPOff, dst_s = pt_s + C::kPTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_mn(dv, desc_k_major(pt_s, 64 * kRow, kk),
                    desc_mn_major(dos + half, 64 * kRow, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_mn(dk, desc_k_major(dst_s, 64 * kRow, kk),
                    desc_mn_major(qs + half, 64 * kRow, kk));
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers, dO and
      // Q MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv, pa[kk], desc_mn_major(dos, 64 * kRow, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk, da[kk], desc_mn_major(qs, 64 * kRow, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(da);
    }
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // the group's share, f32 (groups, B, Tk, Hkv, Dh); element i is key
  // my_key[(i >> 1) & 1], column dc0 + 8 (i / 4) + 2 tq + (i & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = my_key[h];
    if (key >= Tk) continue;
    const int64_t at = (((static_cast<int64_t>(gi) * B + b) * Tk + key) * Hkv
                        + hk) * dh + dc0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < C::kCols / 8; ++j) {
      if (dc0 + 8 * j >= dh) break;
      *reinterpret_cast<float2*>(dk_part + at + 8 * j) =
          make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv_part + at + 8 * j) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------- pass 2

__global__ void __launch_bounds__(256)
bwd_tc_reduce_kernel(const float* __restrict__ dk_part,
                     const float* __restrict__ dv_part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int64_t n, int groups,
                     float scale) {
  // n = B Tk Hkv Dh, a multiple of 8; four elements a thread a step
  for (int64_t i = 4 * (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x);
       i < n; i += 4 * static_cast<int64_t>(gridDim.x) * 256) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int g = 0; g < groups; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(dk_part + g * n + i);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + g * n + i);
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
    }
    __nv_bfloat162 ko[2] = {__floats2bfloat162_rn(a.x * scale, a.y * scale),
                            __floats2bfloat162_rn(a.z * scale, a.w * scale)};
    __nv_bfloat162 vo[2] = {__floats2bfloat162_rn(c.x, c.y),
                            __floats2bfloat162_rn(c.z, c.w)};
    *reinterpret_cast<uint2*>(dk + i) = *reinterpret_cast<const uint2*>(ko);
    *reinterpret_cast<uint2*>(dv + i) = *reinterpret_cast<const uint2*>(vo);
  }
}

// ----------------------------------------------------------------- host

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;             // written by the dQ pass, read by the dK/dV
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;
  int B, Tq, Tk, Hq, Hkv, dh, groups;
  float scale;
  int causal;
};

template <typename K>
int raise_smem(K kern, int bytes, bool& ready) {
  if (ready) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready = true;
  return 0;
}

template <int DP>
int launch_dq(const Args& a, cudaStream_t stream) {
  using C = QCfg<DP>;
  CUtensorMap km, vm;
  int code = encode_map(&km, a.k, a.B, a.Tk, a.Hkv, a.dh, C::kBK);
  if (code == 0) code = encode_map(&vm, a.v, a.B, a.Tk, a.Hkv, a.dh, C::kBK);
  if (code != 0) return code;
  auto kern = bwd_tc_dq_kernel<DP>;
  static bool ready = false;
  code = raise_smem(kern, C::kSmem, ready);
  if (code != 0) return code;
  const int n_tiles = ((a.Hq / a.Hkv) * a.Tq + C::kBQ - 1) / C::kBQ;
  kern<<<n_tiles * a.Hkv * a.B, C::kThreads, C::kSmem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq), a.B, a.Tq, a.Tk, a.Hq, a.Hkv, a.dh,
      a.scale * kLog2e, a.scale, a.causal);
  return repro_last_error();
}

template <int DP>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  using C = KvCfg<DP>;
  CUtensorMap km, vm, qm, dm;
  int code = encode_map(&km, a.k, a.B, a.Tk, a.Hkv, a.dh, 64);
  if (code == 0) code = encode_map(&vm, a.v, a.B, a.Tk, a.Hkv, a.dh, 64);
  if (code == 0) code = encode_map(&qm, a.q, a.B, a.Tq, a.Hq, a.dh, 64);
  if (code == 0) code = encode_map(&dm, a.dout, a.B, a.Tq, a.Hq, a.dh, 64);
  if (code != 0) return code;
  auto kern = bwd_tc_dkdv_kernel<DP>;
  static bool ready = false;
  code = raise_smem(kern, C::kSmem, ready);
  if (code != 0) return code;
  const int n_kt = (a.Tk + C::kKeys - 1) / C::kKeys;
  kern<<<n_kt * a.groups * a.Hkv * a.B, C::kThreads, C::kSmem, stream>>>(
      km, vm, qm, dm, a.lse, a.delta, a.dk_part, a.dv_part, a.B, a.Tq, a.Tk,
      a.Hq, a.Hkv, a.dh, a.groups, a.scale * kLog2e, a.causal);
  return repro_last_error();
}

template <int DP>
int info(int pass, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (pass == 0) {
    using C = QCfg<DP>;
    err = cudaFuncGetAttributes(&attr, bwd_tc_dq_kernel<DP>);
    out[0] = C::kThreads;
    out[1] = C::kSmem;
    out[4] = C::kStages;
    out[5] = C::kProducerRegs;
    out[6] = C::kConsumerRegs;
    out[7] = C::kBK;
  } else {
    using C = KvCfg<DP>;
    err = cudaFuncGetAttributes(&attr, bwd_tc_dkdv_kernel<DP>);
    out[0] = C::kThreads;
    out[1] = C::kSmem;
    out[4] = C::kRing;
    out[5] = C::kProducerRegs;
    out[6] = C::kConsumerRegs;
    out[7] = C::kKeys;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// the padded head width DP a head of dh (8..256) is computed at
int padded(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

}  // namespace

// What the dQ (pass 0) or dK/dV (pass 1) kernel for head width dh launches
// with: out[0] threads, out[1] dynamic shared bytes, out[2] registers a
// thread at launch (before setmaxnreg), out[3] local (spill) bytes a
// thread, out[4] stages of its ring, out[5] and out[6] the registers
// setmaxnreg leaves the producer and each consumer, out[7] keys a tile (dQ)
// or a block (dK/dV).
extern "C" int flash_attn_bwd_tc_info(int pass, int dh, int* out) {
  if ((pass != 0 && pass != 1) || dh < 8 || dh > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (padded(dh)) {
    case 64: return info<64>(pass, out);
    case 128: return info<128>(pass, out);
    default: return info<256>(pass, out);
  }
}

// One pass of K4's bf16 tensor-core route (0 dQ and D, 1 dK/dV, 2 reduce;
// run in that order on one stream). q, o, dout, dq (B, Tq, Hq, dh); k, v,
// dk, dv (B, Tk, Hkv, dh): contiguous bf16, 16-byte aligned. lse (K4's,
// natural log units of the scaled scores) and delta f32 (B, Hq, Tq);
// dk_part and dv_part f32 (groups, B, Tk, Hkv, dh). dh % 8 == 0,
// 8 <= dh <= 256, Hq % Hkv == 0, (Hq / Hkv) % groups == 0, every dimension
// >= 1.
extern "C" int flash_attn_bwd_tc_launch(
    int pass, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* dk_part, float* dv_part, int B, int Tq, int Tk, int Hq,
    int Hkv, int dh, int groups, float scale, int causal, void* stream) {
  if (pass < 0 || pass > 2 || dh < 8 || dh > 256 || dh % 8 != 0 || Hkv < 1
      || Hq % Hkv != 0 || groups < 1 || (Hq / Hkv) % groups != 0 || B < 1
      || Tq < 1 || Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part,
               B, Tq, Tk, Hq, Hkv, dh, groups, scale, causal};
  auto s = static_cast<cudaStream_t>(stream);
  const int dp = padded(dh);
  if (pass == 0)
    return dp == 64 ? launch_dq<64>(a, s) : dp == 128 ? launch_dq<128>(a, s)
                                                      : launch_dq<256>(a, s);
  if (pass == 1)
    return dp == 64 ? launch_dkdv<64>(a, s)
           : dp == 128 ? launch_dkdv<128>(a, s) : launch_dkdv<256>(a, s);
  const int64_t n = static_cast<int64_t>(B) * Tk * Hkv * dh;
  const int64_t want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  bwd_tc_reduce_kernel<<<blocks, 256, 0, s>>>(
      dk_part, dv_part, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, groups, scale);
  return repro_last_error();
}
