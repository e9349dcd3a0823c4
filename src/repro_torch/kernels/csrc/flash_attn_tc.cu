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
//   Dh).
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

namespace {

constexpr int kRow = 128;            // bytes of one swizzled row (64 bf16)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ----------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// waits for the phase of `parity` to complete; a wait of ~10 s (2^34
// cycles) can only be a lost arrival, and traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one 4-D TMA box (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are pending (the older ones are
// done: groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous product: every later use depends on this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// ... and the A fragments a product in flight still reads
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}


// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

// K-major operand (rows x 64-element chunks, chunk stride `chunk` bytes):
// the 16-deep slice kk starts 32 bytes further along the swizzled row; 8-row
// groups are 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k_major(uint32_t base, int chunk,
                                                 int kk) {
  return smem_desc(base + (kk / 4) * chunk + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (V: keys x 64-element chunks along Dh, chunk stride
// `chunk` bytes): the 16-key slice kk starts 16 rows down; the leading
// offset steps to the next 64 columns, the stride offset to the next 8 keys
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t base, int chunk,
                                                  int kk) {
  return smem_desc(base + kk * 16 * kRow, chunk, 8 * kRow);
}

// byte offset of the 16-byte unit u (of 8 bf16) of row r in a swizzled
// region of rows x 64 columns per chunk (chunk stride `chunk` bytes)
__device__ __forceinline__ uint32_t swz(int r, int u, int chunk) {
  return (u / 8) * chunk + r * kRow + (((u % 8) ^ (r % 8)) << 4);
}

// 2^x, the MUFU approximation (relative error ~2^-22; results below
// 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(p);
  sum += __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. wgmma_ss: A and B from
// shared memory, both K-major (S = Q K^T). wgmma_rs: A from registers, B
// MN-major from shared memory (O += P V). Inline asm names every
// accumulator register.

__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows of one (b, KV head) flattened head-major: row r is query head
// hk * G + r / Tq at position t = r % Tq.
struct Rows {
  int total, Tq;
  // the largest and smallest t among rows [r0, r1] (r1 < total)
  __device__ __forceinline__ int t_max(int r0, int r1) const {
    return r0 / Tq == r1 / Tq ? r1 % Tq : Tq - 1;
  }
  __device__ __forceinline__ int t_min(int r0, int r1) const {
    return r0 / Tq == r1 / Tq ? r0 % Tq : 0;
  }
};

template <int DP, int NWG>
__global__ void __launch_bounds__(384, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ o, int B, int Tq, int Tk,
                int Hq, int Hkv, int dh, float scale_log2, int causal) {
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
  }
}

// ----------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over a contiguous (B, T, H, dh) bf16 tensor, box (64, 1, bk, 1)
// under the 128-byte swizzle; out-of-range elements read as zeros
int encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
               int dh, int bk) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T > 0 ? T : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * dh, 2ull * dh * H,
                                 2ull * dh * H * (T > 0 ? T : 1)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(bk), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DP, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int Hq, int Hkv, int dh, float scale, int causal,
           cudaStream_t stream) {
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
      static_cast<__nv_bfloat16*>(o), B, Tq, Tk, Hq, Hkv, dh, scale * kLog2e,
      causal);
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
// 16-byte aligned. dh % 8 == 0, 8 <= dh <= 256, Hq % Hkv == 0.
extern "C" int flash_attn_tc_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int Tq,
                                    int Tk, int Hq, int Hkv, int dh,
                                    float scale, int causal, void* stream) {
  if (dh < 8 || dh > 256 || dh % 8 != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch<64, 2>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale, causal,
                         s);
  if (dh <= 128)
    return launch<128, 2>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale, causal,
                          s);
  return launch<256, 1>(q, k, v, o, B, Tq, Tk, Hq, Hkv, dh, scale, causal,
                        s);
}
