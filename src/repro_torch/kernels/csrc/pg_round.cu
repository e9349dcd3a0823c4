// K1: the flexible admission rounds of the batched SF-ESP greedy.
//
// Replaces src/repro/kernels/pg/pg.py::batch_round (Pallas body
// _round_kernel) and, with it, the loop that drives it: the reference runs
// every round of a stacked batch inside one lax.while_loop
// (src/repro/core/greedy.py, _greedy_jax_batch and its coupled twin). Per
// instance b and round, over the (T, W) latency-feasibility words (bit k of
// word w is allocation 32w + k) and the round's candidate tasks:
//   cap_ok[a] = all_k grid[a,k] <= (cap_k - occ_k) + 1e-9
//   PG[a]     = primal gradient (pg_grad.cuh)
//   V         = max PG[a] over cap_ok lanes lat-feasible for a candidate
//   tau       = first candidate task whose row attains V
//   best_a    = tau's first lane attaining V
// and V = -inf, tau = 0, best_a = 0 when nothing is feasible.
//
// Two entries share the round's device code (round_pick), so they cannot
// drift apart:
//
// * pg_round_launch — the Pallas kernel's contract, one round: packed words
//   and the alive mask in, (V, tau, best_a) per instance out. One block an
//   instance. It lies on no path; it is held against the JAX kernel through
//   its plain version, and against that plain version on the card.
// * pg_solve_launch — the path's entry: ALL flexible rounds of a stacked
//   batch, coupled or not, to convergence, in ONE launch. It leaves the
//   state repro_torch/core/greedy.py's host loop leaves (admitted,
//   alloc_idx, occupied and, coupled, the link budget used), bit for bit,
//   and each coupling group's round count.
//
// The round, word-parallel (the algorithm of the plain torch round and of
// the reference's jnp round; no per-bit loop):
//   1. OR the words of the candidate tasks (column any);
//   2. V = max score over the lanes in (OR and cap_ok), score = PG where
//      cap_ok else -inf;
//   3. hit = those lanes with score == V, one __ballot_sync a word (a warp
//      covers the 32 lanes of a word; lanes >= A never vote);
//   4. tau = the first candidate whose row meets hit (atomicMin);
//   5. best_a = the first set bit of row_tau & hit (__ffs).
// The round's critical path is a few passes over T*W words and A lanes, not
// the densest thread's bit count.
//
// The solve. One thread-block cluster per coupling group (a cluster of one,
// plain CTAs, when the batch is uncoupled); the cluster size is fixed per
// launch at min(8, the largest group) and a CTA owns the members r, r + C,
// ... of its group, in ascending batch order (the coupled solve's
// first-cell tie-break). Each CTA packs its cells' lat_ok rows (bool, as the
// DeviceStack holds them) into words in shared memory once, 16 bytes a
// load, and stages the grid with cp.async; per cell it keeps the score, the
// occupancy, the pool terms, the alive mask and the link loads in shared
// memory, beside the group's rows and link lists, so a round reads no
// global memory; it recomputes the score only after the cell admits
// (nothing else moves it). A CTA is four warps held to 64 registers, so
// eight fit an SM and many clusters run at once: the rounds are a chain
// of latencies, and more groups in flight hide them.
// Each round every CTA picks its cells' (V, tau, best_a), publishes its best
// (V, member) to the cluster, and after one cluster barrier every CTA reads
// the group's pick through distributed shared memory: the first member
// attaining the group max admits, a cell with V = -inf retires (alive &=
// V > -inf). Every CTA keeps the group's link budget used in its own shared
// memory and applies the same update — one f32 add of load[b, tau] on each
// link the admitting cell traverses, exact because the plain loop's sum
// over B has one nonzero addend per link and round (one cell of a group
// admits, and a link's users are all in one group) — so no second barrier
// is needed. link_ok is load <= min_links(cap - used) + 1e-9 in the plain
// loop's f32 order. A group stops when the round's pick is -inf everywhere,
// that is when none of its cells has a candidate left; the published picks
// are double-buffered, so a CTA may write round r + 1's while a peer still
// reads round r's.
//
// Arithmetic. PG and cap_ok come from pg_grad.cuh, shared with K2's round:
// the plain formula's order in correctly rounded intrinsics, built with
// --fmad=false. Selection compares and copies. So every output equals the
// plain PyTorch version bit for bit.
//
// Bound. The solve must read the (B, T, A) bool mask once, alive0 and load,
// the grid, the (B, m) pool state and the link budgets, and write the
// state once: about 5.1 MB at the serving shape (B = 256, T = 64, A = 300),
// 1.5 us of HBM time on an H100. Its rounds are a chain of barriers (five
// CTA barriers a cell a round and one cluster barrier), about 21 at that
// shape; the chain, not the bytes, sets the time, and this design's gain
// over the host loop is the ~30 launches and the host round trip each
// round cost there.

#include <climits>
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "pg_grad.cuh"

namespace cg = cooperative_groups;

// The solve's tables, state and scratch; mirrored field for field by a
// ctypes.Structure in kernels/pg/pg.py (batch_solve). Outside the anonymous
// namespace: the exported launcher takes it.
struct SolveArgs {
  const uint8_t* lat_ok;     // (B, T, A) bool
  const uint8_t* alive0;     // (B, T) bool
  const float* load;         // (B, T) link load (coupled)
  const float* grid;         // (A, m)
  const float* price;        // (B, m)
  const float* cap;          // (B, m)
  const float* link_cap;     // (L,) (coupled)
  const int* grp_rows;       // (B,) batch rows, group by group, ascending
  const int* grp_off;        // (G + 1,)
  const int* lnk_ids;        // each group's links, group by group
  const int* lnk_off;        // (G + 1,)
  const int* cell_lnk;       // each row's links, as indices into its group's
  const int* cell_lnk_off;   // (B + 1,)
  uint8_t* admitted;         // (B, T) out
  int* alloc_idx;            // (B, T) out
  float* occupied;           // (B, m) out
  float* used;               // (L,) out, zeroed by the caller (coupled)
  int* rounds;               // (G,) out: the rounds each group ran (-1:
                             // the loop outran its n*T bound, a fault)
  float* score_scratch;      // (B, 3A) where the scores do not fit
  uint32_t* word_scratch;    // (B, T, W) where the words do not fit
  long long* info;           // host (kInfo,), may be null: the launch plan
  // device (2 + kTracePoints * trace_rounds,), may be null: CTA 0's
  // %globaltimer at entry, after the prologue and at kTracePoints points of
  // each of its first trace_rounds rounds (a diagnostic; off by default)
  long long* trace;
  int B, T, A, m, W, G, coupled, cluster, max_members, max_links,
      max_cell_links, trace_rounds;
};

namespace {

constexpr int kThreads = 256;              // the one-round entry's block
constexpr int kWarps = kThreads / 32;
// The solve's block: four warps and at most 64 registers a thread (a few
// bytes spill), so 8 CTAs fit an SM and 124 clusters of 8 the card: a
// serving solve's 32 groups in one wave, the metro day's 768 in seven. A
// block of 256 at 128 registers fit 30 clusters, so 32 groups took two
// waves; 6 or 7 blocks an SM (fewer spills, fewer clusters) were slower on
// the metro day.
constexpr int kSolveThreads = 128;
constexpr int kSolveBlocksPerSM = 8;
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int64_t kSmemBudget = 220 * 1024;  // of the 227 KB a block may use
constexpr int kInfo = 12;
constexpr int kTracePoints = 5;
// shared memory a kernel may take without raising its limit
constexpr int64_t kSmemDefault = 48 * 1024;

// The round's shared scratch besides the OR and hit words.
struct RoundScratch {
  float red[kWarps];
  int tau;
};

struct Pick {
  float v;
  int tau, best;
};

// One CTA's proposal to its group: its best (V, member) of the round, that
// cell's pick, and whether any of its cells had a task alive.
struct Pub {
  float v;
  int member, tau, best, any;
  float load;  // the link load of that cell's task tau (coupled)
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One flexible round over a cell's packed rows ``words`` (T, W), its
// candidate flags ``cand`` (T,) and lane scores ``score`` (A,). On entry
// cand and score are visible to the block (a barrier since they were
// written). Three barriers: after the OR, after V, after hit and tau; every
// warp then finds best_a itself, so every thread returns the same pick
// (right after V when V = -inf). The scratch is reused by the next call:
// each buffer is written only past a barrier after which this call no
// longer reads it (rs.tau is reset in the OR pass, which follows the
// caller's candidate barrier).
template <int NT>
__device__ Pick round_pick(const uint32_t* words, const uint8_t* cand,
                           const float* score, int T, int W, int A,
                           uint32_t* s_or, uint32_t* s_hit,
                           RoundScratch& rs) {
  constexpr int kThreads = NT, kWarps = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. the OR of the candidate rows, a word per warp
  if (tid == 0) rs.tau = INT_MAX;
  for (int w = warp; w < W; w += kWarps) {
    uint32_t acc = 0u;
    for (int t = lane; t < T; t += 32)
      if (cand[t]) acc |= words[static_cast<int64_t>(t) * W + w];
    acc = __reduce_or_sync(0xffffffffu, acc);
    if (lane == 0) s_or[w] = acc;
  }
  __syncthreads();
  // 2. V over the lanes some candidate can take
  float v = -INFINITY;
  for (int a = tid; a < A; a += kThreads)
    if ((s_or[a >> 5] >> (a & 31)) & 1u) v = fmaxf(v, score[a]);
  v = warp_max(v);
  if (lane == 0) rs.red[warp] = v;
  __syncthreads();
  v = rs.red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = fmaxf(v, rs.red[i]);
  if (!(v > -INFINITY)) return Pick{-INFINITY, 0, 0};
  // 3. per word (a warp each): the lanes attaining V, one ballot, and the
  // first candidate whose row meets them (a ballot per 32 tasks)
  for (int w = warp; w < W; w += kWarps) {
    const int a = w * 32 + lane;
    const bool h = a < A && ((s_or[w] >> lane) & 1u) && score[a] == v;
    const uint32_t hw = __ballot_sync(0xffffffffu, h);
    if (lane == 0) s_hit[w] = hw;
    if (!hw) continue;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const bool meet = t < T && cand[t] &&
                        (words[static_cast<int64_t>(t) * W + w] & hw);
      const uint32_t bal = __ballot_sync(0xffffffffu, meet);
      if (bal) {
        if (lane == 0) atomicMin(&rs.tau, t0 + __ffs(bal) - 1);
        break;
      }
    }
  }
  __syncthreads();
  const int tau = rs.tau;
  // 4. best_a: tau's first lane in hit, found by every warp
  const uint32_t* row = words + static_cast<int64_t>(tau) * W;
  int best = 0;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    const uint32_t x = w < W ? (row[w] & s_hit[w]) : 0u;
    const uint32_t any = __ballot_sync(0xffffffffu, x != 0u);
    if (any) {
      const int src = __ffs(any) - 1;
      const uint32_t xs = __shfl_sync(0xffffffffu, x, src);
      best = (w0 + src) * 32 + __ffs(xs) - 1;
      break;
    }
  }
  return Pick{v, tau, best};
}

// ------------------------------------------------------- the one-round entry

// Dynamic shared memory of the one-round entry, byte offsets; score < 0:
// the scores go to the global scratch.
struct RoundLayout {
  int64_t terms, score, or_, hit, cand, bytes;
};

__global__ void __launch_bounds__(kThreads)
pg_round_kernel(const uint32_t* __restrict__ bits,
                const uint8_t* __restrict__ alive,
                const float* __restrict__ grid,   // (A, m)
                const float* __restrict__ price,  // (B, m)
                const float* __restrict__ cap,    // (B, m)
                const float* __restrict__ occ,    // (B, m)
                int T, int W, int A, int m, float* __restrict__ v_out,
                int* __restrict__ tau_out, int* __restrict__ a_out,
                float* __restrict__ score_scratch, const RoundLayout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoundScratch rs;
  const int b = blockIdx.x, tid = threadIdx.x;
  float* terms = reinterpret_cast<float*>(smem + L.terms);
  float* score = L.score >= 0 ? reinterpret_cast<float*>(smem + L.score)
                              : score_scratch + static_cast<int64_t>(b) * A;
  uint32_t* s_or = reinterpret_cast<uint32_t*>(smem + L.or_);
  uint32_t* s_hit = reinterpret_cast<uint32_t*>(smem + L.hit);
  uint8_t* cand = smem + L.cand;

  const float* occ_b = occ + static_cast<int64_t>(b) * m;
  pg_pool_fill(terms, price + static_cast<int64_t>(b) * m,
               cap + static_cast<int64_t>(b) * m, occ_b, m, tid, kThreads);
  __syncthreads();
  const PgPool pool = pg_pool_view(terms, occ_b, m);
  for (int a = tid; a < A; a += kThreads) {
    bool ok;
    const float pg = pg_lane(pool, grid + static_cast<int64_t>(a) * m, &ok);
    score[a] = ok ? pg : -INFINITY;
  }
  bool any = false;
  for (int t = tid; t < T; t += kThreads) {
    cand[t] = alive[static_cast<int64_t>(b) * T + t];
    any = any || cand[t];
  }
  Pick p{-INFINITY, 0, 0};
  if (__syncthreads_or(any))
    p = round_pick<kThreads>(bits + static_cast<int64_t>(b) * T * W, cand,
                             score, T, W, A, s_or, s_hit, rs);
  if (tid == 0) {
    v_out[b] = p.v;
    tau_out[b] = p.tau;
    a_out[b] = p.best;
  }
}

RoundLayout round_layout(int T, int W, int A, int m) {
  auto al = [](int64_t x) { return (x + 15) & ~int64_t{15}; };
  RoundLayout L;
  L.terms = 0;
  int64_t off = al(4 * static_cast<int64_t>(pg_terms_floats(m)));
  L.or_ = off;
  off += al(4 * static_cast<int64_t>(W));
  L.hit = off;
  off += al(4 * static_cast<int64_t>(W));
  L.cand = off;
  off += al(T);
  const int64_t score = al(4 * static_cast<int64_t>(A));
  L.score = off + score <= kSmemBudget ? off : -1;
  L.bytes = L.score >= 0 ? off + score : off;
  return L;
}

// --------------------------------------------------------- the whole solve

// Dynamic shared memory of the solve, byte offsets (-1: in global memory).
// Each of the CTA's kmax cell slots is a block of slot_bytes at
// slots + s * slot_bytes holding, at these offsets within it, the pool
// terms, the occupancy, the dirty flag, the alive mask, the link loads
// and, when they fit, the scores and the packed words. The group's rows
// and its members' link lists (g_*) and the link budgets sit beside them.
struct SolveLayout {
  int64_t slots, slot_bytes, terms, occ, dirty, alive, load, score, words;
  int64_t grid, or_, hit, cand, used, lcap, g_rows, g_nlnk, g_lnk, bytes;
  int kmax, cluster, place;  // place: 1 scores, 2 words, 4 grid in shared
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The group's barrier. Every thread arrives with release semantics (the
// default of cluster.sync): a reader's loads of a peer's published pick
// must complete before its arrival, or the peer could overwrite that
// buffer two rounds on, or leave the kernel, while they are in flight.
__device__ __forceinline__ void group_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// OR the set bytes among the first n of v, the flat (t, a) bytes from f on
// of a cell's (T, A) mask, into its words: one atomicOr per word touched.
__device__ __forceinline__ void or_bytes(uint32_t* words, int W, int A,
                                         int f, uint4 v, int n) {
  int t = f / A, a = f - t * A;
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  int cur = -1;
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < n) {
      if ((x[j >> 2] >> (8 * (j & 3))) & 0xffu) {
        const int wi = t * W + (a >> 5);
        if (wi != cur) {
          if (acc) atomicOr(&words[cur], acc);
          cur = wi;
          acc = 0u;
        }
        acc |= 1u << (a & 31);
      }
      if (++a == A) {
        a = 0;
        ++t;
      }
    }
  }
  if (acc) atomicOr(&words[cur], acc);
}

// Four bool bytes (nonzero = true) to four bits, byte j to bit j.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x = __vcmpne4(x, 0u) & 0x01010101u;
  return (x | (x >> 7) | (x >> 14) | (x >> 21)) & 0xfu;
}

// OR 16 mask bytes v, the flat bytes f.. of a cell's (T, A) mask, into its
// words: as one 16-bit mask (one or two atomicOr) where they lie in one
// task row, byte by byte where they cross a row's end.
__device__ __forceinline__ void or_chunk(uint32_t* words, int W, int A,
                                         int f, uint4 v) {
  const int t = f / A, a0 = f - t * A;
  if (a0 + 16 > A) {
    or_bytes(words, W, A, f, v, 16);
    return;
  }
  const uint32_t m16 = nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
                       nibble(v.w) << 12;
  if (!m16) return;
  uint32_t* row = words + t * W + (a0 >> 5);
  const int sh = a0 & 31;
  atomicOr(row, m16 << sh);
  if (sh > 16 && (m16 >> (32 - sh))) atomicOr(row + 1, m16 >> (32 - sh));
}

// Pack a cell's (T, A) bool rows into its zeroed (T, W) words: 16-byte loads
// where the rows are 16-byte aligned, byte loads for the head and the tail.
template <int kThreads>
__device__ __forceinline__ void pack_rows(const uint8_t* __restrict__ p,
                                          int T, int A, int W,
                                          uint32_t* words) {
  const int tid = threadIdx.x;
  const int n = T * A;
  const int head = min(n, static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  const int nvec = (n - head) >> 4;
  const int tail = head + nvec * 16;
  if (tid < head) or_bytes(words, W, A, tid, make_uint4(p[tid], 0, 0, 0), 1);
  if (tail + tid < n)
    or_bytes(words, W, A, tail + tid, make_uint4(p[tail + tid], 0, 0, 0), 1);
  const uint4* src = reinterpret_cast<const uint4*>(p + head);
  for (int i0 = tid; i0 < nvec; i0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < nvec ? __ldg(src + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nvec) or_chunk(words, W, A, head + 16 * i, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kSolveThreads, kSolveBlocksPerSM)
pg_solve_kernel(const SolveArgs a, const SolveLayout L) {
  constexpr int kThreads = kSolveThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoundScratch rs;
  __shared__ Pub s_pub[2];

  const int tid = threadIdx.x, lane = tid & 31;
  const int T = a.T, A = a.A, m = a.m, W = a.W, mcl = a.max_cell_links;
  const int C = L.cluster;
  const int g = blockIdx.x / C;
  const int r = C > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                      : 0;
  int first = g, n = 1, l0 = 0, nl = 0;
  if (a.coupled) {
    first = a.grp_off[g];
    n = a.grp_off[g + 1] - first;
    l0 = a.lnk_off[g];
    nl = a.lnk_off[g + 1] - l0;
  }
  const int k = r < n ? (n - r + C - 1) / C : 0;  // this CTA's cells
  long long* trace = blockIdx.x == 0 && tid == 0 ? a.trace : nullptr;
  auto stamp = [&](int round, int point) {
    if (trace != nullptr && round < a.trace_rounds)
      trace[2 + round * kTracePoints + point] = global_ns();
  };
  if (trace != nullptr) trace[0] = global_ns();
  // the group's rows and each member's links (indices into the group's
  // span), staged once: a round reads no global memory
  int* g_rows = reinterpret_cast<int*>(smem + L.g_rows);
  int* g_nlnk = reinterpret_cast<int*>(smem + L.g_nlnk);
  int* g_lnk = reinterpret_cast<int*>(smem + L.g_lnk);
  auto slot = [&](int s) { return smem + L.slots + s * L.slot_bytes; };
  auto row_of = [&](int s) { return a.coupled ? g_rows[r + s * C] : g; };
  auto words_of = [&](int s, int b) {
    return L.words >= 0
        ? reinterpret_cast<uint32_t*>(slot(s) + L.words)
        : a.word_scratch + static_cast<int64_t>(b) * T * W;
  };
  // a cell's lane scores, then each lane's fixed PG half (value, norm_use)
  auto score_of = [&](int s, int b) {
    return L.score >= 0 ? reinterpret_cast<float*>(slot(s) + L.score)
                        : a.score_scratch + static_cast<int64_t>(b) * 3 * A;
  };
  const float* grid =
      L.grid >= 0 ? reinterpret_cast<const float*>(smem + L.grid) : a.grid;
  uint32_t* s_or = reinterpret_cast<uint32_t*>(smem + L.or_);
  uint32_t* s_hit = reinterpret_cast<uint32_t*>(smem + L.hit);
  uint8_t* cand = smem + L.cand;
  float* used = reinterpret_cast<float*>(smem + L.used);
  float* lcap = reinterpret_cast<float*>(smem + L.lcap);

  // prologue: the grid in flight while the cells' state is set up
  if (L.grid >= 0) {
    float* s_grid = reinterpret_cast<float*>(smem + L.grid);
    for (int i = tid; i < A * m; i += kThreads)
      cp_async4(s_grid + i, a.grid + i);
  }
  if (a.coupled) {
    for (int j = tid; j < n; j += kThreads) {
      const int b = a.grp_rows[first + j];
      const int q0 = a.cell_lnk_off[b], nq = a.cell_lnk_off[b + 1] - q0;
      g_rows[j] = b;
      g_nlnk[j] = nq;
      for (int q = 0; q < nq; ++q) g_lnk[j * mcl + q] = a.cell_lnk[q0 + q];
    }
    for (int j = tid; j < nl; j += kThreads) {
      used[j] = 0.0f;
      lcap[j] = a.link_cap[a.lnk_ids[l0 + j]];
    }
  }
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    const int b = row_of(s);
    float* occ = reinterpret_cast<float*>(slot(s) + L.occ);
    for (int kk = tid; kk < m; kk += kThreads) occ[kk] = 0.0f;
    pg_pool_fill(reinterpret_cast<float*>(slot(s) + L.terms),
                 a.price + static_cast<int64_t>(b) * m,
                 a.cap + static_cast<int64_t>(b) * m, occ, m, tid, kThreads);
    if (tid == 0) *reinterpret_cast<int*>(slot(s) + L.dirty) = 1;
    uint8_t* alive = slot(s) + L.alive;
    float* load = reinterpret_cast<float*>(slot(s) + L.load);
    for (int t = tid; t < T; t += kThreads) {
      const int64_t i = static_cast<int64_t>(b) * T + t;
      alive[t] = a.alive0[i] != 0;
      if (a.coupled) load[t] = a.load[i];
      a.admitted[i] = 0;
      a.alloc_idx[i] = -1;
    }
    uint32_t* words = words_of(s, b);
    for (int i = tid; i < T * W; i += kThreads) words[i] = 0u;
  }
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    const int b = row_of(s);
    pack_rows<kThreads>(a.lat_ok + static_cast<int64_t>(b) * T * A, T, A, W,
                        words_of(s, b));
  }
  if (L.grid >= 0) cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < k; ++s) {  // the lanes' fixed PG halves, once
    float* score = score_of(s, row_of(s));
    const PgPool pool = pg_pool_view(
        reinterpret_cast<const float*>(slot(s) + L.terms),
        reinterpret_cast<const float*>(slot(s) + L.occ), m);
    for (int aa = tid; aa < A; aa += kThreads)
      pg_lane_fixed(pool, grid + static_cast<int64_t>(aa) * m,
                    score + A + aa, score + 2 * A + aa);
  }
  __syncthreads();
  if (trace != nullptr) trace[1] = global_ns();

  int rnd = 0, real = 0;
  while (true) {
    Pub mine{-INFINITY, INT_MAX, 0, 0, 0, 0.0f};
    stamp(rnd, 0);
    for (int s = 0; s < k; ++s) {
      const int b = row_of(s), j = r + s * C;
      unsigned char* blk = slot(s);
      float* terms = reinterpret_cast<float*>(blk + L.terms);
      float* occ = reinterpret_cast<float*>(blk + L.occ);
      int* dirty = reinterpret_cast<int*>(blk + L.dirty);
      uint8_t* alive = blk + L.alive;
      const float* load = reinterpret_cast<const float*>(blk + L.load);
      const uint32_t* words = words_of(s, b);
      float* score = score_of(s, b);
      const bool stale = *dirty != 0;
      if (stale) {  // the cell admitted (or this is round 0): rescore
        const PgPool pool = pg_pool_view(terms, occ, m);
        for (int aa = tid; aa < A; aa += kThreads) {
          bool ok;
          const float pg =
              pg_lane_occ(pool, grid + static_cast<int64_t>(aa) * m,
                          score[A + aa], score[2 * A + aa], &ok);
          score[aa] = ok ? pg : -INFINITY;
        }
      }
      // the candidates: alive, and (coupled) the load fits every link
      float thr = INFINITY;
      if (a.coupled) {
        float h = INFINITY;
        for (int q = 0; q < g_nlnk[j]; ++q) {
          const int l = g_lnk[j * mcl + q];
          h = fminf(h, __fsub_rn(lcap[l], used[l]));
        }
        thr = __fadd_rn(h, 1e-9f);
      }
      bool has = false;
      for (int t = tid; t < T; t += kThreads) {
        const bool al = alive[t] != 0;
        cand[t] = al && (!a.coupled || load[t] <= thr);
        has = has || al;
      }
      const bool any = __syncthreads_or(has);
      if (stale && tid == 0) *dirty = 0;
      if (s == 0) stamp(rnd, 1);
      if (!any) continue;
      const Pick p = round_pick<kThreads>(words, cand, score, T, W, A, s_or,
                                          s_hit, rs);
      mine.any = 1;
      if (!(p.v > -INFINITY)) {  // nothing feasible: the cell retires
        for (int t = tid; t < T; t += kThreads) alive[t] = 0;
      } else if (p.v > mine.v) {  // members ascend with s: first max kept
        mine = Pub{p.v, j, p.tau, p.best, 1, a.coupled ? load[p.tau] : 0.0f};
      }
    }

    // the group's pick: one barrier, then every CTA reads every proposal
    if (tid == 0) s_pub[rnd & 1] = mine;
    stamp(rnd, 2);
    group_sync(C);
    Pub w{-INFINITY, INT_MAX, 0, 0, 0, 0.0f};
    if (lane < C) {
      const Pub* src = C > 1
          ? cg::this_cluster().map_shared_rank(&s_pub[rnd & 1], lane)
          : &s_pub[rnd & 1];
      w = *src;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Pub o;
      o.v = __shfl_xor_sync(0xffffffffu, w.v, off);
      o.member = __shfl_xor_sync(0xffffffffu, w.member, off);
      o.tau = __shfl_xor_sync(0xffffffffu, w.tau, off);
      o.best = __shfl_xor_sync(0xffffffffu, w.best, off);
      o.any = __shfl_xor_sync(0xffffffffu, w.any, off);
      o.load = __shfl_xor_sync(0xffffffffu, w.load, off);
      if (o.v > w.v || (o.v == w.v && o.member < w.member)) {
        w.v = o.v;
        w.member = o.member;
        w.tau = o.tau;
        w.best = o.best;
        w.load = o.load;
      }
      w.any |= o.any;
    }
    real += w.any;
    stamp(rnd, 3);
    if (!(w.v > -INFINITY)) break;

    // the admission, applied by the owner; the link update by every CTA
    if (w.member % C == r) {
      const int bs = a.coupled ? g_rows[w.member] : g;
      unsigned char* blk = slot(w.member / C);
      float* terms = reinterpret_cast<float*>(blk + L.terms);
      float* occ = reinterpret_cast<float*>(blk + L.occ);
      for (int kk = tid; kk < m; kk += kThreads) {
        const float o =
            __fadd_rn(occ[kk], grid[static_cast<int64_t>(w.best) * m + kk]);
        occ[kk] = o;
        pg_term_update(terms, m, kk, terms[m + kk], o);
      }
      if (tid == 0) {
        const int64_t i = static_cast<int64_t>(bs) * T + w.tau;
        a.admitted[i] = 1;
        a.alloc_idx[i] = w.best;
        (blk + L.alive)[w.tau] = 0;
        *reinterpret_cast<int*>(blk + L.dirty) = 1;
      }
    }
    if (a.coupled && k > 0) {
      for (int q = tid; q < g_nlnk[w.member]; q += kThreads) {
        const int l = g_lnk[w.member * mcl + q];
        used[l] = __fadd_rn(used[l], w.load);
      }
    }
    __syncthreads();
    stamp(rnd, 4);
    // every round but the last admits one of the group's n*T tasks: a
    // longer run is a fault, reported as -1 rounds rather than spinning
    if (++rnd > n * T) {
      real = -1;
      break;
    }
  }

  // epilogue: the state out, once
  for (int s = 0; s < k; ++s) {
    const int b = row_of(s);
    const float* occ = reinterpret_cast<const float*>(slot(s) + L.occ);
    for (int kk = tid; kk < m; kk += kThreads)
      a.occupied[static_cast<int64_t>(b) * m + kk] = occ[kk];
  }
  if (r == 0) {
    for (int j = tid; j < nl; j += kThreads)
      a.used[a.lnk_ids[l0 + j]] = used[j];
    if (tid == 0) a.rounds[g] = real;
  }
  group_sync(C);  // no CTA leaves while a peer may still read its proposal
}

// The solve's shared memory plan: the fixed part, then the words, the
// scores and the grid, each where it still fits the budget (the words are
// read three times a round, the scores twice, the grid only on an
// admission).
SolveLayout solve_layout(const SolveArgs& a, int C) {
  auto al = [](int64_t x) { return (x + 15) & ~int64_t{15}; };
  SolveLayout L{};
  L.cluster = C;
  L.kmax = a.coupled ? (a.max_members + C - 1) / C : 1;
  const int64_t T = a.T, A = a.A, m = a.m, W = a.W;
  int64_t off = 0;
  L.or_ = off;
  off += al(4 * W);
  L.hit = off;
  off += al(4 * W);
  L.cand = off;
  off += al(T);
  L.used = off;
  off += al(4 * static_cast<int64_t>(a.max_links));
  L.lcap = off;
  off += al(4 * static_cast<int64_t>(a.max_links));
  const int64_t members = a.coupled ? a.max_members : 0;
  L.g_rows = off;
  off += al(4 * members);
  L.g_nlnk = off;
  off += al(4 * members);
  L.g_lnk = off;
  off += al(4 * members * a.max_cell_links);
  int64_t slot = 0;
  L.terms = slot;
  slot += al(4 * static_cast<int64_t>(pg_terms_floats(a.m)));
  L.occ = slot;
  slot += al(4 * m);
  L.dirty = slot;
  slot += 16;
  L.alive = slot;
  slot += al(T);
  L.load = slot;
  slot += a.coupled ? al(4 * T) : 0;
  const int64_t words = al(4 * T * W), score = al(4 * 3 * A),
                grid = al(4 * A * m);
  L.place = 0;
  L.words = L.score = L.grid = -1;
  if (off + L.kmax * (slot + words) <= kSmemBudget) {
    L.words = slot;
    slot += words;
    L.place |= 2;
  }
  if (off + L.kmax * (slot + score) <= kSmemBudget) {
    L.score = slot;
    slot += score;
    L.place |= 1;
  }
  L.slot_bytes = slot;
  L.slots = off;
  off += L.kmax * slot;
  if (off + grid <= kSmemBudget) {
    L.grid = off;
    off += grid;
    L.place |= 4;
  }
  L.bytes = off;
  return L;
}

void set_info(long long* info, const SolveLayout& L, int blocks,
              long long clusters) {
  if (info == nullptr) return;
  cudaFuncAttributes fa{};
  cudaFuncGetAttributes(&fa, pg_solve_kernel);
  const long long v[kInfo] = {L.bytes, L.cluster, L.kmax, L.place, clusters,
                              blocks, fa.numRegs,
                              static_cast<long long>(fa.localSizeBytes),
                              static_cast<long long>(fa.sharedSizeBytes),
                              kSmemBudget, 0, 0};
  for (int i = 0; i < kInfo; ++i) info[i] = v[i];
}

}  // namespace

extern "C" int pg_round_launch(const void* bits, const void* alive,
                               const void* grid, const void* price,
                               const void* cap, const void* occ, int B,
                               int T, int W, int A, int m, void* v_out,
                               void* tau_out, void* a_out,
                               void* score_scratch, void* stream) {
  if (B <= 0) return 0;
  const RoundLayout L = round_layout(T, W, A, m);
  if (L.score < 0 && score_scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.bytes > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        pg_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pg_round_kernel<<<B, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(grid), static_cast<const float*>(price),
      static_cast<const float*>(cap), static_cast<const float*>(occ), T, W, A,
      m, static_cast<float*>(v_out), static_cast<int*>(tau_out),
      static_cast<int*>(a_out), static_cast<float*>(score_scratch), L);
  return repro_last_error();
}

// 1 when the one-round entry needs a (B, A) float scratch for its scores
// (they do not fit shared memory), else 0.
extern "C" int pg_round_needs_scratch(int T, int W, int A, int m) {
  return round_layout(T, W, A, m).score < 0 ? 1 : 0;
}

// The solve's plan for *args, without launching: writes info as the launch
// would (dynamic smem bytes, cluster, cells a CTA, placement bits, -1,
// blocks, registers, local bytes, static smem, budget). The caller sizes
// the scratch from the placement bits.
extern "C" int pg_solve_plan(SolveArgs* args) {
  const SolveArgs& a = *args;
  const int C = a.coupled ? a.cluster : 1;
  if (C < 1 || C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const SolveLayout L = solve_layout(a, C);
  set_info(a.info, L, a.G * C, -1);
  return repro_last_error();
}

// All flexible rounds of the batch *args names, in one launch on stream.
extern "C" int pg_solve_launch(SolveArgs* args, void* stream) {
  const SolveArgs& a = *args;
  if (a.G <= 0) return 0;
  const int C = a.coupled ? a.cluster : 1;
  if (C < 1 || C > kMaxCluster || a.T <= 0 || a.A <= 0 || a.m <= 0 ||
      a.W * 32 < a.A)
    return static_cast<int>(cudaErrorInvalidValue);
  const SolveLayout L = solve_layout(a, C);
  if (L.bytes > kSmemBudget) {  // even the fixed part does not fit
    set_info(a.info, L, a.G * C, 0);
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  if ((L.score < 0 && a.score_scratch == nullptr) ||
      (L.words < 0 && a.word_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.bytes > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        pg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.G) * C);
  cfg.blockDim = dim3(kSolveThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(L.bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  long long clusters = -1;
  if (C > 1) {
    int nc = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&nc, pg_solve_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    clusters = nc;
    if (nc == 0) {  // refused: the wrapper raises with these numbers
      set_info(a.info, L, a.G * C, 0);
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
  }
  set_info(a.info, L, a.G * C, clusters);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pg_solve_kernel, a, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro_last_error();
}
