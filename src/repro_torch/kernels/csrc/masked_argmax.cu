// K2: the single-instance SF-ESP round — masked row max / first argmax, and
// the whole admission round built on it.
//
// Replaces src/repro/kernels/pg/pg.py::masked_argmax (Pallas body _kernel).
// For every task row t, against one shared per-allocation score sel (A,) —
// the primal gradient, or -cost in MinRes mode:
//   score[t,a] = sel[a] if lat_ok[t,a] && cap_ok[a] && alive[t] else -inf
//   g[t]       = max_a score[t,a]
//   idx[t]     = first a attaining g[t]
// and g = -inf, idx = 0 for a row with nothing feasible (jnp's argmax of an
// all -inf row), for a dead row, and for a row whose max is -inf.
//
// Two entries share one row reduction (row_first_max):
//
// * masked_argmax_launch — the Pallas kernel's contract: sel and cap_ok are
//   given.
// * admission_round_launch — one whole admission round of the single-instance
//   solve (repro_torch/core/greedy.py::_round over the pg_argmax inner step),
//   in place on the solve's state (admitted, alloc_idx, occupied, alive). Each
//   block computes the column score itself: the capacity test and the primal
//   gradient of pg_grad.cuh (K1's formula, bit for bit), sel = PG or -cost.
//   Per row it writes best_a (the first max), has = any feasible column, G =
//   has ? PG[best_a] : -inf, and alive &= has. The reference runs the round
//   in one jitted while loop; the port's host loop launches this kernel once
//   per round, where it launched ~82 small kernels before.
//
// Design. The Pallas kernel tiles (256 x 512) blocks and carries (g, idx)
// across the A-grid in its output block, relying on the TPU running the grid
// in order. Hopper runs blocks in no order, so nothing is carried between
// blocks: a TEAM of warps owns one task row and walks the whole of A. The
// scan is a dependent chain of compares per lane, and its length, not the
// bytes, sets the time; so a long row gets four warps while the grid fits
// the SMs, else two or one (team_for: T = 4096 or A = 300 take one). At
// T = 200, A = 1280 a block of 8 warps holds 2 rows, the grid covers 100
// of the card's 132 SMs and a lane visits 10 columns, where one warp a row
// left 25 SMs and each lane 40. The block stages the
// column score in shared memory, kChunk lanes at a time, so A has no upper
// limit; a column that does not fit the capacity is staged as NaN (no
// second array to read). Beside it the team copies its mask row's chunk
// into shared memory, 16 bytes a lane where the row is 16-byte aligned,
// byte by byte for the unaligned head and the tail, then scans it with
// consecutive lanes on consecutive columns (no bank conflicts; a lane that
// scanned its own 16 bytes would put 16 lanes on one bank). Each lane
// keeps a running (max, first index), a branch-free select chain over its
// columns in increasing order, and the warps, then the team, combine under
// the order "greater value wins; on equal values the lower index wins" —
// the sequential first-max, made explicit, so the result does not depend
// on which lane saw what. Columns >= A and rows >= T are never read.
//
// The round's selection across rows needs every row's G. The last block to
// finish takes it: each block publishes its rows, fences, and takes a ticket
// with atomicAdd; the block that draws the last ticket reads all rows past L1
// (volatile), picks tau = the first argmax of G (0 when nothing is alive),
// commits admitted[tau], alloc_idx[tau] and occupied (the reference's
// additions, in its order), clears alive[tau], and resets the ticket for the
// next round on the stream. The ticket lives in the solve's own scratch, so
// solves on other streams do not share it.
//
// Exactness. Selection compares and copies; the gradient is pg_grad.cuh's.
// So g, idx and the whole round's state equal the plain PyTorch versions bit
// for bit. NaN in sel is outside the contract (it would read as a column
// that does not fit): the primal gradient and the cost are finite on the
// grid. has = any feasible column, as the plain round's feas.any; with a
// finite sel it is also g > -inf.
//
// Bound. One call must read the (T, A) mask once (T*A bytes) and the O(A*m)
// column inputs, and write O(T) outputs: 0.26 MB at T = 200, A = 1280, under
// 0.1 us of HBM time on an H100. The round adds A*(10m+8) flops of gradient
// per block and a ticket. At the paper's shapes a launch is far above both:
// the kernel is bound by launch latency, and the round's cost is one launch.

#include <climits>
#include <math.h>

#include "common.cuh"
#include "pg_grad.cuh"

// The round's tables, state and scratch; mirrored by a ctypes.Structure in
// kernels/pg/pg.py (bind_round), which fills it once per solve. Outside the
// anonymous namespace: the exported launcher takes it.
struct RoundArgs {
  const uint8_t* lat_ok;  // (T, A) bool
  const float* grid;      // (A, m)
  const float* price;     // (m,)
  const float* cap;       // (m,)
  const float* cost;      // (A,)
  uint8_t* admitted;      // (T,) bool
  int* alloc_idx;         // (T,)
  float* occupied;        // (m,)
  uint8_t* alive;         // (T,) bool
  float* g;               // (T,) scratch: G where alive after the round
  int* best_a;            // (T,) scratch
  unsigned int* ticket;   // (1,) scratch, 0 between rounds
  int T, A, m, flexible;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2048;             // staged columns: 8 KB of shared
constexpr int kSMs = 132;                // H100 SXM
// dynamic shared memory the round's pool terms may take without raising
// the kernel's limit: the default 48 KB less the row reduction's 25 KB
constexpr size_t kTermsDefault = 16 * 1024;

struct RowBest {
  float v;
  int a;
  bool any;  // some column of the row is feasible
};

// a column that does not fit the capacity is staged as NaN: it compares
// false with everything, so it is never selected, and s == s tells it apart
__device__ __forceinline__ float not_fit() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void combine(RowBest& r, const RowBest& o) {
  if (o.v > r.v || (o.v == r.v && o.a < r.a)) {
    r.v = o.v;
    r.a = o.a;
  }
  r.any = r.any || o.any;
}

// Copy the chunk [base, base + n) of a mask row into shared memory, 16
// bytes a lane where the row is 16-byte aligned, byte by byte for the
// unaligned head and the tail (each under 16 bytes, one a lane). Column j
// lands at s_row[shift + j], shift chosen so the 16-byte stores are
// aligned. Returns shift.
template <int kTeam>
__device__ __forceinline__ int copy_chunk(const uint8_t* __restrict__ row,
                                          int base, int n, uint8_t* s_row,
                                          int tl) {
  const uint8_t* p = row + base;
  const int head = min(n, static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  const int shift = (16 - head) & 15;
  const int nvec = (n - head) >> 4;
  const int tail = head + nvec * 16;
  if (tl < head) s_row[shift + tl] = p[tl];
  if (tail + tl < n) s_row[shift + tail + tl] = p[tail + tl];
  const uint4* src = reinterpret_cast<const uint4*>(p + head);
  uint4* dst = reinterpret_cast<uint4*>(s_row + shift + head);
#pragma unroll 4
  for (int i = tl; i < nvec; i += 32 * kTeam) dst[i] = src[i];
  return shift;
}

// The first max of a task row, scanned by a team of kTeam warps: every
// thread of the block stages columns (stage(col, &ok) returns sel[col] and
// sets ok = cap_ok[col]); each warp reduces its lanes, the team its warps.
// Returns the row's (max, first index, any) on every thread of the team.
template <int kTeam, class Stage>
__device__ __forceinline__ RowBest row_first_max(
    const uint8_t* __restrict__ lat_ok, int A, int row, bool live,
    Stage stage) {
  __shared__ float s_sel[kChunk];
  __shared__ __align__(16) uint8_t s_rows[kWarps / kTeam][kChunk + 16];
  __shared__ RowBest s_red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tl = (warp % kTeam) * 32 + lane;
  uint8_t* s_row = s_rows[warp / kTeam];
  const uint8_t* mask = lat_ok + static_cast<int64_t>(live ? row : 0) * A;
  RowBest r{-INFINITY, INT_MAX, false};
  for (int base = 0; base < A; base += kChunk) {
    const int n = min(kChunk, A - base);
    __syncthreads();  // the previous chunk is consumed by every warp
    const int shift = live ? copy_chunk<kTeam>(mask, base, n, s_row, tl) : 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < n; j += kThreads) {
      bool ok;
      const float v = stage(base + j, &ok);
      s_sel[j] = ok ? v : not_fit();
    }
    __syncthreads();
    if (live) {
      // consecutive lanes on consecutive columns (no bank conflicts); both
      // loads unconditional and a select chain, no branch. A lane visits
      // its columns in increasing order, so "strictly greater" is its
      // first max; the lanes and warps combine under the full order.
#pragma unroll 4
      for (int j = tl; j < n; j += 32 * kTeam) {
        const float sv = s_sel[j];
        const bool feasible = s_row[shift + j] != 0 && sv == sv;
        const bool take = feasible && sv > r.v;
        r.any = r.any || feasible;
        r.v = take ? sv : r.v;
        r.a = take ? base + j : r.a;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    RowBest o;
    o.v = __shfl_xor_sync(0xffffffffu, r.v, off);
    o.a = __shfl_xor_sync(0xffffffffu, r.a, off);
    o.any = false;
    combine(r, o);
  }
  r.any = __any_sync(0xffffffffu, r.any);
  if (lane == 0) s_red[warp] = r;
  __syncthreads();
  const int first = warp - warp % kTeam;
  RowBest out = s_red[first];
#pragma unroll
  for (int k = 1; k < kTeam; ++k) combine(out, s_red[first + k]);
  return out;
}

template <int kTeam>
__global__ void __launch_bounds__(kThreads)
masked_argmax_kernel(const float* __restrict__ sel,       // (A,)
                     const uint8_t* __restrict__ lat_ok,  // (T, A)
                     const uint8_t* __restrict__ cap_ok,  // (A,)
                     const uint8_t* __restrict__ alive,   // (T,)
                     int T, int A, float* __restrict__ g_out,
                     int* __restrict__ idx_out) {
  const int row = blockIdx.x * (kWarps / kTeam) + (threadIdx.x >> 5) / kTeam;
  const bool live = row < T && alive[row] != 0;
  const RowBest r = row_first_max<kTeam>(lat_ok, A, row, live,
                                  [&](int col, bool* ok) {
                                    *ok = cap_ok[col] != 0;
                                    return sel[col];
                                  });
  if (threadIdx.x % (32 * kTeam) == 0 && row < T) {
    const bool found = r.v > -INFINITY;
    g_out[row] = found ? r.v : -INFINITY;
    idx_out[row] = found ? r.a : 0;
  }
}

template <int kTeam>
__global__ void __launch_bounds__(kThreads)
admission_round_kernel(const RoundArgs a) {
  __shared__ bool s_last;
  __shared__ float s_v[kWarps];
  __shared__ int s_t[kWarps];
  __shared__ int s_tau;

  extern __shared__ float s_terms[];  // pg_terms_floats(m): the pool's terms

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (kWarps / kTeam) + warp / kTeam;
  const bool live = row < a.T && a.alive[row] != 0;
  pg_pool_fill(s_terms, a.price, a.cap, a.occupied, a.m, threadIdx.x,
               kThreads);
  __syncthreads();
  const PgPool pool = pg_pool_view(s_terms, a.occupied, a.m);
  const float* grid = a.grid;
  const float* cost = a.cost;
  const int m = a.m;
  const bool flexible = a.flexible != 0;
  const RowBest r = row_first_max<kTeam>(
      a.lat_ok, a.A, row, live, [&](int col, bool* ok) {
        const float pg = pg_lane(pool, grid + static_cast<int64_t>(col) * m,
                                 ok);
        return flexible ? pg : -cost[col];
      });
  if (threadIdx.x % (32 * kTeam) == 0 && row < a.T) {
    const int best = r.v > -INFINITY ? r.a : 0;
    float G = -INFINITY;
    if (r.any) {  // the gradient at the selected allocation, in both modes
      bool ok;
      G = pg_lane(pool, a.grid + static_cast<int64_t>(best) * a.m, &ok);
    }
    const bool keep = live && r.any;  // alive & has
    a.alive[row] = keep;
    a.g[row] = keep ? G : -INFINITY;
    a.best_a[row] = best;
    __threadfence();  // publish this row before the block takes its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned int ticket = atomicAdd(a.ticket, 1u);
    __threadfence();
    s_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every row is published; read them past L1
  const volatile float* g = a.g;
  const volatile uint8_t* alive = a.alive;
  float bv = -INFINITY;
  int bt = INT_MAX;
  bool any_alive = false;
  for (int t = threadIdx.x; t < a.T; t += kThreads) {
    const float v = g[t];
    if (v > bv) {
      bv = v;
      bt = t;
    }
    any_alive = any_alive || alive[t] != 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
    if (ov > bv || (ov == bv && ot < bt)) {
      bv = ov;
      bt = ot;
    }
  }
  if (lane == 0) {
    s_v[warp] = bv;
    s_t[warp] = bt;
  }
  const bool admit = __syncthreads_or(any_alive);
  if (warp == 0) {
    bv = lane < kWarps ? s_v[lane] : -INFINITY;
    bt = lane < kWarps ? s_t[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
      if (ov > bv || (ov == bv && ot < bt)) {
        bv = ov;
        bt = ot;
      }
    }
    if (lane == 0) s_tau = bv > -INFINITY ? bt : 0;  // argmax of all -inf: 0
  }
  __syncthreads();
  // the commit, one store each, in parallel: thread k < m updates
  // occupied[k], warp 1 the task
  const int tau = s_tau;
  if (threadIdx.x < a.m || threadIdx.x == 32) {
    const int pick = static_cast<const volatile int*>(a.best_a)[tau];
    if (threadIdx.x < a.m) {
      const int k = threadIdx.x;
      a.occupied[k] = __fadd_rn(
          a.occupied[k],
          admit ? a.grid[static_cast<int64_t>(pick) * a.m + k] : 0.0f);
    } else {
      if (admit) {
        a.admitted[tau] = 1;
        a.alloc_idx[tau] = pick;
      }
      a.alive[tau] = 0;
      *a.ticket = 0u;  // for the next round on the stream
    }
  }
}

// Warps a task row: four while a lane still sees 8 columns or more and the
// grid stays within one block an SM, else two or one. Short rows gain
// nothing from a team; with many rows every extra block stages the whole
// column score again, which costs more than the shorter scan saves.
int team_for(int T, int A) {
  int team = 4;
  while (team > 1 && (A < 8 * 32 * team ||
                      (T + kWarps / team - 1) / (kWarps / team) > kSMs)) {
    team /= 2;
  }
  return team;
}

template <int kTeam>
int launch_argmax(const void* sel, const void* lat_ok, const void* cap_ok,
                  const void* alive, int T, int A, void* g_out, void* idx_out,
                  cudaStream_t stream) {
  constexpr int rows = kWarps / kTeam;
  masked_argmax_kernel<kTeam><<<(T + rows - 1) / rows, kThreads, 0,
                                stream>>>(
      static_cast<const float*>(sel), static_cast<const uint8_t*>(lat_ok),
      static_cast<const uint8_t*>(cap_ok), static_cast<const uint8_t*>(alive),
      T, A, static_cast<float*>(g_out), static_cast<int*>(idx_out));
  return repro_last_error();
}

template <int kTeam>
int launch_round(const RoundArgs* args, cudaStream_t stream) {
  constexpr int rows = kWarps / kTeam;
  const size_t smem = sizeof(float) * pg_terms_floats(args->m);
  if (smem > kTermsDefault) {  // a pool beyond ~1000 resources
    const cudaError_t err = cudaFuncSetAttribute(
        admission_round_kernel<kTeam>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  admission_round_kernel<kTeam><<<(args->T + rows - 1) / rows, kThreads,
                                  smem, stream>>>(*args);
  return repro_last_error();
}

}  // namespace

extern "C" int masked_argmax_launch(const void* sel, const void* lat_ok,
                                    const void* cap_ok, const void* alive,
                                    int T, int A, void* g_out, void* idx_out,
                                    void* stream) {
  if (T <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (team_for(T, A)) {
    case 4: return launch_argmax<4>(sel, lat_ok, cap_ok, alive, T, A, g_out,
                                    idx_out, s);
    case 2: return launch_argmax<2>(sel, lat_ok, cap_ok, alive, T, A, g_out,
                                    idx_out, s);
    default: return launch_argmax<1>(sel, lat_ok, cap_ok, alive, T, A, g_out,
                                     idx_out, s);
  }
}

// One admission round on the state and tables *args names (see RoundArgs).
extern "C" int admission_round_launch(const RoundArgs* args, void* stream) {
  if (args->T <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (team_for(args->T, args->A)) {
    case 4: return launch_round<4>(args, s);
    case 2: return launch_round<2>(args, s);
    default: return launch_round<1>(args, s);
  }
}
