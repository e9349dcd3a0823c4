// K2: masked row max / first argmax of the single-instance SF-ESP round.
//
// Replaces src/repro/kernels/pg/pg.py::masked_argmax (Pallas body _kernel).
// For every task row t it computes, against one shared per-allocation score
// sel (A,) — the primal gradient, or -cost in MinRes mode:
//   score[t,a] = sel[a] if lat_ok[t,a] && cap_ok[a] && alive[t] else -inf
//   g[t]       = max_a score[t,a]
//   idx[t]     = first a attaining g[t]
// and g = -inf, idx = 0 for a row with nothing feasible (jnp's argmax of an
// all -inf row), for a dead row, and for a row whose max is -inf.
//
// Design. The Pallas kernel tiles (256 x 512) blocks and carries (g, idx)
// across the A-grid in its output block, relying on the TPU running the grid
// in order. Hopper runs blocks in no order, so nothing is carried between
// blocks: ONE WARP owns one task row and walks the whole of A itself. A block
// of 8 warps (8 rows) stages the column score cap_ok[a] ? sel[a] : -inf in
// shared memory, kChunk lanes at a time, so A has no upper limit; within a
// chunk the 32 lanes stride over the row with coalesced byte loads of the
// mask. Each lane keeps a running (max, first index): it visits its columns
// in increasing order and replaces only on a strictly greater value. The
// warp then reduces with __shfl_xor_sync under the order "greater value
// wins; on equal values the lower index wins" — the sequential first-max,
// made explicit, so the result does not depend on which lane saw what.
// Columns >= A and rows >= T are never read.
//
// Exactness. The kernel compares and copies; it does no arithmetic, so g
// and idx equal the plain PyTorch version bit for bit (g is the value sel
// holds at idx). NaN in sel is outside the contract: the primal gradient is
// finite on the grid.
//
// Bound. One call must read the (T, A) mask once (T*A bytes), sel and
// cap_ok (5*A bytes) and alive (T bytes), and write g and idx (8*T bytes):
// 5.3 MB at T = 4096, A = 1280, 1.6 us of HBM time on an H100; at the
// paper's shapes (T <= 200, A <= 1280) it is well under launch latency.
// Byte loads (32 B per warp request) leave bandwidth on the table; widening
// them is work for a later change.

#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2048;  // staged columns: 8 KB of shared memory

__global__ void __launch_bounds__(kThreads)
masked_argmax_kernel(const float* __restrict__ sel,       // (A,)
                     const uint8_t* __restrict__ lat_ok,  // (T, A)
                     const uint8_t* __restrict__ cap_ok,  // (A,)
                     const uint8_t* __restrict__ alive,   // (T,)
                     int T, int A, float* __restrict__ g_out,
                     int* __restrict__ idx_out) {
  __shared__ float s_col[kChunk];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < T && alive[row] != 0;
  const uint8_t* mask = lat_ok + static_cast<int64_t>(live ? row : 0) * A;

  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int base = 0; base < A; base += kChunk) {
    const int n = min(kChunk, A - base);
    __syncthreads();  // the previous chunk is consumed by every warp
    for (int j = threadIdx.x; j < n; j += kThreads) {
      s_col[j] = cap_ok[base + j] != 0 ? sel[base + j] : -INFINITY;
    }
    __syncthreads();
    if (live) {
      for (int j = lane; j < n; j += 32) {
        if (mask[base + j] != 0) {
          const float s = s_col[j];
          if (s > best) {
            best = s;
            best_a = base + j;
          }
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, best_a, off);
    if (ov > best || (ov == best && oa < best_a)) {
      best = ov;
      best_a = oa;
    }
  }
  if (lane == 0 && row < T) {
    const bool found = best > -INFINITY;
    g_out[row] = found ? best : -INFINITY;
    idx_out[row] = found ? best_a : 0;
  }
}

}  // namespace

extern "C" int masked_argmax_launch(const void* sel, const void* lat_ok,
                                    const void* cap_ok, const void* alive,
                                    int T, int A, void* g_out, void* idx_out,
                                    void* stream) {
  if (T <= 0) return 0;
  const int blocks = (T + kWarps - 1) / kWarps;
  masked_argmax_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sel), static_cast<const uint8_t*>(lat_ok),
      static_cast<const uint8_t*>(cap_ok), static_cast<const uint8_t*>(alive),
      T, A, static_cast<float*>(g_out), static_cast<int*>(idx_out));
  return repro_last_error();
}
