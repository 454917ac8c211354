// The run layout shared by the two binned schedules built on the card
// (K14's pair schedule in ablations_binned.cu, K13's cluster-binned
// schedule in ablations_intersect.cu): per-cluster counts become runs of
// whole units (tiles of pair slots, or jobs), laid out cluster after
// cluster by one scan, and each unit learns the cluster whose run holds it.

#pragma once

#include <cuda_runtime.h>

namespace tpt {

constexpr int kRunLayoutThreads = 1024;

// One block scans the clusters' unit counts ceil(count[c] / unit) into
// unit_end (inclusive) and each run's first slot (its first unit x unit)
// into cursor.
__global__ void __launch_bounds__(kRunLayoutThreads)
run_layout_kernel(const int* __restrict__ count, int n_runs, int unit,
                  int* __restrict__ unit_end, int* __restrict__ cursor) {
  __shared__ int s_warp[kRunLayoutThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < n_runs; c0 += blockDim.x) {
    const int c = c0 + tid;
    const int v = c < n_runs ? (count[c] + unit - 1) / unit : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      if (w < warp) before += s_warp[w];
      chunk += s_warp[w];
    }
    incl += carry + before;
    if (c < n_runs) {
      unit_end[c] = incl;
      cursor[c] = (incl - v) * unit;
    }
    carry += chunk;
    __syncthreads();  // s_warp is rewritten next chunk
  }
}

// Unit j goes to the first cluster whose run ends past it
// (searchsorted(unit_end, j, right=True)); a unit past every run gets
// `past`.
__global__ void run_owner_kernel(const int* __restrict__ unit_end,
                                 int n_runs, int n_units, int past,
                                 int* __restrict__ owner) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_units;
       j += gridDim.x * blockDim.x) {
    int lo = 0, hi = n_runs;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (unit_end[mid] <= j) lo = mid + 1;
      else hi = mid;
    }
    owner[j] = lo < n_runs ? lo : past;
  }
}

// Blocks of a grid-stride pass over `count` items, 256 threads each.
inline unsigned run_grid(long long count) {
  const long long blocks = (count + 255) / 256;
  return (unsigned)(blocks < 1 ? 1 : (blocks < 132 * 16 ? blocks : 132 * 16));
}

}  // namespace tpt
