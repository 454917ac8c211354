// One ray to a group of G lanes going down a list of clusters, shared by
// K12 (ablations_intersect.cu: tiles of 128 rays share a list) and K15
// (ablations_binned.cu: tiles of 8); the group's sweep of one cluster for
// a closest hit; and its sweep of a range of boxes, each tested and the
// ones that pass swept, shared by K11 (ablations_intersect.cu: a range a
// slab) and K7 (clustered_build.cu: one range, every box).
//
// The lists are ablations.stream_lists' (cand, keys, cnt, far): ray i's
// list is its tile's, tile i / rt; `cand` and `keys` are [tiles, n_boxes],
// the tile's boxes in ascending key order (a box's key: the least entry
// distance of the tile's rays that pierce it), of which the first
// cnt[tile] are listed; `far` [n_rays] is each ray's last entry distance
// over the boxes it pierces (-3e38: none).
//
// Closest: the group reads G (key, box) entries at a time; each lane runs
// its own guard, its ray's grown box tested against its candidate at
// min(best, tmax) (slab_enter); a ballot gives the candidates that pass,
// and the group sweeps each, nearest key first, its rows split over the
// lanes, and folds (t, row) by xor shuffles, ties to the lowest row (K6's
// leaf). The break is per ray: the first key beyond min(best, far),
// checked again after every swept candidate, as best shrinks within a
// chunk; a key equal to best is still swept, since its box may hold a tied
// hit on a lower row. Guard off: every candidate up to the break is swept.
// Any-hit: the break is the first key beyond min(far, tmax); the group
// sweeps each passing candidate with cluster_blocked and stops at the
// first that blocks. No block barrier and no shared list: a group's
// branches are uniform over its lanes, which hold the same ray.
//
// The rows are read through L1 / L2. K15's bundled body once staged each
// candidate's rows in shared memory; a group that copies the next passing
// cluster's rows into its own shared slot with cp.async while it sweeps
// the current one, double-buffered, took 1.6-1.8x the time of this walk on
// a frame's calls at every width (PERF.md), so both of K15's bodies launch
// this one.

#pragma once

#include "walk.cuh"

namespace tpt {

// The group's sweep of rows [base, base + cluster) for the closest hit
// below min(tmax, ...): every G-th row a lane, then an xor-shuffle fold of
// (t, row), ties to the lowest row, into (best, best_row) on every lane.
template <int G>
__device__ __forceinline__ void sweep_cluster(const Ray& r,
                                              const float4* __restrict__ rows,
                                              int base, int cluster,
                                              const Group& g, float tmin,
                                              float tmax, float& best,
                                              int& best_row) {
  float tl = best;
  int rl = best_row;
  for (int q = g.lane; q < cluster; q += G) {
    const int row = base + q;
    const float4* p = rows + 4 * (size_t)row;
    float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin);
    if (!(t < tmax)) t = kTFar;
    if (t < tl || (t == tl && row < rl)) {
      tl = t;
      rl = row;
    }
  }
#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1) {
    const float to = __shfl_xor_sync(g.mask, tl, off, G);
    const int ro = __shfl_xor_sync(g.mask, rl, off, G);
    if (to < tl || (to == tl && ro < rl)) {
      tl = to;
      rl = ro;
    }
  }
  best = tl;
  best_row = rl;
}

// The group's closest hit over boxes [c0, c1) into (best, best_row): the
// lanes test the boxes G at a time, lane l the box c0 + l (its ray's box
// grown by m) at min(best, tmax) (slab_enter); a ballot gives the ones
// that pass, and the group sweeps each, lowest box first, with
// sweep_cluster, held against min(best, tmax) again since best shrinks
// within a chunk. Both checks are <=: a box entered exactly at best can
// hold a tied hit on a lower row once an earlier range found best.
template <int G>
__device__ __forceinline__ void sweep_boxes(const Ray& r, const Slab& s,
                                            float m,
                                            const float4* __restrict__ bx,
                                            const float4* __restrict__ rows,
                                            int c0, int c1, int cluster,
                                            const Group& g, float tmin,
                                            float tmax, float& best,
                                            int& best_row) {
  for (int base = c0; base < c1; base += G) {
    const int c = base + g.lane;
    float tn = 0.0f;
    const bool ok = c < c1 &&
                    slab_enter(r, s, __ldg(bx + 2 * (size_t)c),
                               __ldg(bx + 2 * (size_t)c + 1), m, tmin, &tn) &&
                    tn <= fminf(best, tmax);
    unsigned pass = group_ballot(g, ok);
    while (pass != 0u) {
      const int j = __ffs(pass) - 1;
      pass &= pass - 1u;
      if (!(__shfl_sync(g.mask, tn, j, G) <= fminf(best, tmax))) continue;
      sweep_cluster<G>(r, rows, (base + j) * cluster, cluster, g, tmin, tmax,
                       best, best_row);
    }
  }
}

// Closest hit of the packed rays [n_rays, 8] over their tiles' lists (see
// above), one ray to a group of G lanes.
template <int G>
__global__ void __launch_bounds__(kWalkThreads)
closest_list_kernel(const float* __restrict__ rays,
                    const float* __restrict__ tris,
                    const float* __restrict__ boxes,
                    const int* __restrict__ cand,
                    const float* __restrict__ keys,
                    const int* __restrict__ cnt,
                    const float* __restrict__ last_key, int n_rays,
                    int n_boxes, int cluster, int rt, float scale,
                    float margin, float tmin, float tmax, int guard,
                    float* __restrict__ t_out, int* __restrict__ row_out) {
  const Group g = group_of_thread<G>();
  const int i = walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  float tm_unused;
  const Ray r = load_ray8(rays, i, &tm_unused);
  const Slab s = make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float lane_far = __ldg(last_key + i);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* rows = reinterpret_cast<const float4*>(tris);
  const int tile = i / rt;
  const int* list = cand + (size_t)tile * n_boxes;
  const float* key = keys + (size_t)tile * n_boxes;
  const int ncand = min(max(__ldg(cnt + tile), 0), n_boxes);
  const unsigned all = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
  float best = kTFar;
  int best_row = 0;
  bool done = false;
  for (int k0 = 0; k0 < ncand && !done; k0 += G) {
    // Keys ascend, and the ray enters no box before its key: the
    // candidates it can still use are the chunk's first ones, up to the
    // first key beyond min(best, last entry).
    const int k = k0 + g.lane;
    const float kk = k < ncand ? __ldg(key + k) : 0.0f;
    const bool live = k < ncand && kk <= fminf(best, lane_far);
    const int c = live ? __ldg(list + k) : 0;
    // The guard: this lane's test of its ray's grown box against its
    // candidate; the entry is held against the bound again below, since
    // best shrinks within the chunk.
    float tn = 0.0f;
    const bool enters =
        live && (!guard || slab_enter(r, s, __ldg(bx + 2 * (size_t)c),
                                      __ldg(bx + 2 * (size_t)c + 1), m, tmin,
                                      &tn));
    const unsigned usable = group_ballot(g, live);
    unsigned pass =
        group_ballot(g, enters && (!guard || tn <= fminf(best, tmax)));
    while (pass != 0u) {
      const int j = __ffs(pass) - 1;
      pass &= pass - 1u;
      if (__shfl_sync(g.mask, kk, j, G) > fminf(best, lane_far)) {
        done = true;  // the break, checked after every swept candidate
        break;
      }
      if (guard && !(__shfl_sync(g.mask, tn, j, G) <= fminf(best, tmax)))
        continue;
      sweep_cluster<G>(r, rows, __shfl_sync(g.mask, c, j, G) * cluster,
                       cluster, g, tmin, tmax, best, best_row);
    }
    if (usable != all) break;  // the break, or the list's end
  }
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
}

// Any-hit of the packed rays [n_rays, 8] (column 6: each ray's tmax) over
// their tiles' lists, one ray to a group of G lanes.
template <int G>
__global__ void __launch_bounds__(kWalkThreads)
occluded_list_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tris,
                     const float* __restrict__ boxes,
                     const int* __restrict__ cand,
                     const float* __restrict__ keys,
                     const int* __restrict__ cnt,
                     const float* __restrict__ last_key, int n_rays,
                     int n_boxes, int cluster, int rt, float scale,
                     float margin, float tmin, int guard,
                     uint8_t* __restrict__ occ_out) {
  const Group g = group_of_thread<G>();
  const int i = walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  float tm;
  const Ray r = load_ray8(rays, i, &tm);
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked lanes carry tm = 0).
  if (tm > tmin) {
    const Slab s = make_slab(r);
    const float m = margin * (scale + max_abs_origin(r));
    const float lane_far = fminf(__ldg(last_key + i), tm);
    const float4* bx = reinterpret_cast<const float4*>(boxes);
    const float4* rows = reinterpret_cast<const float4*>(tris);
    const int tile = i / rt;
    const int* list = cand + (size_t)tile * n_boxes;
    const float* key = keys + (size_t)tile * n_boxes;
    const int ncand = min(max(__ldg(cnt + tile), 0), n_boxes);
    const unsigned all = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
    for (int k0 = 0; k0 < ncand && !blocked; k0 += G) {
      // Keys ascend, and the ray enters no box before its key: the
      // candidates it can still use are the chunk's first ones, up to the
      // first key beyond its last entry or its tmax.
      const int k = k0 + g.lane;
      const bool live = k < ncand && __ldg(key + k) <= lane_far;
      const int c = live ? __ldg(list + k) : 0;
      const unsigned usable = group_ballot(g, live);
      unsigned pass =
          guard ? group_ballot(g, live && box_passes(r, s, m, bx, c, tmin, tm))
                : usable;
      while (pass != 0u && !blocked) {
        const int j = __ffs(pass) - 1;
        pass &= pass - 1u;
        const int cj = __shfl_sync(g.mask, c, j, G);
        blocked =
            cluster_blocked(r, rows, cj * cluster, cluster, G, g, tmin, tm);
      }
      if (usable != all) break;  // the break, or the list's end
    }
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

// Launch either kernel at `group` lanes a ray (a width of with_group) on
// `stream`; false for any other width.
template <class... Args>
inline bool launch_closest_list(int group, int n_rays, cudaStream_t stream,
                                Args... args) {
  return with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    if (n_rays > 0)
      closest_list_kernel<G><<<walk_grid(n_rays, G), kWalkThreads, 0,
                               stream>>>(args...);
  });
}

template <class... Args>
inline bool launch_occluded_list(int group, int n_rays, cudaStream_t stream,
                                 Args... args) {
  return with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    if (n_rays > 0)
      occluded_list_kernel<G><<<walk_grid(n_rays, G), kWalkThreads, 0,
                                stream>>>(args...);
  });
}

}  // namespace tpt
