// Clustered ray-triangle kernels for Hopper (sm_90a): scenes above the
// single-slab limit (TRI_SLAB = 8,192 packed rows), such as the 100k-row
// big mesh and the 1M-row huge mesh.
//
// They replace the clustered Pallas TPU kernels on the big-scene path
// (tpu_pt/intersect/pallas_bf.py):
//
//   tpt_closest_clustered   <- _closest_kernel_clustered_lean (:1042) and
//                              _closest_kernel_chained_lean (:1062),
//                              launched by _closest_call_clustered (:1989):
//                              per ray, the closest (t, packed row) over the
//                              whole clustered table, with t < tmax.
//   tpt_closest_clustered_full
//                           <- _closest_kernel_clustered (:993) and
//                              _closest_kernel_chained (:1012), the same call
//                              site with lean=False: the same function with
//                              the full carry of _closest_sweep (:722-765),
//                              the winner's normal, material, original
//                              triangle id and (want_uv) u, v, so that no
//                              gather follows. One entry point for both
//                              bodies: the chained one exists because a TPU
//                              table is cut into VMEM slabs.
//   tpt_occluded_clustered  <- _occluded_kernel_clustered (:1204), launched
//                              by _occluded_call_clustered (:2128): is any
//                              non-refractive row hit with tmin < t < tmax_ray?
//
// The table holds the packed rows in balanced-kd order; each run of
// `cluster` rows (128) has an axis-aligned box. A ray culls with every box
// grown by margin * (scale + max|o|), so that the cull is conservative at
// any distance of the ray's origin (clustered.py, BOX_MARGIN).
//
// The walk (tpt_closest_clustered, _full, tpt_occluded_clustered).
// The kd order is a tree: a run of k clusters splits into max(1, k / 2)
// clusters and the rest, recursively, so the clusters are its leaves.
// clustered.cluster_tree stores its C - 1 internal nodes, breadth first,
// as [C - 1, 8] f32 rows laid out like the boxes: (min xyz, max xyz, the
// two children's references as int bits; a reference is 2 * index + 1
// for cluster `index`, 2 * index for node `index`). A node's box is the
// exact min / max union of its children's boxes, empty clusters left
// out. One ray goes to a group of G lanes (a part of a warp), and the
// group walks the tree together, depth first and near first: it tests
// both children of a node it opens against the current bound
// min(best, tmax) (the any-hit's: the ray's own tmax), goes on with the
// nearer one that passes and pushes the farther on a short stack in
// shared memory with its entry distance, which is held against the bound
// again when it is popped. A cluster is swept by the whole group, each
// lane testing every G-th row (16 of 128 at G = 8: 16-byte loads,
// neighbouring lanes on neighbouring rows), and log2 G xor shuffles fold
// the group's (t, row) with the compare the flat sweep uses; the any-hit
// votes with one ballot and stops the walk at the first blocking row. G
// is a template parameter, built at 4, 8, 16 and 32; the entry points take
// it as `group`, and clustered.walk_group picks it from the ray count, as
// measured by tools/clustered_group_trial.py (PERF.md).
//
// What bounded the flat design (tpt_*_flat below, kept on no path as the
// yardstick of chip_smoke.py): (1) each thread slab-tested all C boxes
// in file order, whatever its ray pierces: 784 boxes on the big mesh,
// 7,824 on the 1M mesh; (2) the visit order was not near first, so every
// cluster met before the eventual hit and pierced behind it was swept
// whole, 128 rows with an IEEE division each; (3) one thread per ray at
// the path's 32,768 lanes is 256 blocks of 128 threads, ~8 warps an SM
// (12.5% occupancy), with every dependent load's latency in view. The
// walk tests ~2 log2 C boxes per pierced cluster instead of C, sweeps
// near first so that the bound shrinks before the far clusters are met,
// and runs G threads a ray: at 32,768 rays and G = 16, 524,288 threads,
// enough to fill the card (132 SMs x 2,048). The TPU package's version of
// the same idea is one level of supercluster boxes (SUPER,
// pallas_bf.py:153-165, :250-252), which its candidate lists test before
// their clusters' own boxes.
//
// Porting the function, not the TPU schedule. The TPU kernels sweep a
// 256-ray tile's shared work list, slab by chained slab, because the
// table has to fit in VMEM and a tile shares one list; the ray sort, the
// per-tile candidate tables and the slab chaining exist for that. Here
// the table (6.4 MB at 100k rows) lives in device memory and L2: one
// launch per call.
//
// Correctness notes:
// - Results are bitwise those of a dense sweep over every row (the plain
//   versions in clustered.py). Grown boxes mean a culled cluster holds no
//   hit that could change the result, and the best hit is replaced when
//   t < best, or t == best on a lower row, so the visit order does not
//   matter. The per-pair test is pe_test of pe_block.cuh, built with
//   --fmad=false. The full carry is write_attrs of pe_block.cuh, the
//   device code of the dense full-carry kernel (tpt_closest_full): u and v
//   are formed once from the winning row, never reduced over rows.
// - The tree culls exactly what the flat scan culls. min and max are
//   exact, and each rounded step of the slab test, (lo - m - o) * inv, is
//   monotone in the box coordinate; so a node's interval contains each
//   descendant's at the same margin m, and a node passes whenever any
//   cluster under it passes. The clusters the walk sweeps at a bound are
//   the ones the flat scan passes at that bound (clustered._tree_leaves_
//   plain; tests/test_torch_clustered_tree.py). The bound only shrinks to
//   the t of a row already found, and a cluster entered at exactly the
//   bound is still swept (tn <= bound), so a tie on a lower row is found.
// - The slab test (pe_block.cuh, slab_enter) takes the eps-guarded
//   reciprocal of _ray_inv (pallas_bf.py:533-542), so axis-parallel rays
//   stay finite, and every quantity it forms is finite or +-inf, never
//   NaN: a collapsed empty cluster or node (box at 3e37) fails it for
//   every ray.
// - Parked lanes (origin 3e7, tmax 0) find the root behind them and miss.

#include <type_traits>

#include "pe_block.cuh"

namespace {

using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::box_passes;  // cluster c of boxes [C, 8] grown by m

// ---------------------------------------------------------------------------
// The walk: one ray to a group of G lanes
// ---------------------------------------------------------------------------

constexpr int kWalkThreads = 256;
constexpr int kStack = 32;  // entries; clustered.TREE_MAX_DEPTH

struct Group {
  int lane;       // lane within the group
  unsigned mask;  // the group's lanes within the warp
  int slot;       // the group's index within the block
};

template <int G>
__device__ __forceinline__ Group group_of_thread() {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32,
                "a group is a power-of-two part of a warp");
  const int lane = threadIdx.x & 31;
  const int lg = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (lane - lg);
  return Group{lg, mask, (int)threadIdx.x / G};
}

// The box of reference `ref`: cluster ref >> 1 of `bx` when ref is odd,
// else node ref >> 1 of `nd` (both [*, 8] f32: two float4 loads).
__device__ __forceinline__ bool ref_enter(const Ray& r, const Slab& s,
                                          float m, float tmin,
                                          const float4* __restrict__ bx,
                                          const float4* __restrict__ nd,
                                          int ref, float* tn) {
  const float4* p = (ref & 1 ? bx : nd) + 2 * (size_t)(ref >> 1);
  return tpt::slab_enter(r, s, __ldg(p), __ldg(p + 1), m, tmin, tn);
}

// Walk the tree for one ray, near first, calling leaf(c, &bound) on each
// cluster c whose grown box the ray enters within (tmin, bound]; leaf may
// lower the bound and returns true to stop the walk. Every lane of the
// group runs it with the same values, so its branches are group-uniform.
template <class Leaf>
__device__ __forceinline__ void walk_tree(const Ray& r, const Slab& s,
                                          float m, float tmin, float bound,
                                          const float4* __restrict__ bx,
                                          const float4* __restrict__ nd,
                                          int n_boxes, const Group& g,
                                          int* s_ref, float* s_tn,
                                          Leaf leaf) {
  int cur = n_boxes > 1 ? 0 : 1;  // node 0, or the only cluster
  float tn;
  if (!(ref_enter(r, s, m, tmin, bx, nd, cur, &tn) && tn <= bound)) return;
  int sp = 0;
  for (;;) {
    if (cur & 1) {
      if (leaf(cur >> 1, &bound)) return;
    } else {
      const float4 links = __ldg(nd + 2 * (size_t)(cur >> 1) + 1);
      const int kid0 = __float_as_int(links.z);
      const int kid1 = __float_as_int(links.w);
      float tn0, tn1;
      const bool p0 =
          ref_enter(r, s, m, tmin, bx, nd, kid0, &tn0) && tn0 <= bound;
      const bool p1 =
          ref_enter(r, s, m, tmin, bx, nd, kid1, &tn1) && tn1 <= bound;
      if (p0 && p1) {
        const bool first = tn0 <= tn1;  // the nearer; the lower on a tie
        // The group shares the stack: every lane has read the entry below
        // before lane 0 overwrites it, and sees the new one after.
        __syncwarp(g.mask);
        if (g.lane == 0) {
          s_ref[sp] = first ? kid1 : kid0;
          s_tn[sp] = first ? tn1 : tn0;
        }
        __syncwarp(g.mask);
        ++sp;
        cur = first ? kid0 : kid1;
        continue;
      }
      if (p0 || p1) {
        cur = p0 ? kid0 : kid1;
        continue;
      }
    }
    // Pop the most recent entry that still enters within the bound.
    for (;;) {
      if (sp == 0) return;
      --sp;
      if (s_tn[sp] <= bound) {
        cur = s_ref[sp];
        break;
      }
    }
  }
}

// kFull: row_out takes the winner's original triangle id (column 15) and
// the attribute outputs are written; else row_out takes its packed row.
template <int G, bool kFull>
__global__ void __launch_bounds__(kWalkThreads)
closest_tree_kernel(const float* __restrict__ orig,
                    const float* __restrict__ dir,
                    const float* __restrict__ tris,
                    const float* __restrict__ boxes,
                    const float* __restrict__ nodes, int n_rays,
                    int n_boxes, int cluster, float scale, float margin,
                    float tmin, float tmax, int want_uv,
                    float* __restrict__ t_out, int* __restrict__ row_out,
                    float* __restrict__ nrm_out, int* __restrict__ mat_out,
                    float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ int s_ref[kWalkThreads / G][kStack];
  __shared__ float s_tn[kWalkThreads / G][kStack];
  const Group g = group_of_thread<G>();
  const int i = (int)((blockIdx.x * (size_t)kWalkThreads + threadIdx.x) / G);
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  const Slab s = tpt::make_slab(r);
  // Culling margin: margin * (scale + max_k |o_k|) (clustered.BOX_MARGIN).
  const float m = margin * (scale + max_abs_origin(r));
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0;
  walk_tree(r, s, m, tmin, fminf(best, tmax),
            reinterpret_cast<const float4*>(boxes),
            reinterpret_cast<const float4*>(nodes), n_boxes, g,
            s_ref[g.slot], s_tn[g.slot], [&](int c, float* bound) {
              const int base = c * cluster;
              float tl = best;
              int rl = best_row;
              for (int j = g.lane; j < cluster; j += G) {
                const int row = base + j;
                const float4* p = rows + 4 * (size_t)row;
                float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2),
                                  tmin);
                if (!(t < tmax)) t = kTFar;
                if (t < tl || (t == tl && row < rl)) {
                  tl = t;
                  rl = row;
                }
              }
#pragma unroll
              for (int k = G / 2; k >= 1; k >>= 1) {
                const float to = __shfl_xor_sync(g.mask, tl, k);
                const int ro = __shfl_xor_sync(g.mask, rl, k);
                if (to < tl || (to == tl && ro < rl)) {
                  tl = to;
                  rl = ro;
                }
              }
              best = tl;
              best_row = rl;
              *bound = fminf(best, tmax);
              return false;
            });
  if (g.lane != 0) return;
  t_out[i] = best;
  if (kFull)
    tpt::write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out,
                     u_out, v_out, row_out);
  else
    row_out[i] = best < kTFar ? best_row : 0;
}

template <int G>
__global__ void __launch_bounds__(kWalkThreads)
occluded_tree_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dir,
                     const float* __restrict__ tmax,
                     const float* __restrict__ tris,
                     const float* __restrict__ boxes,
                     const float* __restrict__ nodes, int n_rays,
                     int n_boxes, int cluster, float scale, float margin,
                     float tmin, uint8_t* __restrict__ occ_out) {
  __shared__ int s_ref[kWalkThreads / G][kStack];
  __shared__ float s_tn[kWalkThreads / G][kStack];
  const Group g = group_of_thread<G>();
  const int i = (int)((blockIdx.x * (size_t)kWalkThreads + threadIdx.x) / G);
  if (i >= n_rays) return;
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0).
  if (tm > tmin) {
    const Ray r = load_ray(orig, dir, i);
    const Slab s = tpt::make_slab(r);
    const float m = margin * (scale + max_abs_origin(r));
    const float4* rows = reinterpret_cast<const float4*>(tris);
    // A box entered at tn >= tm holds no blocking hit (t > tn): the bound
    // is the ray's own tmax throughout.
    walk_tree(r, s, m, tmin, tm, reinterpret_cast<const float4*>(boxes),
              reinterpret_cast<const float4*>(nodes), n_boxes, g,
              s_ref[g.slot], s_tn[g.slot], [&](int c, float*) {
                const int base = c * cluster;
                bool hit = false;
                for (int j = g.lane; j < cluster && !hit; j += G) {
                  const float4* p = rows + 4 * (size_t)(base + j);
                  if (!(__ldg(p + 3).y < 0.5f)) continue;  // refractive
                  hit = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2),
                                tmin) < tm;
                }
                // Other groups of the warp may reach the same ballot: keep
                // this group's bits only.
                blocked = (__ballot_sync(g.mask, hit) & g.mask) != 0;
                return blocked;
              });
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

inline unsigned walk_grid(int n_rays, int group) {
  const size_t threads = (size_t)n_rays * group;
  return (unsigned)((threads + kWalkThreads - 1) / kWalkThreads);
}

// Calls launch(std::integral_constant<int, G>) for G = group, one of the
// widths built here (4, 8, 16, 32 lanes a ray); false for any other.
template <class Launch>
bool with_group(int group, Launch launch) {
  switch (group) {
    case 4: launch(std::integral_constant<int, 4>()); return true;
    case 8: launch(std::integral_constant<int, 8>()); return true;
    case 16: launch(std::integral_constant<int, 16>()); return true;
    case 32: launch(std::integral_constant<int, 32>()); return true;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// The flat scan (the bodies the walk replaced, verbatim): one thread a
// ray, every box slab-tested in file order. On no path; chip_smoke.py's
// yardstick.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // rays per block, one thread per ray

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
closest_clustered_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir,
                         const float* __restrict__ tris,
                         const float* __restrict__ boxes, int n_rays,
                         int n_boxes, int cluster, float scale, float margin,
                         float tmin, float tmax, int want_uv,
                         float* __restrict__ t_out, int* __restrict__ row_out,
                         float* __restrict__ nrm_out,
                         int* __restrict__ mat_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dir, i);
  const Slab s = tpt::make_slab(r);
  // Culling margin: margin * (scale + max_k |o_k|) (clustered.BOX_MARGIN).
  const float m = margin * (scale + max_abs_origin(r));
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0;
  for (int c = 0; c < n_boxes; ++c) {
    if (!box_passes(r, s, m, bx, c, tmin, fminf(best, tmax))) continue;
    const int base = c * cluster;
    for (int j = 0; j < cluster; ++j) {
      const int row = base + j;
      const float4* p = rows + 4 * (size_t)row;
      float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin);
      if (!(t < tmax)) t = kTFar;
      if (t < best || (t == best && row < best_row)) {
        best = t;
        best_row = row;
      }
    }
  }
  t_out[i] = best;
  if (kFull)
    tpt::write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out,
                     u_out, v_out, row_out);
  else
    row_out[i] = best < kTFar ? best_row : 0;
}

__global__ void __launch_bounds__(kThreads)
occluded_clustered_kernel(const float* __restrict__ orig,
                          const float* __restrict__ dir,
                          const float* __restrict__ tmax,
                          const float* __restrict__ tris,
                          const float* __restrict__ boxes, int n_rays,
                          int n_boxes, int cluster, float scale,
                          float margin, float tmin,
                          uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0).
  if (tm > tmin) {
    const Ray r = load_ray(orig, dir, i);
    const Slab s = tpt::make_slab(r);
    const float m = margin * (scale + max_abs_origin(r));
    const float4* bx = reinterpret_cast<const float4*>(boxes);
    const float4* rows = reinterpret_cast<const float4*>(tris);
    for (int c = 0; c < n_boxes && !blocked; ++c) {
      // A box entered at tn >= tm holds no blocking hit (t > tn).
      if (!box_passes(r, s, m, bx, c, tmin, tm)) continue;
      const int base = c * cluster;
      // Any-hit: the thread stops at its first blocking row.
      for (int j = 0; j < cluster && !blocked; ++j) {
        const float4* p = rows + 4 * (size_t)(base + j);
        if (!(__ldg(p + 3).y < 0.5f)) continue;  // refractive rows pass light
        blocked = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin) < tm;
      }
    }
  }
  occ_out[i] = blocked ? 1 : 0;
}

inline unsigned grid_for(int n_rays) {
  return (unsigned)((n_rays + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).
// `tris` is [n_boxes * cluster, 16] f32, `boxes` [n_boxes, 8] f32 and
// `nodes` [n_boxes - 1, 8] f32 (clustered.cluster_tree; not read when
// n_boxes is 1), all 16-byte aligned; `scale` is the boxes' largest
// coordinate magnitude and `margin` the relative culling margin
// (clustered.py, BOX_MARGIN). `group` is the walk's lanes a ray (4, 8,
// 16 or 32; clustered.walk_group picks it).

int tpt_closest_clustered(const float* orig, const float* dir,
                          const float* tris, const float* boxes,
                          const float* nodes, int n_rays, int n_boxes,
                          int cluster, float scale, float margin, float tmin,
                          float tmax, float* t_out, int* row_out, int group,
                          void* stream) {
  const bool ok = with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_tree_kernel<G, false>
        <<<walk_grid(n_rays, G), kWalkThreads, 0, (cudaStream_t)stream>>>(
            orig, dir, tris, boxes, nodes, n_rays, n_boxes, cluster, scale,
            margin, tmin, tmax, 0, t_out, row_out, nullptr, nullptr, nullptr,
            nullptr);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_closest_clustered_full(const float* orig, const float* dir,
                               const float* tris, const float* boxes,
                               const float* nodes, int n_rays, int n_boxes,
                               int cluster, float scale, float margin,
                               float tmin, float tmax, int want_uv,
                               float* t_out, int* id_out, float* nrm_out,
                               int* mat_out, float* u_out, float* v_out,
                               int group, void* stream) {
  const bool ok = with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_tree_kernel<G, true>
        <<<walk_grid(n_rays, G), kWalkThreads, 0, (cudaStream_t)stream>>>(
            orig, dir, tris, boxes, nodes, n_rays, n_boxes, cluster, scale,
            margin, tmin, tmax, want_uv, t_out, id_out, nrm_out, mat_out,
            u_out, v_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_occluded_clustered(const float* orig, const float* dir,
                           const float* tmax, const float* tris,
                           const float* boxes, const float* nodes,
                           int n_rays, int n_boxes, int cluster, float scale,
                           float margin, float tmin, uint8_t* occ_out,
                           int group, void* stream) {
  const bool ok = with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    occluded_tree_kernel<G>
        <<<walk_grid(n_rays, G), kWalkThreads, 0, (cudaStream_t)stream>>>(
            orig, dir, tmax, tris, boxes, nodes, n_rays, n_boxes, cluster,
            scale, margin, tmin, occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_closest_clustered_flat(const float* orig, const float* dir,
                               const float* tris, const float* boxes,
                               int n_rays, int n_boxes, int cluster,
                               float scale, float margin, float tmin,
                               float tmax, float* t_out, int* row_out,
                               void* stream) {
  closest_clustered_kernel<false>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, 0, t_out, row_out, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int tpt_closest_clustered_full_flat(const float* orig, const float* dir,
                                    const float* tris, const float* boxes,
                                    int n_rays, int n_boxes, int cluster,
                                    float scale, float margin, float tmin,
                                    float tmax, int want_uv, float* t_out,
                                    int* id_out, float* nrm_out, int* mat_out,
                                    float* u_out, float* v_out,
                                    void* stream) {
  closest_clustered_kernel<true>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, want_uv, t_out, id_out, nrm_out, mat_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_clustered_flat(const float* orig, const float* dir,
                                const float* tmax, const float* tris,
                                const float* boxes, int n_rays, int n_boxes,
                                int cluster, float scale, float margin,
                                float tmin, uint8_t* occ_out, void* stream) {
  occluded_clustered_kernel<<<grid_for(n_rays), kThreads, 0,
                              (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
      tmin, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
