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
// group walks the tree together (walk_tree of walk.cuh, shared with the
// fused K5 and the instanced K9), depth first and near first: it tests
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
// Why a walk. A flat design, one thread a ray, (1) slab-tests all C boxes
// in file order, whatever its ray pierces: 784 boxes on the big mesh,
// 7,824 on the 1M mesh; (2) visits them in an order that is not near
// first, so every cluster met before the eventual hit and pierced behind
// it is swept whole, 128 rows with an IEEE division each; (3) at the
// path's 32,768 lanes runs 256 blocks of 128 threads, ~8 warps an SM
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
// - The tree culls exactly what a flat test of every box culls. min and
//   max are exact, and each rounded step of the slab test,
//   (lo - m - o) * inv, is monotone in the box coordinate; so a node's
//   interval contains each descendant's at the same margin m, and a node
//   passes whenever any cluster under it passes. The clusters the walk
//   sweeps at a bound are the ones that flat test passes at that bound
//   (clustered._tree_leaves_plain; tests/test_torch_clustered_tree.py).
//   The bound only shrinks to the t of a row already found, and a
//   cluster entered at exactly the bound is still swept (tn <= bound), so
//   a tie on a lower row is found.
// - The slab test (pe_block.cuh, slab_enter) takes the eps-guarded
//   reciprocal of _ray_inv (pallas_bf.py:533-542), so axis-parallel rays
//   stay finite, and every quantity it forms is finite or +-inf, never
//   NaN: a collapsed empty cluster or node (box at 3e37) fails it for
//   every ray.
// - Parked lanes (origin 3e7, tmax 0) find the root behind them and miss.

#include "walk.cuh"

namespace {

using tpt::ClusterTree;
using tpt::Group;
using tpt::kTFar;
using tpt::kWalkThreads;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::walk_grid;
using tpt::walk_tree;
using tpt::with_group;

// ---------------------------------------------------------------------------
// The walk (csrc/walk.cuh): one ray to a group of G lanes
// ---------------------------------------------------------------------------

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
  __shared__ int s_ref[kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[kWalkThreads / G][tpt::kStack];
  const Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  const Slab s = tpt::make_slab(r);
  // Culling margin: margin * (scale + max_k |o_k|) (clustered.BOX_MARGIN).
  const ClusterTree tree{reinterpret_cast<const float4*>(boxes),
                         reinterpret_cast<const float4*>(nodes), n_boxes,
                         margin * (scale + max_abs_origin(r))};
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0;
  walk_tree(r, s, tmin, fminf(best, tmax), tree, g, s_ref[g.slot],
            s_tn[g.slot], [&](int c, float* bound) {
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
  __shared__ int s_ref[kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[kWalkThreads / G][tpt::kStack];
  const Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0).
  if (tm > tmin) {
    const Ray r = load_ray(orig, dir, i);
    const Slab s = tpt::make_slab(r);
    const ClusterTree tree{reinterpret_cast<const float4*>(boxes),
                           reinterpret_cast<const float4*>(nodes), n_boxes,
                           margin * (scale + max_abs_origin(r))};
    const float4* rows = reinterpret_cast<const float4*>(tris);
    // A box entered at tn >= tm holds no blocking hit (t > tn): the bound
    // is the ray's own tmax throughout.
    walk_tree(r, s, tmin, tm, tree, g, s_ref[g.slot], s_tn[g.slot],
              [&](int c, float*) {
                blocked = tpt::cluster_blocked(r, rows, c * cluster, cluster,
                                               G, g, tmin, tm);
                return blocked;
              });
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
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

}  // extern "C"
