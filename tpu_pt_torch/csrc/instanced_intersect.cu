// Instanced (two-level) ray-triangle kernels for Hopper (sm_90a): glTF
// scenes that keep their instances, such as the 1,001-instance forest.
//
// They replace the instanced Pallas TPU kernels
// (tpu_pt/intersect/pallas_inst.py):
//
//   tpt_closest_inst   <- _closest_kernel_inst (:236), launched by
//                         _closest_call_inst (:338): per ray, the closest
//                         (t, mesh row, instance) with t < tmax.
//   tpt_occluded_inst  <- _occluded_kernel_inst (:292), launched by
//                         _occluded_call_inst (:384): is any
//                         non-refractive row of any instance hit with
//                         tmin < t < tmax_ray?
//
// Both are walks of a tree over the instances (below).
//
// Tables (intersect/instanced.py):
// - inst_rows [I, 16] f32: cols 0:12 the instance's mesh-from-world
//   (inverse) 3x4, row-major; col 12 its first cluster, col 13 its
//   cluster count (both whole numbers), col 14 its id;
// - inst_boxes [I, 8] f32: the instance's world box (min xyz, max xyz),
//   then the two coefficients (a, b) of its world culling margin;
// - inst_nodes [n - 1, 12] f32 (instanced.instance_tree): a tree over
//   the n real instances, ordered by a median split of their world-box
//   centres; a node's box is the exact union of its children's and its
//   (a, b) their element-wise max (walk.cuh, InstanceTree, says why the
//   cull stays exact); leaves reference the instances by their index in
//   inst_rows, so the tie rule and the inst output are unchanged;
// - cboxes [C, 8] f32: mesh-space boxes of the clusters of `cluster` (128)
//   packed mesh rows; tris [C * cluster, 16] f32, the mesh-space rows.
// Padding instances, and the empty meshes of a subset table (foliage's
// opaque occluders), have a far-point box (3e37) and no clusters; they
// stay out of the tree (0 or 1 real instances: a root leaf).
//
// Porting the function, not the TPU schedule. The TPU kernels sweep a
// 256-ray tile's shared list of candidate instances, built outside the
// kernel over sorted rays, because VMEM holds the tables and a tile
// shares one schedule. Here one launch traverses per ray: for each
// instance box the ray pierces before its best hit (or its shadow tmax),
// the ray is moved into mesh space by the inverse 3x4 (the direction is
// left unnormalised, so t stays the world parameter and best hits compare
// across instances), and the clusters of that instance's mesh are culled
// by their mesh-space boxes; the 128 rows of each remaining cluster take
// pe_test (pe_block.cuh).
//
// Why a walk. A flat design (a thread a ray, every instance box
// slab-tested in table order, then the clusters swept one row at a time)
// tests all 1,001 instance boxes of the forest (601 on foliage) in each
// thread, whatever its ray pierces; at the frame's 16,384 rays, blocks of
// 128 threads give 128 blocks, 4 warps on an SM that holds 64: it
// reached 1.2% of K9's bound and 4.3% of K10's (PERF.md). A walk gives
// one ray to a group of G lanes (16,384 rays x 16 lanes = 262,144
// threads), which walks the instance tree near first (walk_tree of
// walk.cuh, as K6 / K8 and K5 do):
// K9 with bound min(best, tmax), K10 at the ray's own tmax, which an
// any-hit never lowers. At an instance leaf every lane forms the same
// mesh-space ray, the lanes split the instance's cluster boxes and ballot
// the ones that pass, and each passing cluster is swept by the whole
// group, 128 / G rows a lane: K9 folds them with xor shuffles on
// (t, instance, row) and lowers the bound; K10 votes with one ballot
// (cluster_blocked) and ends the walk at the first blocked cluster.
// What bounds them now: the instance-node and cluster-box tests a ray
// reaches and the latency of their dependent loads (the tables, 128 KB of
// rows and 48 KB of instances and nodes on the forest, stay in L1 / L2).
// A shadow ray that reaches the light walks every node it passes at its
// full tmax; one that is blocked stops after a path.
//
// Correctness notes:
// - Results are bitwise those of the plain versions (instanced.py), which
//   sweep every row of every instance densely after the same transform:
//   the transform is written in the plain version's operation order and
//   built with --fmad=false, culled boxes hold no hit that could change
//   the result, and the best hit is replaced on t < best, or on an equal t
//   with a lower (instance, row), so the visit order does not matter (an
//   any-hit's flag does not depend on it at all).
// - Exact culling. Mesh-space cluster boxes grow by
//     margin * (scale + max_k |o_m,k|),
//   the clustered kernels' rule applied to the mesh-space ray o_m + t d_m
//   that the row test sees (clustered.BOX_MARGIN). A world box is tested
//   with the world ray, but the hit was found in mesh space: the world
//   point o + t d differs from M (o_m + t d_m) + T by the rounding of the
//   transform (the f32 inverse entries and the transformed origin and
//   direction), a few ulps of ||M|| (||M^-1|| (|o| + |p|) + |m3|), with
//   m3 the inverse's translation column and |p| at most the largest
//   world-box coordinate scale_w. So a world box grows by
//     a * max_k |o_k| + b,  a = margin * K,
//     b = margin * (K * scale_w + ||M||inf * max|m3|),
//   K = ||M||inf ||M^-1||inf >= 1 (the mirrored and non-uniformly scaled
//   instances of the tests have K up to ~4), computed on the host in
//   float64 (instanced.culling_margins). margin = 1e-4 is over ten times
//   both rounding bounds.
// - The slab tests take _ray_inv's guarded reciprocal, so every slab
//   quantity is finite or +-inf, never NaN. Parked lanes (origin 3e7) find
//   every box behind them; padding instances (box at 3e37) fail for every
//   ray and have no clusters. K10 returns at once when tmax <= tmin.

#include "walk.cuh"

namespace {

using tpt::kTFar;
using tpt::load_ray;
using tpt::make_slab;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;

// World ray -> instance mesh space by the inverse 3x4 rows a, b, c
// (_xform_ray, pallas_inst.py:221; instanced._xform's operation order).
__device__ __forceinline__ Ray xform_ray(const Ray& w, float4 a, float4 b,
                                         float4 c) {
  return Ray{a.x * w.ox + a.y * w.oy + a.z * w.oz + a.w,
             b.x * w.ox + b.y * w.oy + b.z * w.oz + b.w,
             c.x * w.ox + c.y * w.oy + c.z * w.oz + c.w,
             a.x * w.dx + a.y * w.dy + a.z * w.dz,
             b.x * w.dx + b.y * w.dy + b.z * w.dz,
             c.x * w.dx + c.y * w.dy + c.z * w.dz};
}

// K9 as a walk: one ray to a group of G lanes over the instance tree,
// then over each reached instance's clusters.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_inst_tree_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir,
                         const float* __restrict__ tris,
                         const float* __restrict__ cboxes,
                         const float* __restrict__ inst_rows,
                         const float* __restrict__ inst_boxes,
                         const float* __restrict__ inst_nodes, int inst_root,
                         int n_rays, int cluster, float scale, float margin,
                         float tmin, float tmax, float* __restrict__ t_out,
                         int* __restrict__ row_out,
                         int* __restrict__ inst_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  // The group's first lane within the warp: ballot bit k + base is the
  // group's lane k.
  const int base_lane = (threadIdx.x & 31) - g.lane;
  const Ray w = load_ray(orig, dir, i);
  const tpt::InstanceTree tree{reinterpret_cast<const float4*>(inst_boxes),
                               reinterpret_cast<const float4*>(inst_nodes),
                               inst_root, max_abs_origin(w)};
  const float4* ir = reinterpret_cast<const float4*>(inst_rows);
  const float4* cb = reinterpret_cast<const float4*>(cboxes);
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0, best_inst = 0;
  tpt::walk_tree(
      w, make_slab(w), tmin, fminf(best, tmax), tree, g, s_ref[g.slot],
      s_tn[g.slot], [&](int c, float* bound) {
        const float4* m = ir + 4 * (size_t)c;
        const Ray r = xform_ray(w, __ldg(m), __ldg(m + 1), __ldg(m + 2));
        const float4 meta = __ldg(m + 3);  // (first cluster, count, id, -)
        const Slab s = make_slab(r);
        const float mm = margin * (scale + max_abs_origin(r));
        const int j_end = (int)meta.x + (int)meta.y;
        for (int j0 = (int)meta.x; j0 < j_end; j0 += G) {
          // Each lane tests one cluster box of this chunk of G.
          const int j = j0 + g.lane;
          float tn = 0.0f;
          const bool pass =
              j < j_end &&
              tpt::slab_enter(r, s, __ldg(cb + 2 * (size_t)j),
                              __ldg(cb + 2 * (size_t)j + 1), mm, tmin, &tn) &&
              tn <= *bound;
          unsigned vote = (__ballot_sync(g.mask, pass) & g.mask) >> base_lane;
          while (vote) {
            const int k = __ffs(vote) - 1;
            vote &= vote - 1;
            // The bound may have dropped since the vote.
            if (!(__shfl_sync(g.mask, tn, k, G) <= *bound)) continue;
            const int base = (j0 + k) * cluster;
            float tl = best;
            int il = best_inst, rl = best_row;
            for (int q = g.lane; q < cluster; q += G) {
              const int row = base + q;
              const float4* p = rows + 4 * (size_t)row;
              float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2),
                                tmin);
              if (!(t < tmax)) t = kTFar;
              if (t < tl || (t == tl && t < kTFar &&
                             (c < il || (c == il && row < rl)))) {
                tl = t;
                il = c;
                rl = row;
              }
            }
#pragma unroll
            for (int h = G / 2; h >= 1; h >>= 1) {
              const float to = __shfl_xor_sync(g.mask, tl, h);
              const int io = __shfl_xor_sync(g.mask, il, h);
              const int ro = __shfl_xor_sync(g.mask, rl, h);
              if (to < tl ||
                  (to == tl && (io < il || (io == il && ro < rl)))) {
                tl = to;
                il = io;
                rl = ro;
              }
            }
            best = tl;
            best_inst = il;
            best_row = rl;
            *bound = fminf(best, tmax);
          }
        }
        return false;
      });
  if (g.lane != 0) return;
  const bool hit = best < kTFar;
  t_out[i] = best;
  row_out[i] = hit ? best_row : 0;
  inst_out[i] = hit ? best_inst : 0;
}

// K10 as a walk: one ray to a group of G lanes over the instance tree at
// the fixed bound tmax[i] (an any-hit never lowers it), then over each
// reached instance's clusters; the walk ends at the first blocked one.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
occluded_inst_tree_kernel(const float* __restrict__ orig,
                          const float* __restrict__ dir,
                          const float* __restrict__ tmax,
                          const float* __restrict__ tris,
                          const float* __restrict__ cboxes,
                          const float* __restrict__ inst_rows,
                          const float* __restrict__ inst_boxes,
                          const float* __restrict__ inst_nodes,
                          int inst_root, int n_rays, int cluster, float scale,
                          float margin, float tmin,
                          uint8_t* __restrict__ occ_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0); the whole group skips the walk.
  if (tm > tmin) {
    const int base_lane = (threadIdx.x & 31) - g.lane;
    const Ray w = load_ray(orig, dir, i);
    const tpt::InstanceTree tree{reinterpret_cast<const float4*>(inst_boxes),
                                 reinterpret_cast<const float4*>(inst_nodes),
                                 inst_root, max_abs_origin(w)};
    const float4* ir = reinterpret_cast<const float4*>(inst_rows);
    const float4* cb = reinterpret_cast<const float4*>(cboxes);
    const float4* rows = reinterpret_cast<const float4*>(tris);
    tpt::walk_tree(
        w, make_slab(w), tmin, tm, tree, g, s_ref[g.slot], s_tn[g.slot],
        [&](int c, float*) {
          const float4* m = ir + 4 * (size_t)c;
          const Ray r = xform_ray(w, __ldg(m), __ldg(m + 1), __ldg(m + 2));
          const float4 meta = __ldg(m + 3);  // (first cluster, count, id, -)
          const Slab s = make_slab(r);
          const float mm = margin * (scale + max_abs_origin(r));
          const int j_end = (int)meta.x + (int)meta.y;
          for (int j0 = (int)meta.x; j0 < j_end; j0 += G) {
            // Each lane tests one cluster box of this chunk of G.
            const int j = j0 + g.lane;
            float tn = 0.0f;
            const bool pass =
                j < j_end &&
                tpt::slab_enter(r, s, __ldg(cb + 2 * (size_t)j),
                                __ldg(cb + 2 * (size_t)j + 1), mm, tmin,
                                &tn) &&
                tn <= tm;
            unsigned vote =
                (__ballot_sync(g.mask, pass) & g.mask) >> base_lane;
            // The vote is the group's: every lane sweeps the same clusters
            // and reaches each ballot of cluster_blocked.
            while (vote) {
              const int k = __ffs(vote) - 1;
              vote &= vote - 1;
              if (tpt::cluster_blocked(r, rows, (j0 + k) * cluster, cluster,
                                       G, g, tmin, tm)) {
                blocked = true;
                return true;
              }
            }
          }
          return false;
        });
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).
// Every table is f32 and 16-byte aligned; `scale` is the mesh-space
// cluster boxes' largest coordinate magnitude and `margin` the relative
// culling margin (instanced.py, clustered.BOX_MARGIN). tpt_closest_inst
// and tpt_occluded_inst also take the instance tree (`inst_nodes`, the
// reference `inst_root` of its root: node 0, or the only real instance's
// leaf) and the walk's lanes a ray (4, 8, 16 or 32).

int tpt_closest_inst(const float* orig, const float* dir, const float* tris,
                     const float* cboxes, const float* inst_rows,
                     const float* inst_boxes, const float* inst_nodes,
                     int inst_root, int n_rays, int cluster, float scale,
                     float margin, float tmin, float tmax, float* t_out,
                     int* row_out, int* inst_out, int group, void* stream) {
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_inst_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, tris, cboxes, inst_rows,
                                   inst_boxes, inst_nodes, inst_root, n_rays,
                                   cluster, scale, margin, tmin, tmax, t_out,
                                   row_out, inst_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_occluded_inst(const float* orig, const float* dir, const float* tmax,
                      const float* tris, const float* cboxes,
                      const float* inst_rows, const float* inst_boxes,
                      const float* inst_nodes, int inst_root, int n_rays,
                      int cluster, float scale, float margin, float tmin,
                      uint8_t* occ_out, int group, void* stream) {
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    occluded_inst_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, tmax, tris, cboxes, inst_rows,
                                   inst_boxes, inst_nodes, inst_root, n_rays,
                                   cluster, scale, margin, tmin, occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
