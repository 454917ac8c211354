// Clustered ray-triangle kernels that build their candidate list inside
// the kernel, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels that build their candidate list
// inside the kernel (tpu_pt/intersect/pallas_bf.py, TPT_INKB=1):
//
//   tpt_closest_clustered_b       <- _closest_kernel_clustered_lean_b (:1137)
//                                    and _closest_kernel_chained_lean_b
//                                    (:1157): closest (t, packed row).
//   tpt_closest_clustered_full_b  <- _closest_kernel_clustered_b (:1088) and
//                                    _closest_kernel_chained_b (:1108): the
//                                    same with the full carry (normal,
//                                    material, original id, u, v).
//   tpt_occluded_clustered_b      <- _occluded_kernel_clustered_b (:1182):
//                                    any-hit, the list bounded by each ray's
//                                    own tmax.
//   The list is what _build_cand_table (:618) builds: the boxes a ray
//   pierces within its bound. Each pair of TPU bodies (clustered / chained)
//   is one entry point here: the chained bodies exist because a TPU table
//   is cut into VMEM slabs, and these kernels sweep the whole table in one
//   launch.
//
// One design for all three: one ray to a group of G lanes (walk.cuh's
// Group), and nothing shared across rays. The group builds its own ray's
// list as it goes: its lanes slab-test the boxes G at a time in box order
// (lane l the box base + l, with the grown boxes of clustered.BOX_MARGIN),
// a ballot gives the ones that pass, and the group sweeps each passing
// cluster at once, lowest box first, its rows split over its lanes and
// read through L1 / L2 (the big mesh's 6.4 MB table fits the H100's 50 MB),
// so no row buffer caps a cluster's rows. No barrier, no shared list, and
// no lane sweeps a cluster its own ray's box test fails.
//
// K7 (lean and full): list_walk.cuh's sweep_boxes over every box, the loop
// K11 runs a slab at a time. A box passes when the ray enters it at
// tn <= min(best, tmax), as the chained TPU bodies bound a slab's list by
// the prior t; the entry is held against the bound again before the sweep,
// since best shrinks within a chunk. The sweep (sweep_cluster) tests every
// G-th row a lane and folds (t, row) by xor shuffles, ties to the lowest
// row; lane 0 writes the result (K7 full: the full carry, write_attrs).
//
// K8b: the same loop against the ray's own tmax, each passing cluster swept
// with cluster_blocked; it stops at its first blocked cluster.
//
// What bounds them is the same as before: every ray slab-tests every box
// (the TPU schedule, no tree: walking the tree is K6's and K8's), 24 flops
// a test; G lanes share one ray's tests, so a ray costs C / G steps of one
// test a lane. G is a template parameter (4, 8, 16, 32), picked by
// clustered.closest_b_group (K7) and clustered.occluded_b_group (K8b) from
// the ray count as tools/inkb_ab_torch.py --widths and
// tools/clustered_group_trial.py measured (PERF.md).
//
// Built with --fmad=false like every kernel here: the results equal
// tpt_closest_clustered(_full) / tpt_occluded_clustered and the plain
// dense sweeps bit for bit (refractive rows pass light; parked lanes, tmax
// 0 or an origin far outside the scene, pass no box). A group's branches
// are uniform over its lanes, which hold the same ray; whole groups leave
// together past n_rays.

#include "list_walk.cuh"

namespace {

using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::Ray;
using tpt::Slab;

// K7: one ray to a group of G lanes, which sweeps every box (see the note
// at the top).
template <int G, bool kFull>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_clustered_b_kernel(const float* __restrict__ orig,
                           const float* __restrict__ dir,
                           const float* __restrict__ tris,
                           const float* __restrict__ boxes, int n_rays,
                           int n_boxes, int cluster, float scale,
                           float margin, float tmin, float tmax, int want_uv,
                           float* __restrict__ t_out,
                           int* __restrict__ row_out,
                           float* __restrict__ nrm_out,
                           int* __restrict__ mat_out,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out) {
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  float best = kTFar;
  int best_row = 0;
  tpt::sweep_boxes<G>(r, s, m, reinterpret_cast<const float4*>(boxes),
                      reinterpret_cast<const float4*>(tris), 0, n_boxes,
                      cluster, g, tmin, tmax, best, best_row);
  if (g.lane != 0) return;
  t_out[i] = best;
  if (kFull)
    tpt::write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out,
                     u_out, v_out, row_out);
  else
    row_out[i] = best < kTFar ? best_row : 0;
}

// K8b: one ray to a group of G lanes, which tests the boxes G at a time
// and sweeps each one that passes at once (see the note at the top).
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
occluded_clustered_b_kernel(const float* __restrict__ orig,
                            const float* __restrict__ dir,
                            const float* __restrict__ tmax,
                            const float* __restrict__ tris,
                            const float* __restrict__ boxes, int n_rays,
                            int n_boxes, int cluster, float scale,
                            float margin, float tmin,
                            uint8_t* __restrict__ occ_out) {
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
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
    for (int base = 0; base < n_boxes && !blocked; base += G) {
      const int b = base + g.lane;
      // A box entered at tn >= tm holds no blocking hit (t > tn).
      unsigned pass = tpt::group_ballot(
          g, b < n_boxes && tpt::box_passes(r, s, m, bx, b, tmin, tm));
      while (pass != 0u && !blocked) {
        const int c = base + __ffs(pass) - 1;
        pass &= pass - 1u;
        blocked = tpt::cluster_blocked(r, rows, c * cluster, cluster, G, g,
                                       tmin, tm);
      }
    }
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

template <bool kFull>
int launch_closest(int group, cudaStream_t stream, const float* orig,
                   const float* dir, const float* tris, const float* boxes,
                   int n_rays, int n_boxes, int cluster, float scale,
                   float margin, float tmin, float tmax, int want_uv,
                   float* t_out, int* row_out, float* nrm_out, int* mat_out,
                   float* u_out, float* v_out) {
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_clustered_b_kernel<G, kFull>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0, stream>>>(
            orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
            tmin, tmax, want_uv, t_out, row_out, nrm_out, mat_out, u_out,
            v_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` at `group` lanes a ray (a width
// built here: 4, 8, 16, 32), allocates nothing, does not synchronise, and
// returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for any other width. Arguments as the entry points
// of clustered_intersect.cu.

int tpt_closest_clustered_b(const float* orig, const float* dir,
                            const float* tris, const float* boxes, int n_rays,
                            int n_boxes, int cluster, float scale,
                            float margin, float tmin, float tmax, float* t_out,
                            int* row_out, int group, void* stream) {
  return launch_closest<false>(group, (cudaStream_t)stream, orig, dir, tris,
                               boxes, n_rays, n_boxes, cluster, scale, margin,
                               tmin, tmax, 0, t_out, row_out, nullptr,
                               nullptr, nullptr, nullptr);
}

int tpt_closest_clustered_full_b(const float* orig, const float* dir,
                                 const float* tris, const float* boxes,
                                 int n_rays, int n_boxes, int cluster,
                                 float scale, float margin, float tmin,
                                 float tmax, int want_uv, float* t_out,
                                 int* id_out, float* nrm_out, int* mat_out,
                                 float* u_out, float* v_out, int group,
                                 void* stream) {
  return launch_closest<true>(group, (cudaStream_t)stream, orig, dir, tris,
                              boxes, n_rays, n_boxes, cluster, scale, margin,
                              tmin, tmax, want_uv, t_out, id_out, nrm_out,
                              mat_out, u_out, v_out);
}

int tpt_occluded_clustered_b(const float* orig, const float* dir,
                             const float* tmax, const float* tris,
                             const float* boxes, int n_rays, int n_boxes,
                             int cluster, float scale, float margin,
                             float tmin, uint8_t* occ_out, int group,
                             void* stream) {
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    occluded_clustered_b_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, tmax, tris, boxes, n_rays,
                                   n_boxes, cluster, scale, margin, tmin,
                                   occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
