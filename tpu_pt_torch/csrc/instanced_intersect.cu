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
// Tables (intersect/instanced.py):
// - inst_rows [I, 16] f32: cols 0:12 the instance's mesh-from-world
//   (inverse) 3x4, row-major; col 12 its first cluster, col 13 its
//   cluster count (both whole numbers), col 14 its id;
// - inst_boxes [I, 8] f32: the instance's world box (min xyz, max xyz),
//   then the two coefficients (a, b) of its world culling margin;
// - cboxes [C, 8] f32: mesh-space boxes of the clusters of `cluster` (128)
//   packed mesh rows; tris [C * cluster, 16] f32, the mesh-space rows.
// Padding instances have a far-point box (3e37) and no clusters.
//
// Porting the function, not the TPU schedule. The TPU kernels sweep a
// 256-ray tile's shared list of candidate instances, built outside the
// kernel over sorted rays, because VMEM holds the tables and a tile
// shares one schedule. Here each thread traverses for its own ray in one
// launch: a flat loop over the instances' world boxes; for each box the
// ray pierces before its best hit, the ray is moved into mesh space by
// the inverse 3x4 (the direction is left unnormalised, so t stays the
// world parameter and best hits compare across instances), and the
// clusters of that instance's mesh are culled by their mesh-space boxes;
// the 128 rows of each remaining cluster take pe_test (pe_block.cuh).
//
// What bounds them on this card: FP32 ALU and divergence, as for the
// clustered kernels. Every thread runs one slab test (~25 flops) per
// instance (1,001 on the forest) and, per pierced instance, an 18-flop
// transform, one slab test per cluster of its mesh and ~28 flops and one
// IEEE division per row of the pierced clusters. A warp executes the
// union of its lanes' instances and clusters; the tables (128 KB of rows
// and 32 KB of instances on the forest) stay in L1/L2 and are read with
// read-only loads. Later work: a hierarchy above the instances (the flat
// loop is O(instances) per ray), a sort of rays by coherence so that a
// warp's lanes pierce the same instances, or a warp per ray that splits
// a pierced cluster's rows over its lanes.
//
// Correctness notes:
// - Results are bitwise those of the plain versions (instanced.py), which
//   sweep every row of every instance densely after the same transform:
//   the transform is written in the plain version's operation order and
//   built with --fmad=false, culled boxes hold no hit that could change
//   the result, and the best hit is replaced on t < best, or on an equal t
//   with a lower (instance, row), so the visit order does not matter.
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

#include "pe_block.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block, one thread per ray
using tpt::kTFar;
using tpt::load_ray;
using tpt::make_slab;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::slab_passes;

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

// Does the world ray meet instance c's world box, grown by its margin
// a * max|o| + b, within (tmin, bound]?
__device__ __forceinline__ bool instance_passes(
    const Ray& w, const Slab& ws, float w_omax,
    const float4* __restrict__ inst_boxes, int c, float tmin, float bound) {
  const float4 a = __ldg(inst_boxes + 2 * (size_t)c);
  const float4 b = __ldg(inst_boxes + 2 * (size_t)c + 1);
  return slab_passes(w, ws, a, b, b.z * w_omax + b.w, tmin, bound);
}

__device__ __forceinline__ bool cluster_passes(
    const Ray& r, const Slab& s, float m, const float4* __restrict__ cboxes,
    int j, float tmin, float bound) {
  return slab_passes(r, s, __ldg(cboxes + 2 * (size_t)j),
                     __ldg(cboxes + 2 * (size_t)j + 1), m, tmin, bound);
}

__global__ void __launch_bounds__(kThreads)
closest_inst_kernel(const float* __restrict__ orig,
                    const float* __restrict__ dir,
                    const float* __restrict__ tris,
                    const float* __restrict__ cboxes,
                    const float* __restrict__ inst_rows,
                    const float* __restrict__ inst_boxes, int n_rays,
                    int n_inst, int cluster, float scale, float margin,
                    float tmin, float tmax, float* __restrict__ t_out,
                    int* __restrict__ row_out, int* __restrict__ inst_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray w = load_ray(orig, dir, i);
  const Slab ws = make_slab(w);
  const float w_omax = max_abs_origin(w);
  const float4* ib = reinterpret_cast<const float4*>(inst_boxes);
  const float4* ir = reinterpret_cast<const float4*>(inst_rows);
  const float4* cb = reinterpret_cast<const float4*>(cboxes);
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0, best_inst = 0;
  for (int c = 0; c < n_inst; ++c) {
    if (!instance_passes(w, ws, w_omax, ib, c, tmin, fminf(best, tmax)))
      continue;
    const float4* m = ir + 4 * (size_t)c;
    const Ray r = xform_ray(w, __ldg(m), __ldg(m + 1), __ldg(m + 2));
    const float4 meta = __ldg(m + 3);  // (first cluster, count, id, -)
    const Slab s = make_slab(r);
    const float mm = margin * (scale + max_abs_origin(r));
    const int j_end = (int)meta.x + (int)meta.y;
    for (int j = (int)meta.x; j < j_end; ++j) {
      if (!cluster_passes(r, s, mm, cb, j, tmin, fminf(best, tmax)))
        continue;
      const int base = j * cluster;
      for (int k = 0; k < cluster; ++k) {
        const int row = base + k;
        const float4* p = rows + 4 * (size_t)row;
        float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin);
        if (!(t < tmax)) t = kTFar;
        if (t < best || (t == best && t < kTFar &&
                         (c < best_inst || (c == best_inst && row < best_row)))) {
          best = t;
          best_row = row;
          best_inst = c;
        }
      }
    }
  }
  const bool hit = best < kTFar;
  t_out[i] = best;
  row_out[i] = hit ? best_row : 0;
  inst_out[i] = hit ? best_inst : 0;
}

__global__ void __launch_bounds__(kThreads)
occluded_inst_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dir,
                     const float* __restrict__ tmax,
                     const float* __restrict__ tris,
                     const float* __restrict__ cboxes,
                     const float* __restrict__ inst_rows,
                     const float* __restrict__ inst_boxes, int n_rays,
                     int n_inst, int cluster, float scale, float margin,
                     float tmin, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0).
  if (tm > tmin) {
    const Ray w = load_ray(orig, dir, i);
    const Slab ws = make_slab(w);
    const float w_omax = max_abs_origin(w);
    const float4* ib = reinterpret_cast<const float4*>(inst_boxes);
    const float4* ir = reinterpret_cast<const float4*>(inst_rows);
    const float4* cb = reinterpret_cast<const float4*>(cboxes);
    const float4* rows = reinterpret_cast<const float4*>(tris);
    for (int c = 0; c < n_inst && !blocked; ++c) {
      if (!instance_passes(w, ws, w_omax, ib, c, tmin, tm)) continue;
      const float4* m = ir + 4 * (size_t)c;
      const Ray r = xform_ray(w, __ldg(m), __ldg(m + 1), __ldg(m + 2));
      const float4 meta = __ldg(m + 3);
      const Slab s = make_slab(r);
      const float mm = margin * (scale + max_abs_origin(r));
      const int j_end = (int)meta.x + (int)meta.y;
      for (int j = (int)meta.x; j < j_end && !blocked; ++j) {
        if (!cluster_passes(r, s, mm, cb, j, tmin, tm)) continue;
        const int base = j * cluster;
        // Any-hit: the thread stops at its first blocking row.
        for (int k = 0; k < cluster && !blocked; ++k) {
          const float4* p = rows + 4 * (size_t)(base + k);
          if (!(__ldg(p + 3).y < 0.5f)) continue;  // refractive rows pass light
          blocked = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin) < tm;
        }
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
// Every table is f32 and 16-byte aligned; `scale` is the mesh-space
// cluster boxes' largest coordinate magnitude and `margin` the relative
// culling margin (instanced.py, clustered.BOX_MARGIN).

int tpt_closest_inst(const float* orig, const float* dir, const float* tris,
                     const float* cboxes, const float* inst_rows,
                     const float* inst_boxes, int n_rays, int n_inst,
                     int cluster, float scale, float margin, float tmin,
                     float tmax, float* t_out, int* row_out, int* inst_out,
                     void* stream) {
  closest_inst_kernel<<<grid_for(n_rays), kThreads, 0,
                        (cudaStream_t)stream>>>(
      orig, dir, tris, cboxes, inst_rows, inst_boxes, n_rays, n_inst,
      cluster, scale, margin, tmin, tmax, t_out, row_out, inst_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_inst(const float* orig, const float* dir, const float* tmax,
                      const float* tris, const float* cboxes,
                      const float* inst_rows, const float* inst_boxes,
                      int n_rays, int n_inst, int cluster, float scale,
                      float margin, float tmin, uint8_t* occ_out,
                      void* stream) {
  occluded_inst_kernel<<<grid_for(n_rays), kThreads, 0,
                         (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, cboxes, inst_rows, inst_boxes, n_rays, n_inst,
      cluster, scale, margin, tmin, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
