// Clustered ray-triangle kernels for Hopper (sm_90a): scenes above the
// single-slab limit (TRI_SLAB = 8,192 packed rows), such as the 100k-row
// big mesh.
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
//                              site with lean=False: the same traversal with
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
// Porting the function, not the TPU schedule. The TPU kernels sweep a
// 256-ray tile's shared work list, slab by chained slab, because the
// table has to fit in VMEM and a tile shares one list; the ray sort, the
// per-tile candidate tables and the slab chaining exist for that. Here
// the table (6.4 MB at 100k rows) lives in device memory and L2, and each
// thread traverses for its own ray: one launch per call.
//
// What bounds them on this card: FP32 ALU and divergence. A thread runs a
// slab test (~20 flops) against every cluster box, and the plane + edge
// test (~28 flops and one IEEE division per row) on the 128 rows of each
// box its ray pierces before its current best hit. A warp executes the
// union of its lanes' pierced clusters. Boxes and rows are read with
// read-only loads; lanes of a warp sweeping the same cluster read the same
// address (a broadcast), and the table stays in L2. A hierarchy above the
// clusters, shared-memory staging of the boxes and a near-first visiting
// order are later performance work.
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
// - The slab test (pe_block.cuh, slab_passes) takes the eps-guarded
//   reciprocal of _ray_inv (pallas_bf.py:533-542), so axis-parallel rays
//   stay finite, and every quantity it forms is finite or +-inf, never
//   NaN: a collapsed empty cluster (box at 3e37) fails it for every ray.
// - Parked lanes (origin 3e7, tmax 0) find every box behind them and miss.

#include "pe_block.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block, one thread per ray
using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::box_passes;  // cluster c of boxes [C, 8] grown by m

// kFull: row_out takes the winner's original triangle id (column 15) and
// the attribute outputs are written; else row_out takes its packed row.
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
// `tris` is [n_boxes * cluster, 16] f32 and `boxes` [n_boxes, 8] f32, both
// 16-byte aligned; `scale` is the boxes' largest coordinate magnitude and
// `margin` the relative culling margin (clustered.py, BOX_MARGIN).

int tpt_closest_clustered(const float* orig, const float* dir,
                          const float* tris, const float* boxes, int n_rays,
                          int n_boxes, int cluster, float scale, float margin,
                          float tmin, float tmax, float* t_out, int* row_out,
                          void* stream) {
  closest_clustered_kernel<false>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, 0, t_out, row_out, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int tpt_closest_clustered_full(const float* orig, const float* dir,
                               const float* tris, const float* boxes,
                               int n_rays, int n_boxes, int cluster,
                               float scale, float margin, float tmin,
                               float tmax, int want_uv, float* t_out,
                               int* id_out, float* nrm_out, int* mat_out,
                               float* u_out, float* v_out, void* stream) {
  closest_clustered_kernel<true>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, want_uv, t_out, id_out, nrm_out, mat_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_clustered(const float* orig, const float* dir,
                           const float* tmax, const float* tris,
                           const float* boxes, int n_rays, int n_boxes,
                           int cluster, float scale, float margin, float tmin,
                           uint8_t* occ_out, void* stream) {
  occluded_clustered_kernel<<<grid_for(n_rays), kThreads, 0,
                              (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
      tmin, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
