// Dense single-slab ray-triangle kernels for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of the single-slab path
// (tpu_pt/intersect/pallas_bf.py):
//
//   tpt_closest_lean  <- _closest_kernel_lean (body _lean_sweep), launched by
//                        _closest_call_lean: per ray, the minimum t over all
//                        packed rows and the lowest row among equal t.
//   tpt_closest_full  <- _closest_kernel (body _closest_sweep), launched by
//                        _closest_call: the same, clipped at a finite tmax,
//                        plus the winner's normal, material and u/v.
//   tpt_occluded      <- _occluded_kernel (body _occlusion_sweep), launched by
//                        _occluded_call: is any non-refractive row hit with
//                        tmin < t < tmax_ray?
//   tpt_closest_nee_lean
//                     <- _closest_nee_kernel_lean, launched by
//                        _closest_nee_call_lean: tpt_closest_lean's sweep,
//                        then the NEE shadow ray from the hit point to the
//                        light point (lz1, lz2), swept any-hit over the
//                        occluder subset rows.
//   tpt_closest_nee_full
//                     <- _closest_nee_kernel, launched by _closest_nee_call:
//                        tpt_closest_full's sweep (no u/v), then the same
//                        shadow ray swept over all rows.
//
// The per-pair test is pe_test of pe_block.cuh, shared with the clustered
// kernels.
//
// What bounds them on this card: FP32 ALU. A ray x row pair costs ~28
// flops (plus one IEEE division); a main-path call is 262,144 rays x 432
// rows ~ 3.2 GFLOP against 80 bytes of ray data per ray and a 27 KB row
// table. The design answer is the simple one: one thread per ray keeps its
// ray and running best in registers; the row table is staged through shared
// memory in tiles of 256 rows (16 KB), read by every thread of the block as
// a broadcast, so device memory is touched once per block per row. The
// fused kernels run both sweeps in one launch: the shadow ray never leaves
// registers, and one launch replaces two.
//
// Correctness notes:
// - Ties: rows are visited in ascending order and the best is replaced
//   only on a strict t < best, which is the TPU kernels' "lowest row among
//   equal t" rule (pallas_bf.py:706-721).
// - NaN in u/v: on the TPU the full-carry kernel reduced u/v with masked
//   sums, and one degenerate row's NaN once poisoned them (the round-2/3
//   whitted shading bug, ARCHITECTURE.md:435-448, invisible to CPU tests).
//   Here no reduction exists: u and v are recomputed once, from the winning
//   row only, after the loop, and written as 0 on a miss (write_attrs of
//   pe_block.cuh, shared with the clustered full-carry kernels).
// - Padded and degenerate rows reject themselves through IEEE inf/NaN, and
//   the library is built with --fmad=false, so the kernels agree with the
//   plain PyTorch versions in dense.py bit for bit (see pe_block.cuh).
// - The shadow ray's 1/|to_light| is an IEEE sqrtf and an IEEE division
//   (not rsqrtf, ~2 ulp), as the plain version's 1 / torch.sqrt, and the
//   light point is formed as ((corner + v1 lz1) + v2 lz2) - p, the TPU
//   kernel's order. On a miss lane p is o + 1e16 d: the occlusion flag
//   there is written but meaningless (the caller masks it).

#include "pe_block.cuh"

namespace {

constexpr int kThreads = 256;   // rays per block, one thread per ray
constexpr int kTileRows = 256;  // packed rows staged per shared-memory tile
constexpr float kNeeEps = 0.01f;  // shadow-ray range shrink (pallas_bf.NEE_EPS)
using tpt::kCols;
using tpt::kTFar;
using tpt::load_ray;
using tpt::pe_test;
using tpt::Ray;
using tpt::stage_rows;
using tpt::write_attrs;

// Closest-hit sweep over rows [0, n_rows) staged tile by tile through
// s_rows; every thread of the block calls it (non-live threads help stage).
// With kClip, t >= tmax counts as a miss.
template <bool kClip>
__device__ __forceinline__ void closest_sweep(float4* s_rows, const Ray& r,
                                              bool live,
                                              const float* __restrict__ tris,
                                              int n_rows, float tmin,
                                              float tmax, float& best,
                                              int& best_row) {
  best = kTFar;
  best_row = 0;
  for (int base = 0; base < n_rows; base += kTileRows) {
    const int rows = min(kTileRows, n_rows - base);
    __syncthreads();  // the previous tile is no longer read
    stage_rows(s_rows, tris, base, rows);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      float t = pe_test(r, s_rows[4 * j], s_rows[4 * j + 1],
                        s_rows[4 * j + 2], tmin);
      if (kClip && !(t < tmax)) t = kTFar;
      if (t < best) {
        best = t;
        best_row = base + j;
      }
    }
  }
}

// Any-hit sweep: is any non-refractive row hit with tmin < t < tm? Every
// thread of the block calls it; the block stops as soon as every one of
// its rays is blocked (or past the end). The first barrier also protects
// s_rows from a previous sweep's readers.
__device__ __forceinline__ bool occluded_sweep(float4* s_rows, const Ray& r,
                                               bool live, float tm,
                                               const float* __restrict__ tris,
                                               int n_rows, float tmin) {
  bool blocked = false;
  for (int base = 0; base < n_rows; base += kTileRows) {
    if (__syncthreads_and(blocked || !live)) break;
    const int rows = min(kTileRows, n_rows - base);
    stage_rows(s_rows, tris, base, rows);
    __syncthreads();
    if (!live) continue;
    // Per-thread any-hit early exit on the first blocking row.
    for (int j = 0; j < rows && !blocked; ++j) {
      const float4 d = s_rows[4 * j + 3];  // (valid, refr, mat, id)
      if (!(d.y < 0.5f)) continue;         // refractive rows pass light
      const float t = pe_test(r, s_rows[4 * j], s_rows[4 * j + 1],
                              s_rows[4 * j + 2], tmin);
      blocked = t < tm;
    }
  }
  return blocked;
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tris, int n_rays, int n_rows,
               float tmin, float tmax, int want_uv, float* __restrict__ t_out,
               int* __restrict__ row_out, float* __restrict__ nrm_out,
               int* __restrict__ mat_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  float best;
  int best_row;
  closest_sweep<kFull>(s_rows, r, live, tris, n_rows, tmin, tmax, best,
                       best_row);
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
  if (kFull)
    write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out, u_out,
                v_out);
}

__global__ void __launch_bounds__(kThreads)
occluded_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax, const float* __restrict__ tris,
                int n_rays, int n_rows, float tmin,
                uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const float tm = live ? tmax[i] : 0.0f;
  const bool blocked = occluded_sweep(s_rows, r, live, tm, tris, n_rows, tmin);
  if (live) occ_out[i] = blocked ? 1 : 0;
}

// Fused closest hit + NEE shadow ray. kFull: the full-carry closest hit
// (clipped at tmax; normal and material out, no u/v) as _closest_nee_kernel,
// else the lean (t, row) sweep with no clipping, as
// _closest_nee_kernel_lean. light = (corner xyz, v1 xyz, v2 xyz).
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
closest_nee_kernel(const float* __restrict__ orig,
                   const float* __restrict__ dir,
                   const float* __restrict__ lz1,
                   const float* __restrict__ lz2,
                   const float* __restrict__ tris, int n_rows,
                   const float* __restrict__ occ_tris, int n_occ,
                   const float* __restrict__ light, int n_rays, float tmin,
                   float tmax, float* __restrict__ t_out,
                   int* __restrict__ row_out, float* __restrict__ nrm_out,
                   int* __restrict__ mat_out, uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  float best;
  int best_row;
  closest_sweep<kFull>(s_rows, r, live, tris, n_rows, tmin, tmax, best,
                       best_row);

  // The shadow ray, in registers: from p = o + t d toward the light point.
  Ray s{0, 0, 0, 0, 0, 0};
  float tm = 0.0f;
  if (live) {
    const float a = lz1[i], b = lz2[i];
    s.ox = r.ox + best * r.dx;
    s.oy = r.oy + best * r.dy;
    s.oz = r.oz + best * r.dz;
    const float tlx = light[0] + light[3] * a + light[6] * b - s.ox;
    const float tly = light[1] + light[4] * a + light[7] * b - s.oy;
    const float tlz = light[2] + light[5] * a + light[8] * b - s.oz;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float inv = 1.0f / sqrtf(fmaxf(dist2, 1e-12f));
    s.dx = tlx * inv;
    s.dy = tly * inv;
    s.dz = tlz * inv;
    tm = dist2 * inv - kNeeEps;  // |to_light| - eps (cu:1017)
  }
  const bool blocked = occluded_sweep(s_rows, s, live, tm, occ_tris, n_occ,
                                      tmin);
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
  occ_out[i] = blocked ? 1 : 0;
  if (kFull)
    write_attrs(tris, r, i, best, best_row, false, nrm_out, mat_out, nullptr,
                nullptr);
}

inline unsigned grid_for(int n_rays) {
  return (unsigned)((n_rays + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).

int tpt_closest_lean(const float* orig, const float* dir, const float* tris,
                     int n_rays, int n_rows, float tmin, float* t_out,
                     int* row_out, void* stream) {
  closest_kernel<false><<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, n_rays, n_rows, tmin, kTFar, 0, t_out, row_out,
      nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int tpt_closest_full(const float* orig, const float* dir, const float* tris,
                     int n_rays, int n_rows, float tmin, float tmax,
                     int want_uv, float* t_out, int* row_out, float* nrm_out,
                     int* mat_out, float* u_out, float* v_out, void* stream) {
  closest_kernel<true><<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, n_rays, n_rows, tmin, tmax, want_uv, t_out, row_out,
      nrm_out, mat_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int tpt_occluded(const float* orig, const float* dir, const float* tmax,
                 const float* tris, int n_rays, int n_rows, float tmin,
                 uint8_t* occ_out, void* stream) {
  occluded_kernel<<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, n_rays, n_rows, tmin, occ_out);
  return (int)cudaGetLastError();
}

int tpt_closest_nee_lean(const float* orig, const float* dir, const float* lz1,
                         const float* lz2, const float* tris, int n_rows,
                         const float* occ_tris, int n_occ, const float* light,
                         int n_rays, float tmin, float* t_out, int* row_out,
                         uint8_t* occ_out, void* stream) {
  closest_nee_kernel<false>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, lz1, lz2, tris, n_rows, occ_tris, n_occ, light, n_rays,
          tmin, kTFar, t_out, row_out, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

int tpt_closest_nee_full(const float* orig, const float* dir, const float* lz1,
                         const float* lz2, const float* tris, int n_rows,
                         const float* light, int n_rays, float tmin,
                         float tmax, float* t_out, int* row_out,
                         float* nrm_out, int* mat_out, uint8_t* occ_out,
                         void* stream) {
  closest_nee_kernel<true>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, lz1, lz2, tris, n_rows, tris, n_rows, light, n_rays,
          tmin, tmax, t_out, row_out, nrm_out, mat_out, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
