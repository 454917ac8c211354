// Dense single-slab ray-triangle kernels for Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels on the path tracer's main path
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
//
// Packed rows are [T, 16] f32 as tpu_pt_torch.intersect.dense.pack_tris
// builds them: n xyz, d0, wu xyz, cu, wv xyz, cv, valid, refr, mat, id.
// The per-pair test is the plane + edge-function form of _pe_block
// (pallas_bf.py:478-526): t from the triangle plane, u and v as affine
// functions of the hit point.
//
// What bounds them on this card: FP32 ALU. A ray x row pair costs ~28
// flops (plus one IEEE division); a main-path call is 262,144 rays x 432
// rows ~ 3.2 GFLOP against 80 bytes of ray data per ray and a 27 KB row
// table. The design answer is the simple one: one thread per ray keeps its
// ray and running best in registers; the row table is staged through shared
// memory in tiles of 256 rows (16 KB), read by every thread of the block as
// a broadcast, so device memory is touched once per block per row.
//
// Correctness notes:
// - Ties: rows are visited in ascending order and the best is replaced
//   only on a strict t < best, which is the TPU kernels' "lowest row among
//   equal t" rule (pallas_bf.py:706-721).
// - No validity column is read: padded and degenerate rows have a zero
//   normal, so 1/ndotd is inf and t is NaN or inf; every NaN comparison is
//   false, so such rows reject themselves. This needs IEEE inf/NaN: never
//   build with --use_fast_math.
// - NaN in u/v: on the TPU the full-carry kernel reduced u/v with masked
//   sums, and one degenerate row's NaN once poisoned them (the round-2/3
//   whitted shading bug, ARCHITECTURE.md:435-448, invisible to CPU tests).
//   Here no reduction exists: u and v are recomputed once, from the winning
//   row only, after the loop, and written as 0 on a miss.
// - The library is built with --fmad=false, so each multiply and add rounds
//   on its own exactly as the plain PyTorch version in dense.py does; the
//   kernel then agrees with it bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // rays per block, one thread per ray
constexpr int kTileRows = 256;  // packed rows staged per shared-memory tile
constexpr int kCols = 16;       // floats per packed row (4 x float4)
constexpr float kTFar = 1e16f;  // miss sentinel (tpu_pt.intersect.moller.T_FAR)

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dir,
                                        int i) {
  const float* o = orig + 3 * (size_t)i;
  const float* d = dir + 3 * (size_t)i;
  return Ray{o[0], o[1], o[2], d[0], d[1], d[2]};
}

// Plane + edge test of one ray against one packed row; the operation order
// is dense._pe_block's. Returns t on a hit, kTFar otherwise.
__device__ __forceinline__ float pe_test(const Ray& r, float4 a, float4 b,
                                         float4 c, float tmin) {
  // a = (nx, ny, nz, d0), b = (wux, wuy, wuz, cu), c = (wvx, wvy, wvz, cv)
  const float ndotd = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float rcp = 1.0f / ndotd;
  const float t = (a.w - (a.x * r.ox + a.y * r.oy + a.z * r.oz)) * rcp;
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  const float u = b.x * px + b.y * py + b.z * pz + b.w;
  const float v = c.x * px + c.y * py + c.z * pz + c.w;
  const bool hit = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > tmin);
  return hit ? t : kTFar;
}

// Cooperative copy of rows [base, base + rows) into shared memory.
__device__ __forceinline__ void stage_rows(float4* s_rows,
                                           const float* __restrict__ tris,
                                           int base, int rows) {
  const float4* src = reinterpret_cast<const float4*>(tris + (size_t)base * kCols);
  for (int k = threadIdx.x; k < rows * 4; k += blockDim.x) s_rows[k] = src[k];
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

  float best = kTFar;
  int best_row = 0;
  for (int base = 0; base < n_rows; base += kTileRows) {
    const int rows = min(kTileRows, n_rows - base);
    __syncthreads();  // the previous tile is no longer read
    stage_rows(s_rows, tris, base, rows);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      float t = pe_test(r, s_rows[4 * j], s_rows[4 * j + 1],
                        s_rows[4 * j + 2], tmin);
      if (kFull && !(t < tmax)) t = kTFar;
      if (t < best) {
        best = t;
        best_row = base + j;
      }
    }
  }
  if (!live) return;

  const bool hit = best < kTFar;
  t_out[i] = best;
  row_out[i] = hit ? best_row : 0;
  if (!kFull) return;

  float nx = 0.0f, ny = 0.0f, nz = 0.0f, u = 0.0f, v = 0.0f;
  int mat = 0;
  if (hit) {
    const float* row = tris + (size_t)best_row * kCols;
    nx = row[0];
    ny = row[1];
    nz = row[2];
    mat = (int)row[14];
    if (want_uv) {
      const float px = r.ox + best * r.dx;
      const float py = r.oy + best * r.dy;
      const float pz = r.oz + best * r.dz;
      u = row[4] * px + row[5] * py + row[6] * pz + row[7];
      v = row[8] * px + row[9] * py + row[10] * pz + row[11];
    }
  }
  nrm_out[3 * (size_t)i] = nx;
  nrm_out[3 * (size_t)i + 1] = ny;
  nrm_out[3 * (size_t)i + 2] = nz;
  mat_out[i] = mat;
  u_out[i] = u;
  v_out[i] = v;
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

  bool blocked = false;
  for (int base = 0; base < n_rows; base += kTileRows) {
    // Also the barrier before restaging: the whole block stops as soon as
    // every one of its rays is blocked (or past the end).
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
  if (live) occ_out[i] = blocked ? 1 : 0;
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

}  // extern "C"
