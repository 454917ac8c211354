// The per-pair ray-triangle test shared by every kernel of tpu_pt_torch,
// the full carry written from the winning row, the staging of rows into
// shared memory, and the ray-vs-box slab test of the culling kernels.
//
// Packed rows are [T, 16] f32 as tpu_pt_torch.intersect.dense.pack_tris
// builds them: n xyz, d0, wu xyz, cu, wv xyz, cv, valid, refr, mat, id.
// The test is the plane + edge-function form of _pe_block
// (tpu_pt/intersect/pallas_bf.py:478-526): t from the triangle plane, u and
// v as affine functions of the hit point. Every kernel calls pe_test, so
// all of them evaluate it identically; with --fmad=false each multiply and
// add rounds on its own, in the order of the plain PyTorch version
// (dense._pe_block), and the kernels agree with it bit for bit.
//
// No validity column is read: padded and degenerate rows have a zero
// normal, so 1/ndotd is inf and t is NaN or inf; every NaN comparison is
// false, so such rows reject themselves. This needs IEEE inf/NaN: never
// build with --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpt {

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

// Ray i of packed rays [N, 8] f32 (o xyz, d xyz, tmax, 0: two float4 rows,
// tpu_pt_torch.intersect.ablations.pack_rays); its tmax goes to *tm.
__device__ __forceinline__ Ray load_ray8(const float* __restrict__ rays,
                                         int i, float* tm) {
  const float4* q = reinterpret_cast<const float4*>(rays) + 2 * (size_t)i;
  const float4 a = __ldg(q), b = __ldg(q + 1);
  *tm = b.z;
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y};
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

// Cooperative copy of packed rows [base, base + rows) into shared memory,
// by every thread of the block (coalesced float4 loads).
__device__ __forceinline__ void stage_rows(float4* s_rows,
                                           const float* __restrict__ tris,
                                           int base, int rows) {
  const float4* src = reinterpret_cast<const float4*>(tris + (size_t)base * kCols);
  for (int k = threadIdx.x; k < rows * 4; k += blockDim.x) s_rows[k] = src[k];
}

// One ray against `rows` packed rows staged in shared memory: the closest t
// (kTFar on a miss) and, through *sub, the index of its row (0 on a miss).
// Rows ascend, so a tie keeps the lowest.
__device__ __forceinline__ float sweep_staged(const Ray& r,
                                              const float4* s_rows, int rows,
                                              float tmin, int* sub) {
  float best = kTFar;
  int at = 0;
  for (int j = 0; j < rows; ++j) {
    const float t = pe_test(r, s_rows[4 * j], s_rows[4 * j + 1],
                            s_rows[4 * j + 2], tmin);
    if (t < best) {
      best = t;
      at = j;
    }
  }
  *sub = at;
  return best;
}

// One ray against staged rows, any-hit: is a row whose refractive column
// is < 0.5 hit with tmin < t < tm? Stops at the first such row.
__device__ __forceinline__ bool blocked_staged(const Ray& r,
                                               const float4* s_rows, int rows,
                                               float tmin, float tm) {
  for (int j = 0; j < rows; ++j) {
    if (!(s_rows[4 * j + 3].y < 0.5f)) continue;  // refractive: light passes
    if (pe_test(r, s_rows[4 * j], s_rows[4 * j + 1], s_rows[4 * j + 2],
                tmin) < tm)
      return true;
  }
  return false;
}

// The full carry of a closest hit: the winner's normal and material (and
// u/v with want_uv) from its packed row, zeros on a miss. u and v are the
// edge functions at the hit point o + best d, the operations pe_test itself
// formed for that row, so no reduction over rows exists that a degenerate
// row's NaN could poison. With id_out, also the winner's original triangle
// id (column 15; tables in cluster order are permuted).
__device__ __forceinline__ void write_attrs(const float* __restrict__ tris,
                                            const Ray& r, int i, float best,
                                            int best_row, bool want_uv,
                                            float* __restrict__ nrm_out,
                                            int* __restrict__ mat_out,
                                            float* __restrict__ u_out,
                                            float* __restrict__ v_out,
                                            int* __restrict__ id_out = nullptr) {
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, u = 0.0f, v = 0.0f;
  int mat = 0, id = 0;
  if (best < kTFar) {
    const float* row = tris + (size_t)best_row * kCols;
    nx = row[0];
    ny = row[1];
    nz = row[2];
    mat = (int)row[14];
    id = (int)row[15];
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
  if (u_out != nullptr) {
    u_out[i] = u;
    v_out[i] = v;
  }
  if (id_out != nullptr) id_out[i] = id;
}

// The ray-vs-box slab test of the culling kernels (_ray_inv and
// _box_near_far, pallas_bf.py:533-559).

struct Slab {
  float ix, iy, iz;  // guarded reciprocal direction
};

// _ray_inv: 1 / where(|c| > 1e-12, c, where(c >= 0, 1e-12, -1e-12)), so
// axis-parallel rays stay finite (the slab only grows).
__device__ __forceinline__ float inv_dir(float c) {
  const float g = fabsf(c) > 1e-12f ? c : (c >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / g;
}

__device__ __forceinline__ Slab make_slab(const Ray& r) {
  return Slab{inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
}

__device__ __forceinline__ float max_abs_origin(const Ray& r) {
  return fmaxf(fabsf(r.ox), fmaxf(fabsf(r.oy), fabsf(r.oz)));
}

// Box [8] f32 (min xyz, max xyz, two more columns) as two float4 loads,
// a = (minx, miny, minz, maxx) and b = (maxy, maxz, -, -), grown by m on
// every side. True when the ray's parameter interval through the box
// meets (tmin, bound]. Every quantity formed is finite or +-inf, never
// NaN, so a box collapsed to a far point fails for every ray.
// slab_enter is the same test without the bound: true when the interval
// meets (tmin, inf), with its entry distance in *tn.
__device__ __forceinline__ bool slab_enter(const Ray& r, const Slab& s,
                                           float4 a, float4 b, float m,
                                           float tmin, float* tn_out) {
  float t0 = (a.x - m - r.ox) * s.ix, t1 = (a.w + m - r.ox) * s.ix;
  float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
  t0 = (a.y - m - r.oy) * s.iy;
  t1 = (b.x + m - r.oy) * s.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (a.z - m - r.oz) * s.iz;
  t1 = (b.y + m - r.oz) * s.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  *tn_out = tn;
  return tn <= tf && tf > tmin;
}

__device__ __forceinline__ bool slab_passes(const Ray& r, const Slab& s,
                                            float4 a, float4 b, float m,
                                            float tmin, float bound) {
  float tn;
  return slab_enter(r, s, a, b, m, tmin, &tn) && tn <= bound;
}

// Cluster c of `boxes` ([C, 8] f32: min xyz, max xyz, two unused) grown by
// m: does the ray's parameter interval through it meet (tmin, bound]?
__device__ __forceinline__ bool box_passes(const Ray& r, const Slab& s,
                                           float m,
                                           const float4* __restrict__ boxes,
                                           int c, float tmin, float bound) {
  return slab_passes(r, s, __ldg(boxes + 2 * (size_t)c),
                     __ldg(boxes + 2 * (size_t)c + 1), m, tmin, bound);
}

}  // namespace tpt
