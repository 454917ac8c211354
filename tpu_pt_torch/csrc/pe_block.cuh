// The per-pair ray-triangle test shared by every kernel of tpu_pt_torch.
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

}  // namespace tpt
