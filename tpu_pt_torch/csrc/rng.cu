// The counter RNG of the wavefront round for Hopper (sm_90a): PCG4D
// (Jarzynski & Olano, JCGT 2020) in native uint32 arithmetic, and the 24-bit
// uniforms the round uses, in one pass over the lanes.
//
//   tpt_bounce_uniforms  the two draws of render._bounce in one launch:
//                        streams sa = 1 + 2 depth and sb = 2 + 2 depth, both
//                        hashed per lane; writes the six floats the bounce
//                        uses (z1, z2, z3 of sa; lz1, lz2, z_rr of sb) as
//                        the rows of one [6, ld] float32 buffer.
//   tpt_uniform          one draw (rng.uniform2 / uniform4): the first k
//                        (2 or 4) outputs as the rows of a [k, ld] buffer.
//
// It replaces no Pallas kernel: the JAX package's tpu_pt/rng.py is jnp that
// XLA fuses into its callers. The port's plain version, rng.pcg4d, emulates
// uint32 in int64 (~115 eager launches a draw over every lane); this kernel
// is bitwise equal to it by construction: an int64 counter enters as its low
// 32 bits (rng._u32's & 0xFFFFFFFF, negative values included), every product
// is the wrapping uint32 multiply, and the float is (u >> 8) * 2^-24, exact
// as rng._to_unit_float is.
//
// What bounds it on this card: bytes. A hash is ~30 integer multiply-adds
// against 8 bytes read a per-lane counter and 4 bytes written a used float:
// ~96 bytes a lane a round for the bounce pair and the jitter draw, the
// least the answer needs. The design: one pass that reads each counter once
// and writes only the used floats; four consecutive lanes a thread, so the
// int64 loads are two 16-byte loads and each output row's stores one float4
// a thread, coalesced across the warp; no shared memory. A counter is a
// per-lane tensor (stride 1), one element broadcast to every lane (stride 0)
// or a value passed by argument (null pointer), so a scalar counter never
// becomes a device tensor and the host never waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // lanes a thread: one float4 store a row

// A counter as the wrapper passes it: per-lane int64 values (stride 1),
// one int64 value broadcast (stride 0), or `value` when `p` is null.
struct Counter {
  const long long* p;
  int stride;
  unsigned value;
};

struct Hash4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Hash4 pcg4d(uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  return {x, y, z, w};
}

__device__ __forceinline__ float unit(uint32_t u) {
  return (float)(u >> 8) * 0x1p-24f;
}

// The low 32 bits of the counter for lanes i0 .. i0 + 3 (lanes past n are
// not read). A full group of 16-byte-aligned per-lane values is two
// 16-byte loads.
__device__ __forceinline__ void load4(const Counter& c, long long i0,
                                      long long n, uint32_t v[kLanes]) {
  if (c.p == nullptr) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) v[j] = c.value;
    return;
  }
  if (c.stride == 0) {
    const uint32_t s = (uint32_t)__ldg(c.p);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) v[j] = s;
    return;
  }
  const long long* p = c.p + i0;
  if (i0 + kLanes <= n && ((uintptr_t)p & 15) == 0) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
    v[0] = (uint32_t)a.x;
    v[1] = (uint32_t)a.y;
    v[2] = (uint32_t)b.x;
    v[3] = (uint32_t)b.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    v[j] = i0 + j < n ? (uint32_t)__ldg(p + j) : 0u;
}

// Row `row` of the output for lanes i0 .. i0 + 3; `out` rows are `ld`
// floats apart, ld a multiple of 4, so a full group is one float4 store.
__device__ __forceinline__ void store4(float* out, long long ld, int row,
                                       long long i0, long long n,
                                       const float v[kLanes]) {
  float* q = out + row * ld + i0;
  if (i0 + kLanes <= n) {
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (i0 + j < n) q[j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
pcg4d_bounce_kernel(Counter pixel, Counter sample, Counter frame,
                    Counter depth, long long n, long long ld,
                    float* __restrict__ out) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kLanes;
  if (i0 >= n) return;
  uint32_t a[kLanes], b[kLanes], c[kLanes], d[kLanes];
  load4(pixel, i0, n, a);
  load4(sample, i0, n, b);
  load4(frame, i0, n, c);
  load4(depth, i0, n, d);
  float r[6][kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const Hash4 ha = pcg4d(a[j], b[j], c[j], 1u + 2u * d[j]);
    const Hash4 hb = pcg4d(a[j], b[j], c[j], 2u + 2u * d[j]);
    r[0][j] = unit(ha.x);
    r[1][j] = unit(ha.y);
    r[2][j] = unit(ha.z);
    r[3][j] = unit(hb.x);
    r[4][j] = unit(hb.y);
    r[5][j] = unit(hb.z);
  }
#pragma unroll
  for (int row = 0; row < 6; ++row) store4(out, ld, row, i0, n, r[row]);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
pcg4d_uniform_kernel(Counter ca, Counter cb, Counter cc, Counter cd,
                     long long n, long long ld, float* __restrict__ out) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kLanes;
  if (i0 >= n) return;
  uint32_t a[kLanes], b[kLanes], c[kLanes], d[kLanes];
  load4(ca, i0, n, a);
  load4(cb, i0, n, b);
  load4(cc, i0, n, c);
  load4(cd, i0, n, d);
  float r[K][kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const Hash4 h = pcg4d(a[j], b[j], c[j], d[j]);
    r[0][j] = unit(h.x);
    r[1][j] = unit(h.y);
    if constexpr (K == 4) {
      r[2][j] = unit(h.z);
      r[3][j] = unit(h.w);
    }
  }
#pragma unroll
  for (int row = 0; row < K; ++row) store4(out, ld, row, i0, n, r[row]);
}

unsigned blocks_for(long long n) {
  const long long per_block = (long long)kThreads * kLanes;
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).
// A counter is (pointer, stride, value): see Counter. `out` is 16-byte
// aligned and `ld`, its row pitch in floats, a multiple of 4 and >= n.

int tpt_bounce_uniforms(const long long* pix, int pix_stride,
                        unsigned pix_value, const long long* smp,
                        int smp_stride, unsigned smp_value,
                        const long long* frm, int frm_stride,
                        unsigned frm_value, const long long* dep,
                        int dep_stride, unsigned dep_value, long long n,
                        long long ld, float* out, void* stream) {
  if (n > 0)
    pcg4d_bounce_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
        Counter{pix, pix_stride, pix_value}, Counter{smp, smp_stride, smp_value},
        Counter{frm, frm_stride, frm_value}, Counter{dep, dep_stride, dep_value},
        n, ld, out);
  return (int)cudaGetLastError();
}

// `k`: 2 or 4 outputs (x, y or x, y, z, w of the hash).
int tpt_uniform(const long long* a, int a_stride, unsigned a_value,
                const long long* b, int b_stride, unsigned b_value,
                const long long* c, int c_stride, unsigned c_value,
                const long long* d, int d_stride, unsigned d_value, int k,
                long long n, long long ld, float* out, void* stream) {
  if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
  const Counter ca{a, a_stride, a_value}, cb{b, b_stride, b_value},
      cc{c, c_stride, c_value}, cd{d, d_stride, d_value};
  if (n > 0) {
    if (k == 2)
      pcg4d_uniform_kernel<2><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(ca, cb, cc, cd, n, ld,
                                                        out);
    else
      pcg4d_uniform_kernel<4><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(ca, cb, cc, cd, n, ld,
                                                        out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
