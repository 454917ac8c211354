// The f32 / bf16 throughput probe for Hopper (sm_90a): the twin of
// tools/microbench_bf16.py's _kernel (:37), which the JAX tool launches
// through pl.pallas_call (:56) to ask whether packed bf16 elementwise math
// beats f32 on the TPU's vector unit.
//
//   tpt_chain_f32   one thread per element: 128 steps of the 8 dependent
//                   mul / add operations of _kernel (:45-51)
//                       t = a*b + acc; u = t*a - b; v = u*b + t; acc = v*a - u
//                   in float, acc starting at 0, the result written once.
//   tpt_chain_bf16  the same chain on __nv_bfloat162 pairs: two elements an
//                   instruction, each operation the packed PTX
//                   mul / add / sub.rn.bf16x2, rounded to bf16 after every
//                   operation.
//
// Built with --fmad=false (and the bf16 operations written as PTX with .rn,
// which ptxas never contracts), so every multiply and add is one
// instruction, as in the JAX tool. What bounds it: the ALU. A call reads two
// inputs and writes one output once (24 MB in f32 at [2,048, 1,024], some 7
// us of device memory time) and executes 2,048 x 1,024 x 128 x 8 operations;
// 1,024 dependent steps a thread, hidden by the 2M (f32) or 1M (bf16)
// threads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chain_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int n, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i];
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float t = x * y + acc;
    const float u = t * x - y;
    const float v = u * y + t;
    acc = v * x - u;
  }
  out[i] = acc;
}

__device__ __forceinline__ uint32_t mul2(uint32_t p, uint32_t q) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(p), "r"(q));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t p, uint32_t q) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(p), "r"(q));
  return d;
}

__device__ __forceinline__ uint32_t sub2(uint32_t p, uint32_t q) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(p), "r"(q));
  return d;
}

// Pair i holds elements 2i and 2i + 1 (bf16 bit patterns, low half first).
__global__ void __launch_bounds__(kThreads)
chain_bf16_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int pairs, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const uint32_t x = a[i], y = b[i];
  uint32_t acc = 0u;  // +0.0 in both halves
  for (int s = 0; s < steps; ++s) {
    const uint32_t t = add2(mul2(x, y), acc);
    const uint32_t u = sub2(mul2(t, x), y);
    const uint32_t v = add2(mul2(u, y), t);
    acc = sub2(mul2(v, x), u);
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).

int tpt_chain_f32(const float* a, const float* b, float* out, int n,
                  int steps, void* stream) {
  if (n > 0)
    chain_f32_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(a, b, out, n, steps);
  return (int)cudaGetLastError();
}

// `a`, `b`, `out`: 2 * pairs bf16 values, 4-byte aligned.
int tpt_chain_bf16(const void* a, const void* b, void* out, int pairs,
                   int steps, void* stream) {
  if (pairs > 0)
    chain_bf16_kernel<<<(unsigned)((pairs + kThreads - 1) / kThreads),
                        kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), pairs, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
