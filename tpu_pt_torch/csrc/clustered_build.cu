// Clustered ray-triangle kernels whose thread block builds one shared work
// list and sweeps it in lockstep, for Hopper (sm_90a).
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
//   The list is what _build_cand_table (:618) builds: the boxes that any
//   ray of the tile pierces within its bound. Each pair of TPU bodies
//   (clustered / chained) is one entry point here: the chained bodies exist
//   because a TPU table is cut into VMEM slabs, and these kernels sweep the
//   whole table in one launch.
//
// The design (clustered_intersect.cu holds the other one, a traversal per
// thread). A block is kThreads consecutive lanes, one thread per ray. It
// walks the cluster boxes in chunks of kThreads:
//
//   build  The chunk's boxes are staged into shared memory. Every thread
//          slab-tests its own ray against each of them (bound: the ray's
//          best hit so far or tmax for the closest hit, as the chained TPU
//          bodies bound a slab's list by the prior t; the ray's own tmax,
//          or nothing once it is blocked, for the any-hit), and keeps the
//          passes as bits. A warp ORs its lanes' bits (__reduce_or_sync)
//          and one lane ORs them into the chunk's mask in shared memory: a
//          box is listed if any ray of the block passes. The TPU compacts
//          with a triangular matmul and a one-hot; here thread j takes box j
//          and its slot is a prefix population count of the mask. The list
//          (at most kThreads entries) is in box order, and shared memory
//          does not grow with the scene.
//   sweep  For each listed cluster the block holds its rows (8 KB at 128
//          rows) in one of two shared buffers. Each thread loads its share
//          of the next listed cluster into registers, runs pe_test on every
//          row of the current one from shared memory with no box test of
//          its own (guard "none", :796-805), stores the registers into the
//          other buffer, and the block synchronises once per cluster.
//
// A thread tests rows of clusters its own ray does not pierce; that never
// changes its result, which is that of a dense sweep over every row.
// Chunks, the list and the rows are visited in ascending order and the best
// hit is replaced on a strictly smaller t only, so ties go to the lowest
// packed row. Built with --fmad=false like every kernel here: the results
// equal tpt_closest_clustered(_full) / tpt_occluded_clustered and the plain
// dense sweeps bit for bit.
//
// Barriers: every loop that holds a __syncthreads has a trip count that is
// the same for every thread of the block (the box chunks; the list's length
// read from shared memory; __syncthreads_and for the any-hit's early exit).
// Lanes past n_rays and parked lanes (origin 3e7, tmax 0) pass no box, so a
// block of such lanes leaves with empty lists; they still reach every
// barrier and help stage.

#include "pe_block.cuh"

namespace {

constexpr int kThreads = 128;     // rays per block = boxes per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 128;  // rows per cluster the row buffers hold
constexpr int kRowLoads = kMaxCluster * 4 / kThreads;  // float4 per thread
using tpt::kCols;
using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::slab_passes;

struct Shared {
  float4 rows[2][kMaxCluster * 4];  // two clusters' packed rows
  float4 boxes[kThreads * 2];       // the chunk's boxes
  unsigned mask[kWarps];            // bit b: some ray passes box b
  int list[kThreads];               // listed clusters, ascending
};

// Build the work list of boxes [base, base + nb): returns its length (the
// same in every thread). `bound` < tmin (or !live) makes this thread vote
// no. Ends with a barrier: sh.list is ready to read.
__device__ __forceinline__ int build_list(Shared& sh, const Ray& r,
                                          const Slab& s, float m, bool live,
                                          const float* __restrict__ boxes,
                                          int base, int nb, float tmin,
                                          float bound) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The barrier also ends every read of the previous chunk's list.
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(boxes) + 2 * (size_t)base;
  for (int k = tid; k < 2 * nb; k += kThreads) sh.boxes[k] = src[k];
  if (tid < kWarps) sh.mask[tid] = 0u;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    unsigned bits = 0u;
    if (live) {
      const int hi = min(32, nb - 32 * w);
      for (int k = 0; k < hi; ++k) {
        const int b = 32 * w + k;
        if (slab_passes(r, s, sh.boxes[2 * b], sh.boxes[2 * b + 1], m, tmin,
                        bound))
          bits |= 1u << k;
      }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&sh.mask[w], bits);
  }
  __syncthreads();
  // Thread j owns box j of the chunk: its slot is the number of listed
  // boxes before it.
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = __popc(sh.mask[w]);
    if (w < warp) before += c;
    count += c;
  }
  const unsigned mine = sh.mask[warp];
  if ((mine >> lane) & 1u)
    sh.list[before + __popc(mine & ((1u << lane) - 1u))] = base + tid;
  __syncthreads();
  return count;
}

// This thread's share of cluster c's rows, from device memory.
__device__ __forceinline__ void load_cluster(float4 (&pre)[kRowLoads],
                                             const float* __restrict__ tris,
                                             int c, int cluster) {
  const float4* src =
      reinterpret_cast<const float4*>(tris) + 4 * (size_t)c * cluster;
#pragma unroll
  for (int q = 0; q < kRowLoads; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < cluster * 4) pre[q] = __ldg(src + k);
  }
}

__device__ __forceinline__ void store_cluster(float4* buf,
                                              const float4 (&pre)[kRowLoads],
                                              int cluster) {
#pragma unroll
  for (int q = 0; q < kRowLoads; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < cluster * 4) buf[k] = pre[q];
  }
}

// Sweep the `count` listed clusters: test(buf, c) runs this thread's tests
// on cluster c's rows in shared memory. One barrier per cluster.
template <typename Test>
__device__ __forceinline__ void sweep_list(Shared& sh,
                                           const float* __restrict__ tris,
                                           int count, int cluster, Test test) {
  if (count == 0) return;
  float4 pre[kRowLoads];
  // Nobody reads either buffer now: the last sweep ended with a barrier.
  load_cluster(pre, tris, sh.list[0], cluster);
  store_cluster(sh.rows[0], pre, cluster);
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    if (k + 1 < count) load_cluster(pre, tris, sh.list[k + 1], cluster);
    test(sh.rows[k & 1], sh.list[k]);
    // The other buffer was read one iteration ago, before the last barrier.
    if (k + 1 < count) store_cluster(sh.rows[(k + 1) & 1], pre, cluster);
    __syncthreads();
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
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
  __shared__ Shared sh;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));

  float best = kTFar;
  int best_row = 0;
  for (int base = 0; base < n_boxes; base += kThreads) {
    const int nb = min(kThreads, n_boxes - base);
    const int count = build_list(sh, r, s, m, live, boxes, base, nb, tmin,
                                 fminf(best, tmax));
    sweep_list(sh, tris, count, cluster, [&](const float4* rows, int c) {
      if (!live) return;
      const int row0 = c * cluster;
      for (int j = 0; j < cluster; ++j) {
        float t = pe_test(r, rows[4 * j], rows[4 * j + 1], rows[4 * j + 2],
                          tmin);
        if (!(t < tmax)) t = kTFar;
        if (t < best) {
          best = t;
          best_row = row0 + j;
        }
      }
    });
  }
  if (!live) return;
  t_out[i] = best;
  if (kFull)
    tpt::write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out,
                     u_out, v_out, row_out);
  else
    row_out[i] = best < kTFar ? best_row : 0;
}

__global__ void __launch_bounds__(kThreads)
occluded_clustered_b_kernel(const float* __restrict__ orig,
                            const float* __restrict__ dir,
                            const float* __restrict__ tmax,
                            const float* __restrict__ tris,
                            const float* __restrict__ boxes, int n_rays,
                            int n_boxes, int cluster, float scale,
                            float margin, float tmin,
                            uint8_t* __restrict__ occ_out) {
  __shared__ Shared sh;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float tm = live ? tmax[i] : 0.0f;
  // Nothing can block when (tmin, tm) is empty (parked and ineligible
  // shadow rays carry tm = 0): such a thread votes for no box.
  bool open = live && tm > tmin;
  bool blocked = false;
  for (int base = 0; base < n_boxes; base += kThreads) {
    // The block stops once every one of its rays is blocked or closed.
    if (__syncthreads_and(!open)) break;
    const int nb = min(kThreads, n_boxes - base);
    const int count = build_list(sh, r, s, m, open, boxes, base, nb, tmin, tm);
    sweep_list(sh, tris, count, cluster, [&](const float4* rows, int) {
      // A blocked thread stops testing and goes on to the barriers.
      for (int j = 0; j < cluster && open; ++j) {
        if (!(rows[4 * j + 3].y < 0.5f)) continue;  // refractive: light passes
        if (pe_test(r, rows[4 * j], rows[4 * j + 1], rows[4 * j + 2], tmin) <
            tm) {
          blocked = true;
          open = false;
        }
      }
    });
  }
  if (live) occ_out[i] = blocked ? 1 : 0;
}

inline unsigned grid_for(int n_rays) {
  return (unsigned)((n_rays + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue when `cluster` is outside 1..128 (the row buffers).
// Arguments as the entry points of clustered_intersect.cu.

int tpt_closest_clustered_b(const float* orig, const float* dir,
                            const float* tris, const float* boxes, int n_rays,
                            int n_boxes, int cluster, float scale,
                            float margin, float tmin, float tmax, float* t_out,
                            int* row_out, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  closest_clustered_b_kernel<false>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, 0, t_out, row_out, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int tpt_closest_clustered_full_b(const float* orig, const float* dir,
                                 const float* tris, const float* boxes,
                                 int n_rays, int n_boxes, int cluster,
                                 float scale, float margin, float tmin,
                                 float tmax, int want_uv, float* t_out,
                                 int* id_out, float* nrm_out, int* mat_out,
                                 float* u_out, float* v_out, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  closest_clustered_b_kernel<true>
      <<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          orig, dir, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
          tmin, tmax, want_uv, t_out, id_out, nrm_out, mat_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_clustered_b(const float* orig, const float* dir,
                             const float* tmax, const float* tris,
                             const float* boxes, int n_rays, int n_boxes,
                             int cluster, float scale, float margin,
                             float tmin, uint8_t* occ_out, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  occluded_clustered_b_kernel<<<grid_for(n_rays), kThreads, 0,
                                (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, boxes, n_rays, n_boxes, cluster, scale, margin,
      tmin, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
