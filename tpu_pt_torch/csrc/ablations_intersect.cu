// Three more schedulers of the clustered closest hit / any-hit for Hopper
// (sm_90a): the rotated chain, the streamed tile list and the
// cluster-binned pair jobs.
//
// They replace the first three kernel families of
// tpu_pt/intersect/pallas_ablations.py, each a scheduler of the function
// tpt_closest_clustered / tpt_occluded_clustered compute (closest (t, packed
// row), or the any-hit flag, over the clustered table):
//
//   tpt_closest_rotated    <- _closest_kernel_rotated_lean (:84) and
//                             _closest_kernel_rotated_chained_lean (:110),
//                             launched S times by _closest_call_rotated
//                             (:333): every ray tile visits the table's S
//                             slabs in its own order, the predicted landing
//                             slab first, the rest ascending.
//   tpt_closest_streamed   <- _closest_kernel_streamed_lean (:210) via
//                             _closest_call_streamed (:490),
//   tpt_occluded_streamed  <- _occluded_kernel_streamed (:275) via
//                             _occluded_call_streamed (:529): one launch; a
//                             tile of rays shares a list of the boxes any of
//                             them pierces, sorted by the tile's least entry
//                             distance, sweeps it through a ring of row
//                             buffers filled ahead of the sweep, and stops
//                             at the first key no lane can still use.
//   tpt_closest_cbin       <- _closest_kernel_cbin (:905) via
//                             _closest_call_cbin (:948),
//   tpt_occluded_cbin      <- _occluded_kernel_cbin (:1014) via
//                             _occluded_call_cbin (:1054): the grid is a
//                             list of jobs, each a run of (ray, cluster)
//                             pair lanes against one cluster; results are
//                             per pair and reduced per ray outside.
//
// What was kept of each TPU schedule, and what was not:
// - rotated: the S chained launches, needed there because a slab had to
//   fit in VMEM, are a loop over the slabs inside one launch; the per-tile
//   candidate tables (rotated_candidates) have no twin, since each thread
//   culls the slab's cluster boxes for its own ray as
//   tpt_closest_clustered does, bounded by its best hit so far. A warp
//   (the unit that diverges) agrees on one first slab by a vote: the most
//   frequent prediction of its lanes, ties to the lowest slab.
// - streamed: the list, the keys, the ring (STREAM_BUF = 4 slots of one
//   cluster, 8 KB each at 128 rows, filled with cp.async), the exact early
//   break and the per-candidate guard are all kept. The 128-lane widening
//   of the table is a Mosaic DMA constraint and has no twin. The break is
//   tightened by one term the list build knows: `far`, a lane's last entry
//   distance over the boxes it pierces; beyond it the lane takes part in no
//   candidate, so a lane that misses everything does not hold its tile.
// - cbin: the job table and the per-pair layout are kept (cbin_pairs builds
//   them in plain PyTorch); blocks run in any order, so the one-job-ahead
//   row prefetch across grid steps has no twin: a block stages its cluster
//   once and every thread sweeps it for its pair ray.
//
// What bounds them on this card: FP32 ALU, as the other clustered kernels.
// The streamed and binned kernels sweep rows from shared memory without
// divergence inside a block, but a streamed block sweeps the union of its
// lanes' boxes, and a binned launch sweeps every padded pair lane.
//
// Correctness: results are bitwise those of a dense sweep over every row
// with ties to the lowest packed row. The three closest kernels replace the
// best hit on (t, row) in lexicographic order, so any visit order gives the
// same answer. Every cull (list builds in ablations.py, the guards here)
// uses the boxes grown by margin * (scale + max|o|) as
// tpt_closest_clustered does. The streamed break is `key > bound`, not
// `>=`: a candidate entered exactly at a lane's best t can still hold a
// tied hit on a lower row. Built with --fmad=false; the per-pair test is
// pe_test of pe_block.cuh.
//
// Barriers: every thread of a block, live, parked or past n_rays, reaches
// every barrier; trip counts and break conditions come from block votes.

#include "pe_block.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kMaxTile = 256;     // lanes per streamed tile / binned job
constexpr int kMaxCluster = 128;  // rows per cluster the row buffers hold
constexpr int kRing = 4;          // ablations.STREAM_BUF
constexpr int kRotThreads = 128;
using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::box_passes;

// ---------------------------------------------------------------- rotated

__global__ void __launch_bounds__(kRotThreads)
closest_rotated_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dir,
                       const float* __restrict__ tris,
                       const float* __restrict__ boxes,
                       const int* __restrict__ pred, int n_rays, int n_boxes,
                       int cluster, int slab_boxes, int s_count, float scale,
                       float margin, float tmin, float tmax,
                       float* __restrict__ t_out, int* __restrict__ row_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  // The warp's first slab: the most frequent prediction of its lanes, ties
  // to the lowest slab; unknown and out-of-range predictions count as 0.
  int p = live ? pred[i] : 0;
  if (p < 0 || p >= s_count) p = 0;
  const unsigned peers = __match_any_sync(0xffffffffu, p);
  unsigned vote = ((unsigned)__popc(peers) << 24) | (0xffffffu - (unsigned)p);
  vote = __reduce_max_sync(0xffffffffu, vote);
  const int first = (int)(0xffffffu - (vote & 0xffffffu));
  if (!live) return;
  const Ray r = load_ray(orig, dir, i);
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* rows = reinterpret_cast<const float4*>(tris);

  float best = kTFar;
  int best_row = 0;
  for (int v = 0; v < s_count; ++v) {
    // Visit v: the first slab, then the others in ascending order.
    const int sid = v == 0 ? first : (v - 1 < first ? v - 1 : v);
    const int c1 = min((sid + 1) * slab_boxes, n_boxes);
    for (int c = sid * slab_boxes; c < c1; ++c) {
      if (!box_passes(r, s, m, bx, c, tmin, fminf(best, tmax))) continue;
      const int base = c * cluster;
      for (int j = 0; j < cluster; ++j) {
        const int row = base + j;
        const float4* q = rows + 4 * (size_t)row;
        float t = pe_test(r, __ldg(q), __ldg(q + 1), __ldg(q + 2), tmin);
        if (!(t < tmax)) t = kTFar;
        if (t < best || (t == best && row < best_row)) {
          best = t;
          best_row = row;
        }
      }
    }
  }
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
}

// --------------------------------------------------------------- streamed

// Start the copy of cluster c's rows into a ring slot (16 bytes a request,
// the block's threads side by side).
__device__ __forceinline__ void ring_fill(float4* slot,
                                           const float* __restrict__ tris,
                                           int c, int cluster) {
  const float4* src =
      reinterpret_cast<const float4*>(tris) + 4 * (size_t)c * cluster;
  for (int k = threadIdx.x; k < cluster * 4; k += blockDim.x)
    __pipeline_memcpy_async(slot + k, src + k, sizeof(float4));
}

// Tile `blockIdx.x` holds lanes [tile * blockDim.x, ...). `cand` and `keys`
// are [tiles, n_boxes]: the tile's boxes in ascending key order and their
// keys, of which the first cnt[tile] are listed; `last_key` [>= tiles *
// blockDim.x] is each lane's last entry distance over the boxes it pierces
// (-3e38: none).
__global__ void __launch_bounds__(kMaxTile)
closest_streamed_kernel(const float* __restrict__ orig,
                        const float* __restrict__ dir,
                        const float* __restrict__ tris,
                        const float* __restrict__ boxes,
                        const int* __restrict__ cand,
                        const float* __restrict__ keys,
                        const int* __restrict__ cnt,
                        const float* __restrict__ last_key, int n_rays,
                        int n_boxes, int cluster, float scale, float margin,
                        float tmin, float tmax, int guard,
                        float* __restrict__ t_out, int* __restrict__ row_out) {
  __shared__ float4 s_rows[kRing][kMaxCluster * 4];
  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float lane_far = live ? last_key[i] : -3e38f;
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const int* list = cand + (size_t)tile * n_boxes;
  const float* key = keys + (size_t)tile * n_boxes;
  const int ncand = min(max(cnt[tile], 0), n_boxes);

  for (int j = 0; j < kRing - 1; ++j) {
    if (j < ncand) ring_fill(s_rows[j], tris, list[j], cluster);
    __pipeline_commit();
  }
  float best = kTFar;
  int best_row = 0;
  for (int k = 0; k < ncand; ++k) {
    // Keys ascend, and a lane enters no later box before its key: once the
    // key is beyond every lane's best t (or its last entry), nothing left
    // can improve or tie. The vote is also the barrier that ends every
    // read of the slot refilled below.
    const float kk = key[k];
    if (!__syncthreads_or(live && kk <= fminf(best, lane_far))) break;
    const int ahead = k + kRing - 1;
    if (ahead < ncand)
      ring_fill(s_rows[ahead % kRing], tris, list[ahead], cluster);
    __pipeline_commit();
    __pipeline_wait_prior(kRing - 1);  // this thread's share of candidate k
    const int c = list[k];
    // The barrier that makes every thread's share visible; with the guard
    // it also asks whether any lane can still find something in this box.
    bool useful = true;
    if (guard)
      useful = __syncthreads_or(
          live && box_passes(r, s, m, bx, c, tmin, fminf(best, tmax)));
    else
      __syncthreads();
    if (!useful || !live) continue;
    const float4* rows = s_rows[k % kRing];
    const int row0 = c * cluster;
    for (int j = 0; j < cluster; ++j) {
      float t = pe_test(r, rows[4 * j], rows[4 * j + 1], rows[4 * j + 2],
                        tmin);
      if (!(t < tmax)) t = kTFar;
      const int row = row0 + j;
      if (t < best || (t == best && row < best_row)) {
        best = t;
        best_row = row;
      }
    }
  }
  __pipeline_wait_prior(0);
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
}

__global__ void __launch_bounds__(kMaxTile)
occluded_streamed_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir,
                         const float* __restrict__ tmax,
                         const float* __restrict__ tris,
                         const float* __restrict__ boxes,
                         const int* __restrict__ cand,
                         const float* __restrict__ keys,
                         const int* __restrict__ cnt,
                         const float* __restrict__ last_key, int n_rays,
                         int n_boxes, int cluster, float scale, float margin,
                         float tmin, int guard,
                         uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[kRing][kMaxCluster * 4];
  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float tm = live ? tmax[i] : 0.0f;
  const float lane_far = live ? fminf(last_key[i], tm) : -3e38f;
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const int* list = cand + (size_t)tile * n_boxes;
  const float* key = keys + (size_t)tile * n_boxes;
  const int ncand = min(max(cnt[tile], 0), n_boxes);

  for (int j = 0; j < kRing - 1; ++j) {
    if (j < ncand) ring_fill(s_rows[j], tris, list[j], cluster);
    __pipeline_commit();
  }
  // Nothing can block when (tmin, tm) is empty (parked lanes carry tm = 0).
  bool open = live && tm > tmin;
  bool blocked = false;
  for (int k = 0; k < ncand; ++k) {
    // Stop once every lane is blocked, closed, or entered by no later box
    // before its own tmax.
    const float kk = key[k];
    if (!__syncthreads_or(open && kk <= lane_far)) break;
    const int ahead = k + kRing - 1;
    if (ahead < ncand)
      ring_fill(s_rows[ahead % kRing], tris, list[ahead], cluster);
    __pipeline_commit();
    __pipeline_wait_prior(kRing - 1);
    const int c = list[k];
    bool useful = true;
    if (guard)
      useful = __syncthreads_or(open && box_passes(r, s, m, bx, c, tmin, tm));
    else
      __syncthreads();
    if (!useful) continue;
    const float4* rows = s_rows[k % kRing];
    for (int j = 0; j < cluster && open; ++j) {
      if (!(rows[4 * j + 3].y < 0.5f)) continue;  // refractive: light passes
      if (pe_test(r, rows[4 * j], rows[4 * j + 1], rows[4 * j + 2], tmin) <
          tm) {
        blocked = true;
        open = false;
      }
    }
  }
  __pipeline_wait_prior(0);
  if (live) occ_out[i] = blocked ? 1 : 0;
}

// ----------------------------------------------------------------- binned

// Job `blockIdx.x` is pair lanes [job * blockDim.x, ...) against cluster
// jtab[job]; -1 marks an empty job.
__global__ void __launch_bounds__(kMaxTile)
closest_cbin_kernel(const float* __restrict__ pair_rays,
                    const float* __restrict__ tris,
                    const int* __restrict__ jtab, int cluster, float tmin,
                    float* __restrict__ t_out, int* __restrict__ row_out) {
  __shared__ float4 s_rows[kMaxCluster * 4];
  const int c = jtab[blockIdx.x];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < 0) {  // the whole block leaves: no barrier follows
    t_out[p] = kTFar;
    row_out[p] = 0;
    return;
  }
  tpt::stage_rows(s_rows, tris, c * cluster, cluster);
  __syncthreads();
  float tm;
  const Ray r = tpt::load_ray8(pair_rays, p, &tm);
  int sub;
  const float best = tpt::sweep_staged(r, s_rows, cluster, tmin, &sub);
  t_out[p] = best;
  row_out[p] = c * cluster + sub;
}

__global__ void __launch_bounds__(kMaxTile)
occluded_cbin_kernel(const float* __restrict__ pair_rays,
                     const float* __restrict__ tris,
                     const int* __restrict__ jtab, int cluster, float tmin,
                     int* __restrict__ occ_out) {
  __shared__ float4 s_rows[kMaxCluster * 4];
  const int c = jtab[blockIdx.x];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < 0) {
    occ_out[p] = 0;
    return;
  }
  tpt::stage_rows(s_rows, tris, c * cluster, cluster);
  __syncthreads();
  float tm;
  const Ray r = tpt::load_ray8(pair_rays, p, &tm);
  occ_out[p] = tpt::blocked_staged(r, s_rows, cluster, tmin, tm) ? 1 : 0;
}

inline bool bad_tile(int rt, int cluster) {
  return rt < 32 || rt > kMaxTile || rt % 32 || cluster < 1 ||
         cluster > kMaxCluster;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for a tile width that is not a multiple of 32 up to
// 256 or a cluster outside 1..128. Tables as tpt_closest_clustered.

int tpt_closest_rotated(const float* orig, const float* dir,
                        const float* tris, const float* boxes,
                        const int* pred, int n_rays, int n_boxes, int cluster,
                        int slab_boxes, float scale, float margin, float tmin,
                        float tmax, float* t_out, int* row_out, void* stream) {
  if (slab_boxes < 1) return (int)cudaErrorInvalidValue;
  const int s_count = (n_boxes + slab_boxes - 1) / slab_boxes;
  if (s_count >= (1 << 24)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_rays + kRotThreads - 1) / kRotThreads);
  closest_rotated_kernel<<<grid, kRotThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, boxes, pred, n_rays, n_boxes, cluster, slab_boxes,
      s_count, scale, margin, tmin, tmax, t_out, row_out);
  return (int)cudaGetLastError();
}

int tpt_closest_streamed(const float* orig, const float* dir,
                         const float* tris, const float* boxes,
                         const int* cand, const float* keys, const int* cnt,
                         const float* last_key, int n_rays, int n_boxes,
                         int cluster, int rt, float scale, float margin,
                         float tmin, float tmax, int guard, float* t_out,
                         int* row_out, void* stream) {
  if (bad_tile(rt, cluster)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_rays + rt - 1) / rt);
  closest_streamed_kernel<<<grid, rt, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes, cluster,
      scale, margin, tmin, tmax, guard, t_out, row_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_streamed(const float* orig, const float* dir,
                          const float* tmax, const float* tris,
                          const float* boxes, const int* cand,
                          const float* keys, const int* cnt, const float* last_key,
                          int n_rays, int n_boxes, int cluster, int rt,
                          float scale, float margin, float tmin, int guard,
                          uint8_t* occ_out, void* stream) {
  if (bad_tile(rt, cluster)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_rays + rt - 1) / rt);
  occluded_streamed_kernel<<<grid, rt, 0, (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes,
      cluster, scale, margin, tmin, guard, occ_out);
  return (int)cudaGetLastError();
}

int tpt_closest_cbin(const float* pair_rays, const float* tris,
                     const int* jtab, int n_jobs, int cluster, int rt,
                     float tmin, float* t_out, int* row_out, void* stream) {
  if (bad_tile(rt, cluster)) return (int)cudaErrorInvalidValue;
  closest_cbin_kernel<<<(unsigned)n_jobs, rt, 0, (cudaStream_t)stream>>>(
      pair_rays, tris, jtab, cluster, tmin, t_out, row_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_cbin(const float* pair_rays, const float* tris,
                      const int* jtab, int n_jobs, int cluster, int rt,
                      float tmin, int* occ_out, void* stream) {
  if (bad_tile(rt, cluster)) return (int)cudaErrorInvalidValue;
  occluded_cbin_kernel<<<(unsigned)n_jobs, rt, 0, (cudaStream_t)stream>>>(
      pair_rays, tris, jtab, cluster, tmin, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
