// The last two scheduler families of the clustered closest hit / any-hit
// for Hopper (sm_90a): the pair-binned jobs and the 8-lane groups.
//
// They replace the rest of tpu_pt/intersect/pallas_ablations.py, each a
// scheduler of what tpt_closest_clustered / tpt_occluded_clustered compute
// (closest (t, packed row), or the any-hit flag, over the clustered table):
//
//   tpt_closest_binned   <- _binned_closest_kernel (:1272) via
//                           _closest_call_binned (:1294), and the fold of
//                           _reduce_pairs (:1334),
//   tpt_occluded_binned  <- _binned_occluded_kernel (:1365) via
//                           _occluded_call_binned (:1383): every (ray,
//                           cluster) pair of a ray's k nearest pierced
//                           clusters is one thread; pairs come in tiles of
//                           PAIR_TILE = 512 against one cluster each
//                           (ablations._pair_schedule builds them).
//   tpt_closest_grp      <- _closest_kernel_grp (:1760),
//                           _closest_kernel_grp_chained (:1775),
//                           _closest_kernel_grp_bundled (:1693) and
//                           _closest_kernel_grp_bundled_chained (:1703) via
//                           _closest_call_grp (:1804),
//   tpt_occluded_grp     <- _occluded_kernel_grp (:1791) and
//                           _occluded_kernel_grp_bundled (:1715) via
//                           _occluded_call_grp (:1866): a group of 8 lanes
//                           (a quarter warp) walks its own near-first list of
//                           the clusters any of its rays pierces.
//
// What was kept of each TPU schedule, and what was not:
// - binned: the pairs, their tiles of 512 against one cluster, the dead tail
//   (tile id = number of clusters) and the per-ray fold are kept. The double
//   payload sort and the 22-bit packed key, there because TPU gathers were
//   slow, are a counting layout in ablations.py; a pair holds its ray's
//   index, and the thread gathers the ray. _reduce_pairs' un-sort and
//   one-hot pick become one 64-bit atomicMin per pair on the key
//   (float bits of t) << 32 | row: every hit has t > tmin > 0, so the key
//   orders as (t, row) does, and the fold is the lexicographic minimum in
//   any order, so it is deterministic.
// - grp: the transposed [16, CLUSTER] table and the [N, 8] rays exist
//   because rays live in a TPU vector's lanes; here a lane is a ray and the
//   table keeps its row layout. The chained slabs exist because a slab had to
//   fit in VMEM; one launch covers the table. The serial body (TPT_GRP=1)
//   lets every quarter warp run free, reading rows through L1. The bundled
//   body (TPT_GRP=2) is the TPU's lockstep made real: a block of GRP_BUNDLE
//   groups advances every group one candidate a step, each staging its
//   cluster in its own 8 KB of shared memory with cp.async, one block
//   barrier a step. Both walk the same lists and give the same values.
//   Added, exactly: a lane culls a listed cluster whose grown box it does not
//   enter before its best t (or tmax), and a group stops at the first key
//   beyond every lane's min(best, far) (K12's break); the reference sweeps
//   every listed cluster for all 8 rays.
//
// What bounds them on this card: FP32 ALU. The binned closest kernel sweeps
// every live pair against all 128 rows of its staged cluster without
// divergence; the groups diverge inside a warp where the four groups' lists
// differ.
//
// Correctness: results are bitwise those of a dense sweep over every row
// with ties to the lowest packed row. The closest kernels compare (t, row)
// lexicographically; every cull (the lists in ablations.py, the per-lane
// cull here) uses the boxes grown by margin * (scale + max|o|). Built with
// --fmad=false; the per-pair test is pe_test of pe_block.cuh, and the sweep
// of a staged cluster is K13's (sweep_staged, blocked_staged).
//
// Barriers: in the binned kernels a dead tile leaves before its only
// barrier, as a whole block; in the bundled group kernels every thread,
// live or not, reaches every barrier, and the trip count is a block vote.

#include "pe_block.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kPairTile = 512;    // ablations.PAIR_TILE
constexpr int kMaxCluster = 128;  // rows per cluster the row buffers hold
constexpr int kGroup = 8;         // ablations.GRP_LANES
constexpr int kBundle = 8;        // ablations.GRP_BUNDLE
using tpt::kTFar;
using tpt::load_ray8;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::box_passes;

// ------------------------------------------------------------------ binned

// Tile `blockIdx.x` is pair slots [tile * 512, ...) against cluster
// tile_sid[tile]; a tile id >= n_boxes marks the dead tail, a slot's ray
// index < 0 an unused slot. `key` [n] starts at (bits of kTFar) << 32.
__global__ void __launch_bounds__(kPairTile)
closest_binned_kernel(const float* __restrict__ rays,
                      const float* __restrict__ tris,
                      const int* __restrict__ pair_ray,
                      const int* __restrict__ tile_sid, int n_boxes,
                      int cluster, float tmin,
                      unsigned long long* __restrict__ key) {
  __shared__ float4 s_rows[kMaxCluster * 4];
  const int c = tile_sid[blockIdx.x];
  if (c >= n_boxes) return;  // the whole block leaves: no barrier follows
  tpt::stage_rows(s_rows, tris, c * cluster, cluster);
  __syncthreads();
  const int r = pair_ray[(size_t)blockIdx.x * kPairTile + threadIdx.x];
  if (r < 0) return;
  float tm;
  const Ray ray = load_ray8(rays, r, &tm);
  int sub;
  const float best = tpt::sweep_staged(ray, s_rows, cluster, tmin, &sub);
  if (best < kTFar)
    atomicMin(key + r, ((unsigned long long)__float_as_uint(best) << 32) |
                           (unsigned)(c * cluster + sub));
}

// `occ` [n] starts at 0; a pair that finds a blocking row stores 1.
__global__ void __launch_bounds__(kPairTile)
occluded_binned_kernel(const float* __restrict__ rays,
                       const float* __restrict__ tris,
                       const int* __restrict__ pair_ray,
                       const int* __restrict__ tile_sid, int n_boxes,
                       int cluster, float tmin, uint8_t* __restrict__ occ) {
  __shared__ float4 s_rows[kMaxCluster * 4];
  const int c = tile_sid[blockIdx.x];
  if (c >= n_boxes) return;
  tpt::stage_rows(s_rows, tris, c * cluster, cluster);
  __syncthreads();
  const int r = pair_ray[(size_t)blockIdx.x * kPairTile + threadIdx.x];
  if (r < 0) return;
  float tm;
  const Ray ray = load_ray8(rays, r, &tm);
  if (tpt::blocked_staged(ray, s_rows, cluster, tmin, tm)) occ[r] = 1;
}

// ------------------------------------------------------------------- groups

// The rows of cluster c as the group reads them: bundled, copied by the
// group's 8 lanes into its own shared slot (cp.async, 16 bytes a request),
// visible to the group after the wait and the group's sync; serial, the
// table itself, read through L1.
template <bool kBundled>
__device__ __forceinline__ const float4* group_rows(
    const float4* __restrict__ table, float4* slot, int c, int cluster,
    int lane, unsigned gmask) {
  const float4* src = table + 4 * (size_t)c * cluster;
  if (!kBundled) return src;
  for (int q = lane; q < cluster * 4; q += kGroup)
    __pipeline_memcpy_async(slot + q, src + q, sizeof(float4));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp(gmask);
  return slot;
}

// Lane i belongs to group i / 8; `cand` and `keys` are [groups, n_boxes]:
// the group's boxes in ascending key order, the first cnt[group] listed;
// `last_key` [n] is each lane's last entry distance over the boxes it
// pierces (-3e38: none). n_rays is a multiple of 8, so a group is live or
// dead as a whole.
template <bool kBundled>
__global__ void closest_grp_kernel(const float* __restrict__ rays,
                                   const float* __restrict__ tris,
                                   const float* __restrict__ boxes,
                                   const int* __restrict__ cand,
                                   const float* __restrict__ keys,
                                   const int* __restrict__ cnt,
                                   const float* __restrict__ last_key,
                                   int n_rays, int n_boxes, int cluster,
                                   float scale, float margin, float tmin,
                                   float tmax, float* __restrict__ t_out,
                                   int* __restrict__ row_out) {
  extern __shared__ float4 s_slots[];  // bundled: kBundle slots of a cluster
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  if (!kBundled && !live) return;      // serial: no block barrier
  const int g = i / kGroup, lane = threadIdx.x % kGroup;
  const unsigned gmask = 0xffu << (threadIdx.x & 24);
  float4* slot = s_slots + (threadIdx.x / kGroup) * cluster * 4;
  float tm_unused;
  const Ray r = live ? load_ray8(rays, i, &tm_unused) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float lane_far = live ? last_key[i] : -3e38f;
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* table = reinterpret_cast<const float4*>(tris);
  const int ncand = live ? min(max(cnt[g], 0), n_boxes) : 0;
  const int* list = cand + (size_t)(live ? g : 0) * n_boxes;
  const float* key = keys + (size_t)(live ? g : 0) * n_boxes;

  float best = kTFar;
  int best_row = 0;
  for (int k = 0;; ++k) {
    // Keys ascend, and a lane enters no later box before its key: once the
    // key is beyond every lane's best t (or its last entry), nothing left
    // can improve or tie, and the group's list has ended.
    bool on = k < ncand && key[k] <= fminf(best, lane_far);
    on = (__ballot_sync(gmask, on) & gmask) != 0;
    if (kBundled) {
      // The step's barrier: also ends every read of the slots refilled below.
      if (!__syncthreads_or(on)) break;
      if (!on) continue;  // ended: vote no, reach every barrier
    } else if (!on) {
      break;
    }
    const int c = list[k];
    const bool lane_ok = box_passes(r, s, m, bx, c, tmin, fminf(best, tmax));
    if ((__ballot_sync(gmask, lane_ok) & gmask) == 0) continue;
    const float4* rows =
        group_rows<kBundled>(table, slot, c, cluster, lane, gmask);
    if (!lane_ok) continue;
    const int row0 = c * cluster;
    for (int j = 0; j < cluster; ++j) {
      float t = pe_test(r, rows[4 * j], rows[4 * j + 1], rows[4 * j + 2], tmin);
      if (!(t < tmax)) t = kTFar;
      const int row = row0 + j;
      if (t < best || (t == best && row < best_row)) {
        best = t;
        best_row = row;
      }
    }
  }
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
}

// Any-hit: per-lane tmax (column 6 of the rays); a lane that is blocked
// stops testing, and the group stops when every lane is blocked or closed,
// its list has ended, or the key is beyond every open lane's
// min(last entry, tmax).
template <bool kBundled>
__global__ void occluded_grp_kernel(const float* __restrict__ rays,
                                    const float* __restrict__ tris,
                                    const float* __restrict__ boxes,
                                    const int* __restrict__ cand,
                                    const float* __restrict__ keys,
                                    const int* __restrict__ cnt,
                                    const float* __restrict__ last_key,
                                    int n_rays, int n_boxes, int cluster,
                                    float scale, float margin, float tmin,
                                    uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 s_slots[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  if (!kBundled && !live) return;
  const int g = i / kGroup, lane = threadIdx.x % kGroup;
  const unsigned gmask = 0xffu << (threadIdx.x & 24);
  float4* slot = s_slots + (threadIdx.x / kGroup) * cluster * 4;
  float tm = 0.0f;
  const Ray r = live ? load_ray8(rays, i, &tm) : Ray{0, 0, 0, 0, 0, 0};
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float lane_far = live ? fminf(last_key[i], tm) : -3e38f;
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* table = reinterpret_cast<const float4*>(tris);
  const int ncand = live ? min(max(cnt[g], 0), n_boxes) : 0;
  const int* list = cand + (size_t)(live ? g : 0) * n_boxes;
  const float* key = keys + (size_t)(live ? g : 0) * n_boxes;

  // Nothing can block when (tmin, tm) is empty (parked lanes carry tm = 0).
  bool open = live && tm > tmin;
  bool blocked = false;
  for (int k = 0;; ++k) {
    bool on = open && k < ncand && key[k] <= lane_far;
    on = (__ballot_sync(gmask, on) & gmask) != 0;
    if (kBundled) {
      if (!__syncthreads_or(on)) break;
      if (!on) continue;
    } else if (!on) {
      break;
    }
    const int c = list[k];
    const bool lane_ok = open && box_passes(r, s, m, bx, c, tmin, tm);
    if ((__ballot_sync(gmask, lane_ok) & gmask) == 0) continue;
    const float4* rows =
        group_rows<kBundled>(table, slot, c, cluster, lane, gmask);
    if (!lane_ok) continue;
    if (tpt::blocked_staged(r, rows, cluster, tmin, tm)) {
      blocked = true;
      open = false;
    }
  }
  if (live) occ_out[i] = blocked ? 1 : 0;
}

inline bool bad_cluster(int cluster) {
  return cluster < 1 || cluster > kMaxCluster;
}

// Threads per block: bundled, GRP_BUNDLE groups; serial, `lanes` (a
// multiple of 32 up to 1,024).
inline int grp_block(int bundled, int lanes) {
  return bundled ? kBundle * kGroup : lanes;
}

// Dynamic shared memory of a bundled block (8 slots of 8 KB at 128 rows:
// above the 48 KB a block gets without asking), or -1 if refused.
template <typename Kernel>
inline int grp_smem(Kernel kernel, int cluster) {
  const int bytes = kBundle * cluster * 4 * (int)sizeof(float4);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  return bytes;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for a cluster outside 1..128 or a serial group block
// that is not a multiple of 32 up to 1,024. Rays are [n, 8] f32 (pack_rays),
// tables as tpt_closest_clustered.

int tpt_closest_binned(const float* rays, const float* tris,
                       const int* pair_ray, const int* tile_sid, int n_tiles,
                       int n_boxes, int cluster, float tmin,
                       unsigned long long* key, void* stream) {
  if (bad_cluster(cluster)) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    closest_binned_kernel<<<(unsigned)n_tiles, kPairTile, 0,
                            (cudaStream_t)stream>>>(
        rays, tris, pair_ray, tile_sid, n_boxes, cluster, tmin, key);
  return (int)cudaGetLastError();
}

int tpt_occluded_binned(const float* rays, const float* tris,
                        const int* pair_ray, const int* tile_sid, int n_tiles,
                        int n_boxes, int cluster, float tmin, uint8_t* occ,
                        void* stream) {
  if (bad_cluster(cluster)) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    occluded_binned_kernel<<<(unsigned)n_tiles, kPairTile, 0,
                             (cudaStream_t)stream>>>(
        rays, tris, pair_ray, tile_sid, n_boxes, cluster, tmin, occ);
  return (int)cudaGetLastError();
}

int tpt_closest_grp(const float* rays, const float* tris, const float* boxes,
                    const int* cand, const float* keys, const int* cnt,
                    const float* last_key, int n_rays, int n_boxes,
                    int cluster, int lanes, int bundled, float scale,
                    float margin, float tmin, float tmax, float* t_out,
                    int* row_out, void* stream) {
  if (bad_cluster(cluster) || n_rays % kGroup ||
      (!bundled && (lanes < 32 || lanes > 1024 || lanes % 32)))
    return (int)cudaErrorInvalidValue;
  const int block = grp_block(bundled, lanes);
  const unsigned grid = (unsigned)((n_rays + block - 1) / block);
  if (grid == 0) return (int)cudaGetLastError();
  if (bundled) {
    const int smem = grp_smem(closest_grp_kernel<true>, cluster);
    if (smem < 0) return (int)cudaGetLastError();
    closest_grp_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        rays, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes,
        cluster, scale, margin, tmin, tmax, t_out, row_out);
  } else {
    closest_grp_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        rays, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes,
        cluster, scale, margin, tmin, tmax, t_out, row_out);
  }
  return (int)cudaGetLastError();
}

int tpt_occluded_grp(const float* rays, const float* tris,
                     const float* boxes, const int* cand, const float* keys,
                     const int* cnt, const float* last_key, int n_rays,
                     int n_boxes, int cluster, int lanes, int bundled,
                     float scale, float margin, float tmin, uint8_t* occ_out,
                     void* stream) {
  if (bad_cluster(cluster) || n_rays % kGroup ||
      (!bundled && (lanes < 32 || lanes > 1024 || lanes % 32)))
    return (int)cudaErrorInvalidValue;
  const int block = grp_block(bundled, lanes);
  const unsigned grid = (unsigned)((n_rays + block - 1) / block);
  if (grid == 0) return (int)cudaGetLastError();
  if (bundled) {
    const int smem = grp_smem(occluded_grp_kernel<true>, cluster);
    if (smem < 0) return (int)cudaGetLastError();
    occluded_grp_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        rays, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes,
        cluster, scale, margin, tmin, occ_out);
  } else {
    occluded_grp_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        rays, tris, boxes, cand, keys, cnt, last_key, n_rays, n_boxes,
        cluster, scale, margin, tmin, occ_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
