// The last two scheduler families of the clustered closest hit / any-hit
// for Hopper (sm_90a): the pair-binned jobs with their schedule, and the
// 8-lane groups.
//
// They replace the rest of tpu_pt/intersect/pallas_ablations.py, each a
// scheduler of what tpt_closest_clustered / tpt_occluded_clustered compute
// (closest (t, packed row), or the any-hit flag, over the clustered table):
//
//   tpt_pair_schedule    <- _pair_schedule (:1156), which the JAX package
//                           builds in XLA outside its kernels: the (ray,
//                           cluster) pairs of each ray's k nearest pierced
//                           clusters, cluster-major in tiles against one
//                           cluster each, built on the card.
//   tpt_closest_binned   <- _binned_closest_kernel (:1272) via
//                           _closest_call_binned (:1294), and the fold of
//                           _reduce_pairs (:1334),
//   tpt_occluded_binned  <- _binned_occluded_kernel (:1365) via
//                           _occluded_call_binned (:1383): every pair is
//                           one thread, a tile of T pairs one block.
//   tpt_closest_grp      <- _closest_kernel_grp (:1760),
//                           _closest_kernel_grp_chained (:1775),
//                           _closest_kernel_grp_bundled (:1693) and
//                           _closest_kernel_grp_bundled_chained (:1703) via
//                           _closest_call_grp (:1804),
//   tpt_occluded_grp     <- _occluded_kernel_grp (:1791) and
//                           _occluded_kernel_grp_bundled (:1715) via
//                           _occluded_call_grp (:1866): 8 consecutive rays
//                           share a near-first list of the clusters any of
//                           them pierces, and each ray, a group of G lanes,
//                           goes down it on its own.
//
// What was kept of each TPU schedule, and what was not:
// - binned: the pairs, their tiles against one cluster, the dead tail (tile
//   id = number of clusters), the per-ray fold, and next_tn / overflow for
//   the completion pass are kept. The rest is rebuilt for the card:
//   - The schedule is built here, not in eager PyTorch: the eager build
//     (ablations._pair_schedule, now the plain version) ran [rays x 1,024]
//     slab tests in column chunks, a top-k over every cluster, a stable
//     sort of all n k pairs and a scatter, some 6 ms a call at 32,768 rays
//     on the big mesh against a kernel of 0.1 ms. Select: one thread a ray
//     slab-tests the boxes staged in shared memory and keeps its k + 1
//     nearest (entry bits, id) keys in registers by insertion, so the top-k
//     of the reference (and its (entry, id) tie rule) is a pass over the
//     boxes with no [rays x clusters] array; it counts its pairs per cluster
//     with atomics. Layout: one block scans the per-cluster tile counts.
//     Place: each pair takes the next slot of its cluster's run with an
//     atomic. The reference's payload sorts, which fix the order within a
//     run, have no twin: the fold below is order-free, so the results do
//     not depend on it, and chip_smoke.py holds each run as a set.
//   - The tile width T is a template parameter (64, 128, 256 or 512 pairs;
//     ablations.BINNED_TILE, from tools/binned_ab_torch.py's trial on a
//     frame's calls). PAIR_TILE = 512 is a TPU lane layout; coherent camera
//     and shadow rays give most clusters far fewer pairs than that, and
//     every run is padded to whole tiles, so at 512 most of a block's
//     threads held no pair.
//   - The double payload sort and the 22-bit packed key, there because TPU
//     gathers were slow, are gone: a pair holds its ray's index and the
//     thread gathers the ray. _reduce_pairs' un-sort and one-hot pick
//     become one 64-bit atomicMin per pair on the key (float bits of t)
//     << 32 | row: every hit has t > tmin > 0, so the key orders as (t,
//     row) does, and the fold is the lexicographic minimum in any order,
//     so it is deterministic; the any-hit's fold is a store of 1.
// - grp: the transposed [16, CLUSTER] table and the [N, 8] rays exist
//   because rays live in a TPU vector's lanes, and the chained slabs
//   because a slab had to fit in VMEM; here the table keeps its row layout
//   and one launch covers it. The function is K12's at a tile of 8 rays,
//   and so is the kernel (list_walk.cuh, shared with K12): one ray to a
//   group of G lanes (ablations.grp_group / grp_occ_group) that goes down
//   its 8-ray tile's list on its own, G candidates at a time, each lane
//   running its own guard, a ballot for the passes, a per-ray break
//   re-checked after every swept candidate, the rows split over the lanes
//   and (t, row) folded by xor shuffles; the any-hit stops at its first
//   blocking cluster. The bundled body's TPU lockstep (a block barrier a
//   step, every group staging every candidate whether or not one of its
//   lanes passes) is not kept, and TPT_GRP=2 launches the same walk as
//   TPT_GRP=1: staging the next passing cluster's rows in the group's own
//   shared slot with cp.async, double-buffered, was 1.6-1.8x slower on a
//   frame's calls at every width (PERF.md). Exact, as K12: the reference
//   sweeps every listed cluster for all 8 rays; a culled cluster or one
//   past the break holds no nearer hit.
//
// What bounds them on this card: FP32 ALU. The binned closest kernel sweeps
// every live pair against all 128 rows of its staged cluster without
// divergence, the schedule's select step every (ray, box) slab test; the
// groups diverge where rays' lists or passes part. The
// binned path's bound is the function's with every box tested (K6's flat
// count), and the schedule's slab tests are most of it.
//
// Correctness: results are bitwise those of a dense sweep over every row
// with ties to the lowest packed row. The closest kernels compare (t, row)
// lexicographically; every cull (the lists in ablations.py, the per-lane
// cull and the schedule's slab tests here) uses the boxes grown by margin *
// (scale + max|o|). Built with --fmad=false; the per-pair test is pe_test
// of pe_block.cuh, the sweep of a staged cluster is K13's (sweep_staged,
// blocked_staged), and the schedule's slab test is slab_enter, the list
// build's, in the plain version's operation order.
//
// Barriers: in the binned kernels a dead tile leaves before its only
// barrier, as a whole block; in the schedule's select step every thread,
// live or not, reaches every barrier of the staging loop; the group kernels
// reach no barrier.

#include "list_walk.cuh"
#include "runs.cuh"

#include <type_traits>

namespace {

constexpr int kMaxCluster = 128;  // rows per cluster the row buffers hold
constexpr int kGroup = 8;         // ablations.GRP_LANES: rays a list
using tpt::kTFar;
using tpt::load_ray8;
using tpt::max_abs_origin;
using tpt::Ray;
using tpt::Slab;

// ---------------------------------------------------------- pair schedule

constexpr int kSelThreads = 128;   // rays a block of the select step
constexpr int kSelBoxes = 1024;    // boxes it stages at a time (32 KB)

// The order-preserving bits of a float as ablations._order_bits forms
// them (a signed int; -0.0 below +0.0), offset so that unsigned order is
// theirs, and back.
__device__ __forceinline__ unsigned order_key(float t) {
  const int b = __float_as_int(t);
  return (unsigned)(b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000u;
}

__device__ __forceinline__ float from_order_key(unsigned u) {
  const int b = (int)(u ^ 0x80000000u);
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}

// Step 1, select: a group of G consecutive lanes a ray. The block stages
// the boxes kSelBoxes at a time; lane l of the group slab-tests boxes l,
// l + G, ... against its ray's box grown by the ray's margin, within
// (tmin, tmax], in _near_far's operation order (slab_enter), and keeps the
// KMAX smallest keys (order_key(tn) << 32 | id, ties to the lowest id) of
// the boxes that pass in registers, sorted, by insertion. The group then
// merges its lanes' lists, k + 1 rounds of a shuffle minimum over their
// heads, the winner dropping its head, and writes the ray's k nearest ids
// to near[i * k ...] (n_boxes for none), the entry of its (k + 1)-th to
// next_tn (3e38 for none), whether it pierces more than k to overflow, and
// counts its pairs per cluster into per_c (atomicAdd). Needs k < KMAX.
// Every lane, live or not, reaches every barrier and every shuffle.
template <int KMAX, int G>
__global__ void __launch_bounds__(kSelThreads)
pair_select_kernel(const float* __restrict__ rays,
                   const float* __restrict__ tmax, float tmax_all,
                   const float* __restrict__ boxes, int n_rays, int n_boxes,
                   int k, float scale, float margin, float tmin,
                   int* __restrict__ near, float* __restrict__ next_tn,
                   uint8_t* __restrict__ overflow, int* __restrict__ per_c) {
  __shared__ float4 s_box[2 * kSelBoxes];
  const int i = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / G);
  const int lane = threadIdx.x % G;
  const bool live = i < n_rays;
  float tm = 0.0f;
  Ray r{0, 0, 0, 0, 0, 0};
  if (live) {
    r = load_ray8(rays, i, &tm);
    tm = tmax != nullptr ? tmax[i] : tmax_all;
  }
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  unsigned long long keep[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) keep[j] = ~0ull;
  int count = 0;
  for (int c0 = 0; c0 < n_boxes; c0 += kSelBoxes) {
    const int nb = min(kSelBoxes, n_boxes - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int q = threadIdx.x; q < 2 * nb; q += blockDim.x)
      s_box[q] = __ldg(bx + 2 * (size_t)c0 + q);
    __syncthreads();
    if (!live) continue;
    for (int b = lane; b < nb; b += G) {
      float tn;
      if (!tpt::slab_enter(r, s, s_box[2 * b], s_box[2 * b + 1], m, tmin,
                           &tn) ||
          !(tn <= tm))
        continue;
      ++count;
      const unsigned long long key =
          ((unsigned long long)order_key(tn) << 32) | (unsigned)(c0 + b);
      if (key < keep[KMAX - 1]) {
#pragma unroll
        for (int j = KMAX - 1; j > 0; --j)
          keep[j] = key < keep[j - 1] ? keep[j - 1]
                                      : (key < keep[j] ? key : keep[j]);
        keep[0] = key < keep[0] ? key : keep[0];
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off, G);
  float next = 3e38f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j > k) break;  // uniform: every lane has k
    unsigned long long head = keep[0];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const unsigned long long other =
          __shfl_xor_sync(0xffffffffu, head, off, G);
      head = other < head ? other : head;
    }
    if (keep[0] == head) {  // the winner drops its head (keys are unique)
#pragma unroll
      for (int t = 0; t < KMAX - 1; ++t) keep[t] = keep[t + 1];
      keep[KMAX - 1] = ~0ull;
    }
    if (!live || lane != j % G) continue;
    if (j < k) {
      const int c = j < count ? (int)(unsigned)(head & 0xffffffffu)
                              : n_boxes;
      near[(size_t)i * k + j] = c;
      if (c < n_boxes) atomicAdd(per_c + c, 1);
    } else if (count > k) {
      next = from_order_key((unsigned)(head >> 32));
    }
  }
  if (!live || lane != k % G) return;
  next_tn[i] = next;
  overflow[i] = count > k ? 1 : 0;
}

// Step 2, layout and tiles: tpt::run_layout_kernel scans the clusters'
// tile counts ceil(per_c / tile) into tile_end (inclusive) and each run's
// first slot into cursor; tpt::run_owner_kernel gives tile j the first
// cluster whose runs end past it (searchsorted(tile_end, j, right=True)),
// the tail past every run n_boxes.

// Step 3, place: pair p (ray p / k) takes the next slot of its cluster's
// run. The order within a run is the order of the atomics; the kernels
// fold a run in any order to the same result.
__global__ void pair_place_kernel(const int* __restrict__ near, int n_pairs,
                                  int k, int n_boxes,
                                  int* __restrict__ cursor,
                                  int* __restrict__ pair_ray) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    const int c = near[p];
    if (c < n_boxes) pair_ray[atomicAdd(cursor + c, 1)] = p / k;
  }
}

// ------------------------------------------------------------------ binned

// Tile `blockIdx.x` is pair slots [tile * T, ...) against cluster
// tile_sid[tile]; a tile id >= n_boxes marks the dead tail, a slot's ray
// index < 0 an unused slot. `key` [n] starts at (bits of kTFar) << 32.
template <int T>
__global__ void __launch_bounds__(T)
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
  const int r = pair_ray[(size_t)blockIdx.x * T + threadIdx.x];
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
template <int T>
__global__ void __launch_bounds__(T)
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
  const int r = pair_ray[(size_t)blockIdx.x * T + threadIdx.x];
  if (r < 0) return;
  float tm;
  const Ray ray = load_ray8(rays, r, &tm);
  if (tpt::blocked_staged(ray, s_rows, cluster, tmin, tm)) occ[r] = 1;
}

inline bool bad_cluster(int cluster) {
  return cluster < 1 || cluster > kMaxCluster;
}

// Calls launch(std::integral_constant<int, T>{}) for a tile width T built
// here (ablations.BINNED_TILES); false for any other.
template <typename Launch>
bool with_tile(int tile, Launch launch) {
  switch (tile) {
    case 64: launch(std::integral_constant<int, 64>{}); return true;
    case 128: launch(std::integral_constant<int, 128>{}); return true;
    case 256: launch(std::integral_constant<int, 256>{}); return true;
    case 512: launch(std::integral_constant<int, 512>{}); return true;
    default: return false;
  }
}

// The same for the select step's register list, KMAX > k, and its lanes a
// ray G (ablations.PAIR_GROUPS).
template <typename Launch>
bool with_kmax(int k, Launch launch) {
  if (k < 8) launch(std::integral_constant<int, 8>{});
  else if (k < 16) launch(std::integral_constant<int, 16>{});
  else if (k < 32) launch(std::integral_constant<int, 32>{});
  else if (k < 64) launch(std::integral_constant<int, 64>{});
  else return false;
  return true;
}

template <typename Launch>
bool with_select_group(int group, Launch launch) {
  switch (group) {
    case 1: launch(std::integral_constant<int, 1>{}); return true;
    case 2: launch(std::integral_constant<int, 2>{}); return true;
    case 4: launch(std::integral_constant<int, 4>{}); return true;
    case 8: launch(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for a cluster outside 1..128, a width not built
// here, or a K15 ray count that is not a multiple of 8. Rays are [n, 8]
// f32 (pack_rays), tables as tpt_closest_clustered.

// The pair schedule of ablations._pair_schedule for rays [n_rays, 8]
// (tmax [n_rays] f32 each ray's bound, or null for tmax_all) and boxes
// [n_boxes, 8], k <= n_boxes pairs a ray at most, at tiles of `tile`
// slots: pair_ray [(ceil(n_rays k / tile) + n_boxes) * tile] i32,
// tile_sid [ceil(n_rays k / tile) + n_boxes] i32, next_tn [n_rays] f32,
// overflow [n_rays] u8. Scratch: near [n_rays * k] i32, per_c, tile_end
// and cursor [n_boxes] i32. Needs 0 <= k < 64, a tile width of with_tile
// and `group` lanes a ray for the select step of with_select_group.
int tpt_pair_schedule(const float* rays, const float* tmax, float tmax_all,
                      const float* boxes, int n_rays, int n_boxes, int k,
                      int tile, int group, float scale, float margin,
                      float tmin, int* near, int* per_c, int* tile_end,
                      int* cursor, int* pair_ray, int* tile_sid,
                      float* next_tn, uint8_t* overflow, void* stream) {
  if (n_rays < 0 || n_boxes < 1 || k < 0 || k > n_boxes ||
      !with_tile(tile, [](auto) {}) || !with_kmax(k, [](auto) {}) ||
      !with_select_group(group, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_pairs = (long long)n_rays * k;
  const long long n_tiles = (n_pairs + tile - 1) / tile + n_boxes;
  cudaMemsetAsync(per_c, 0, sizeof(int) * n_boxes, s);
  cudaMemsetAsync(pair_ray, 0xff, sizeof(int) * n_tiles * tile, s);  // -1
  if (n_rays > 0)
    with_kmax(k, [&](auto kc) {
      constexpr int KMAX = decltype(kc)::value;
      with_select_group(group, [&](auto gc) {
        constexpr int G = decltype(gc)::value;
        const long long threads = (long long)n_rays * G;
        pair_select_kernel<KMAX, G>
            <<<(unsigned)((threads + kSelThreads - 1) / kSelThreads),
               kSelThreads, 0, s>>>(rays, tmax, tmax_all, boxes, n_rays,
                                    n_boxes, k, scale, margin, tmin, near,
                                    next_tn, overflow, per_c);
      });
    });
  tpt::run_layout_kernel<<<1, tpt::kRunLayoutThreads, 0, s>>>(
      per_c, n_boxes, tile, tile_end, cursor);
  tpt::run_owner_kernel<<<tpt::run_grid(n_tiles), 256, 0, s>>>(
      tile_end, n_boxes, (int)n_tiles, n_boxes, tile_sid);
  if (n_pairs > 0)
    pair_place_kernel<<<tpt::run_grid(n_pairs), 256, 0, s>>>(
        near, (int)n_pairs, k, n_boxes, cursor, pair_ray);
  return (int)cudaGetLastError();
}

int tpt_closest_binned(const float* rays, const float* tris,
                       const int* pair_ray, const int* tile_sid, int n_tiles,
                       int tile, int n_boxes, int cluster, float tmin,
                       unsigned long long* key, void* stream) {
  if (bad_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const bool ok = with_tile(tile, [&](auto tc) {
    constexpr int T = decltype(tc)::value;
    if (n_tiles > 0)
      closest_binned_kernel<T><<<(unsigned)n_tiles, T, 0,
                                 (cudaStream_t)stream>>>(
          rays, tris, pair_ray, tile_sid, n_boxes, cluster, tmin, key);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_occluded_binned(const float* rays, const float* tris,
                        const int* pair_ray, const int* tile_sid, int n_tiles,
                        int tile, int n_boxes, int cluster, float tmin,
                        uint8_t* occ, void* stream) {
  if (bad_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const bool ok = with_tile(tile, [&](auto tc) {
    constexpr int T = decltype(tc)::value;
    if (n_tiles > 0)
      occluded_binned_kernel<T><<<(unsigned)n_tiles, T, 0,
                                  (cudaStream_t)stream>>>(
          rays, tris, pair_ray, tile_sid, n_boxes, cluster, tmin, occ);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// K15 over the group lists of tpt_stream_candidates at tiles of kGroup
// (8) rays, `rays` packed [n_rays, 8] (n_rays a multiple of 8), `group`
// lanes a ray (a width of with_group: 4, 8, 16, 32). The serial and the
// bundled body (TPT_GRP=1, 2) both launch it (see the note at the top).
int tpt_closest_grp(const float* rays, const float* tris, const float* boxes,
                    const int* cand, const float* keys, const int* cnt,
                    const float* last_key, int n_rays, int n_boxes,
                    int cluster, float scale, float margin, float tmin,
                    float tmax, float* t_out, int* row_out, int group,
                    void* stream) {
  if (bad_cluster(cluster) || n_rays % kGroup)
    return (int)cudaErrorInvalidValue;
  const bool ok = tpt::launch_closest_list(
      group, n_rays, (cudaStream_t)stream, rays, tris, boxes, cand, keys,
      cnt, last_key, n_rays, n_boxes, cluster, kGroup, scale, margin, tmin,
      tmax, 1, t_out, row_out);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// K15 any-hit: `rays` column 6 each ray's tmax; the rest as above.
int tpt_occluded_grp(const float* rays, const float* tris,
                     const float* boxes, const int* cand, const float* keys,
                     const int* cnt, const float* last_key, int n_rays,
                     int n_boxes, int cluster, float scale, float margin,
                     float tmin, uint8_t* occ_out, int group, void* stream) {
  if (bad_cluster(cluster) || n_rays % kGroup)
    return (int)cudaErrorInvalidValue;
  const bool ok = tpt::launch_occluded_list(
      group, n_rays, (cudaStream_t)stream, rays, tris, boxes, cand, keys,
      cnt, last_key, n_rays, n_boxes, cluster, kGroup, scale, margin, tmin,
      1, occ_out);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
