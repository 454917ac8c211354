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
//                             _closest_call_streamed (:490): one launch; a
//                             tile of rays shares a list of the boxes any of
//                             them pierces, sorted by the tile's least entry
//                             distance, sweeps it through a ring of row
//                             buffers filled ahead of the sweep, and stops
//                             at the first key no lane can still use.
//   tpt_occluded_streamed  <- _occluded_kernel_streamed (:275) via
//                             _occluded_call_streamed (:529): the any-hit
//                             over the same kind of list, one ray to a
//                             group of lanes (below).
//   tpt_stream_candidates  <- stream_candidates (:408), which the JAX
//                             package builds in XLA outside its kernels:
//                             the tile lists of both, built on the card.
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
// - streamed, closest: the list, the keys, the ring (STREAM_BUF = 4 slots
//   of one cluster, 8 KB each at 128 rows, filled with cp.async), the exact
//   early break and the per-candidate guard are all kept. The 128-lane
//   widening of the table is a Mosaic DMA constraint and has no twin. The
//   break is tightened by one term the list build knows: `far`, a lane's
//   last entry distance over the boxes it pierces; beyond it the lane takes
//   part in no candidate, so a lane that misses everything does not hold
//   its tile.
// - streamed, any-hit: the tile's list, its near-first key order and the
//   exact break (key > the lane's min(far, tmax)) are kept; the tile's
//   lockstep is not. One ray goes to a group of G lanes (walk.cuh), and
//   each group goes down its tile's list on its own: G candidates at a
//   time, each lane reading one (key, box) through L2 and, with the guard
//   on, testing its ray's own grown box against it; a ballot gives the
//   candidates before the break that pass, and the group sweeps each with
//   cluster_blocked (rows split over its lanes, read through L2), nearest
//   first, until one blocks. No block vote, no barrier and no ring of
//   shared row buffers: a ray that reaches the light no longer keeps a
//   block of 256 running, and no lane sweeps a cluster its own box test
//   fails. Guard off (TPT_STREAM_GUARD=0): every candidate up to the
//   break is swept. Its tile (ablations.STREAM_OCC_TILE) and G
//   (ablations.stream_occ_group) come from tools/clustered_group_trial.py.
// - the list build: one block a tile. Each warp takes 32 of the tile's
//   rays, one a lane, and a slice of the boxes; per box it slab-tests its
//   rays against the box grown by their margins, within their tmax, and a
//   ballot says whether any passes; only then does it fold their least
//   entry distance (a warp min, then a shared-memory atomicMin) and count
//   them. A lane keeps its ray's last entry (`far`) itself. The block then
//   sorts (key, box id) in shared memory: a bitonic sort, the key's bits
//   made order-preserving, -0.0 taken as +0.0 (torch.sort compares the two
//   equal), so ties go to the lower id, as the stable sort of
//   stream_candidates has them. Only the boxes whose key is not T_FAR
//   (the listed ones, near first) are sorted; the rest, every unlisted box
//   among them, keep their id order between the keys below T_FAR and any
//   above it. It writes cand, keys, cnt and far, bitwise equal to
//   stream_candidates. That holds up to 256 rays a tile and 8,192 boxes;
//   past either (tpt_stream_candidates_global) the same slab tests run in
//   blocks of one tile and 2,048 boxes, looping over the tile's 32-ray
//   chunks, with the keys, the counts and `far` in device memory, each
//   block sorts its run of (key bits, id), every box's, in shared memory,
//   and merge passes in device memory (each entry to its rank in the merge
//   of two runs, by a binary search in the other) give each tile's order.
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
// The any-hit's groups reach no barrier: a group's branches are uniform
// over its lanes, which hold the same ray.

#include "walk.cuh"

#include <cuda_pipeline.h>

#include <cstring>

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

// Ray i's list is its tile's, tile i / rt. One ray to a group of G lanes.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
occluded_streamed_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir,
                         const float* __restrict__ tmax,
                         const float* __restrict__ tris,
                         const float* __restrict__ boxes,
                         const int* __restrict__ cand,
                         const float* __restrict__ keys,
                         const int* __restrict__ cnt,
                         const float* __restrict__ last_key, int n_rays,
                         int n_boxes, int cluster, int rt, float scale,
                         float margin, float tmin, int guard,
                         uint8_t* __restrict__ occ_out) {
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const float tm = tmax[i];
  bool blocked = false;
  // Nothing can block when (tmin, tm) is empty (parked lanes carry tm = 0).
  if (tm > tmin) {
    const Ray r = load_ray(orig, dir, i);
    const Slab s = tpt::make_slab(r);
    const float m = margin * (scale + max_abs_origin(r));
    const float lane_far = fminf(__ldg(last_key + i), tm);
    const float4* bx = reinterpret_cast<const float4*>(boxes);
    const float4* rows = reinterpret_cast<const float4*>(tris);
    const int tile = i / rt;
    const int* list = cand + (size_t)tile * n_boxes;
    const float* key = keys + (size_t)tile * n_boxes;
    const int ncand = min(max(__ldg(cnt + tile), 0), n_boxes);
    const unsigned all = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
    for (int k0 = 0; k0 < ncand && !blocked; k0 += G) {
      // Keys ascend, and the ray enters no box before its key: the
      // candidates it can still use are the chunk's first ones, up to the
      // first key beyond its last entry or its tmax.
      const int k = k0 + g.lane;
      const bool live = k < ncand && __ldg(key + k) <= lane_far;
      const int c = live ? __ldg(list + k) : 0;
      const unsigned usable = tpt::group_ballot(g, live);
      unsigned pass = guard ? tpt::group_ballot(
                                  g, live && tpt::box_passes(r, s, m, bx, c,
                                                             tmin, tm))
                            : usable;
      while (pass != 0u && !blocked) {
        const int j = __ffs(pass) - 1;
        pass &= pass - 1u;
        const int cj = __shfl_sync(g.mask, c, j, G);
        blocked = tpt::cluster_blocked(r, rows, cj * cluster, cluster, G, g,
                                       tmin, tm);
      }
      if (usable != all) break;  // the break, or the list's end
    }
  }
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

// ------------------------------------------------------------- list build

constexpr int kListThreads = 1024;  // threads a block (a tile)
constexpr int kListMaxTile = 256;   // ablations.LIST_MAX_TILE
constexpr int kListMaxBoxes = 8192;  // ablations.LIST_MAX_BOXES

// Float bits whose signed-integer order is the float order (no NaN here):
// an atomicMax / atomicMin on them is a max / min of the floats.
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int e) {
  return __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

// The sort key of a float: unsigned order = float order, -0.0 as +0.0
// (torch.sort compares the two equal, so a stable sort keeps their ids in
// order).
__device__ __forceinline__ unsigned sort_bits(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Bitonic sort of s[0, n) ascending by the whole block (n a power of two;
// every entry unique: the ids in the low word). Ends with a barrier.
__device__ void bitonic_sort(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int a = 2 * p - (p & (j - 1));
        const unsigned long long x = s[a], y = s[a + j];
        if ((x > y) == ((a & k) == 0)) {
          s[a] = y;
          s[a + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Tile blockIdx.x: rays [tile * rt, ...) of the packed rays [n_pad, 8];
// each ray's bound is tmax[i], or tmax_all when tmax is null. Dynamic
// shared memory: sort_cap u64 sort keys (the next power of two of
// n_boxes), then n_boxes i32 minima (later the keys as floats), n_boxes
// i32 counts and rt i32 last entries.
__global__ void __launch_bounds__(kListThreads)
stream_candidates_kernel(const float* __restrict__ rays,
                         const float* __restrict__ tmax, float tmax_all,
                         const float* __restrict__ boxes, int n_boxes,
                         int rt, int sort_cap, float scale, float margin,
                         float tmin, int* __restrict__ cand,
                         float* __restrict__ keys, int* __restrict__ cnt,
                         float* __restrict__ last_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kListThreads / 32];
  unsigned long long* s_sort = reinterpret_cast<unsigned long long*>(smem);
  int* s_min = reinterpret_cast<int*>(s_sort + sort_cap);
  int* s_nok = s_min + n_boxes;
  int* s_far = s_nok + n_boxes;
  const int tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  const int ray_warps = (rt + 31) >> 5;
  const int slice = warp / ray_warps, slices = warps / ray_warps;
  for (int b = tid; b < n_boxes; b += blockDim.x) {
    s_min[b] = ordered(__int_as_float(0x7f800000));  // +inf
    s_nok[b] = 0;
  }
  for (int q = tid; q < rt; q += blockDim.x) s_far[q] = ordered(-3e38f);
  __syncthreads();

  // This lane's ray; lanes past the tile's rays (rt < 32) and warps past
  // the last slice pass no box.
  const int q = (warp % ray_warps) * 32 + lane;
  const bool real = q < rt && slice < slices;
  float tm = 0.0f;
  Ray r{0, 0, 0, 0, 0, 0};
  if (real) {
    r = tpt::load_ray8(rays, tile * rt + q, &tm);
    tm = tmax != nullptr ? tmax[tile * rt + q] : tmax_all;
  }
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  float far = -3e38f;
  if (slice < slices) {
    for (int b = slice; b < n_boxes; b += slices) {
      float tn;
      const bool ok = real &&
                      tpt::slab_enter(r, s, __ldg(bx + 2 * (size_t)b),
                                      __ldg(bx + 2 * (size_t)b + 1), m, tmin,
                                      &tn) &&
                      tn <= tm;
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
      if (vote == 0u) continue;  // warp-uniform
      far = fmaxf(far, ok ? tn : -3e38f);
      const int least = __reduce_min_sync(
          0xffffffffu, ok ? ordered(tn) : ordered(__int_as_float(0x7f800000)));
      if (lane == 0) {
        atomicMin(s_min + b, least);
        atomicAdd(s_nok + b, __popc(vote));
      }
    }
  }
  if (real) atomicMax(s_far + q, ordered(far));
  __syncthreads();

  // A box's key is the least over the tile's rays of (its entry distance
  // where it passes, T_FAR where it does not), T_FAR where none passes.
  // The sorted order puts the keys below T_FAR first, then the boxes whose
  // key is T_FAR in id order (every unlisted box among them), then the
  // keys above it (only with a tmax above T_FAR): only the first and the
  // last kind are sorted.
  float* key_of = reinterpret_cast<float*>(s_min);
  int listed = 0, below = 0, sorted = 0;
  for (int b0 = 0; b0 < n_boxes; b0 += blockDim.x) {
    const int b = b0 + tid;
    int nok = 0;
    float key = kTFar;
    if (b < n_boxes) {
      nok = s_nok[b];
      if (nok > 0)
        key = fminf(from_ordered(s_min[b]),
                    nok < rt ? kTFar : __int_as_float(0x7f800000));
      key_of[b] = key;
    }
    listed += __syncthreads_count(nok > 0);
    below += __syncthreads_count(key < kTFar);
    sorted += __syncthreads_count(key != kTFar);
  }
  const size_t row = (size_t)tile * n_boxes;
  const int n_far = n_boxes - sorted;  // keys equal to T_FAR
  // Compact the sorted kind into s_sort in id order (a block-wide prefix
  // count per chunk); write the T_FAR kind straight to its place.
  int done = 0;  // sorted-kind boxes with a lower id than this chunk's
  for (int b0 = 0; b0 < n_boxes; b0 += blockDim.x) {
    const int b = b0 + tid;
    const bool in_sort = b < n_boxes && key_of[b] != kTFar;
    const unsigned vote = __ballot_sync(0xffffffffu, in_sort);
    if (lane == 0) s_warp[warp] = __popc(vote);
    __syncthreads();
    int before = done, chunk = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = s_warp[w];
      if (w < warp) before += c;
      chunk += c;
    }
    before += __popc(vote & ((1u << lane) - 1u));
    if (in_sort) {
      s_sort[before] =
          ((unsigned long long)sort_bits(key_of[b]) << 32) | (unsigned)b;
    } else if (b < n_boxes) {
      const size_t at = row + below + (b - before);
      cand[at] = b;
      keys[at] = key_of[b];
    }
    done += chunk;
    __syncthreads();  // s_warp is rewritten next chunk
  }
  int n_sort = 1;
  while (n_sort < sorted) n_sort <<= 1;
  for (int p = sorted + tid; p < n_sort; p += blockDim.x) s_sort[p] = ~0ull;
  __syncthreads();

  bitonic_sort(s_sort, n_sort);

  for (int p = tid; p < sorted; p += blockDim.x) {
    const int id = (int)(unsigned)(s_sort[p] & 0xffffffffu);
    const size_t at = row + (p < below ? p : p + n_far);
    cand[at] = id;
    keys[at] = key_of[id];
  }
  if (tid == 0) cnt[tile] = listed;
  for (int q2 = tid; q2 < rt; q2 += blockDim.x)
    last_key[(size_t)tile * rt + q2] = from_ordered(s_far[q2]);
}

// ------------------------------------------- list build past its caps
//
// Tiles of more than kListMaxTile rays or tables of more than kListMaxBoxes
// boxes: the same lists, with the block's state in device memory. Step 1
// (list_runs_kernel): block (x, y) takes tile x against boxes
// [y * kRunBoxes, ...); its warps take 32-ray chunks and box slices as the
// shared build's do, looping over the chunks where the tile has more than
// 32 of them; each box's key goes to key_of [tiles, n_boxes], the listed
// count to cnt[tile] (atomicAdd), each ray's last entry to far_bits
// (atomicMax of ordered bits), and the block sorts its run of (sort bits,
// id) in shared memory into runs [tiles, n_boxes]. Step 2
// (list_merge_kernel, once per doubling of the run width): each entry of a
// pair of adjacent sorted runs goes to its rank in their merge, its rank in
// its own run plus the number of the other run's entries below it (a binary
// search; every entry is unique). Step 3 (list_emit_kernel): cand, keys and
// last_key from the sorted entries. Every box is sorted, the T_FAR ones
// included: (sort bits, id) puts them by id between the keys below T_FAR
// and those above it, where the shared build places them unsorted.

constexpr int kRunBoxes = 2048;  // boxes a block of step 1 takes and sorts

__global__ void fill_ints(int* __restrict__ out, int n, int value) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = value;
}

__global__ void __launch_bounds__(kListThreads)
list_runs_kernel(const float* __restrict__ rays, const float* __restrict__ tmax,
                 float tmax_all, const float* __restrict__ boxes, int n_boxes,
                 int rt, float scale, float margin, float tmin,
                 float* __restrict__ key_of, int* __restrict__ cnt,
                 int* __restrict__ far_bits,
                 unsigned long long* __restrict__ runs) {
  __shared__ int s_min[kRunBoxes];
  __shared__ int s_nok[kRunBoxes];
  __shared__ unsigned long long s_sort[kRunBoxes];
  const int tile = blockIdx.x, b0 = blockIdx.y * kRunBoxes;
  const int nb = min(kRunBoxes, n_boxes - b0);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  for (int b = tid; b < nb; b += blockDim.x) {
    s_min[b] = ordered(__int_as_float(0x7f800000));  // +inf
    s_nok[b] = 0;
  }
  __syncthreads();

  const int ray_warps = (rt + 31) >> 5;
  const int rw0 = min(ray_warps, warps);
  const int slice = warp / rw0, slices = warps / rw0;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + 2 * (size_t)b0;
  if (slice < slices) {
    for (int rw = warp % rw0; rw < ray_warps; rw += rw0) {
      const int q = rw * 32 + lane;
      const bool real = q < rt;
      const size_t i = (size_t)tile * rt + q;
      float tm = 0.0f;
      Ray r{0, 0, 0, 0, 0, 0};
      if (real) {
        r = tpt::load_ray8(rays, (int)i, &tm);
        tm = tmax != nullptr ? tmax[i] : tmax_all;
      }
      const Slab s = tpt::make_slab(r);
      const float m = margin * (scale + max_abs_origin(r));
      float far = -3e38f;
      for (int b = slice; b < nb; b += slices) {
        float tn;
        const bool ok = real &&
                        tpt::slab_enter(r, s, __ldg(bx + 2 * (size_t)b),
                                        __ldg(bx + 2 * (size_t)b + 1), m,
                                        tmin, &tn) &&
                        tn <= tm;
        const unsigned vote = __ballot_sync(0xffffffffu, ok);
        if (vote == 0u) continue;  // warp-uniform
        far = fmaxf(far, ok ? tn : -3e38f);
        const int least = __reduce_min_sync(
            0xffffffffu,
            ok ? ordered(tn) : ordered(__int_as_float(0x7f800000)));
        if (lane == 0) {
          atomicMin(s_min + b, least);
          atomicAdd(s_nok + b, __popc(vote));
        }
      }
      if (real) atomicMax(far_bits + i, ordered(far));
    }
  }
  __syncthreads();

  int n_sort = 1;
  while (n_sort < nb) n_sort <<= 1;
  int listed = 0;
  for (int p0 = 0; p0 < n_sort; p0 += blockDim.x) {
    const int b = p0 + tid;
    int nok = 0;
    if (b < nb) {
      nok = s_nok[b];
      float key = kTFar;
      if (nok > 0)
        key = fminf(from_ordered(s_min[b]),
                    nok < rt ? kTFar : __int_as_float(0x7f800000));
      key_of[(size_t)tile * n_boxes + b0 + b] = key;
      s_sort[b] = ((unsigned long long)sort_bits(key) << 32) | (unsigned)(b0 + b);
    } else if (b < n_sort) {
      s_sort[b] = ~0ull;  // above every entry: no key's bits are all ones
    }
    listed += __syncthreads_count(nok > 0);
  }
  bitonic_sort(s_sort, n_sort);
  unsigned long long* run = runs + (size_t)tile * n_boxes + b0;
  for (int p = tid; p < nb; p += blockDim.x) run[p] = s_sort[p];
  if (tid == 0 && listed > 0) atomicAdd(cnt + tile, listed);
}

// Runs of `width` sorted entries of each tile's row of `in` [tiles,
// n_boxes], merged in pairs into `out`.
__global__ void list_merge_kernel(const unsigned long long* __restrict__ in,
                                  unsigned long long* __restrict__ out,
                                  int n_boxes, int width, size_t total) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t tile = idx / n_boxes;
    const int i = (int)(idx - tile * n_boxes);
    const unsigned long long* row = in + tile * n_boxes;
    const int base = (int)((long long)i / (2LL * width) * (2LL * width));
    const int a_end = (int)min((long long)base + width, (long long)n_boxes);
    const int b_end = (int)min((long long)base + 2LL * width,
                               (long long)n_boxes);
    const unsigned long long x = row[i];
    const bool in_a = i < a_end;
    int lo = in_a ? a_end : base, hi = in_a ? b_end : a_end;
    const int start = lo;
    while (lo < hi) {  // the other run's entries below x
      const int mid = (lo + hi) >> 1;
      if (row[mid] < x) lo = mid + 1;
      else hi = mid;
    }
    const int pos = (in_a ? i : base + (i - a_end)) + (lo - start);
    out[tile * n_boxes + pos] = x;
  }
}

__global__ void list_emit_kernel(const unsigned long long* __restrict__ sorted,
                                 const float* __restrict__ key_of,
                                 const int* __restrict__ far_bits,
                                 int n_boxes, size_t total, int n_rays,
                                 int* __restrict__ cand,
                                 float* __restrict__ keys,
                                 float* __restrict__ last_key) {
  const size_t end = total > (size_t)n_rays ? total : (size_t)n_rays;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < end;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < total) {
      const int id = (int)(unsigned)(sorted[idx] & 0xffffffffu);
      cand[idx] = id;
      keys[idx] = key_of[idx / n_boxes * n_boxes + id];
    }
    if (idx < (size_t)n_rays) last_key[idx] = from_ordered(far_bits[idx]);
  }
}

// Blocks of a grid-stride pass over `count` items, 256 threads each.
inline unsigned stride_grid(size_t count) {
  const size_t blocks = (count + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
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
// 256 or a cluster outside 1..128 (the any-hit: a tile below 1, or a
// `group` that is not a width built here, 4, 8, 16, 32). Tables as
// tpt_closest_clustered.

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
                          uint8_t* occ_out, int group, void* stream) {
  if (rt < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    occluded_streamed_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, tmax, tris, boxes, cand, keys,
                                   cnt, last_key, n_rays, n_boxes, cluster,
                                   rt, scale, margin, tmin, guard, occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The tile lists of stream_candidates for `rays` [n_rays, 8] (n_rays a
// multiple of rt): cand [tiles, n_boxes] i32, keys [tiles, n_boxes] f32,
// cnt [tiles] i32, last_key [n_rays] f32. `tmax` [n_rays] f32 is each
// ray's bound, or null for tmax_all on every ray. Needs 1 <= rt <= 256
// and 1 <= n_boxes <= 8,192 (the shared-memory sort).
int tpt_stream_candidates(const float* rays, const float* tmax,
                          float tmax_all, const float* boxes, int n_rays,
                          int n_boxes, int rt, float scale, float margin,
                          float tmin, int* cand, float* keys, int* cnt,
                          float* last_key, void* stream) {
  if (rt < 1 || rt > kListMaxTile || n_rays % rt || n_boxes < 1 ||
      n_boxes > kListMaxBoxes)
    return (int)cudaErrorInvalidValue;
  int sort_cap = 1;
  while (sort_cap < n_boxes) sort_cap <<= 1;
  const size_t smem = (size_t)sort_cap * 8 + (size_t)n_boxes * 8 + rt * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned tiles = (unsigned)(n_rays / rt);
  if (tiles == 0) return (int)cudaSuccess;
  stream_candidates_kernel<<<tiles, kListThreads, smem,
                             (cudaStream_t)stream>>>(
      rays, tmax, tmax_all, boxes, n_boxes, rt, sort_cap, scale, margin, tmin,
      cand, keys, cnt, last_key);
  return (int)cudaGetLastError();
}

// The same lists for any tile width and any number of boxes (the steps
// above), with scratch from the caller: key_of [tiles * n_boxes] f32,
// far_bits [n_rays] i32, sort_a and sort_b [tiles * n_boxes] u64. Needs
// rt >= 1 dividing n_rays and n_boxes >= 1.
int tpt_stream_candidates_global(const float* rays, const float* tmax,
                                 float tmax_all, const float* boxes,
                                 int n_rays, int n_boxes, int rt, float scale,
                                 float margin, float tmin, float* key_of,
                                 int* far_bits, unsigned long long* sort_a,
                                 unsigned long long* sort_b, int* cand,
                                 float* keys, int* cnt, float* last_key,
                                 void* stream) {
  if (rt < 1 || n_rays % rt || n_boxes < 1 ||
      (n_boxes + kRunBoxes - 1) / kRunBoxes > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = n_rays / rt;
  if (tiles == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t total = (size_t)tiles * n_boxes;
  cudaMemsetAsync(cnt, 0, sizeof(int) * tiles, s);
  const float neg = -3e38f;
  int neg_bits;
  std::memcpy(&neg_bits, &neg, sizeof(int));
  neg_bits ^= 0x7fffffff;  // ordered(-3e38): the bits are negative
  fill_ints<<<stride_grid(n_rays), 256, 0, s>>>(far_bits, n_rays, neg_bits);
  const dim3 grid((unsigned)tiles, (unsigned)((n_boxes + kRunBoxes - 1) /
                                              kRunBoxes));
  list_runs_kernel<<<grid, kListThreads, 0, s>>>(
      rays, tmax, tmax_all, boxes, n_boxes, rt, scale, margin, tmin, key_of,
      cnt, far_bits, sort_a);
  unsigned long long *src = sort_a, *dst = sort_b;
  for (long long w = kRunBoxes; w < n_boxes; w *= 2) {
    list_merge_kernel<<<stride_grid(total), 256, 0, s>>>(src, dst, n_boxes,
                                                          (int)w, total);
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  list_emit_kernel<<<stride_grid(total > (size_t)n_rays ? total : n_rays),
                     256, 0, s>>>(src, key_of, far_bits, n_boxes, total,
                                  n_rays, cand, keys, last_key);
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
