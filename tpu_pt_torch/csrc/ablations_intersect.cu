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
//                             distance, and each ray, a group of lanes, goes
//                             down it on its own (below).
//   tpt_occluded_streamed  <- _occluded_kernel_streamed (:275) via
//                             _occluded_call_streamed (:529): the any-hit
//                             over the same kind of list, one ray to a
//                             group of lanes (below).
//   tpt_stream_candidates  <- stream_candidates (:408), which the JAX
//                             package builds in XLA outside its kernels:
//                             the tile lists of both, built on the card.
//   tpt_cbin_schedule      <- cbin_pairs (:814), which the JAX package
//                             builds in XLA outside its kernels: the job
//                             table of both sweeps, built on the card.
//   tpt_closest_cbin       <- _closest_kernel_cbin (:905) via
//                             _closest_call_cbin (:948), and the reduce
//                             _cbin_reduce (:988),
//   tpt_occluded_cbin      <- _occluded_kernel_cbin (:1014) via
//                             _occluded_call_cbin (:1054), and
//                             _cbin_reduce_occ (:1089): the grid is a list
//                             of jobs, each a run of (ray, cluster) pair
//                             lanes against one cluster; each lane folds
//                             its result into its ray's.
//
// What was kept of each TPU schedule, and what was not:
// - rotated: the S chained launches, needed there because a slab had to
//   fit in VMEM, are a loop over the slabs inside one launch; the per-tile
//   candidate tables (rotated_candidates) have no twin. One ray goes to a
//   group of G lanes (walk.cuh), which starts at its own predicted slab:
//   the warp vote on a first slab (a TPU tile's shared order) is gone, as
//   the result does not depend on the order. Within a slab the group tests
//   the boxes G at a time, each lane its ray's grown box against one at
//   min(best, tmax); a ballot gives the ones that pass, and the group
//   sweeps each (held against the bound again, since best shrinks within a
//   chunk), its rows split over the lanes and folded by xor shuffles
//   (list_walk.cuh's sweep_boxes, which K7 runs over every box at once):
//   K8b's shape with a closest-hit carry.
//   G (ablations.rotated_group) comes from tools/grp_rot_ab_torch.py's
//   trial on a frame's calls; sweeping a chunk's passes nearest entry first
//   instead of lowest box first gained nothing there (PERF.md).
// - streamed, closest: the tile's list, its near-first key order, the exact
//   early break and the per-candidate guard are kept; the tile's lockstep (a
//   ring of shared row buffers, one block vote for the break and one for the
//   guard per candidate) is not. One ray goes to a group of G lanes
//   (list_walk.cuh, shared with K15) and goes down its tile's list on its
//   own, G candidates at a time: each lane reads one (key, box) and, with the
//   guard on, tests its ray's own grown box against it at min(best, tmax);
//   the group sweeps each candidate that passes, nearest first, its rows
//   split over the lanes, and folds (t, row) by xor shuffles, ties to the
//   lowest row (K6's leaf). The break is per ray: the first key beyond
//   min(best, far), checked again after every swept candidate, as best
//   shrinks within a chunk; `far` is the ray's last entry distance over the
//   boxes it pierces, a term the list build knows, so a ray that misses
//   everything stops at once. Guard off (TPT_STREAM_GUARD=0): every candidate
//   up to the break is swept. One lane that still needs a far cluster no
//   longer holds 255 others; any tile width is taken, past the list build's
//   caps too. Its tile (ablations.STREAM_CLOSEST_TILE) and G
//   (ablations.stream_closest_group) come from tools/cbin_ab_torch.py's trial
//   on a frame's calls. The 128-lane widening of the table is a Mosaic DMA
//   constraint and has no twin.
// - streamed, any-hit: the tile's list, its near-first key order and the
//   exact break (key > the lane's min(far, tmax)) are kept; the tile's
//   lockstep is not. As the closest side, one ray goes to a group of G
//   lanes, and
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
// - cbin: the per-group lists, the cluster-major jobs, the job table, the
//   pair budget and the incomplete lanes are kept, built on the card
//   (tpt_cbin_schedule; ablations.cbin_pairs, the reference's eager build,
//   is its plain version): a group of W lanes builds a group's list with a
//   ballot and a popcount per chunk of candidates, in ascending id order,
//   with no sort; the per-cluster counts are atomics; one block lays out the
//   runs of jobs (runs.cuh, as K14's schedule); each (group, cluster) pair
//   takes the next slot of its run by an atomic. A slot holds its group's
//   index, and the sweep gathers the ray from the packed rays: the
//   [P_cap, 8] copy of pair rays and the reduce targets are gone. The
//   reference's reduce (a scatter to (group, rank) cells, then a min over
//   the ranks) becomes the fold inside the sweep: one 64-bit atomicMin a
//   pair lane with a hit, on (float bits of t) << 32 | row, the order-free
//   lexicographic minimum (K14's fold); the any-hit's OR a store of 1, and
//   a lane whose ray is already blocked skips its sweep. The job width RT
//   is a template parameter (64, 128, 256; ablations.CBIN_JOB_TILE from
//   tools/cbin_ab_torch.py's trial on a frame's calls): RAY_TILE_C = 256 is
//   a TPU lane layout, and coherent rays give most clusters fewer pairs.
//   Blocks run in any order, so the one-job-ahead row prefetch across grid
//   steps has no twin: a block stages its cluster once and every thread
//   sweeps it for its pair's ray.
//
// What bounds them on this card: FP32 ALU, as the other clustered kernels.
// The binned sweeps run rows from shared memory without divergence inside
// a block, but a launch sweeps every padded pair lane; the streamed and
// rotated groups diverge where rays' lists or passes part, and read rows
// through L1 / L2. K11 tests every box of the table for every ray.
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
// Barriers: in the list build every thread of a block, live, parked or
// past n_rays, reaches every barrier; trip counts come from block votes.
// The rotated and streamed groups and the cbin list groups reach no
// barrier: a group's branches are uniform over its lanes, which hold the
// same ray (or ray group). A cbin sweep's empty job leaves before its only barrier, as a
// whole block.

#include "list_walk.cuh"
#include "runs.cuh"

#include <algorithm>
#include <cstring>

namespace {

constexpr int kMaxCluster = 128;  // rows per cluster K13 stages
using tpt::kTFar;
using tpt::load_ray;
using tpt::max_abs_origin;
using tpt::pe_test;
using tpt::Ray;
using tpt::Slab;
using tpt::box_passes;

// ---------------------------------------------------------------- rotated

// One ray to a group of G lanes. The group visits its ray's predicted slab
// first (pred[i]; unknown or out of range: slab 0), then the others in
// ascending order. Within a slab it tests the boxes G at a time, a lane a
// box, at min(best, tmax) (slab_enter); a ballot gives the ones that pass,
// and the group sweeps each, lowest box first, held against min(best,
// tmax) again since best shrinks within a chunk, its rows split over the
// lanes and folded by xor shuffles (list_walk.cuh's sweep_boxes, shared
// with K7).
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_rotated_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dir,
                       const float* __restrict__ tris,
                       const float* __restrict__ boxes,
                       const int* __restrict__ pred, int n_rays, int n_boxes,
                       int cluster, int slab_boxes, int s_count, float scale,
                       float margin, float tmin, float tmax,
                       float* __restrict__ t_out, int* __restrict__ row_out) {
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  int first = __ldg(pred + i);
  if (first < 0 || first >= s_count) first = 0;
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
    tpt::sweep_boxes<G>(r, s, m, bx, rows, sid * slab_boxes,
                        min((sid + 1) * slab_boxes, n_boxes), cluster, g,
                        tmin, tmax, best, best_row);
  }
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
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

// Bitonic sort of s[0, n) ascending (n a power of two; every entry
// unique: the ids in the low bits), by the whole block, or with kWarp by
// the calling warp alone. Ends with a barrier (__syncwarp with kWarp).
template <bool kWarp = false>
__device__ void bitonic_sort(unsigned long long* s, int n) {
  const int first = kWarp ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
  const int step = kWarp ? 32 : (int)blockDim.x;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = first; p < (n >> 1); p += step) {
        const int a = 2 * p - (p & (j - 1));
        const unsigned long long x = s[a], y = s[a + j];
        if ((x > y) == ((a & k) == 0)) {
          s[a] = y;
          s[a + j] = x;
        }
      }
      if (kWarp)
        __syncwarp();
      else
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


// ------------------------------------------------ list build, small tiles
//
// Tiles of at most kSmallMaxTile rays (K15's 8): one warp a tile and no
// block barrier, where the shared build gives a tile a block of 1,024
// threads, three quarters of whose lanes hold no ray at tiles of 8, and
// sorts every box. The warp stages its tile's rays in shared memory (origin,
// reciprocal direction, margin, tmax); each lane then takes one box, 32 a
// step, and slab-tests it against each of the tile's rays in turn (SEG,
// the ray count rounded up to a power of two, unrolled: independent tests
// in flight), within each ray's tmax (slab_enter, as the shared build),
// keeping the box's least entry (ordered bits, the shared build's
// atomicMin), its count of passing rays, and per ray its last entry (an
// ordered max, folded over the warp at the end). A ballot and a popcount
// file each step's boxes: a key other than T_FAR goes to the warp's sort
// array in id order, as (sort bits << 32 | id << 1 | the key is -0.0),
// which sorts as (key with -0.0 as +0.0, id) and gives the key's bits back
// whole; the ballot of the keys equal to T_FAR is the step's word of the
// warp's mask. The warp sorts only its array (bitonic, the listed boxes:
// about nine a tile on the big mesh), writes it around the T_FAR run
// (those under T_FAR before it, those above after it), then the run in id
// order from the mask: cand, keys, cnt and far bitwise the shared build's
// and stream_candidates'.

constexpr int kSmallMaxTile = 32;       // ablations.LIST_SMALL_MAX_TILE
constexpr int kSmallMaxBoxes = 16384;   // ablations.LIST_SMALL_MAX_BOXES
constexpr int kSmallWarps = 8;          // tiles a block at most
constexpr int kSmallSmem = 96 * 1024;   // shared memory a block aims at

__device__ __forceinline__ float from_sort_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A warp's shared memory, each part 16-byte aligned: sort_cap u64
// entries, the T_FAR mask, then seg staged rays of two float4.
__host__ __device__ inline size_t small_sort_bytes(int sort_cap) {
  return ((size_t)sort_cap * 8 + 15) / 16 * 16;
}

__host__ __device__ inline size_t small_mask_bytes(int n_boxes) {
  return (((size_t)n_boxes + 31) / 32 * 4 + 15) / 16 * 16;
}

__host__ __device__ inline size_t small_warp_bytes(int n_boxes, int sort_cap,
                                                   int seg) {
  return small_sort_bytes(sort_cap) + small_mask_bytes(n_boxes) +
         (size_t)seg * 32;
}

template <int SEG>
__global__ void __launch_bounds__(kSmallWarps * 32)
stream_candidates_small_kernel(const float* __restrict__ rays,
                               const float* __restrict__ tmax, float tmax_all,
                               const float* __restrict__ boxes, int n_boxes,
                               int rt, int tiles, int sort_cap, float scale,
                               float margin, float tmin,
                               int* __restrict__ cand,
                               float* __restrict__ keys,
                               int* __restrict__ cnt,
                               float* __restrict__ last_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile >= tiles) return;  // whole warps leave: no block barrier
  unsigned char* mine =
      smem + warp * small_warp_bytes(n_boxes, sort_cap, SEG);
  unsigned long long* s_sort = reinterpret_cast<unsigned long long*>(mine);
  const int words = (n_boxes + 31) / 32;
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(mine + small_sort_bytes(sort_cap));
  float4* s_ray = reinterpret_cast<float4*>(
      mine + small_sort_bytes(sort_cap) + small_mask_bytes(n_boxes));
  if (lane < rt) {
    const size_t i = (size_t)tile * rt + lane;
    float tm;
    const Ray r = tpt::load_ray8(rays, (int)i, &tm);
    const Slab sl = tpt::make_slab(r);
    s_ray[2 * lane] = make_float4(r.ox, r.oy, r.oz, sl.ix);
    s_ray[2 * lane + 1] =
        make_float4(sl.iy, sl.iz, margin * (scale + max_abs_origin(r)),
                    tmax != nullptr ? tmax[i] : tmax_all);
  }
  __syncwarp();

  const int inf_bits = ordered(__int_as_float(0x7f800000));
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  int far[SEG];
#pragma unroll
  for (int q = 0; q < SEG; ++q) far[q] = ordered(-3e38f);
  int listed = 0, below = 0, n_sort = 0;
  for (int b0 = 0; b0 < n_boxes; b0 += 32) {
    const int b = b0 + lane;
    const bool in = b < n_boxes;
    const float4 lo = in ? __ldg(bx + 2 * (size_t)b) : make_float4(0, 0, 0, 0);
    const float4 hi =
        in ? __ldg(bx + 2 * (size_t)b + 1) : make_float4(0, 0, 0, 0);
    int least = inf_bits, nok = 0;
#pragma unroll
    for (int q = 0; q < SEG; ++q) {
      const float4 u = s_ray[2 * q], v = s_ray[2 * q + 1];
      float tn;
      const bool ok = in && q < rt &&
                      tpt::slab_enter(Ray{u.x, u.y, u.z, 0, 0, 0},
                                      Slab{u.w, v.x, v.y}, lo, hi, v.z, tmin,
                                      &tn) &&
                      tn <= v.w;
      if (ok) {
        least = min(least, ordered(tn));
        far[q] = max(far[q], ordered(tn));
        ++nok;
      }
    }
    float key = kTFar;
    if (nok > 0)
      key = fminf(from_ordered(least),
                  nok < rt ? kTFar : __int_as_float(0x7f800000));
    listed += __popc(__ballot_sync(full, nok > 0));
    below += __popc(__ballot_sync(full, in && key < kTFar));
    const bool in_sort = in && key != kTFar;
    const unsigned sv = __ballot_sync(full, in_sort);
    if (in_sort)
      s_sort[n_sort + __popc(sv & ((1u << lane) - 1u))] =
          ((unsigned long long)sort_bits(key) << 32) | ((unsigned)b << 1) |
          (__float_as_uint(key) == 0x80000000u ? 1u : 0u);
    const unsigned fv = __ballot_sync(full, in && key == kTFar);
    if (lane == 0) s_mask[b0 >> 5] = fv;
    n_sort += __popc(sv);
  }
  // Each ray's last entry, folded over the warp; lane q keeps ray q's.
  int my_far = ordered(-3e38f);
#pragma unroll
  for (int q = 0; q < SEG; ++q) {
    int f = far[q];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      f = max(f, __shfl_xor_sync(full, f, off));
    if (lane == q) my_far = f;
  }
  int n_pow = 1;
  while (n_pow < n_sort) n_pow <<= 1;
  for (int p = n_sort + lane; p < n_pow; p += 32) s_sort[p] = ~0ull;
  __syncwarp();
  bitonic_sort<true>(s_sort, n_pow);

  const size_t row = (size_t)tile * n_boxes;
  const int n_far = n_boxes - n_sort;  // keys equal to T_FAR
  for (int p = lane; p < n_sort; p += 32) {
    const unsigned long long e = s_sort[p];
    const unsigned lo = (unsigned)(e & 0xffffffffu);
    const size_t at = row + (p < below ? p : p + n_far);
    cand[at] = (int)(lo >> 1);
    keys[at] = (lo & 1u) ? -0.0f : from_sort_bits((unsigned)(e >> 32));
  }
  int done = 0;
  for (int w = 0; w < words; ++w) {
    const unsigned v = s_mask[w];
    if ((v >> lane) & 1u) {
      const size_t at = row + below + done + __popc(v & ((1u << lane) - 1u));
      cand[at] = w * 32 + lane;
      keys[at] = kTFar;
    }
    done += __popc(v);
  }
  if (lane == 0) cnt[tile] = listed;
  if (lane < rt) last_key[(size_t)tile * rt + lane] = from_ordered(my_far);
}

// Calls launch(std::integral_constant<int, SEG>()) for SEG = rt rounded up
// to a power of two, rt in 1..kSmallMaxTile; false for any other.
template <class Launch>
bool with_seg(int rt, Launch launch) {
  if (rt < 1 || rt > kSmallMaxTile) return false;
  if (rt <= 1) launch(std::integral_constant<int, 1>());
  else if (rt <= 2) launch(std::integral_constant<int, 2>());
  else if (rt <= 4) launch(std::integral_constant<int, 4>());
  else if (rt <= 8) launch(std::integral_constant<int, 8>());
  else if (rt <= 16) launch(std::integral_constant<int, 16>());
  else launch(std::integral_constant<int, 32>());
  return true;
}

// ---------------------------------------------------------- cbin schedule
//
// ablations.cbin_pairs' work, built on the card: each group of g rays that
// shares a work list gets the ascending ids of the first k clusters its
// group test passes (cbin_lists), the per-cluster counts become runs of
// whole jobs of RT / g group-pairs laid out cluster after cluster
// (runs.cuh), and each (group, cluster) pair takes the next slot of its
// cluster's run (cbin_place). jtab and incomplete are bitwise cbin_pairs';
// a slot holds its group (-1: padding), not a copy of its rays, and the
// order within a run is the atomics'.

constexpr int kCbinThreads = 256;
constexpr int kCbinK1Max = 64;  // ablations.CBIN_K1_MAX
constexpr float kBig = 3e38f;   // ablations._BIG

// A group's interval bounds (ablations._cbin_ray_bounds): per axis the
// least and largest origin and reciprocal direction over its live members
// (origin x < 1e7), their largest tmax and margin, and whether any lives.
struct GroupBounds {
  float olo[3], ohi[3], ilo[3], ihi[3];
  float tmax, m;
  bool live;
};

template <int W>
__device__ __forceinline__ float group_min(const tpt::Group& g, float v) {
#pragma unroll
  for (int off = W / 2; off >= 1; off >>= 1)
    v = fminf(v, __shfl_xor_sync(g.mask, v, off, W));
  return v;
}

template <int W>
__device__ __forceinline__ float group_max(const tpt::Group& g, float v) {
#pragma unroll
  for (int off = W / 2; off >= 1; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(g.mask, v, off, W));
  return v;
}

// Every lane of the group holds one member (several lanes may hold the
// same one: a minimum or maximum does not mind).
template <int W>
__device__ __forceinline__ GroupBounds group_bounds(const tpt::Group& g,
                                                    const Ray& r,
                                                    const Slab& s, float tm,
                                                    float m) {
  const bool parked = r.ox >= 1.0e7f;
  const float o[3] = {r.ox, r.oy, r.oz}, inv[3] = {s.ix, s.iy, s.iz};
  GroupBounds b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.olo[a] = group_min<W>(g, parked ? kBig : o[a]);
    b.ohi[a] = group_max<W>(g, parked ? -kBig : o[a]);
    b.ilo[a] = group_min<W>(g, parked ? kBig : inv[a]);
    b.ihi[a] = group_max<W>(g, parked ? -kBig : inv[a]);
  }
  b.tmax = group_max<W>(g, parked ? -kBig : tm);
  b.m = group_max<W>(g, parked ? 0.0f : m);
  b.live = tpt::group_ballot(g, !parked) != 0u;
  return b;
}

// ablations._interval_slab of a group against the box (lo, hi), grown by
// the group's margin: per axis the eight endpoint products of (face - o) x
// inv bound every member's entry from below and exit from above.
__device__ __forceinline__ bool interval_passes(const GroupBounds& b,
                                                const float lo[3],
                                                const float hi[3],
                                                float tmin) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo_a = lo[a] - b.m, hi_a = hi[a] + b.m;
    const float f[4] = {lo_a - b.ohi[a], lo_a - b.olo[a], hi_a - b.ohi[a],
                        hi_a - b.olo[a]};
    float pmin = f[0] * b.ilo[a], pmax = pmin;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p0 = f[q] * b.ilo[a], p1 = f[q] * b.ihi[a];
      pmin = fminf(pmin, fminf(p0, p1));
      pmax = fmaxf(pmax, fmaxf(p0, p1));
    }
    tn = a == 0 ? pmin : fmaxf(tn, pmin);
    tf = a == 0 ? pmax : fminf(tf, pmax);
  }
  return tn <= tf && tf > tmin && tn <= b.tmax && b.live;
}

__device__ __forceinline__ void load_box(const float* __restrict__ boxes,
                                         int id, float lo[3], float hi[3]) {
  const float4* q = reinterpret_cast<const float4*>(boxes) + 2 * (size_t)id;
  const float4 a = __ldg(q), b = __ldg(q + 1);
  lo[0] = a.x;
  lo[1] = a.y;
  lo[2] = a.z;
  hi[0] = a.w;
  hi[1] = b.x;
  hi[2] = b.y;
}

// The parent boxes of the two-level lists: parent p spans boxes
// [p * fan, p * fan + fan), the missing ones past n_boxes padded with
// lo = 3e38 and hi = -3e38 (an exact min / max).
__global__ void cbin_parents_kernel(const float* __restrict__ boxes,
                                    int n_boxes, int fan, int n_parents,
                                    float* __restrict__ parents) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_parents;
       p += gridDim.x * blockDim.x) {
    float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
    for (int j = 0; j < fan; ++j) {
      const int c = p * fan + j;
      if (c >= n_boxes) break;
      float bl[3], bh[3];
      load_box(boxes, c, bl, bh);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], bl[a]);
        hi[a] = fmaxf(hi[a], bh[a]);
      }
    }
    float* out = parents + 8 * (size_t)p;
    for (int a = 0; a < 3; ++a) {
      out[a] = lo[a];
      out[3 + a] = hi[a];
    }
    out[6] = out[7] = 0.0f;
  }
}

// The group tests of ablations._cbin_lists.
enum CbinMode { kFlatInterval = 0, kFlatExact = 1, kTwoLevel = 2 };

// Step 1, lists: W lanes (a part of a warp, W >= g) a group of g rays,
// lane l holding member l % g. The group walks its candidates (boxes,
// parents, the kept parents' children) in ascending order, W / seg at a
// time: with the interval test (seg = 1) each lane tests one candidate
// against the group's bounds; with the exact union (seg = g) g lanes test
// one candidate, each for its own member (ablations._ray_box_test, the
// list build's slab_enter). A ballot gives the candidates that pass, and
// the passing ones take the next ranks in ascending order (a popcount of
// the passing ones before them): the first `cap` are kept, the rest only
// counted. Writes the group's list (c_list [n_groups, k], ascending ids;
// in the two-level mode ids past n_boxes may appear, as the reference's
// padded children pass the interval test), its length min(count, k) to
// n_list, whether a cap cut it to inc_out, and counts each kept id below
// n_boxes into per_c (atomicAdd). Groups leave whole; no block barrier.
template <int W>
__global__ void __launch_bounds__(kCbinThreads)
cbin_lists_kernel(const float* __restrict__ rays,
                  const float* __restrict__ boxes,
                  const float* __restrict__ parents, int n_groups, int g,
                  int n_boxes, int k, int mode, int fan, int n_parents,
                  int k1, float scale, float margin, float tmin,
                  int* __restrict__ c_list, int* __restrict__ n_list,
                  uint8_t* __restrict__ inc_out, int* __restrict__ per_c) {
  __shared__ int s_par[kCbinThreads / W][kCbinK1Max];
  const tpt::Group grp = tpt::group_of_thread<W>();
  const int q = (int)(((size_t)blockIdx.x * kCbinThreads + threadIdx.x) / W);
  if (q >= n_groups) return;  // whole groups leave together
  float tm;
  const Ray r = tpt::load_ray8(rays, q * g + grp.lane % g, &tm);
  const Slab s = tpt::make_slab(r);
  const float m = margin * (scale + max_abs_origin(r));
  GroupBounds b{};
  if (mode != kFlatExact) b = group_bounds<W>(grp, r, s, tm, m);

  // The ballot-and-popcount compaction of n_items candidates, seg lanes a
  // candidate; returns how many pass.
  auto compact = [&](int n_items, int seg, auto test, auto emit) {
    const int per_chunk = W / seg, lead = grp.lane / seg * seg;
    const unsigned seg_mask = seg == 32 ? 0xffffffffu : (1u << seg) - 1u;
    int base = 0;
    for (int x0 = 0; x0 < n_items; x0 += per_chunk) {
      const int x = x0 + grp.lane / seg;
      const bool ok = x < n_items && test(x);
      const unsigned votes = tpt::group_ballot(grp, ok);
      const bool head =
          grp.lane == lead && ((votes >> lead) & seg_mask) != 0u;
      const unsigned heads = tpt::group_ballot(grp, head);
      if (head) emit(base + __popc(heads & ((1u << grp.lane) - 1u)), x);
      base += __popc(heads);
    }
    return base;
  };
  auto keep = [&](int rank, int id) {
    if (rank >= k) return;
    c_list[(size_t)q * k + rank] = id;
    if (id < n_boxes) atomicAdd(per_c + id, 1);
  };

  int count;
  bool cut;
  if (mode != kTwoLevel) {
    const bool exact = mode == kFlatExact;
    count = compact(n_boxes, exact ? g : 1, [&](int x) {
      float lo[3], hi[3];
      if (!exact) {
        load_box(boxes, x, lo, hi);
        return interval_passes(b, lo, hi, tmin);
      }
      const float4* bq = reinterpret_cast<const float4*>(boxes) + 2 * (size_t)x;
      float tn;
      return tpt::slab_enter(r, s, __ldg(bq), __ldg(bq + 1), m, tmin, &tn) &&
             tn <= tm;
    }, keep);
    cut = count > k;
  } else {
    int* kept = s_par[grp.slot];
    const int count1 = compact(n_parents, 1, [&](int x) {
      float lo[3], hi[3];
      load_box(parents, x, lo, hi);
      return interval_passes(b, lo, hi, tmin);
    }, [&](int rank, int x) {
      if (rank < k1) kept[rank] = x;
    });
    __syncwarp(grp.mask);
    const int n_kept = min(count1, k1);
    auto child = [&](int x) { return kept[x / fan] * fan + x % fan; };
    count = compact(n_kept * fan, 1, [&](int x) {
      const int id = child(x);
      float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
      if (id < n_boxes) load_box(boxes, id, lo, hi);
      return interval_passes(b, lo, hi, tmin);
    }, [&](int rank, int x) { keep(rank, child(x)); });
    cut = count1 > k1 || count > k;
  }
  if (grp.lane != 0) return;
  n_list[q] = min(count, k);
  inc_out[q] = cut ? 1 : 0;
}

// Step 3, place: one thread a group. Each listed cluster below n_boxes
// takes the next slot of its run (cursor, an atomic); a slot past the
// budget (the jobs past j_cap) is dropped. The group's lanes are
// incomplete when a cap cut its list or one of its clusters' runs ends
// past j_cap (an id past n_boxes counts as cluster n_boxes - 1, as
// cbin_pairs' clamp has it).
__global__ void cbin_place_kernel(const int* __restrict__ c_list,
                                  const int* __restrict__ n_list,
                                  const uint8_t* __restrict__ inc_lists,
                                  const int* __restrict__ job_end,
                                  int* __restrict__ cursor, int n_groups,
                                  int g, int k, int n_boxes, int j_cap,
                                  int n_slots, int* __restrict__ slot_group,
                                  uint8_t* __restrict__ incomplete) {
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n_groups;
       q += gridDim.x * blockDim.x) {
    bool bad = inc_lists[q] != 0;
    const int n = n_list[q];
    for (int e = 0; e < n; ++e) {
      const int c = c_list[(size_t)q * k + e];
      if (job_end[min(c, n_boxes - 1)] > j_cap) bad = true;
      if (c >= n_boxes) continue;
      const int slot = atomicAdd(cursor + c, 1);
      if (slot < n_slots) slot_group[slot] = q;
    }
    for (int j = 0; j < g; ++j) incomplete[(size_t)q * g + j] = bad ? 1 : 0;
  }
}

// ------------------------------------------------------------- cbin sweep

// Job `blockIdx.x` is RT pair lanes against cluster jtab[job] (-1: an empty
// job); slot `job * (RT / g) + lane / g` holds its group (-1: padding), and
// the lane sweeps ray group * g + lane % g of the packed rays. Closest:
// the lane folds its (t, row) into its ray's key (float bits of t) << 32 |
// row with one 64-bit atomicMin (every hit has t > tmin > 0, so the key
// orders as (t, row) does); `key` starts at all ones (a miss). Any-hit:
// the lane stores 1 into its ray's flag, and skips the sweep when the flag
// is already set.
template <int RT, bool kAny>
__global__ void __launch_bounds__(RT)
cbin_sweep_kernel(const float* __restrict__ rays,
                  const float* __restrict__ tris,
                  const int* __restrict__ jtab,
                  const int* __restrict__ slot_group, int g, int cluster,
                  float tmin, unsigned long long* __restrict__ key,
                  uint8_t* __restrict__ occ) {
  __shared__ float4 s_rows[kMaxCluster * 4];
  const int c = jtab[blockIdx.x];
  if (c < 0) return;  // the whole block leaves: no barrier follows
  tpt::stage_rows(s_rows, tris, c * cluster, cluster);
  __syncthreads();
  const int q = slot_group[(size_t)blockIdx.x * (RT / g) + threadIdx.x / g];
  if (q < 0) return;
  const int i = q * g + threadIdx.x % g;
  float tm;
  const Ray r = tpt::load_ray8(rays, i, &tm);
  if (kAny) {
    if (occ[i] != 0) return;
    if (tpt::blocked_staged(r, s_rows, cluster, tmin, tm)) occ[i] = 1;
    return;
  }
  int sub;
  const float best = tpt::sweep_staged(r, s_rows, cluster, tmin, &sub);
  if (best < kTFar)
    atomicMin(key + i, ((unsigned long long)__float_as_uint(best) << 32) |
                           (unsigned)(c * cluster + sub));
}

// The per-ray (t, row) of the folded keys: all ones is a miss (T_FAR,
// row 0).
__global__ void cbin_unpack_kernel(const unsigned long long* __restrict__ key,
                                   int n_rays, float* __restrict__ t_out,
                                   int* __restrict__ row_out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
       i += gridDim.x * blockDim.x) {
    const unsigned long long x = key[i];
    const bool hit = x != ~0ull;
    t_out[i] = hit ? __uint_as_float((unsigned)(x >> 32)) : kTFar;
    row_out[i] = hit ? (int)(unsigned)(x & 0xffffffffu) : 0;
  }
}

// Calls launch(std::integral_constant<int, RT>()) for a job width built
// here (ablations.CBIN_JOB_TILES); false for any other.
template <class Launch>
bool with_job(int rt, Launch launch) {
  switch (rt) {
    case 64: launch(std::integral_constant<int, 64>()); return true;
    case 128: launch(std::integral_constant<int, 128>()); return true;
    case 256: launch(std::integral_constant<int, 256>()); return true;
    default: return false;
  }
}

inline bool power_of_two(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for arguments its kernels do not take (below each).
// Tables as tpt_closest_clustered; packed rays [n, 8] as
// ablations.pack_rays builds them.

// K11 for rays (orig, dir) [n_rays, 3]: slabs of slab_boxes clusters,
// `group` lanes a ray (a width of with_group).
int tpt_closest_rotated(const float* orig, const float* dir,
                        const float* tris, const float* boxes,
                        const int* pred, int n_rays, int n_boxes, int cluster,
                        int slab_boxes, float scale, float margin, float tmin,
                        float tmax, float* t_out, int* row_out, int group,
                        void* stream) {
  if (slab_boxes < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  const int s_count = (n_boxes + slab_boxes - 1) / slab_boxes;
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    if (n_rays > 0)
      closest_rotated_kernel<G>
          <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
             (cudaStream_t)stream>>>(orig, dir, tris, boxes, pred, n_rays,
                                     n_boxes, cluster, slab_boxes, s_count,
                                     scale, margin, tmin, tmax, t_out,
                                     row_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// K12 closest over the tile lists of tpt_stream_candidates, `rays`
// packed [n_rays, 8]: any tile width rt >= 1 (each ray's tile is i / rt),
// `group` lanes a ray, a width of with_group (4, 8, 16, 32).
int tpt_closest_streamed(const float* rays, const float* tris,
                         const float* boxes, const int* cand,
                         const float* keys, const int* cnt,
                         const float* last_key, int n_rays, int n_boxes,
                         int cluster, int rt, float scale, float margin,
                         float tmin, float tmax, int guard, float* t_out,
                         int* row_out, int group, void* stream) {
  if (rt < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  const bool ok = tpt::launch_closest_list(
      group, n_rays, (cudaStream_t)stream, rays, tris, boxes, cand,
      keys, cnt, last_key, n_rays, n_boxes, cluster, rt, scale, margin, tmin,
      tmax, guard, t_out, row_out);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// K12 any-hit, `rays` packed [n_rays, 8] (column 6: each ray's tmax): a
// tile width rt >= 1, `group` as above.
int tpt_occluded_streamed(const float* rays, const float* tris,
                          const float* boxes, const int* cand,
                          const float* keys, const int* cnt,
                          const float* last_key, int n_rays, int n_boxes,
                          int cluster, int rt, float scale, float margin,
                          float tmin, int guard, uint8_t* occ_out, int group,
                          void* stream) {
  if (rt < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  const bool ok = tpt::launch_occluded_list(
      group, n_rays, (cudaStream_t)stream, rays, tris, boxes, cand,
      keys, cnt, last_key, n_rays, n_boxes, cluster, rt, scale, margin, tmin,
      guard, occ_out);
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
  fill_ints<<<tpt::run_grid(n_rays), 256, 0, s>>>(far_bits, n_rays, neg_bits);
  const dim3 grid((unsigned)tiles, (unsigned)((n_boxes + kRunBoxes - 1) /
                                              kRunBoxes));
  list_runs_kernel<<<grid, kListThreads, 0, s>>>(
      rays, tmax, tmax_all, boxes, n_boxes, rt, scale, margin, tmin, key_of,
      cnt, far_bits, sort_a);
  unsigned long long *src = sort_a, *dst = sort_b;
  for (long long w = kRunBoxes; w < n_boxes; w *= 2) {
    list_merge_kernel<<<tpt::run_grid((long long)total), 256, 0, s>>>(src, dst, n_boxes,
                                                          (int)w, total);
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  list_emit_kernel<<<tpt::run_grid((long long)(total > (size_t)n_rays ? total : n_rays)),
                     256, 0, s>>>(src, key_of, far_bits, n_boxes, total,
                                  n_rays, cand, keys, last_key);
  return (int)cudaGetLastError();
}

// The same lists for tiles of at most 32 rays (one warp a tile, above):
// needs 1 <= rt <= 32 dividing n_rays and 1 <= n_boxes <= 16,384.
int tpt_stream_candidates_small(const float* rays, const float* tmax,
                                float tmax_all, const float* boxes,
                                int n_rays, int n_boxes, int rt, float scale,
                                float margin, float tmin, int* cand,
                                float* keys, int* cnt, float* last_key,
                                void* stream) {
  if (rt < 1 || rt > kSmallMaxTile || n_rays % rt || n_boxes < 1 ||
      n_boxes > kSmallMaxBoxes)
    return (int)cudaErrorInvalidValue;
  const int tiles = n_rays / rt;
  if (tiles == 0) return (int)cudaSuccess;
  int sort_cap = 1;
  while (sort_cap < n_boxes) sort_cap <<= 1;
  cudaError_t err = cudaSuccess;
  with_seg(rt, [&](auto sc) {
    constexpr int SEG = decltype(sc)::value;
    const size_t per_warp = small_warp_bytes(n_boxes, sort_cap, SEG);
    const int warps = (int)std::max<size_t>(
        1, std::min<size_t>(kSmallWarps, kSmallSmem / per_warp));
    const size_t smem = per_warp * warps;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(stream_candidates_small_kernel<SEG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return;
    }
    stream_candidates_small_kernel<SEG>
        <<<(unsigned)((tiles + warps - 1) / warps), warps * 32, smem,
           (cudaStream_t)stream>>>(rays, tmax, tmax_all, boxes, n_boxes, rt,
                                   tiles, sort_cap, scale, margin, tmin, cand,
                                   keys, cnt, last_key);
  });
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// K13's schedule (ablations.cbin_schedule) for packed `rays` [n_rays, 8]
// (each ray's bound in column 6) and `boxes` [n_boxes, 8]: groups of g
// rays, lists of at most k clusters, jobs of rt pair lanes (a width of
// with_job, n_rays a multiple of it, g a power of two up to 32 dividing
// rt and `lanes`), a budget of j_cap jobs; `mode` a CbinMode (two-level:
// parents of `fan` boxes, at most k1 <= 64 kept); `lanes` lanes a group in
// the list step, a width of with_group. Writes jtab [j_cap] i32 (-1: an
// empty job), slot_group [j_cap * rt / g] i32 (-1: padding) and
// incomplete [n_rays] u8. Scratch: parents [ceil(n_boxes / fan) * 8] f32,
// c_list [n_rays / g * k], n_list [n_rays / g] i32, inc_lists
// [n_rays / g] u8, per_c, job_end, cursor [n_boxes] i32.
int tpt_cbin_schedule(const float* rays, const float* boxes, int n_rays,
                      int n_boxes, int g, int k, int rt, int j_cap, int mode,
                      int fan, int k1, int lanes, float scale, float margin,
                      float tmin, float* parents, int* c_list, int* n_list,
                      uint8_t* inc_lists, int* per_c, int* job_end,
                      int* cursor, int* jtab, int* slot_group,
                      uint8_t* incomplete, void* stream) {
  if (n_rays < 0 || n_boxes < 1 || k < 1 || !with_job(rt, [](auto) {}) ||
      n_rays % rt || !power_of_two(g) || g > 32 || rt % g || lanes % g ||
      j_cap < 0 || mode < kFlatInterval || mode > kTwoLevel ||
      (mode == kTwoLevel && (fan < 1 || k1 < 1 || k1 > kCbinK1Max)) ||
      !tpt::with_group(lanes, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_groups = n_rays / g;
  const long long n_slots = (long long)j_cap * (rt / g);
  const int n_parents = (n_boxes + fan - 1) / fan;
  cudaMemsetAsync(per_c, 0, sizeof(int) * n_boxes, s);
  if (n_slots > 0) cudaMemsetAsync(slot_group, 0xff, sizeof(int) * n_slots, s);
  if (mode == kTwoLevel)
    cbin_parents_kernel<<<tpt::run_grid(n_parents), 256, 0, s>>>(
        boxes, n_boxes, fan, n_parents, parents);
  if (n_groups > 0)
    tpt::with_group(lanes, [&](auto wc) {
      constexpr int W = decltype(wc)::value;
      const long long threads = (long long)n_groups * W;
      cbin_lists_kernel<W>
          <<<(unsigned)((threads + kCbinThreads - 1) / kCbinThreads),
             kCbinThreads, 0, s>>>(rays, boxes, parents, n_groups, g,
                                   n_boxes, k, mode, fan, n_parents, k1,
                                   scale, margin, tmin, c_list, n_list,
                                   inc_lists, per_c);
    });
  tpt::run_layout_kernel<<<1, tpt::kRunLayoutThreads, 0, s>>>(
      per_c, n_boxes, rt / g, job_end, cursor);
  if (j_cap > 0)
    tpt::run_owner_kernel<<<tpt::run_grid(j_cap), 256, 0, s>>>(
        job_end, n_boxes, j_cap, -1, jtab);
  if (n_groups > 0)
    cbin_place_kernel<<<tpt::run_grid(n_groups), 256, 0, s>>>(
        c_list, n_list, inc_lists, job_end, cursor, n_groups, g, k, n_boxes,
        j_cap, (int)n_slots, slot_group, incomplete);
  return (int)cudaGetLastError();
}

// K13's sweeps over that schedule (n_jobs = j_cap jobs of rt lanes, groups
// of g rays, packed `rays` [n_rays, 8]; rt a width of with_job, a cluster
// of 1..128 rows). Closest: t_out, row_out [n_rays], each ray's closest
// (t, packed row) over its pairs' clusters, T_FAR and row 0 where it has
// none; scratch key [n_rays] u64. No tmax: the path clips.
int tpt_closest_cbin(const float* rays, const float* tris, const int* jtab,
                     const int* slot_group, int n_jobs, int rt, int g,
                     int n_rays, int cluster, float tmin,
                     unsigned long long* key, float* t_out, int* row_out,
                     void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || !power_of_two(g) || rt % g)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_rays > 0) cudaMemsetAsync(key, 0xff, sizeof(*key) * n_rays, s);
  const bool ok = with_job(rt, [&](auto rc) {
    constexpr int RT = decltype(rc)::value;
    if (n_jobs > 0)
      cbin_sweep_kernel<RT, false><<<(unsigned)n_jobs, RT, 0, s>>>(
          rays, tris, jtab, slot_group, g, cluster, tmin, key, nullptr);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n_rays > 0)
    cbin_unpack_kernel<<<tpt::run_grid(n_rays), 256, 0, s>>>(key, n_rays,
                                                             t_out, row_out);
  return (int)cudaGetLastError();
}

// Any-hit: occ [n_rays] u8, is a non-refractive row of one of the ray's
// pairs' clusters hit with tmin < t < its tmax (column 6)?
int tpt_occluded_cbin(const float* rays, const float* tris, const int* jtab,
                      const int* slot_group, int n_jobs, int rt, int g,
                      int n_rays, int cluster, float tmin, uint8_t* occ,
                      void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || !power_of_two(g) || rt % g)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_rays > 0) cudaMemsetAsync(occ, 0, n_rays, s);
  const bool ok = with_job(rt, [&](auto rc) {
    constexpr int RT = decltype(rc)::value;
    if (n_jobs > 0)
      cbin_sweep_kernel<RT, true><<<(unsigned)n_jobs, RT, 0, s>>>(
          rays, tris, jtab, slot_group, g, cluster, tmin, nullptr, occ);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
